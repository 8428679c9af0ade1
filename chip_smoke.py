#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ssi_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (each prints one progress line; any failure raises and exits
non-zero without printing the final line):

0. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
1. build: the tokenizer's native BPE core (``ssi_tpu_torch/native``, g++)
   and every CUDA kernel from ``ssi_tpu_torch/csrc`` (one nvcc per source,
   in parallel, then one link); prints each kernel's registers and spills
   from the ptxas log;
2. flash-attention forward kernel vs its plain version (f32 and bf16, the
   bf16 one the Hopper kernel of ``csrc/flash_hopper_fwd.cu``; causal, full,
   segment ids) at the serving path's largest prefill dispatch (B 8, S 768),
   at B 2 x S 768, and at the training path's B 2 x S 2048; times beside
   SDPA;
3. fused paged-decode kernel (#8) vs its plain version at the 1B serving
   shape (32 slots, 8 kv heads, page 128, context 1280; ragged and inactive
   slots), and at context 16,384 (past the old design's shared-memory cap):
   attention within tolerance, two launches bitwise equal, pools bitwise
   equal except the trash row; device times (a CUDA graph of launches,
   replayed, so the host's enqueue cost is left out) as the decode step
   launches the kernel, the 16 layers' page tables in turn (no launch finds
   its pages in L2 from the one before; a rate above the card's 3.35 TB/s
   fails the run as a timing error), beside the same layer launched again
   and again, graphed and eager, with GB/s of history pages; the device
   kernels one bf16 call runs must be 1 (read with ``torch.profiler`` after
   phase 1, at each paged phase's shape, in a child process);
a. the multi-token verify kernel (#9) vs its plain version at the same
   shape, T 4 and 8, f32 and bf16: history 0, a mid-page start, spans that
   cross a page, full context less T, an inactive slot and a slot whose
   write cap cuts its span; attention within tolerance on tokens whose
   writes land, beside a control (the plain output with the in-flight
   causal mask dropped) that must miss; two launches bitwise equal; pools
   bitwise equal except the trash row; T 4 at context 16,384; times and the
   kernels a bf16 call runs as in phase 3;
4. engine in f32 at the full width of ``llama3_2_1b`` (random weights from
   ``--seed``): greedy tokens identical with the kernels and with the plain
   versions, and equal to a full-recompute greedy oracle for one prompt;
b. speculation in f32 at the same width: prompts that share a 256-token
   prefix and repeat content; ``speculate_k=3`` emits the ``speculate_k=0``
   tokens, with the kernels and with the plain versions; the prefix cache
   and the drafter both engage;
5. the serving main path: the 1B bf16 engine serves 64 requests (32 slots,
   128 tokens each); every request finishes, every page is free or parked in
   the prefix cache, and both serving kernels' launch counters are > 0 for
   that run;
c. the serving path with speculation: phase 5's requests with
   ``speculate_k=3``, the prefix cache and ``prefill_chunk=512``; every
   request finishes, pages balance, the flash and verify kernels' launch
   counters are > 0; tok/s, tokens per verify step and the token agreement
   with phase 5 (bf16: the T-token verify GEMMs round unlike the 1-token
   step, so agreement is reported, not required);
o. tensor-parallel serving in a tp group of one rank: this process joins a
   1-rank NCCL group and runs phase 5's requests (random bf16 1B weights,
   full width) through the paged engine with ``mesh=make_mesh(dp=1, tp=1)``
   beside the mesh-less engine, at ``speculate_k`` 0 (runs in turns: none,
   mesh, local, none; "local" is the same tp path on a mesh
   with no process group, every collective skipped, which sets apart what
   the NCCL calls cost) and 3 (none, mesh), each run on a fresh engine
   after a warm-up, at pipeline depth 1 (depth 2's admission rounds depend
   on when results reach the host); every run's greedy tokens must equal
   the mesh-less run's bitwise (at one rank the all-reduces after ``wo``
   and ``w_down`` and the embedding's, and the logits' all-gather, move no
   value); tok/s of each beside the card's name and power limit, the kernels the mesh
   runs launched (#1, #8, #9: the kernels line's ``serve_tp``). With two or
   more cards, phase d also runs the generation CLI under ``torchrun
   --nproc_per_node 2 tensor_parallel=2`` and ``--nproc_per_node 1`` on its
   ``step_0/``, holding the two runs' first decode step logits within 1e-2
   in relative norm and reporting their token agreement; with one card it
   prints ``tp2: 1 card, not run``;
j. ``n > 1`` parallel sampling and the pipeline depth (the engine's
   default, 2, runs every serving phase):
   j2. #8 vs its plain version on a page table in which each gang of 4
   slots shares its prompt's read-only pages and owns the boundary page
   (copied from the leader's by ``copy_pages``, checked equal in all 16
   layers) and the pages after it; 32 slots, 32 q / 8 kv heads, hd 64,
   f32 and bf16: attention within phase 3's tolerances beside a control,
   the written pools equal the plain version's, no shared page changed;
   j4. f32 at 1B width with the depth cut to 2 layers, the kernels: depth 2
   tokens == depth 1's, n=3 greedy == the n=1 stream, a seeded n=3 sampled
   stream (temperature 0.8) reproduces itself with its siblings apart,
   top-k 1 == greedy;
   j1. 16 of phase 5's prompts as n=4 greedy gangs on phase 5's random
   bf16 1B weights (32 slots, 128 tokens): every gang's siblings equal token
   for token, ``pages_shared`` == sum 3 x floor((p-1)/128) (the pool holds
   8 gangs at once: none splits), pages balance, #1 and #8 launched (the
   kernels line's ``launches_by_path["serve_n"]``); tok/s;
   j3. phase 5's 64 requests at pipeline depth 1 and 2, a run each (depth 1
   first), each on a fresh engine after phase 5's warm-up: tok/s, harvest wait,
   dispatch and prefill enqueue seconds, slot occupancy, chunk dispatches
   and the requests equal to phase 5's tokens, per run (no gate: bf16
   batches depend on timing at depth 2);
d. the generation entry point: a ``step_0/`` under
   ``<tmp>/experiments/run/checkpoints/`` (a 128,000-entry base tokenizer
   extended with 5,000 DSUs and 2 modality tokens, random bf16 1B weights
   written through ``internal_to_hf`` and the port's safetensors writer, the
   HF model files) and a 64-row JSON-lines test split; the CLI's ``main``
   (``python -m ssi_tpu_torch.cli.generate``) with the WER drive's overrides
   writes 64 finished records with in-vocab tokens; the config snapshot
   reads back to the resolved config; the loaded parameters equal the
   written ones bitwise; the flash and paged kernels' launch counters are
   > 0 for the run; every record's tokens equal a direct engine call on the
   same prompts and loaded parameters when both prefilled in the same
   admission rounds (recorded around ``_prefill_admitted``; otherwise every
   record of a matching round, and the rounds print); prints the load GB/s,
   tokenization, warm-up and generate times and the records' tok/s;
i. the serving entry point over HTTP, on phase d's ``step_0/`` before it is
   deleted: ``python -m ssi_tpu_torch.cli.serve model=<step_0>
   server.port=<free>`` as a subprocess with ``conf/serve.yaml`` as it
   stands (32 slots, ``max_cache_len`` 4096, the prefix cache,
   ``prefill_chunk`` 512, features sample,topk,topp; ``speech.n_dsus`` from a
   training-config snapshot beside the checkpoint); two warm-up requests;
   four of phase 5's prompts one at a time; then phase 5's 64 prompts
   streamed from 32 client threads at once (every response 200 and ending
   in ``[DONE]``; pages balance at idle); a string prompt, a chat request, a
   streamed chat equal to it, a stop string, ``temperature 1, seed 5`` twice
   equal, and (after the gate requests) an ``n: 4`` greedy request answered
   with 4 equal choices; SIGINT, exit 0, and the server's
   launch counts show #1 and #8; the four sequential requests equal, token
   for token, a direct engine built as ``run_server`` builds it on the same
   weights and fed the same requests in the same order. Prints tok/s over
   HTTP beside phases 5 and d, TTFT p50/p90/max, start-to-``/health``
   seconds, how the 64 prompts' prefill split between #1 and the plain
   suffix pass, ``/metrics``, and the device memory in use (which must not
   grow by 1 GiB after the 64 requests);
l. the dense engine, on phase d's ``step_0/`` and split before they are
   deleted: f32 at 1B width (2 layers), the dense ``DecodeEngine``'s greedy
   tokens equal the paged engine's (kernels) and a full-recompute oracle's
   for phase 4's prompts, a seeded sampled run reproduces itself and top-k
   1 is greedy; the generation CLI with ``engine=dense batch_size=8`` in
   bf16 (the split's first 32 records in 4 batches, cut from 64 in 8 to
   make room for phase n; every record finished; generated tok/s
   beside phase d's paged rate, agreement with phase d's tokens reported,
   not required); one ``python -m ssi_tpu_torch.cli.generate_sample``
   process on ``repeat_this_modality_switch`` with speech tokens (a
   finished record); phase l uses no kernel of the table (the JAX dense
   engine's attention is XLA);
6. flash-attention backward kernel vs its plain version (dq, dk, dv; f32 and
   bf16, the bf16 one the Hopper kernels of ``csrc/flash_hopper_bwd.cu``;
   causal, full, segment ids) at B 4, S 768 and the training shape
   B 2, S 2048, with the plain gradients at lse + 0.05 as the control; dq,
   dk and dv bitwise equal over two launches; times and TFLOP/s (counted on
   the 5 products and on the 7 the kernels issue) beside the backward of
   PyTorch's ``scaled_dot_product_attention`` (timed only, as a yardstick);
7. the cross-entropy kernels (lse, the backward's dlogits pass, the dh and
   dE GEMMs; in bf16 the backward's three on the Hopper GEMM of
   ``csrc/cross_entropy_hopper.cu``)
   and the loss vs their plain versions at N 4,096 and 3,072
   tokens, D 2048, V 133,258 (f32 and bf16, every 7th label ignored), at the
   init logit spread and a trained-like one (std 4); dE's labelled and
   unlabelled vocab rows held apart; controls: a constant lse, lse + 0.05,
   dh without its softmax term; lse, dlogits, dh and dE bitwise equal over
   two launches;
   times and TFLOP/s of each pass and of the whole backward beside one
   ``torch.mm`` per GEMM (with its TFLOP/s) and ``F.cross_entropy(h @ E.T, y)``
   with its backward;
8. f32 train-step parity at the full width of ``llama3_2_1b``: one
   micro-batch of B 1, S 512 through ``make_loss_fn`` (the kernels) and
   through the plain attention and cross-entropy on the card: loss and every
   leaf's gradient agree;
9. the training main path: ``make_train_step`` on the 1B bf16 model with
   the SFT window (accum 4 x micro-batch 2 x seq 2048), f32 gradient
   accumulation, clip 1.0, AdamW defaults: first one micro-batch from the
   one state under every remat policy, whose loss and every gradient must
   equal remat "none"'s bitwise (``save_qkv_mlp_attn`` launching the flash
   forward once per layer, the other checkpointed policies twice); then a
   zero-token warm-up window per
   remat policy (no update, step not advanced), then 3 timed optimizer
   steps on one repeated window with full remat, 3 with ``save_qkv_mlp``
   (the conf's selective policy) and 3 with full remat again, untraced;
   every loss finite, step 9, the third loss below the first, and every
   training kernel's launch counter > 0 for each policy's run; step ms,
   peak memory and launches per optimizer step of each;
p. tensor-parallel training (one card: NCCL refuses two ranks on one, so
   tp > 1 runs only in the CPU tests): p1. kernels #5-#7 on the vocabulary
   cut into 2 slices as 2 tp ranks run them, in one process (N 4,096, D
   2048, bf16; V 133,258 in slices of 66,629 and V 129,206 in slices of
   64,603): each slice's lse, the ``[2, N]`` merged by ``merge_slices``
   (the logsumexp's merge pass, launched alone), the picked logit summed,
   each slice's dlogits pass on its remapped labels, dh summed and dE
   stacked; lse and loss held to 1e-5 relative, dh and dE to 1e-2 in
   relative norm, against the plain version and the whole-vocabulary
   kernels, each beside a control that must miss (a merge without the last
   slice; labels not remapped); each pass timed on one slice beside the
   whole vocabulary, and the merge pass beside ``torch.logsumexp``; p2.
   phase 9's window through ``make_train_step`` with a tp-1 ``StateLayout``
   over a 1-rank NCCL group (the Megatron ops, the masked lookup, the
   vocab-parallel cross-entropy and the dp x tp reducers, all identities)
   beside the mesh-less step from the same state, 2 steps each after a
   zero-token warm-up: losses, token counts, grad norms and every parameter
   and moment bitwise equal; step ms of both; every training kernel and the
   merge pass launched on the tp path;
e. the training entry points at the full width of ``llama3_2_1b``: a
   synthesized base (the drive's 128,000-entry tokenizer, random bf16
   weights) extended by ``python -m ssi_tpu_torch.cli.extend_llama3_2``'s
   ``main`` with the WER drive's arguments (vocab 133,258, base rows
   bitwise unchanged, new rows finite, a DSU span encodes to its ids); the
   SFT CLI's ``main`` with the drive's overrides (JSON-lines splits of 64
   and 16 rows, window 4 x 2 x 2048, the conf's ``save_qkv_mlp`` and bf16,
   4 steps, a save and a dev loss every 2): losses finite, every training
   kernel launched, ``step_4/`` reloaded equal to the trainer's parameters
   bitwise, the training state read back by the port's decoder; the CPT
   CLI for 2 steps with the conf's window (micro-batch 4 x accum 16 x seq
   768, interleaved): losses finite, the final checkpoint written; an
   A/B of ``overlap_io`` (6 SFT steps each way, untraced, no save: every
   logged value but the timings equal, wall per step and duration_step of
   steps 2-5 printed); then a fresh SFT run (no save) from ``step_2/`` and
   the step-2 training state whose
   step 3-4 losses and step-4 weights equal the uninterrupted run's
   bitwise, its step 3 traced through the Trainer's ``profiler`` key
   (device busy share and device time by kernel class). Prints the
   extension's seconds, each run's JSONL step times and label tok/s, save
   seconds and GB/s for the model and the state, reload and state-read
   seconds, peak memory, launches, and the free disk at the start (the
   phase holds about 23 GB at its peak, its base kept for phase m, and
   deletes each directory once read);
k. packed training, inside phase e on its extended checkpoint: the SFT
   CLI with ``data.train.packed=true data.dev.packed=true`` at phase e's
   window (4 x 2 x 2048) over 112 rows (phase e's 64 and 48 more: 27 packs
   of 2048, 3 optimizer steps an epoch), 4 steps, a save and a packed dev
   loss every 2: losses finite and falling, every training kernel launched
   (the kernels line's ``launches_by_path["train_packed"]``); a fresh run
   (no save) from ``step_2/`` and its state whose steps 3-4 (across the epoch
   boundary, after the re-pack) and step-4 weights equal the uninterrupted
   run's bitwise; #1 and #3 at the run's first two packs (segments 1..k,
   then a tail of segment 0) vs their plain versions in f32 and bf16, each
   beside a segment-blind control that must miss, with bf16 times beside
   SDPA given the same boolean mask (the backend that took it is named);
   f32 at 1B width (2 layers): the two packs' loss equals the sum over
   their samples run alone, with the kernels and with the plain versions,
   within 1e-5 of the sum; then 2 steps with ``pack_window`` 8 (no save). Prints
   label tok/s and ``duration_step`` beside phase e's unpacked run, the
   non-pad share of packed and unpacked rows, and peak memory;
n. training across ranks, inside phase e on its extended checkpoint (after
   phase k): ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` of the SFT CLI with ``parallel.distributed=true``
   (NCCL at world size 1) at phase e's window, steps and argv: n1 with
   ``parallel.zero1=true`` and no dev evaluation, n2 with
   ``parallel.fsdp=true sharded_optimizer_state=true`` (saves at steps 2 and
   4), n3 resuming n2 from step 2 (overlapping on the card: n1 and n2 at
   once, n3 once n1 has ended and n2 has kept its step-2 state; cut so to
   make room for phase t); n1's and n2's
   losses, grad norms and ``step_4/`` files and n2's dev losses equal phase
   e's bitwise, n3's steps 3-4, ``step_4/``
   and step-4 moments (read back from both sharded directories) equal
   n2's; every training kernel launched (the kernels line's
   ``launches_by_path["train_dp"]``, through
   ``SSI_TPU_TORCH_LAUNCH_COUNTS``); and, while n3 runs, two NCCL ranks on
   the one card (NCCL's answer printed; if it took them, n4 trains at dp 2
   with the per-rank batch halved, held to n1's losses within 1e-2). Each
   torchrun runs a launcher file that runs the CLI's module as ``python
   -m`` does and reports the rank's peak memory, save seconds and where its
   wall went. Prints ``duration_step`` and label tok/s beside phase e's,
   peak memory and save seconds;
m. the BPE-compressed DSU axis, inside phase e on its synthesized base
   (after phase k): a Markov DSU corpus from ``--seed`` (128 rows of 8-14
   words, a 5,000-unit Zipf alphabet, out-degree 8, 25% holds) through
   ``python -m ssi_tpu_torch.cli.train_dsu_bpe --n-merges 1024
   --deduplicate`` (in this process), ``merge_into_tokenizer`` with the
   modality tokens (n_new), the extension CLI with ``--n_new_dsus n_new``
   and the compressed ``tokenizer.model`` swapped in (``config.json``'s
   bos/eos must equal its dynamic specials), the CPT CLI through
   ``conf/cpt.yaml`` with ``tokenizer.pattern=cl100k speech.n_dsus=n_new``
   for 2 steps at phase e's window on the same rows (every training kernel
   launched, ``n_tokens.dsu`` > 0), the generation CLI with the cl100k
   pattern from its ``step_2/`` (16 prompts x 64 greedy tokens, every record
   finished and its text the tokenizer's decode; flash and #8 launched), and
   #5-#7 against their plain versions at V_c (N 4,096, D 2,048); prints
   n_new, V_c, the compression ratio, the rows' tokens under the PUA and
   the cl100k pattern (``dsu_only`` and ``interleaved``; cl100k's
   ``dsu_only`` must be fewer), the host encode rate under each, the CPT
   step readings beside phase e's and the phase's seconds (the kernels
   line's ``launches_by_path["cpt_compressed"]``: the CPT and generation
   runs together);
q. the slice's host modules, inside phase e on its extended checkpoint
   (before phase k): q1 phase e's SFT run for 2 steps with no save, both
   splits read from a local dataset directory in the HF repo layout (phase
   e's rows in two parquet train shards and one validation shard, a README
   ``configs:`` block; JSON-lines shards when pyarrow does not import),
   passed as ``data.{train,dev}.dataset.source=<dir>`` with no
   ``data_files``: losses, grad norms and the step-2 dev loss bitwise phase
   e's; q2 phase e's CPT run for 2 steps with no save and
   ``tokenizer.pattern`` the PUA pattern wrapped as ``(?:...)`` (a string the
   C++ scanner does not take: the ``regex`` route): every CPT row's tokens
   equal the scanner's, losses and grad norms bitwise phase e's CPT (without
   ``regex``, the CLI's refusal naming it); prints the split read time
   (directory beside JSON lines), the host encode rate of each route, the
   step readings and the phase's seconds (the kernels line's
   ``launches_by_path["train_local"]``: both runs together);
f. weight-only int8 and the port's WER drive:
   f1. ``quantize_layer_weights_int8`` on phase 5's random bf16 1B weights
   on the card: ``q`` and ``scale`` bitwise equal to the same f32
   arithmetic on the CPU, ``|w - q * scale| <= amax / 127`` for every
   weight, the int8 leaves ``torch.int8`` on the card; then phase 5's 64
   requests through the int8 engine (``quantize="int8"``): every request
   finishes, pages balance, the flash and paged kernels' launch counters are
   > 0; tok/s beside phase 5's, the layer stack's bytes int8 beside bf16,
   the token agreement with phase 5 (int8 is not bitwise: reported, not
   required);
   f2. the kernels at the 100m WER drive's shapes against their plain
   versions (``hold``, ``REL``): flash forward and backward at B 32, S 160,
   8 q / 4 kv heads; the CE lse, dlogits, dh and dE at N 5,120, D 512,
   V 133,258 (spread 1 and 4; dE's unlabelled rows beside the lse + 0.05
   control); #8 at 48 slots, 4 kv heads, n_rep 2, page 128, 3 pages; bf16
   times beside the plain versions;
   f3. ``python -m ssi_tpu_torch.wer_drive --smoke`` (``llama3_2_100m``, 8
   SFT steps, 256 training rows), run as a subprocess as a user runs it,
   every stage a subprocess of the port's CLI on the card: both WERs
   computed and finite (not gated at this size; the full drive's summary is
   committed under ``artifacts/wer_drive_torch/``), the summary's
   ``hardware`` this card, every training kernel launched by the SFT stage
   and the flash and paged kernels by each generate stage (each stage's
   process reports its counts through ``SSI_TPU_TORCH_LAUNCH_COUNTS``);
   prints the stage seconds, the final dev loss, the generate tok/s of both
   precisions and the drive's wall; phase t3's tiny drive runs beside it
   (both host-bound CLI chains on small models), waited for before f3's
   traced step;
2g-ah. the head_dim-128 instances (Llama 3.2 3B's and 3.1 8B's heads) vs
   their plain versions, each beside a control that must miss, in f32 and
   bf16, with bf16 times beside SDPA or ``torch.mm`` and the bound: the
   flash forward and backward (in bf16 the Hopper kernels of
   ``csrc/flash_hopper_fwd.cu`` and ``csrc/flash_hopper_bwd.cu``; the backward
   launched twice, bitwise equal) at
   3B's training shape (B 2, S 2048, 24 q / 8 kv heads: n_rep 3) and 8B's
   largest prefill dispatch (B 8, S 768, 32 / 8); the CE kernels at 3B's D 3,072 (N 4,096); #8 and #9 (T 4 and 8)
   at 3B's and 8B's serving shapes (32 slots, page 128, context 1280; a
   graph of 16 layers' launches in turn) and at context 16,384;
g. Llama 3.2 3B through the entry points at full width (D 3,072, its depth
   cut to 4 of its 28 layers for the run's time limit, ``G_LAYERS``; random
   bf16 weights from ``--seed``): first, at 3B width with the depth
   cut to 2 layers, f32 greedy tokens kernels == plain (and == a
   full-recompute oracle), ``speculate_k=3`` == 0, and one micro-batch's
   loss and gradients within phase 8's limits; then an extended 3B dir in
   two safetensors shards with an index (as Llama-3.2-3B ships: the
   Checkpointer wants 2), the SFT CLI for 4 steps (window 4 x 2 x 2048 over
   an 8-row split, lr 5e-4 after a 1-step warm-up; losses finite and
   falling, every training kernel launched, ``step_4/`` in two shards), and
   the generation CLI from ``step_4/`` on 32 rows (cut from 64 to make room
   for phase n: one wave of the 32 slots) in bf16 and with
   ``quantize_weights=int8`` (every record finished; flash and #8
   launched); deleted as it goes;
h. Llama 3.1 8B serving at full width (D 4,096, FFN 14,336, an untied
   ``lm_head``, rope ``scale_factor`` 8), the depth cut to 16 of 32 layers
   (random bf16 weights, about 9.2 GB, initialised on the card): phase 5's
   64 requests x 128 greedy tokens at 32 slots, then with ``speculate_k=3``, the prefix cache and
   ``prefill_chunk=512`` (every request finishes, pages balance, #1, #8 and
   #9 launched); then f32 greedy at 8B width with the depth cut to 2
   layers, tokens kernels == plain and == the oracle;
t. the shapes the JAX kernels take beyond the registry's (ROADMAP B1-B3)
   and ``tiny_test`` through its entry points:
   t1. every new shape of each kernel, f32 and bf16, against its plain
   version, each beside a control that must miss: #1-#4 at head_dims 16,
   40, 72, 80, 96, 120 and 100 (padded to 104 by the wrapper) with q, k, v
   and do column slices of 128-wide buffers holding NaN past d (control:
   the plain forward at the scale of the instance's width); #5-#7 at D 64,
   72, 100, 576 and 960 with h a slice of a NaN buffer (controls: the lse
   of the D tail dropped, lse + 0.05, dh without its softmax term); #8/#9 at
   head_dims 16, 80, 96 and 256 (Gemma 2B's 8 q / 1 kv heads at T 1, 4, 8),
   36 and 20 (not multiples of 8) and at 72 and 128 query rows of a kv
   head, every unused pool cell NaN or +-Inf, three splits, pages of 16 and
   128 (#1-#4 also at 136, 200 and 256, on 256-wide NaN buffers);
   t2. the new shapes' rows timed in bf16 beside their bounds and the
   library calls: #1-#4 at head_dim 80 and 96 at 1B's heads (B 8, S 768
   and B 2, S 2048), #5-#7 at D 576 and 960 (N 4,096, V 133,258), #8 at
   head_dim 96 (32 slots, n_rep 4, context 1,280), #9 at Llama 3.1 405B's
   heads (128 q / 8 kv of 128: 64 query rows at T 4, 128 at T 8); the
   hd-256 instances at Gemma 2B's (8 q / 1 kv) and 7B's (16 / 16) heads:
   #1-#4 at B 8, S 768 and B 2, S 2048 beside SDPA, #8/#9 at 32 slots,
   context 1,280, T 1, 4, 8; #8/#9 at head_dims 36 and 20 (the plain-load
   kernels); #8 at Gemma 2B's heads with shorter splits, timed only;
   t3. ``tiny_test`` f32 greedy tokens kernels == plain (and == the
   oracle, ``speculate_k=3`` == 0), then ``python -m ssi_tpu_torch.wer_drive
   --smoke --model-config tiny_test --max-seq-len 512`` as a subprocess,
   every stage a CLI on the card (#1, #3, #5-#7 launched by its SFT stage,
   #1 and #8 by each generate stage), and the generation CLI on its
   checkpoint with ``speculate_k=3`` (#1 and #9 launched): the kernels line's
   ``launches_by_path["tiny_drive"]``;
   t4. a 2-layer model at Gemma 2B's attention layout (D 2,048, 8 q / 1 kv
   heads of 256, FFN 8,192, the 1B's vocabulary; built here, not in the
   registry) through the engine and the trainer: f32 greedy tokens kernels
   == plain == oracle at k 0, ``speculate_k=3`` == 0, f32 loss and
   gradients within phase 8's limits; bf16 serving at k 0, one bf16 SFT
   window through ``make_train_step`` (loss and gradients of a micro-batch
   against the plain versions); then ``tiny_test`` at heads of 36 and 20
   (f32 parity, bf16 at k 0 and 3).

``--only 1b,e,hd128,g,h,tiny`` runs the named groups alone while developing (1b:
phases 2-f, phases i, j, k, l, n, m and q with them; e: phases e, q, k, n and m alone;
tiny: phase t) and prints no result line.

Tolerances: phases 2, 3 and a hold each output elementwise to ``TOL``
(absolute and relative). Every kernel output is also held in relative norm,
||kernel - plain|| / ||plain|| <= ``REL`` (1e-4 f32, 1e-2 bf16), and in
phases a, 6 and 7 each such check comes with a control, a deliberately wrong
result that must miss the same limit. The cross-entropy lse is held to
``LSE_ATOL`` absolute and the loss to 1e-5 of its sum; phase 8 holds each
gradient leaf to 1e-4 of its largest entry.
It then prints one JSON line with per-kernel results (errors, times, the
bound computed from this run's shapes, the library yardstick, launches by
path, ``wer_drive`` the sum over the drive's stage processes,
``serve_http`` the HTTP server process's, ``serve_n`` phase j1's,
``serve_tp`` phase o's mesh runs, ``train_tp`` phase p2's tp path,
``train_packed`` phase k's packed SFT run, ``cpt_compressed`` phase
m's CPT and generation runs, ``train_dp`` the sum over phase n's
torchrun processes, ``train_local`` phase q's SFT and CPT runs and
``tiny_drive`` the sum over phase t3's drive and speculative generate
processes; phase t2's rows of a kernel under its ``other_shapes``, those at
Gemma 2B's heads and at head_dims 36 / 20 with phase t4's launches by path; the
head_dim-128 instances as rows of their own, ``<name>_hd128``, with the 3B
and 8B paths' launches, and the head_dim-256 ones, ``<name>_hd256``, with
phase t4's) and, last, the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLASH_REPLACES = "ssi_tpu/ops/flash_attention.py:76"  # _fwd_kernel (and _fwd_kernel_grouped, :174)
FLASH_BWD_REPLACES = "ssi_tpu/ops/flash_attention.py:263"  # _bwd_kernel (and _bwd_kernel_grouped, :365)
PAGED_REPLACES = "ssi_tpu/generate/paged_pallas.py:83"  # paged_attention_pallas -> _kernel
PAGED_MULTI_REPLACES = "ssi_tpu/generate/paged_pallas.py:425"  # paged_attention_pallas_multi -> _kernel_multi
CE_REPLACES = {
    "cross_entropy_lse": "ssi_tpu/ops/cross_entropy_pallas.py:53",  # _compute_lse -> _lse_kernel
    # the logits and dlogits that _dh_kernel (:118-126) and _de_kernel (:148-156) each form
    "cross_entropy_dlogits": "ssi_tpu/ops/cross_entropy_pallas.py:108",
    "cross_entropy_dh": "ssi_tpu/ops/cross_entropy_pallas.py:108",  # _bwd_rule -> _dh_kernel
    "cross_entropy_de": "ssi_tpu/ops/cross_entropy_pallas.py:137",  # _bwd_rule -> _de_kernel
}
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "cross_entropy_lse", "cross_entropy_dlogits",
                 "cross_entropy_dh", "cross_entropy_de")
DENSE_RECORDS = 32  # phase l's dense CLI run: the first 32 of phase d's 64 records
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# limit on ||kernel - plain|| / ||plain|| over one output tensor (or one set of its rows)
REL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_ATOL = 1e-3  # cross-entropy lse, absolute: well below its row-to-row spread
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, w) -> float:
    """||a - w|| / ||w|| over all entries, summed in f64."""
    a, w = a.double(), w.double()
    return ((a - w).norm() / w.norm().clamp_min(1e-300)).item()


def hold(what: str, a, w, key: str, controls=()) -> tuple[float, float, float]:
    """Hold the kernel's ``a`` to the plain ``w`` within ``REL[key]`` in
    relative norm; each control, a deliberately wrong result ``(name, c)``,
    must miss the same limit, or the check could not tell. Returns
    (max |a - w|, relative error, the smallest control's relative error)."""
    limit = REL[key]
    rel = rel_err(a, w)
    check(rel <= limit, f"{what} {key}: ||kernel - plain|| / ||plain|| = {rel:.3e} > {limit}")
    least = math.inf
    for name, c in controls:
        rc = rel_err(c, w)
        check(rc > limit, f"{what} {key}: the control '{name}' passes ({rc:.3e} <= {limit}), so the check cannot tell")
        least = min(least, rc)
    return (a.float() - w.float()).abs().max().item(), rel, least


def bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """Least time the card could take (ms): the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory rate; which bounds."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def in_turns(kernel, plain, iters: int = 10) -> tuple[float, float]:
    """(kernel ms, plain ms), best of two each, timed plain, kernel, kernel, plain."""
    t_p, t_k, t_k2, t_p2 = time_ms(plain, iters), time_ms(kernel, iters), time_ms(kernel, iters), time_ms(plain, iters)
    return min(t_k, t_k2), min(t_p, t_p2)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ssi_tpu_torch import _build

    nvcc = _build.find_nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True).stdout
    log(smi)
    log(
        f"phase 0 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc_v.strip().splitlines()[-1]}"
    )
    return smi


def _kernel_name(mangled: str) -> str:
    """A mangled kernel symbol -> its name (``<length><name>`` ending in
    ``_kernel``) and up to 40 characters of its mangled template arguments."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):  # the length may follow other digits (a hash)
            n = int(mangled[start:m.end()])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                rest = mangled[m.end() + n:]
                return name + (rest[:40] if rest.startswith("I") else "")
    return mangled


PTXAS: dict[str, list[str]] = {}  # kernel (name and mangled template arguments) -> its ptxas report lines


def ptxas_of(part: str) -> str:
    """The ptxas report (registers, spills) of the one kernel whose name
    holds ``part``, as phase 1 read it from the build log."""
    found = [k for k in PTXAS if part in k]
    check(len(found) == 1, f"ptxas report: {len(found)} kernels match {part!r}")
    return "; ".join(PTXAS[found[0]])


def phase_build():
    from ssi_tpu_torch import _build, native

    t0 = time.perf_counter()
    native.load_native()  # the tokenizer's C++ BPE core (g++), beside the kernels
    log(f"  native BPE core (g++): {time.perf_counter() - t0:.1f} s")
    _build.load_library()
    kernel = ""  # the kernel the ptxas lines below belong to: its name and mangled template arguments
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            kernel = _kernel_name(ln.split("'")[1])
        elif "registers" in ln or "spill" in ln:
            PTXAS.setdefault(kernel, []).append(ln.strip())
            log(f"  ptxas {kernel}: {ln.strip()}")
    # ptxas reports no dynamic shared memory: what each Hopper kernel's launcher asks for (its Smem
    # struct + 1 KB of alignment slack) is stated in the note at the top of its source
    log(f"phase 1 build: {_build.build_seconds:.1f} s (0.0 = cached library reused: its saved ptxas report above); "
        f"each source's nvcc done after {', '.join(f'{k} {v:.1f} s' for k, v in _build.source_seconds.items())}")


def phase_flash(gen, hq=32, hkv=8, d=64, shapes=((8, 768), (2, 768), (2, 2048)), row=(8, 768),
                tag="phase 2 flash forward"):
    """The flash forward kernel vs its plain version at ``shapes`` (B, S) of
    ``hq`` / ``hkv`` heads of ``d``: o and lse elementwise within ``TOL``, o
    within ``REL`` beside a control (the plain output with each q head
    routed to the next kv head) that must miss; bf16 causal times beside
    SDPA. Returns the kernels-line numbers at ``row``."""
    import torch
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

    worst, least = {}, math.inf
    # 1B: B8 S768 is the main path's largest prefill dispatch (8 prompts, bucket 768), also timed below
    for b, s in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            cuts = sorted(torch.randint(1, s, (3,), generator=gen, device="cuda").tolist())
            seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
            for c in cuts:
                seg[:, c:] += 1
            for name, causal, segs in (("causal", True, None), ("full", False, None), ("segments", True, seg)):
                o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segs)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=segs)
                torch.cuda.synchronize()
                tol = TOL[str(dtype).split(".")[1]]
                err_o = (o.float() - o_ref.float()).abs().max().item()
                err_l = (lse - lse_ref).abs().max().item()
                ok_o = torch.allclose(o.float(), o_ref.float(), atol=tol, rtol=tol)
                ok_l = torch.allclose(lse, lse_ref, atol=tol, rtol=tol)
                check(ok_o and ok_l, f"flash {name} B{b} S{s} {dtype}: o err {err_o}, lse err {err_l}, tol {tol}")
                key = str(dtype).split(".")[1]
                # control: each q head reads the next kv head's keys and values (one kv head: the next q head's query)
                o_ctrl, _ = (flash_attention_reference(q, k.roll(1, 2), v.roll(1, 2), causal=causal, segment_ids=segs)
                             if hkv > 1 else flash_attention_reference(q.roll(1, 2), k, v, causal=causal,
                                                                       segment_ids=segs))
                _, rel_o, ctrl = hold(f"flash {name} B{b} S{s} o", o, o_ref, key, [("kv heads shifted", o_ctrl)])
                least = min(least, ctrl)
                worst[key] = max(worst.get(key, 0.0), err_o, err_l)
                log(f"  flash {name:8s} B{b} S{s} Hq{hq} Hkv{hkv} d{d} {key:8s}: max|o err| {err_o:.3e}, max|lse err| "
                    f"{err_l:.3e} (tol {tol}); o rel {rel_o:.2e} (limit {REL[key]}; control {ctrl:.2e})")
                del o, lse, o_ref, lse_ref, o_ctrl
            del q, k, v
            torch.cuda.empty_cache()
    # times at the checked shapes, beside one PyTorch call; the kernels line reports ``row``
    times, library = {}, {}
    for b, s in shapes:
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        times[(b, s)] = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                                 lambda: flash_attention_reference(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library[(b, s)] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        # useful causal work: QK^T and PV over the S(S+1)/2 allowed pairs, 2 FLOP per MAC
        tflops = 4 * b * hq * d * s * (s + 1) / 2 / (times[(b, s)][0] * 1e-3) / 1e12
        log(f"  flash time bf16 causal B{b} S{s} Hq{hq} Hkv{hkv} d{d}: kernel {times[(b, s)][0]:.3f} ms ({tflops:.1f} "
            f"TFLOP/s = {tflops / 989:.1%} of the bf16 tensor-core peak), plain {times[(b, s)][1]:.3f} ms, "
            f"scaled_dot_product_attention {library[(b, s)]:.3f} ms")
        del q, k, v, qt, kt, vt
    b, s = row
    n_bytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s  # q, o; k, v; lse
    bound_ms, bound_by = bound(4 * b * hq * d * s * (s + 1) / 2, n_bytes)
    log(f"  flash B{b} S{s} Hq{hq} Hkv{hkv} d{d}: bound {bound_ms:.4f} ms ({bound_by})")
    log(f"{tag}: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; controls >= {least:.2e})")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst["bfloat16"], "ms": times[row][0], "plain_ms": times[row][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[row]}


HBM_GBS = PEAK_BYTES / 1e9


def paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, n_layers, hist, active, hd=64):
    """Pools of ``n_layers`` layers (trash row last), a random logical page
    map, q and the new K/V of #8 (``t_q`` 1) or #9, and per layer its page
    table and write rows (inactive slots write to the trash row)."""
    import torch

    n_pages = slots * max_pages
    rows = n_layers * n_pages + 1
    kp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype)
    shape = (slots,) if t_q == 1 else (slots, t_q)
    q = torch.randn((*shape, hkv * n_rep, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((*shape, hkv, hd), generator=gen, device="cuda").to(dtype)
    logical = torch.randperm(n_pages, generator=gen, device="cuda").view(slots, max_pages).to(torch.int32)
    pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
    per_layer = []
    for layer in range(n_layers):
        table = layer * n_pages + logical
        write = torch.where(active[:, None], torch.gather(table, 1, (pos // ps).clamp(max=max_pages - 1).long()),
                            rows - 1).to(torch.int32)
        per_layer.append((table, write[:, 0] if t_q == 1 else write))
    return kp, vp, q, kn, vn, per_layer


def paged_call(t_q: int):
    """(kernel, plain) of #8 (``t_q`` 1) or #9, and the lengths each takes
    from the history lengths and the active mask."""
    import torch

    from ssi_tpu_torch.generate.paged_cuda import (
        paged_attention_fused,
        paged_attention_fused_reference,
        paged_attention_multi_fused,
        paged_attention_multi_fused_reference,
    )

    if t_q == 1:  # seq_lens count the incoming token; 0 = inactive
        return (paged_attention_fused, paged_attention_fused_reference,
                lambda hist, active: torch.where(active, hist + 1, 0).to(torch.int32))
    return paged_attention_multi_fused, paged_attention_multi_fused_reference, lambda hist, active: hist


def paged_long_context(gen, t_q: int, key_dtypes=("float32", "bfloat16"), hd: int = 64, n_rep: int = 4) -> str:
    """#8 (``t_q`` 1) or #9 at 32 slots, context 16,384, 8 kv heads of
    ``hd``, page 128, past the old #8's shared-memory cap: kernel vs plain
    (``hold``), two launches bitwise equal, pools bitwise equal except the
    trash row; the bf16 launch's time and GB/s (1 GB of pages at head_dim
    64: no L2 reuse). Returns a summary for the phase line."""
    import torch

    from ssi_tpu_torch.generate.paged_cuda import split_plan

    slots, hkv, ps, max_pages = 32, 8, 128, 128
    cap = ps * max_pages
    kernel, plain, lens_of = paged_call(t_q)
    hist = [cap - t_q, 0, 1, 1024, 1025, 6000]
    hist = torch.tensor(hist + torch.randint(1, cap - t_q + 1, (slots - len(hist),), generator=gen,
                                             device="cuda").tolist(), dtype=torch.int32, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    active[1] = False
    lens = lens_of(hist, active)
    parts = []
    for key in key_dtypes:
        dtype = getattr(torch, key)
        kp, vp, q, kn, vn, ((table, write),) = paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, 1,
                                                            hist, active, hd)
        kw = dict(k_new=kn, v_new=vn, write_rows=write)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = kernel(q, kp, vp, table, lens, **kw)
        again = kernel(q, kp, vp, table, lens, **kw)
        ref = plain(q, kp_ref, vp_ref, table, lens, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged T{t_q} context {cap} {key}: two launches differ")
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged T{t_q} context {cap} {key}: pools not bitwise equal outside the trash row")
        err, rel, _ = hold(f"paged T{t_q} context {cap}", got[active], ref[active], key)
        check(torch.allclose(got[active].float(), ref[active].float(), atol=TOL[key], rtol=TOL[key]),
              f"paged T{t_q} context {cap} {key}: max err {err} > tol {TOL[key]}")
        part = f"{key} rel {rel:.2e}"
        if key == "bfloat16":
            t = graph_ms([lambda: kernel(q, kp, vp, table, lens, **kw)] * 4)
            n_bytes = int(hist[active].sum().item()) * hkv * hd * kp.element_size() * 2
            part += f", {t:.3f} ms ({n_bytes / 1e9:.2f} GB of pages, {n_bytes / (t * 1e-3) / 1e9:.0f} GB/s)"
        parts.append(part)
        del kp, vp, kp_ref, vp_ref, got, again, ref
        torch.cuda.empty_cache()
    per_split, n_splits = split_plan(max_pages, ps)
    return (f"context {cap}, n_rep {n_rep}, head_dim {hd} ({n_splits} splits of {per_split} pages; the old #8 "
            "refused it): "
            + "; ".join(parts) + "; two launches bitwise equal, pools bitwise equal except trash")


def graph_ms(calls, replays: int = 10) -> float:
    """Device time per call (ms) of ``calls``, no-argument functions that
    launch CUDA work, captured once in a CUDA graph and replayed: the host's
    cost of enqueuing a call, which exceeds a short kernel's run time, is
    left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # first use outside the capture
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def device_kernels(fn) -> list[str]:
    """The names of the device activities (kernels, copies, fills) of one
    call of ``fn``, after a warm-up call, as a ``torch.profiler`` window
    records them. A window that records no device activity at all (the
    profiler did not see the card) is read again, up to three windows."""
    import torch

    fn()
    torch.cuda.synchronize()
    names: list[str] = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


# (Hq, Hkv, head_dim, T) -> the device kernels one bf16 paged call runs there
PAGED_KERNELS: dict[tuple, list[str]] = {}
PAGED_SHAPES = [(32, 8, 64, 1), (32, 8, 64, 4), (32, 8, 64, 8), (24, 8, 128, 1), (32, 8, 128, 1), (24, 8, 128, 4),
                (24, 8, 128, 8), (32, 8, 128, 4), (32, 8, 128, 8),  # phases 3, a, 3g, 3h, ag, ah
                (32, 8, 96, 1), (128, 8, 128, 4), (128, 8, 128, 8),  # phase t2: hd 96; 64 and 128 rows a kv head
                # phase t2: Gemma 2B's and 7B's heads of 256; head_dims 36 and 20 (the plain-load kernel)
                *((hq, hkv, 256, t) for hq, hkv in ((8, 1), (16, 16)) for t in (1, 4, 8)),
                *((32, 8, hd, t) for hd in (36, 20) for t in (1, 4, 8))]


def paged_kernel_names() -> dict[str, list[str]]:
    """The device kernels one bf16 call of #8 / #9 runs at each serving
    shape of phases 3, a, 3g, 3h, ag and ah (32 slots, page 128, context
    1,280, ragged), each read with a ``torch.profiler`` window; keyed
    "Hq,Hkv,hd,T"."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    slots, ps, max_pages = 32, 128, 10
    names = {}
    for hq, hkv, hd, t_q in PAGED_SHAPES:
        kernel, _, lens_of = paged_call(t_q)
        hist = torch.randint(0, ps * max_pages - t_q, (slots,), generator=gen, device="cuda").to(torch.int32)
        active = torch.ones(slots, dtype=torch.bool, device="cuda")
        kp, vp, q, kn, vn, ((table, write),) = paged_inputs(gen, torch.bfloat16, t_q, slots, hkv, hq // hkv, ps,
                                                            max_pages, 1, hist, active, hd)
        lens = lens_of(hist, active)
        names[f"{hq},{hkv},{hd},{t_q}"] = device_kernels(
            lambda: kernel(q, kp, vp, table, lens, k_new=kn, v_new=vn, write_rows=write))
    return names


def count_paged_kernels() -> None:
    """``paged_kernel_names`` in a child process, whose tracing leaves this
    one untouched: a process that has traced stays slower on the host (the
    serving phases' tok/s would read it), and once phase e's traced step has
    run, windows here were seen to record no device activity."""
    out = subprocess.run([sys.executable, "-c", "import json, chip_smoke; "
                          "print(json.dumps(chip_smoke.paged_kernel_names()))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"counting the paged kernels' device kernels failed: {out.stderr[-2000:]}")
    for key, names in json.loads(out.stdout.strip().splitlines()[-1]).items():
        PAGED_KERNELS[tuple(int(x) for x in key.split(","))] = names
    log(f"  paged bf16 device kernels a call, read with torch.profiler in a child process: "
        + ", ".join(f"Hq{k[0]} hd{k[2]} T{k[3]} {len(v)}" for k, v in PAGED_KERNELS.items()))


def one_launch(what: str, hq: int, hkv: int, hd: int, t_q: int) -> str:
    """Check that one bf16 call of a paged kernel at this shape runs one
    device kernel (as ``count_paged_kernels`` read it after the build)."""
    names = PAGED_KERNELS[(hq, hkv, hd, t_q)]
    check(len(names) == 1, f"{what}: one call ran {len(names)} device kernels ({names}), not 1")
    return f"one call runs 1 device kernel ({names[0][:90]}; torch.profiler)"


def paged_times(kernel, plain, per_layer, layer, n_bytes):
    """The kernel's device time as the decode step launches it, the layers'
    page tables in turn (no launch finds its pages in L2 from the one
    before), and the plain version's alike: one CUDA graph of a launch per
    layer, replayed, in turns (plain, kernel, kernel, plain; best of each).
    Beside them, the same layer again and again, graphed, and as the earlier
    design was timed (eager launches between two events, which reads the
    host's enqueue rate once that exceeds the kernel's time). ``kernel(table, write)``;
    ``n_bytes``: the history pages one launch reads. Returns (rotated ms,
    plain ms, same-layer graphed ms, same-layer eager ms, rotated GB/s)."""
    rot_k = [lambda t=t, w=w: kernel(t, w) for t, w in per_layer]
    rot_p = [lambda t=t, w=w: plain(t, w) for t, w in per_layer]
    t_p = graph_ms(rot_p)
    t_k = min(graph_ms(rot_k), graph_ms(rot_k))
    t_p = min(t_p, graph_ms(rot_p))
    same = [lambda: kernel(*per_layer[layer])] * len(per_layer)
    t_same = graph_ms(same)
    t_eager = time_ms(same[0], 32)
    gbs = n_bytes / (t_k * 1e-3) / 1e9
    check(gbs <= HBM_GBS, f"the rotated timing reads {gbs:.0f} GB/s, above the card's {HBM_GBS:.0f}: "
          "the timing is wrong (pages served from L2)")
    return t_k, t_p, t_same, t_eager, gbs


def phase_paged(gen, hq=32, hkv=8, hd=64, n_layers=16, tag="phase 3 paged decode", long_context=True):
    """#8 vs its plain version at the serving shape (32 slots, ``hkv`` kv
    heads of ``hd``, ``hq`` q heads, page 128, context 1280; ragged and
    inactive slots) beside a control (each q head routed to the next kv
    head; with one kv head, to the next q head's query), then at context
    16,384 (``long_context``); times of a graph of the ``n_layers`` layers
    in turn."""
    import torch

    from ssi_tpu_torch.generate.paged import paged_attention

    slots, ps, max_ctx = 32, 128, 1280
    n_rep = hq // hkv
    kernel, plain, lens_of = paged_call(1)
    layer = min(5, n_layers - 1)
    lens = [1, ps, 2 * ps - 3, max_ctx, 0]  # 0 = inactive slot
    lens += torch.randint(1, max_ctx + 1, (slots - len(lens),), generator=gen, device="cuda").tolist()
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    active = seq_lens > 0
    hist = (seq_lens - 1).clamp(min=0)
    worst, timing = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        tol = TOL[key]
        kp, vp, q, kn, vn, per_layer = paged_inputs(gen, dtype, 1, slots, hkv, n_rep, ps, max_ctx // ps, n_layers,
                                                    hist, active, hd)
        table, write_rows = per_layer[layer]
        kw = dict(k_new=kn, v_new=vn)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        again = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        ref = plain(q, kp_ref, vp_ref, table, seq_lens, write_rows=write_rows, **kw)
        # control: each q head reads the next kv head's history (the token written as the kernel writes it)
        ctrl_out = paged_attention(q.roll(n_rep if hkv > 1 else 1, 1), kp_ref, vp_ref, table, seq_lens)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged attention {key}: two launches differ")
        err = (got[active].float() - ref[active].float()).abs().max().item()
        check(torch.allclose(got[active].float(), ref[active].float(), atol=tol, rtol=tol),
              f"paged attention {key}: max err {err} > tol {tol}")
        _, rel, ctrl = hold("paged attention", got[active], ref[active], key,
                            [("kv heads shifted", ctrl_out[active])])
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"paged pools {key}: not bitwise equal outside the trash row")
        worst[key] = err
        log(f"  paged Hq{hq} Hkv{hkv} hd{hd} {key:8s}: max|attn err| {err:.3e} (tol {tol}), rel {rel:.2e} (limit "
            f"{REL[key]}; control {ctrl:.2e}); two launches bitwise equal; pools bitwise equal except trash")
        if dtype == torch.bfloat16:
            # bytes the algorithm must read: every history K and V row of every active slot
            n_tokens = int(hist[active].sum().item())
            n_bytes = n_tokens * hkv * hd * kp.element_size() * 2
            timing = paged_times(
                lambda t, w: kernel(q, kp, vp, t, seq_lens, write_rows=w, **kw),
                lambda t, w: plain(q, kp_ref, vp_ref, t, seq_lens, write_rows=w, **kw), per_layer, layer, n_bytes)
            t_k, t_p, t_same, t_eager, gbs = timing
            log(f"  paged Hq{hq} Hkv{hkv} hd{hd} bf16: " + one_launch(f"paged Hq{hq} Hkv{hkv} hd{hd}", hq, hkv, hd, 1))
            # bound: those pages, q read and out written, the new K/V read and written once
            bound_ms, bound_by = bound(4 * n_tokens * hq * hd,
                                       n_bytes + 2 * 2 * slots * hq * hd + 4 * 2 * slots * hkv * hd)
            log(f"  paged time bf16, 32 slots, Hq{hq} Hkv{hkv} hd{hd}, one layer, device time of a graph of the "
                f"{n_layers} layers in turn: kernel "
                f"{t_k:.4f} ms ({n_bytes / 1e6:.1f} MB of pages, {gbs:.0f} GB/s = {gbs / HBM_GBS:.1%} of 3.35 TB/s), "
                f"plain {t_p:.3f} ms; the same layer again and again (pages partly in L2): {t_same:.4f} ms graphed, "
                f"{t_eager:.4f} ms eager (the earlier design's timing); bound {bound_ms:.4f} ms ({bound_by}); "
                "no single PyTorch call computes it")
        del kp, vp, kp_ref, vp_ref
        torch.cuda.empty_cache()
    if long_context:
        log(f"  paged {paged_long_context(gen, 1, hd=hd, n_rep=n_rep)}")
    log(f"{tag}: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    t_k, t_p, t_same, t_eager, gbs = timing
    return {"max_abs_err": worst["bfloat16"], "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms_same_layer": t_same, "ms_same_layer_eager": t_eager,
            "gb_per_s": gbs}


def phase_paged_multi(gen, hq=32, hkv=8, hd=64, n_layers=16, tag="phase a paged multi-token verify",
                      long_context=True):
    import torch

    from ssi_tpu_torch.generate.paged import paged_attention

    slots, ps, max_ctx = 32, 128, 1280
    n_rep = hq // hkv
    max_pages = max_ctx // ps
    kernel, plain, _ = paged_call(4)
    layer = min(9, n_layers - 1)
    worst, row = {}, None
    for t_q in (4, 8):
        # history 0, a mid-page start, a span crossing a page, full context less T,
        # an inactive slot (6), a slot whose cap cuts its span (7), the rest ragged
        fixed = [0, 5, ps - 2, 3 * ps + 60, max_ctx - t_q, 700, 400, 2 * ps - 1]
        hist = fixed + torch.randint(1, max_ctx - t_q + 1, (slots - len(fixed),), generator=gen, device="cuda").tolist()
        hist = torch.tensor(hist, dtype=torch.int32, device="cuda")
        active = torch.ones(slots, dtype=torch.bool, device="cuda")
        active[6] = False
        cap = torch.full((slots,), max_ctx, dtype=torch.int32, device="cuda")
        cap[7] = 2 * ps + 1  # positions 2*ps-1 and 2*ps persist, the rest go to the trash row
        pos = hist[:, None] + torch.arange(t_q, device="cuda")[None, :]
        ok = active[:, None] & (pos < cap[:, None])
        landed = torch.cumprod(ok.int(), dim=1).bool()  # token t and every earlier one persisted
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            tol = TOL[key]
            kp, vp, q, kn, vn, per_layer = paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps, max_pages, n_layers,
                                                        hist, active, hd)
            trash = kp.shape[0] - 1
            per_layer = [(t, torch.where(ok, w, trash).to(torch.int32)) for t, w in per_layer]
            table, write_rows = per_layer[layer]
            kw = dict(k_new=kn, v_new=vn)
            kp_ref, vp_ref = kp.clone(), vp.clone()
            got = kernel(q, kp, vp, table, hist, write_rows=write_rows, **kw)
            again = kernel(q, kp, vp, table, hist, write_rows=write_rows, **kw)
            ref = plain(q, kp_ref, vp_ref, table, hist, write_rows=write_rows, **kw)
            # control: every in-flight token sees all T (the causal mask dropped)
            loose = torch.stack([paged_attention(q[:, t], kp_ref, vp_ref, table, hist + t_q) for t in range(t_q)], 1)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"paged multi T{t_q} {key}: two launches differ")
            a, w = got[landed].float(), ref[landed].float()
            err = (a - w).abs().max().item()
            check(torch.allclose(a, w, atol=tol, rtol=tol), f"paged multi T{t_q} {key}: max err {err} > tol {tol}")
            _, rel, ctrl = hold(f"paged multi T{t_q}", got[landed], ref[landed], key,
                                [("causal mask dropped", loose[landed])])
            check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
                  f"paged multi T{t_q} {key}: pools not bitwise equal outside the trash row")
            worst[key] = max(worst.get(key, 0.0), err)
            log(f"  paged multi T{t_q} Hq{hq} Hkv{hkv} hd{hd} {key:8s}: max|attn err| {err:.3e} (tol {tol}) over "
                f"{int(landed.sum())} landed "
                f"tokens, rel {rel:.2e} (limit {REL[key]}; control {ctrl:.2e}); two launches bitwise equal; pools "
                "bitwise equal except trash")
            if dtype == torch.bfloat16:
                elt = kp.element_size()
                n_hist = int(hist[active].sum().item())
                n_bytes_hist = n_hist * hkv * hd * elt * 2
                t_k, t_p, t_same, t_eager, gbs = paged_times(
                    lambda t, w: kernel(q, kp, vp, t, hist, write_rows=w, **kw),
                    lambda t, w: plain(q, kp_ref, vp_ref, t, hist, write_rows=w, **kw), per_layer, layer,
                    n_bytes_hist)
                log(f"  paged multi T{t_q} Hq{hq} Hkv{hkv} hd{hd} bf16: " + one_launch(
                    f"paged multi T{t_q} Hq{hq} Hkv{hkv} hd{hd}", hq, hkv, hd, t_q))
                # bound: the history K and V rows of active slots, q read and out written,
                # the new K/V read once and the persisted tokens written once
                n_bytes = (n_bytes_hist + 2 * slots * t_q * hq * hd * elt + 2 * slots * t_q * hkv * hd * elt
                           + int(ok.sum().item()) * hkv * hd * elt * 2)
                n_active = int(active.sum().item())
                ops = 4 * hq * hd * (t_q * n_hist + n_active * t_q * (t_q + 1) // 2)
                bound_ms, bound_by = bound(ops, n_bytes)
                log(f"  paged multi time bf16 T{t_q}, 32 slots, Hq{hq} Hkv{hkv} hd{hd}, one layer, device time of a "
                    f"graph of the {n_layers} layers in turn: kernel {t_k:.4f} ms ({gbs:.0f} GB/s of history pages = {gbs / HBM_GBS:.1%} of 3.35 "
                    f"TB/s), plain {t_p:.3f} ms; the same layer again and again: {t_same:.4f} ms graphed, "
                    f"{t_eager:.4f} ms eager (the earlier design's timing); bound {bound_ms:.4f} ms "
                    f"({bound_by}); no single PyTorch call computes it")
                if t_q == 4:  # the main path's T (speculate_k=3)
                    row = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                           "ms_same_layer": t_same, "ms_same_layer_eager": t_eager, "gb_per_s": gbs}
                else:
                    row_t8 = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "gb_per_s": gbs}
            del kp, vp, kp_ref, vp_ref
            torch.cuda.empty_cache()
    if long_context:
        log(f"  paged multi T4 {paged_long_context(gen, 4, hd=hd, n_rep=n_rep)}")
    log(f"{tag}: ok (max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return {"max_abs_err": worst["bfloat16"], **row, "t8": row_t8}


def model_config(name: str = "llama3_2_1b", num_layers: int | None = None):
    """The registry's ``name`` extended with 5,000 DSUs and 2 modality tokens
    (vocab 133,258), its depth cut to ``num_layers`` when given."""
    from ssi_tpu_torch.models.configs import get_model_config

    cfg = get_model_config(name)
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    if num_layers is not None:
        cfg.num_layers = num_layers
    return cfg


def prompts_from_seed(seed: int, n: int, vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).tolist() for m in rng.integers(32, 701, n)]


def plain_hidden(params, tokens, cfg):
    """The decoder through the plain attention on the card (no kernel, no
    remat): the reference the kernel paths are held to."""
    import torch

    from ssi_tpu_torch.models.llama3 import block, rms_norm, rope_for_positions
    from ssi_tpu_torch.ops.attention import reference_attention

    b, s = tokens.shape
    cos, sin = rope_for_positions(torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s), cfg)
    h = params["embed"][tokens]
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        h = block(h, dict(zip(names, weights)), cos, sin, cfg,
                  lambda q, k, v: reference_attention(q, k, v, causal=True))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def plain_loss(params, tokens, labels, cfg):
    """``make_loss_fn``'s loss sum through the plain attention and the plain cross-entropy."""
    from ssi_tpu_torch.models.llama3 import unembed
    from ssi_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ssi_tpu_torch.train.step import shift_labels

    h = plain_hidden(params, tokens, cfg)
    return fused_cross_entropy(h.reshape(-1, h.shape[-1]), unembed(params), shift_labels(labels).reshape(-1))


def naive_greedy(params, cfg, prompt, n_tokens):
    """Full-recompute greedy decode (plain attention, no cache, no kernel)."""
    import torch

    from ssi_tpu_torch.models.llama3 import logits

    toks = list(prompt)
    for _ in range(n_tokens):
        x = torch.tensor([toks], dtype=torch.int64, device="cuda")
        h = plain_hidden(params, x, cfg)[:, -1]
        toks.append(int(torch.argmax(logits(params, h), dim=-1).item()))
    return toks[len(prompt):]


def phase_engine_f32(seed: int, cfg=None, tag: str = "phase 4 engine f32 (1B width"):
    import torch

    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = cfg or model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    prompts = prompts_from_seed(seed, 4, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    outs = {}
    for impl in ("kernel", "reference"):
        eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=4, attn_impl=impl)
        outs[impl] = eng.generate_batch(prompts, sp)
        del eng
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["reference"])):
        check(a["token_ids"] == b["token_ids"], f"f32 engine prompt {i}: kernel {a['token_ids']} != plain {b['token_ids']}")
        check(len(a["token_ids"]) == 16, f"f32 engine prompt {i}: {len(a['token_ids'])} tokens")
    dlp = max(abs(a["cumulative_logprob"] - b["cumulative_logprob"]) for a, b in zip(outs["kernel"], outs["reference"]))
    oracle = naive_greedy(params, cfg, prompts[0], 16)
    check(outs["kernel"][0]["token_ids"] == oracle, f"f32 engine prompt 0 != full-recompute greedy {oracle}")
    log(f"{tag}, vocab {cfg.vocab_size}): 4 prompts x 16 greedy tokens identical "
        f"kernel vs plain and vs full recompute; max |cum logprob diff| {dlp:.2e}")
    del params
    torch.cuda.empty_cache()


def phase_spec_f32(seed: int, cfg=None, tag: str = "phase b spec f32 (1B width)"):
    import numpy as np
    import torch

    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = cfg or model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 4)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    # a shared 256-token prefix (two cacheable pages), then content said twice
    prompts = []
    for n in (40, 64, 90, 120):
        part = rng.integers(0, cfg.vocab_size, n).tolist()
        prompts.append(prefix + part + part)
    sp = SamplingParams(temperature=0.0, max_tokens=32)
    outs, stats = {}, {}
    for impl in ("kernel", "reference"):
        for k in (0, 3):
            eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=4, attn_impl=impl, speculate_k=k)
            outs[impl, k] = [o["token_ids"] for o in eng.generate_batch(prompts, sp)]
            stats[impl, k] = dict(eng.last_stats)
            del eng
    for impl in ("kernel", "reference"):
        check(outs[impl, 3] == outs[impl, 0], f"f32 spec ({impl}): speculate_k=3 tokens differ from speculate_k=0")
        st = stats[impl, 3]
        check(st["cached_prompt_tokens"] > 0 and st["verify_steps"] > 0,
              f"f32 spec ({impl}): cached_prompt_tokens {st['cached_prompt_tokens']}, verify_steps {st['verify_steps']}")
    check(outs["kernel", 3] == outs["reference", 3], "f32 spec: kernel and plain tokens differ")
    st = stats["kernel", 3]
    log(f"{tag}: 4 prompts (256-token shared prefix, repeated content) x 32 greedy tokens "
        f"identical for speculate_k 3 and 0, kernels and plain; cached prompt tokens {st['cached_prompt_tokens']}, "
        f"verify steps {st['verify_steps']}, tokens per verify {st['tokens_per_verify']:.3f}")
    del params
    torch.cuda.empty_cache()


def phase_engine_bf16(seed: int, smi: str):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=128)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16)
    check(eng.attn_impl == "kernel", f"engine on CUDA resolved attn_impl {eng.attn_impl!r}")
    eng.generate_batch(prompts[:8], SamplingParams(max_tokens=16))  # warm-up: CUDA/cuBLAS first-use costs
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
              f"request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"request {i}: token out of vocab")
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages, f"pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    n_tok = sum(len(o["token_ids"]) for o in outs)
    s = eng.last_stats
    log(f"phase 5 engine bf16 main path: 64 requests x 128 tokens, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.0f} generated tok/s on {smi} (wall clock incl. prefill, after a warm-up batch; "
        f"{s['chunk_dispatches']} chunks, "
        f"{s['prefill_dispatches']} prefill dispatches, occupancy {s['slot_occupancy']:.3f}); launches {launches}")
    return launches, [o["token_ids"] for o in outs], n_tok / wall


def phase_spec_serving(seed: int, smi: str, base_tokens, base_rate: float):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16,
                            speculate_k=3, prefill_chunk=512)
    check(eng.attn_impl == "kernel" and eng.prefix_caching, "spec engine: not the kernels with the prefix cache")
    eng.generate_batch(prompts_from_seed(seed + 5, 8, cfg.vocab_size), SamplingParams(max_tokens=16))  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=128))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
              f"spec request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"spec request {i}: token out of vocab")
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages, f"spec serving: pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_multi"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the speculative serving path")
    s = eng.last_stats
    same = sum(o["token_ids"] == b for o, b in zip(outs, base_tokens))
    agree = [next((i for i, (x, y) in enumerate(zip(o["token_ids"], b)) if x != y), len(b))
             for o, b in zip(outs, base_tokens)]
    n_tok = sum(len(o["token_ids"]) for o in outs)
    log(f"phase c spec serving bf16 (speculate_k 3, prefix cache, prefill_chunk 512): 64 requests x 128 tokens, "
        f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.0f} generated tok/s (phase 5, k=0: {base_rate:.0f}) on "
        f"{smi}; tokens per verify {s['tokens_per_verify']:.3f}, {s['verify_steps']} verify steps, "
        f"{s['chunk_dispatches']} chunks, {s['prefill_dispatches']} prefill dispatches ({s['prefill_pieces']} "
        f"chunked pieces), cached prompt tokens {s['cached_prompt_tokens']}; {same}/64 requests equal to phase 5's "
        f"tokens, mean agreeing prefix {sum(agree) / len(agree):.1f} of 128; launches {launches}")
    del eng, params
    torch.cuda.empty_cache()
    return launches


# --- phase o: tensor-parallel serving in a tp group of one rank --------------------------------


def phase_serve_tp(seed: int, smi: str, base_rate: float) -> dict:
    """Phase o: phase 5's requests through the engine with a tp-1 mesh over a
    1-rank NCCL group and without a mesh, at k 0 and 3, pipeline depth 1;
    the mesh runs' tokens bitwise equal the mesh-less runs'. Returns the
    mesh runs' launches."""
    import socket

    import torch
    import torch.distributed as dist

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.parallel import Mesh, make_mesh

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)  # phase 5's requests
    warm = prompts_from_seed(seed + 5, 8, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=128)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    launches: dict[str, int] = {}
    try:
        # "mesh": the tp-1 mesh over the NCCL group; "local": the same tp path
        # with no process group (every collective skipped), which sets apart
        # what the NCCL calls cost
        meshes = {"none": None, "mesh": make_mesh(dp=1, tp=1), "local": Mesh(dp=1, tp=1)}
        check(meshes["mesh"].tp_group is not None and dist.get_backend(meshes["mesh"].tp_group) == "nccl",
              "phase o: the tp-1 mesh carries no NCCL group")
        for k, order in ((0, ("none", "mesh", "local", "none")), (3, ("none", "mesh"))):
            tokens, rates = {}, {name: [] for name in set(order)}
            for name in order:
                eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128,
                                        chunk=16, speculate_k=k, pipeline_depth=1, mesh=meshes[name])
                check(eng.attn_impl == "kernel" and eng.is_driver, f"phase o: {name} engine not the kernels' driver")
                check(eng.params["embed"] is params["embed"], f"phase o: the {name} engine copied the whole weights")
                eng.generate_batch(warm, SamplingParams(max_tokens=16))
                torch.cuda.synchronize()
                _build.launch_counts.clear()
                t0 = time.perf_counter()
                outs = eng.generate_batch(prompts, sp)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if name == "mesh":
                    for key, n in _build.launch_counts.items():
                        launches[key] = launches.get(key, 0) + n
                for i, o in enumerate(outs):
                    check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
                          f"phase o k={k} {name} request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
                parked = len(eng._free_pages) + len(eng._cache_lru)
                check(parked == eng.n_pages, f"phase o k={k} {name}: pages leaked: {eng.n_pages - parked}")
                run = [o["token_ids"] for o in outs]
                check(tokens.setdefault(name, run) == run, f"phase o k={k}: two {name} runs differ")
                rates[name].append(sum(map(len, run)) / wall)
                eng.close()
                del eng
                torch.cuda.empty_cache()
            for name in tokens:
                same = sum(a == b for a, b in zip(tokens[name], tokens["none"]))
                check(same == 64, f"phase o k={k}: {64 - same} of 64 {name} streams differ from the mesh-less engine's")
            mean = {n: sum(r) / len(r) for n, r in rates.items()}
            local = (f", tp path without a process group {', '.join(f'{r:.0f}' for r in rates['local'])} tok/s, "
                     f"local / none {mean['local'] / mean['none']:.3f}" if "local" in rates else "")
            log(f"phase o serve_tp k={k} (1B bf16, phase 5's 64 requests x 128 greedy tokens, 32 slots, depth 1, "
                f"runs in turns {', '.join(order)}): tp-1 mesh in a 1-rank NCCL group "
                f"{', '.join(f'{r:.0f}' for r in rates['mesh'])} tok/s, no mesh "
                f"{', '.join(f'{r:.0f}' for r in rates['none'])} tok/s, mesh / none {mean['mesh'] / mean['none']:.3f}"
                f"{local} (phase 5, depth 2: {base_rate:.0f}); every stream bitwise the mesh-less engine's; on {smi}")
    finally:
        dist.destroy_process_group()
    for name in ("flash_attention_fwd", "paged_attention_fused", "paged_attention_multi"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the tp serving path")
    log(f"phase o launches (mesh runs, k 0 and 3): {launches}; phase wall {time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()
    return launches


# torchrun's script for phase o's two-card check: the generation CLI's module
# run as ``python -m`` runs it, with rank 0's first decode step's logits (the
# rows it advances) saved to argv[1]
TP_LAUNCHER = """
import os, runpy, sys
import torch
import ssi_tpu_torch.generate.paged_engine as pe

out = sys.argv[1]
sys.argv = ["ssi_tpu_torch.cli.generate", *sys.argv[2:]]
orig, saved = pe.decode_step_tokens, []

def recorded(params, tok, cfg, pools, page_table, seq_lens, active, **kw):
    logits = orig(params, tok, cfg, pools, page_table, seq_lens, active, **kw)
    if not saved and os.environ.get("RANK", "0") == "0":
        saved.append(out)
        torch.save(logits[active].float().cpu(), out)
    return logits

pe.decode_step_tokens = recorded
runpy.run_module("ssi_tpu_torch.cli.generate", run_name="__main__")
"""


def phase_tp2_cli(root, argv: list[str], smi: str) -> None:
    """Phase o's two-card check, on phase d's ``step_0/``: the generation CLI
    under torchrun at ``tensor_parallel`` 1 and 2 (one rank, then two ranks
    on cards 0 and 1); their first decode step's logits within 1e-2 in
    relative norm, their token agreement reported."""
    import torch

    launcher = root / "tp_launcher.py"
    launcher.write_text(TP_LAUNCHER)
    logits, records = {}, {}
    for tp in (1, 2):
        out = root / f"tp{tp}"
        env = {**os.environ, "PYTHONPATH": REPO}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                               str(tp), str(launcher), str(root / f"tp{tp}_logits.pt"), *argv,
                               f"gen.output_dir={out}", f"tensor_parallel={tp}"],
                              cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            log(proc.stdout[-3000:] + proc.stderr[-3000:])
        check(proc.returncode == 0, f"phase o tp{tp}: the generation CLI under torchrun exited {proc.returncode}")
        log(f"  phase o tp{tp} CLI under torchrun: {time.perf_counter() - t0:.1f} s")
        logits[tp] = torch.load(root / f"tp{tp}_logits.pt")
        records[tp] = [json.loads(line)["outputs"][0]["token_ids"] for line in
                       (out / "json" / "test" / "generations.jsonl").read_text().splitlines()]
    err = rel_err(logits[2], logits[1])
    check(logits[2].shape == logits[1].shape and err <= REL["bfloat16"],
          f"phase o tp2: first-step logits {tuple(logits[2].shape)} vs {tuple(logits[1].shape)}, rel {err:.2e}")
    same = sum(a == b for a, b in zip(records[2], records[1]))
    log(f"phase o tp2 (generation CLI, torchrun --nproc_per_node 2 tensor_parallel=2, NCCL, 1B bf16, "
        f"{len(records[2])} records): first decode step's logits rel {err:.2e} of tp 1's (limit {REL['bfloat16']}); "
        f"{same}/{len(records[2])} records equal tp 1's tokens (bf16: reported, not required); on {smi}")


# --- phase j: n > 1 parallel sampling and the pipeline depth -----------------------------------


def phase_gangs_and_depth(seed: int, smi: str, base_tokens, base_rate: float):
    """Phases j1 and j3 on phase 5's random bf16 1B weights: 16 of phase 5's
    prompts as n=4 greedy gangs, then phase 5's 64 requests at pipeline
    depth 1 and 2, a run each. Returns the gang run's launches."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    kw = dict(n_slots=32, page_size=128, prompt_bucket=128, chunk=16)

    # j1: 16 prompts x n=4 greedy; the default pool (32 slots x 10 pages) holds
    # 8 gangs of 4 at once, so no gang splits and no admission rolls back
    gang = prompts[:16]
    eng = PagedDecodeEngine(params, cfg, pad_id=0, **kw)
    eng.generate_batch(prompts_from_seed(seed + 5, 4, cfg.vocab_size), SamplingParams(n=2, max_tokens=16))  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(gang, SamplingParams(n=4, temperature=0.0, max_tokens=128))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check(len(outs) == 64, f"gangs: {len(outs)} outputs for 16 prompts x n 4")
    for i in range(16):
        seqs = [o["token_ids"] for o in outs[4 * i : 4 * i + 4]]
        check(all(o["finish_reason"] == "length" for o in outs[4 * i : 4 * i + 4]) and len(seqs[0]) == 128,
              f"gang {i}: not 4 x 128 tokens")
        check(all(s == seqs[0] for s in seqs), f"gang {i}: the 4 greedy siblings differ")
    s = dict(eng.last_stats)
    want_shared = sum(3 * ((len(p) - 1) // 128) for p in gang)
    check(s["pages_shared"] == want_shared, f"gangs: pages_shared {s['pages_shared']} != {want_shared}")
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages and not eng._page_refs.any(), f"gangs: pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the n > 1 path")
    same5 = sum(outs[4 * i]["token_ids"] == base_tokens[i] for i in range(16))
    n_tok = sum(len(o["token_ids"]) for o in outs)
    log(f"phase j1 gangs bf16 (1B, 32 slots, 16 prompts of {min(map(len, gang))}-{max(map(len, gang))} tokens x "
        f"n 4 x 128 greedy tokens): {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.0f} generated tok/s on {smi}; "
        f"every gang's 4 siblings equal token for token; pages_shared {s['pages_shared']} == sum 3 x floor((p-1)/128); "
        f"pages balance; {s['prefill_rows']} prefill rows for 64 sequences, {s['chunk_dispatches']} chunks, occupancy "
        f"{s['slot_occupancy']:.3f}; {same5}/16 leaders equal to phase 5's tokens (bf16, other batches: reported); "
        f"launches {launches}")
    del eng
    torch.cuda.empty_cache()

    # j3: phase 5's run at depth 1 and 2, in turns (each engine fresh, with
    # phase 5's warm-up: its 8 prompts leave the same prefix-cache hits)
    readings = {1: [], 2: []}
    for depth in (1, 2):
        eng = PagedDecodeEngine(params, cfg, pad_id=0, pipeline_depth=depth, **kw)
        eng.generate_batch(prompts[:8], SamplingParams(max_tokens=16))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=128))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(o["finish_reason"] == "length" and len(o["token_ids"]) == 128 for o in outs),
              f"depth {depth}: a request did not finish with 128 tokens")
        parked = len(eng._free_pages) + len(eng._cache_lru)
        check(parked == eng.n_pages, f"depth {depth}: pages leaked: {eng.n_pages - parked}")
        s = eng.last_stats
        readings[depth].append({
            "tok_s": sum(len(o["token_ids"]) for o in outs) / wall, "wall_s": wall,
            "harvest_block_s": s["harvest_block_s"], "dispatch_block_s": s["dispatch_block_s"],
            "prefill_block_s": s["prefill_block_s"], "slot_occupancy": s["slot_occupancy"],
            "chunk_dispatches": s["chunk_dispatches"],
            "equal_to_phase_5": sum(o["token_ids"] == b for o, b in zip(outs, base_tokens))})
        del eng
    for depth, runs in readings.items():
        log(f"phase j3 depth {depth} (phase 5's 64 requests x 128 greedy tokens, 32 slots, chunk 16; one run each, "
            f"depth 1 first) on {smi}: " + "; ".join(
                f"{r['tok_s']:.0f} tok/s ({r['wall_s']:.2f} s), harvest wait {r['harvest_block_s']:.3f} s, dispatch "
                f"{r['dispatch_block_s']:.3f} s, prefill enqueue {r['prefill_block_s']:.3f} s, occupancy "
                f"{r['slot_occupancy']:.3f}, {r['chunk_dispatches']} chunks, {r['equal_to_phase_5']}/64 equal to "
                f"phase 5's tokens" for r in runs))
    ratio = (sum(r["tok_s"] for r in readings[2]) / sum(r["tok_s"] for r in readings[1]))
    log(f"phase j3: depth 2 / depth 1 tok/s {ratio:.3f} (one run each; phase 5: {base_rate:.0f} tok/s; "
        "bf16 batches depend on timing at depth 2, so token agreement is reported, not required)")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_paged_shared(gen, hq=32, hkv=8, hd=64, n_layers=16, n=4):
    """Phase j2: #8 vs its plain version on a page table in which each gang
    of ``n`` slots shares its prompt's read-only pages and each slot owns its
    boundary page (copied from the leader's by ``copy_pages``) and the pages
    after it; 32 slots, page 128, prompts 32-700 tokens, 0-127 tokens decoded."""
    import torch

    from ssi_tpu_torch.generate.paged import copy_pages, paged_attention

    kernel, plain, _ = paged_call(1)
    slots, ps, max_pages, layer = 32, 128, 10, min(5, n_layers - 1)
    n_rep = hq // hkv
    n_pages = slots * max_pages
    rows = n_layers * n_pages + 1
    plens = torch.randint(32, 701, (slots // n,), generator=gen, device="cuda").tolist()
    decoded = torch.randint(0, 128, (slots,), generator=gen, device="cuda").tolist()
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    logical = torch.zeros((slots, max_pages), dtype=torch.int32)
    shared, copies = set(), []
    for g, p in enumerate(plens):
        shared_n = (p - 1) // ps
        prefix = [perm.pop() for _ in range(shared_n)]
        shared.update(prefix)
        for j in range(n):
            own = [perm.pop() for _ in range(max_pages - shared_n)]
            logical[g * n + j] = torch.tensor(prefix + own, dtype=torch.int32)
            if j:
                copies.append((int(logical[g * n, shared_n]), own[0]))
    logical = logical.cuda()
    hist = torch.tensor([plens[i // n] - 1 + decoded[i] for i in range(slots)], dtype=torch.int32, device="cuda")
    seq_lens = hist + 1
    shared_rows = torch.tensor([layer_ * n_pages + pg for layer_ in range(n_layers) for pg in sorted(shared)],
                               dtype=torch.long, device="cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        tol = TOL[key]
        pools = {name: torch.randn((rows, ps, hkv * hd), generator=gen, device="cuda").to(dtype) for name in "kv"}
        src, dst = (torch.tensor(c, dtype=torch.int32, device="cuda") for c in zip(*copies))
        copy_pages(pools, src, dst, n_pages=n_pages)
        for s_pg, d_pg in copies:
            check(all(torch.equal(pools[nm][l_ * n_pages + d_pg], pools[nm][l_ * n_pages + s_pg])
                      for nm in "kv" for l_ in range(n_layers)), "copy_pages: a boundary page differs from its source")
        kp, vp = pools["k"], pools["v"]
        q = torch.randn((slots, hq, hd), generator=gen, device="cuda").to(dtype)
        kn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
        vn = torch.randn((slots, hkv, hd), generator=gen, device="cuda").to(dtype)
        table = (layer * n_pages + logical).to(torch.int32)
        write_rows = torch.gather(table, 1, (hist // ps).long()[:, None])[:, 0].to(torch.int32)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        before_k, before_v = kp[shared_rows].clone(), vp[shared_rows].clone()
        got = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, k_new=kn, v_new=vn)
        ref = plain(q, kp_ref, vp_ref, table, seq_lens, write_rows=write_rows, k_new=kn, v_new=vn)
        ctrl_out = paged_attention(q.roll(n_rep, 1), kp_ref, vp_ref, table, seq_lens)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
              f"paged attention on a shared table {key}: max err {err} > tol {tol}")
        _, rel, ctrl = hold("paged attention on a shared table", got, ref, key, [("kv heads shifted", ctrl_out)])
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"shared-table pools {key}: the kernel's writes differ from the plain version's")
        check(torch.equal(kp[shared_rows], before_k) and torch.equal(vp[shared_rows], before_v),
              f"shared-table pools {key}: a shared page changed")
        worst[key] = err
        log(f"  paged shared table {key:8s}: max|attn err| {err:.3e} (tol {tol}), rel {rel:.2e} (limit {REL[key]}; "
            f"control {ctrl:.2e}); written pools equal the plain version's; {len(shared)} shared pages unchanged")
        del pools, kp, vp, kp_ref, vp_ref
        torch.cuda.empty_cache()
    log(f"phase j2 paged decode (#8) on a shared page table ({slots // n} gangs of {n} slots, Hq{hq} Hkv{hkv} "
        f"hd{hd}, {n_layers} layers, {len(copies)} boundary pages copied): ok (max err f32 {worst['float32']:.3e}, "
        f"bf16 {worst['bfloat16']:.3e})")


def phase_parallel_f32(seed: int, cfg=None, tag: str = "phase j4 f32 (1B width, 2 of 16 layers)"):
    """Phase j4, the kernels in f32: depth 2 == depth 1, n=3 greedy == the
    n=1 stream, a seeded n=3 sampled stream reproduces itself at depth 2 and
    its siblings differ, top-k 1 == greedy. Six prompts on 32 slots: every
    gang is admitted in the first round, so both runs of a pair batch alike."""
    import torch

    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = cfg or model_config(num_layers=2)
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    prompts = prompts_from_seed(seed + 11, 6, cfg.vocab_size)

    def run(sp, depth=2, run_seed=0):
        eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, attn_impl="kernel", pipeline_depth=depth)
        out = [o["token_ids"] for o in eng.generate_batch(prompts, sp, seed=run_seed)]
        check(len(eng._free_pages) + len(eng._cache_lru) == eng.n_pages, "f32 parallel sampling: pages leaked")
        return out

    greedy = run(SamplingParams(max_tokens=32), depth=1)
    check(run(SamplingParams(max_tokens=32)) == greedy, "f32: depth 2 tokens differ from depth 1's")
    n3 = run(SamplingParams(n=3, max_tokens=32))
    check(n3 == [g for g in greedy for _ in range(3)], "f32: n=3 greedy siblings differ from the n=1 stream")
    samp = SamplingParams(n=3, temperature=0.8, max_tokens=32)
    a, b = run(samp, run_seed=7), run(samp, run_seed=7)
    check(a == b, "f32: a seeded n=3 sampled stream does not reproduce itself at depth 2")
    differ = sum(len({tuple(s) for s in a[3 * i : 3 * i + 3]}) > 1 for i in range(len(prompts)))
    check(differ == len(prompts), f"f32: the sampled siblings of {len(prompts) - differ} prompts are all equal")
    top1 = run(SamplingParams(n=3, temperature=0.8, top_k=1, max_tokens=32), run_seed=7)
    check(top1 == n3, "f32: top-k 1 sampling differs from greedy")
    log(f"{tag}: 6 prompts x 32 tokens, kernels: depth 2 == depth 1, n=3 greedy == the n=1 stream, a seeded "
        f"n=3 sampled stream (temperature 0.8) reproduces itself with siblings apart in {differ}/6 prompts, "
        "top-k 1 == greedy")
    del params
    torch.cuda.empty_cache()


# --- phase d: the generation entry point ------------------------------------------------------


def write_model_files(step, cfg) -> None:
    """``config.json``, ``generation_config.json`` and ``original/params.json``,
    as ``tests/helpers.py`` ``make_tiny_hf_checkpoint`` writes them (``(step /
    "original")`` must exist)."""
    first_special = cfg.base_vocab_size_txt + cfg.n_dsus + 2 * cfg.modality_tokens
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "vocab_size": cfg.vocab_size,
        "bos_token_id": first_special,
        "eos_token_id": first_special + 1,
        "tie_word_embeddings": cfg.tied_embeddings,
        "rope_theta": float(cfg.rope_base),
        "max_position_embeddings": cfg.max_seq_len,
    }
    (step / "config.json").write_text(json.dumps(config, indent=2))
    (step / "generation_config.json").write_text(
        json.dumps({"bos_token_id": config["bos_token_id"], "eos_token_id": config["eos_token_id"]}, indent=2))
    (step / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}, indent=2))


def split_rows(seed: int, n: int, n_dsus: int) -> list[dict]:
    """``n`` rows of speech tokens (no two neighbours equal, so deduplication
    keeps every one) and a transcript of task words. The conf system prompt
    takes about 95 tokens of the synthesized vocabulary, so speech spans of
    10-640 tokens make prompts of about 105-740 tokens (phase 5's: 32-700)."""
    import numpy as np

    from ssi_tpu_torch.wer_drive import WORDS

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        m = int(rng.integers(10, 641))
        steps = rng.integers(1, n_dsus, m)  # a nonzero step mod n_dsus: never a repeat
        tokens = (int(rng.integers(0, n_dsus)) + np.cumsum(steps)) % n_dsus
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), 10)]
        rows.append({"speech_tokens": tokens.tolist(), "transcript": " ".join(words), "ID": f"utt_{i}"})
    return rows


def run_cli(main, argv):
    """A CLI ``main`` run in this process; its job logging (a console and a
    file handler on the root logger) ends with it. Returns (result, wall s)."""
    import torch

    root_logger = logging.getLogger()
    saved = root_logger.level, list(root_logger.handlers)
    t0 = time.perf_counter()
    try:
        out = main(argv)
        torch.cuda.synchronize()
    finally:
        for handler in root_logger.handlers:
            if handler not in saved[1]:
                handler.close()
        root_logger.handlers = saved[1]
        root_logger.setLevel(saved[0])
    return out, time.perf_counter() - t0


class PrefillRounds:
    """Records each admission round of every engine built while it is
    active (a wrapper around ``PagedDecodeEngine._prefill_admitted``): the
    round's prompts and their prefix-cache hits, which fix its prefill
    passes. At pipeline depth 2 which prompts share a round depends on when
    each chunk's results reach the host, and bf16 prefill products of other
    batches round otherwise; a prompt's decode steps do not depend on the
    other slots."""

    def __enter__(self):
        from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine

        self.cls, self.orig, self.rounds = PagedDecodeEngine, PagedDecodeEngine._prefill_admitted, []
        orig, rounds = self.orig, self.rounds

        def recorded(eng, admitted):
            rounds.append(tuple((tuple(eng._slots[sid].req.prompt), eng._slots[sid].cached_len) for sid, _ in admitted))
            return orig(eng, admitted)

        PagedDecodeEngine._prefill_admitted = recorded
        return self

    def __exit__(self, *exc):
        self.cls._prefill_admitted = self.orig

    def by_prompt(self) -> dict:
        """Each prompt's last round (a later run of a prompt replaces a warm-up's)."""
        return {prompt: r for r in self.rounds for prompt, _ in r}


def flat_params(p) -> dict:
    return {**{k: v for k, v in p.items() if k != "layers"}, **p["layers"]}


def phase_generate_cli(seed: int, smi: str, base_tokens, base_rate: float):
    """Phase d: ``python -m ssi_tpu_torch.cli.generate``'s ``main``, run in this
    process on a synthesized ``step_0/`` (128,000-entry base tokenizer + 5,000
    DSUs + 2 modality tokens, random bf16 1B weights written through
    ``internal_to_hf`` and the port's safetensors writer) and a 64-row
    JSON-lines test split, with the WER drive's overrides."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.checkpoint.convert import internal_to_hf
    from ssi_tpu_torch.checkpoint.safetensors_io import save_file
    from ssi_tpu_torch.cli.generate import CONF_DIR, main as generate_main
    from ssi_tpu_torch.config import compose, load_yaml, to_container
    from ssi_tpu_torch.extend import extend_tiktoken
    from ssi_tpu_torch.generate import last_run_stats, resolve_gen_output_dir
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from ssi_tpu_torch.wer_drive import WORDS, build_base_tokenizer

    cfg = model_config()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_generate_"))
    try:
        step = root / "experiments" / "run" / "checkpoints" / "step_0"
        tok_path = step / "original" / "tokenizer.model"
        t0 = time.perf_counter()
        build_base_tokenizer(tok_path, WORDS)
        extend_tiktoken(cfg.n_dsus, cfg.modality_tokens, tok_path, tok_path)
        written = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
        save_file(internal_to_hf(written, cfg), step / "model.safetensors", metadata={"format": "pt"})
        write_model_files(step, cfg)
        split = root / "test.jsonl"
        split.write_text("".join(json.dumps(r) + "\n" for r in split_rows(seed + 7, 64, cfg.n_dsus)))
        t_synth = time.perf_counter() - t0

        argv = [
            f"model={step}", f"experiments_root_dir={root / 'experiments'}",
            f"tokenizer.path={tok_path}", f"speech.n_dsus={cfg.n_dsus}",
            "data=sft/mls-hubert_large_ll60k-layer_22",
            "data.test.dataset.source=json", f"+data.test.dataset.data_files={split}", "data.test.dataset.split=train",
            "gen.split=test", "batch_size=32", "sampling_params.max_tokens=128", "dtype=bf16", "observability=true",
        ]
        _build.launch_counts.clear()
        with PrefillRounds() as cli_rounds:
            _, wall = run_cli(generate_main, argv)
        launches = dict(_build.launch_counts)
        stats = dict(last_run_stats)

        out_dir = step.parents[1] / "generations" / "step_0" / "json" / "test"
        records = [json.loads(line) for line in (out_dir / "generations.jsonl").read_text().splitlines()]
        check(len(records) == 64, f"generate: {len(records)} records, expected 64")
        for r in records:
            outs = r["outputs"]
            check(r["finished"] is True and len(outs) == 1, f"record {r['request_id']}: not one finished output")
            o = outs[0]
            check(o["finish_reason"] in ("stop", "length") and 0 < len(o["token_ids"]) <= 128,
                  f"record {r['request_id']}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
            check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"record {r['request_id']}: token out of vocab")
        for name in ("flash_attention_fwd", "paged_attention_fused"):
            check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the generation entry point")

        # the snapshot reads back (the port's YAML reader) to the config that ran
        ran = compose(CONF_DIR, "generate", overrides=argv)
        ran.gen.output_dir = resolve_gen_output_dir(ran)
        check(load_yaml(out_dir / "generation_config.yaml") == to_container(ran, resolve=True),
              "generation_config.yaml does not read back to the resolved config")

        # the loaded parameters are the written ones, bit for bit
        loaded = Checkpointer(step, output_dir=root / "scratch",
                              model_expectations=cfg.checkpoint_expectations).load_params(cfg, torch.bfloat16, "cuda")
        for name, w in flat_params(written).items():
            check(torch.equal(flat_params(loaded)[name], w), f"loaded {name} differs from the written weights")
        del written

        # the run's tokens == a direct engine call on the same prompts and loaded
        # parameters (same settings and pipeline depth, the CLI's default; same
        # two-prompt warm-up first: the kernels are bitwise repeatable and the
        # warm-up leaves the same prefix cache). Every record must match when
        # both runs prefilled in the same rounds; otherwise every record whose
        # prompt was prefilled in a matching round, and the schedules print
        tokenizer, _ = setup_llama3_tokenizer(tok_path, verbose=False)
        prompts = [r["prompt_token_ids"] for r in records]
        sp = SamplingParams(max_tokens=128, stop_token_ids=tuple(tokenizer.stop_tokens))
        eng = PagedDecodeEngine(loaded, cfg, pad_id=tokenizer.pad_id, n_slots=32,
                                max_context=max(map(len, prompts)) + 128)
        check(eng.attn_impl == "kernel", f"direct engine resolved attn_impl {eng.attn_impl!r}")
        with PrefillRounds() as direct_rounds:
            eng.generate_batch(prompts[:2], sp)
            direct = eng.generate_batch(prompts, sp)
        equal = [d["token_ids"] == r["outputs"][0]["token_ids"] for d, r in zip(direct, records)]
        cli_sig, direct_sig = cli_rounds.by_prompt(), direct_rounds.by_prompt()
        matched = [cli_sig.get(tuple(p)) == direct_sig.get(tuple(p)) for p in prompts]
        same = sum(equal)
        if all(matched):
            check(same == 64, f"generate: {64 - same} of 64 records differ from a direct engine call "
                  "that prefilled in the same rounds")
            schedule_note = "both runs prefilled in the same rounds; all 64 records equal a direct engine call"
        else:
            log(f"  phase d prefill rounds differ (sizes): CLI {[len(r) for r in cli_rounds.rounds]}, direct "
                f"{[len(r) for r in direct_rounds.rounds]}")
            bad = sum(m and not e for e, m in zip(equal, matched))
            check(bad == 0, f"generate: {bad} records prefilled in matching rounds differ from a direct engine call")
            schedule_note = (f"prefill rounds differ: the {sum(matched)} records of matching rounds equal a direct "
                             f"engine call ({same}/64 in all)")

        rate = records[0]["metrics"]["batch_tokens_per_second"]
        n_tok = records[0]["metrics"]["batch_generated_tokens"]
        lens = [len(r["prompt_token_ids"]) for r in records]
        stops = sum(r["outputs"][0]["finish_reason"] == "stop" for r in records)
        log(f"phase d generate CLI (1B bf16, 64 records, prompts {min(lens)}-{max(lens)} tokens): synthesis "
            f"{t_synth:.2f} s; checkpoint load {stats['load_s']:.2f} s = "
            f"{stats['load_bytes'] / 1e9 / stats['load_s']:.2f} GB/s ({stats['load_bytes'] / 1e9:.3f} GB); "
            f"tokenization {stats['tokenize_s']:.3f} s; warm-up {stats['warmup_s']:.2f} s; generate "
            f"{stats['generate_s']:.2f} s, {n_tok} tokens = {rate:.0f} generated tok/s (phase 5: {base_rate:.0f}); "
            f"CLI wall {wall:.2f} s; {stops} stopped early; {schedule_note}; on {smi}; "
            f"launches {launches}")
        del eng
        torch.cuda.empty_cache()
        # phase o's two-card check runs the CLI under torchrun on this step_0/
        if torch.cuda.device_count() >= 2:
            phase_tp2_cli(root, [a for a in argv if not a.startswith("observability")], smi)
        else:
            log("tp2: 1 card, not run")
        # phase i serves this step_0/ over HTTP before it is deleted (no second checkpoint)
        http_launches = phase_serve_http(seed, smi, step, tok_path, loaded, base_tokens, base_rate, rate)
        del loaded
        torch.cuda.empty_cache()
        # phase l runs the dense engine on this step_0/ and split before they are deleted
        t0 = time.perf_counter()
        phase_dense(seed, smi, root, step, argv, records, rate)
        log(f"  [phase l: {time.perf_counter() - t0:.1f} s]")
        return launches, http_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase l: the dense engine and generate_sample ---------------------------------------------


def phase_dense_f32(seed: int) -> str:
    """f32 at 1B width, the depth cut to 2 layers: the dense engine's greedy
    tokens equal the paged engine's (with the kernels) and a full-recompute
    greedy oracle's for phase 4's prompts; a seeded sampled run reproduces
    itself and top-k 1 is greedy."""
    import torch

    from ssi_tpu_torch.generate.engine import DecodeEngine, SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config(num_layers=2)
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    prompts = prompts_from_seed(seed, 4, cfg.vocab_size)
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    engine = DecodeEngine(params, cfg, pad_id=0)
    dense = engine.generate_batch(prompts, sp)
    paged = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=4).generate_batch(prompts, sp)
    for i, (a, b) in enumerate(zip(dense, paged)):
        check(a["token_ids"] == b["token_ids"] and len(a["token_ids"]) == 16,
              f"f32 dense prompt {i}: {a['token_ids']} != the paged engine's {b['token_ids']}")
        oracle = naive_greedy(params, cfg, prompts[i], 16)
        check(a["token_ids"] == oracle, f"f32 dense prompt {i}: {a['token_ids']} != full-recompute greedy {oracle}")
    dlp = max(abs(a["cumulative_logprob"] - b["cumulative_logprob"]) for a, b in zip(dense, paged))
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, max_tokens=16)
    check(engine.generate_batch(prompts, sampled, seed=5) == engine.generate_batch(prompts, sampled, seed=5),
          "f32 dense: a seeded sampled run does not reproduce itself")
    top1 = engine.generate_batch(prompts, SamplingParams(temperature=1.5, top_k=1, max_tokens=16), seed=6)
    check([o["token_ids"] for o in top1] == [o["token_ids"] for o in dense], "f32 dense: top-k 1 differs from greedy")
    del params, engine
    torch.cuda.empty_cache()
    return (f"f32 (1B width, 2 layers): 4 prompts x 16 greedy tokens equal the paged engine's (kernels) and "
            f"full-recompute greedy; max |cum logprob diff| vs paged {dlp:.2e}; a seeded sampled run reproduces "
            f"itself; top-k 1 == greedy")


def phase_dense(seed: int, smi: str, root, step, argv: list[str], records: list[dict], paged_rate: float) -> None:
    """Phase l, on phase d's ``step_0/`` and split: the f32 gate; the
    generation CLI with ``engine=dense batch_size=8`` in bf16 (the split's
    first 32 records, 4 batches, every record finished; tok/s beside phase d's paged rate,
    agreement with phase d's tokens reported, not required); one ``python -m
    ssi_tpu_torch.cli.generate_sample`` run on a shipped template (a finished
    record)."""
    import subprocess

    import torch

    from ssi_tpu_torch.cli.generate import main as generate_main
    from ssi_tpu_torch.generate import last_run_stats

    f32_line = phase_dense_f32(seed)
    cfg = model_config()
    out_root = root / "dense"
    _, wall = run_cli(generate_main, [*argv, "engine=dense", "batch_size=8", f"gen.output_dir={out_root}",
                                      f"data.test.dataset.n_samples={DENSE_RECORDS}"])
    stats = dict(last_run_stats)
    dense = [json.loads(line) for line in (out_root / "json" / "test" / "generations.jsonl").read_text().splitlines()]
    check(len(dense) == DENSE_RECORDS and len(records) == 64, f"dense generate: {len(dense)} records, expected "
          f"{DENSE_RECORDS}")
    for r in dense:
        o = r["outputs"][0]
        check(r["finished"] is True and len(r["outputs"]) == 1 and o["finish_reason"] in ("stop", "length")
              and 0 < len(o["token_ids"]) <= 128 and all(0 <= t < cfg.vocab_size for t in o["token_ids"]),
              f"dense record {r['request_id']}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
    batches = [dense[i]["metrics"] for i in range(0, DENSE_RECORDS, 8)]
    n_tok = sum(m["batch_generated_tokens"] for m in batches)
    rate = n_tok / sum(m["batch_duration_s"] for m in batches)
    same = sum(a["outputs"][0]["token_ids"] == b["outputs"][0]["token_ids"] for a, b in zip(dense, records))
    torch.cuda.empty_cache()

    sample_out = root / "sample.jsonl"
    speech = [17, 17, 23, 900, 4999, 0, 0, 12]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.cli.generate_sample", "--model", str(step),
                           "--n_dsus", str(cfg.n_dsus), "--template", "repeat_this_modality_switch",
                           "--speech_tokens", *map(str, speech), "--deduplicate", "--max_tokens", "64",
                           "--jsonl_out", str(sample_out)], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    t_sample = time.perf_counter() - t0
    check(proc.returncode == 0, f"generate_sample exited {proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(sample_out.read_text().splitlines()[-1])
    o = record["outputs"][0]
    check(record["finished"] is True and o["finish_reason"] in ("stop", "length") and 0 < len(o["token_ids"]) <= 64
          and all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"generate_sample record {record}")
    check(record["prompt_token_ids"][0] == cfg.base_vocab_size_txt + cfg.n_dsus + 2 * cfg.modality_tokens,
          "generate_sample prompt does not start with BOS")
    log(f"phase l dense engine {f32_line}")
    log(f"phase l generate CLI engine=dense batch_size=8 (1B bf16, {DENSE_RECORDS} records in {len(batches)} batches): "
        f"{n_tok} tokens = "
        f"{rate:.0f} generated tok/s over the batches (batch rates "
        f"{', '.join(f'{m['batch_tokens_per_second']:.0f}' for m in batches)}; phase d's paged engine, 32 slots: "
        f"{paged_rate:.0f}, {rate / paged_rate:.2f}x); generate {stats['generate_s']:.2f} s, load {stats['load_s']:.2f} s, "
        f"CLI wall {wall:.2f} s; every record finished; {same}/{DENSE_RECORDS} records equal phase d's tokens (bf16, other batch "
        f"shapes: reported, not required); on {smi}")
    log(f"phase l python -m ssi_tpu_torch.cli.generate_sample --template repeat_this_modality_switch "
        f"(1B bf16, {len(record['prompt_token_ids'])} prompt tokens): {o['finish_reason']}, {len(o['token_ids'])} tokens, "
        f"wall {t_sample:.2f} s (process start, checkpoint load and decode)")


# --- phase i: the serving entry point over HTTP ------------------------------------------------


def http_opener():
    """urllib without proxies: every request goes to this machine's own port."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_json(opener, url: str, body: dict | None = None, timeout: float = 300) -> tuple[int, dict]:
    """GET (``body`` None) or POST JSON; returns (status, decoded body), 4xx included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with opener.open(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_stream(opener, url: str, body: dict, timeout: float = 300) -> dict:
    """POST with ``stream: true`` and read the SSE events to ``[DONE]``: status,
    the events, the tokens and seconds from the POST to the first event that
    carries a token, and the request's wall seconds."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    out = {"events": [], "tokens": [], "ttft": None, "done": False}
    with opener.open(req, timeout=timeout) as r:
        out["status"] = r.status
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                out["done"] = True
                break
            event = json.loads(payload)
            check("choices" in event, f"stream error event: {event}")
            ids = event["choices"][0].get("token_ids") or []
            if ids and out["ttft"] is None:
                out["ttft"] = time.perf_counter() - t0
            out["tokens"] += ids
            out["events"].append(event)
    out["wall"] = time.perf_counter() - t0
    return out


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def phase_serve_http(seed: int, smi: str, step, tok_path, loaded, base_tokens, base_rate: float, gen_rate: float):
    """Phase i: ``python -m ssi_tpu_torch.cli.serve model=<step_0>`` as a
    subprocess (``conf/serve.yaml`` as it stands: 32 slots, ``max_cache_len``
    4096, the prefix cache, ``prefill_chunk`` 512; ``speech.n_dsus`` from a
    training-config snapshot beside the checkpoint), driven over HTTP."""
    import concurrent.futures
    import signal
    import socket

    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.cli.serve import CONF_DIR
    from ssi_tpu_torch.config import compose
    from ssi_tpu_torch.constants import TRAIN_CONFIG_FILENAME
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer

    cfg = model_config()
    root = step.parents[1]
    (step.parent / TRAIN_CONFIG_FILENAME).write_text(f"speech:\n  n_dsus: {cfg.n_dsus}\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    argv = [f"model={step}", f"server.port={port}", f"tokenizer.path={tok_path}"]
    scfg = compose(str(CONF_DIR), "serve", overrides=argv + [f"speech.n_dsus={cfg.n_dsus}"])  # what the server runs
    counts_file, log_file = root / "serve_launches.jsonl", root / "serve.log"
    env = {**os.environ, "SSI_TPU_TORCH_LAUNCH_COUNTS": str(counts_file), "PYTHONPATH": REPO}
    opener = http_opener()
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)  # phase 5's 64 requests
    warm = prompts_from_seed(seed + 9, 2, cfg.vocab_size)
    gate = prompts[:4]

    def device_used_gib() -> float:
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2**30

    used = {"before": device_used_gib()}
    t_phase = time.perf_counter()
    with open(log_file, "w") as log_f:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "ssi_tpu_torch.cli.serve", *argv], cwd=REPO, env=env,
                                stdout=log_f, stderr=subprocess.STDOUT)
    try:
        while True:
            check(proc.poll() is None, f"the server exited with {proc.returncode}:\n{log_file.read_text()[-3000:]}")
            check(time.perf_counter() - t0 < 300, "the server did not answer /health within 300 s")
            try:
                if http_json(opener, url + "/health", timeout=5) == (200, {"status": "ok"}):
                    break
            except OSError:
                time.sleep(0.2)
        t_health = time.perf_counter() - t0

        def post(body, path="/v1/completions"):
            return http_json(opener, url + path, body)

        for p in warm:  # not timed: the server process's CUDA and cuBLAS first-use costs
            code, body = post({"prompt": p, "max_tokens": 16, "temperature": 0})
            check(code == 200, f"warm-up: {code} {body}")
        used["warm"] = device_used_gib()
        # the hard gate's four requests, one at a time, first: with no concurrent
        # traffic their prefill and decode are reproducible by a direct engine
        gated = []
        for p in gate:
            code, body = post({"prompt": p, "max_tokens": 128, "temperature": 0})
            check(code == 200, f"gate request: {code} {body}")
            gated.append(body["choices"][0]["token_ids"])
        # n > 1 over HTTP: one greedy gang of 4 (a warm-up prompt, so the 64's
        # prefix-cache hits below stay the gate prompts' alone)
        code, gang = post({"prompt": warm[1], "max_tokens": 64, "temperature": 0, "n": 4})
        check(code == 200 and [c["index"] for c in gang["choices"]] == [0, 1, 2, 3]
              and all(c["token_ids"] == gang["choices"][0]["token_ids"] for c in gang["choices"])
              and gang["usage"]["completion_tokens"] == 4 * len(gang["choices"][0]["token_ids"]),
              f"n: 4 greedy: not 4 equal choices: {code} {gang}")
        _, before = http_json(opener, url + "/metrics")

        # phase 5's 64 requests, streamed, from 32 client threads at once
        t_all = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            runs = list(pool.map(lambda p: http_stream(opener, url + "/v1/completions",
                                                       {"prompt": p, "max_tokens": 128, "temperature": 0}), prompts))
        wall = time.perf_counter() - t_all
        used["after_64"] = device_used_gib()
        for i, r in enumerate(runs):
            check(r["status"] == 200 and r["done"], f"stream {i}: status {r['status']}, [DONE] {r['done']}")
            final = r["events"][-1]
            check(final["choices"][0]["finish_reason"] in ("stop", "length"), f"stream {i}: final {final}")
            check(final["usage"]["completion_tokens"] == len(r["tokens"]) and 0 < len(r["tokens"]) <= 128,
                  f"stream {i}: {len(r['tokens'])} tokens, usage {final['usage']}")
            check(all(0 <= t < cfg.vocab_size for t in r["tokens"]), f"stream {i}: token out of vocab")
        for _ in range(50):  # the last records free their slots before they are sent
            _, after = http_json(opener, url + "/metrics")
            if after["free_pages"] + after["cached_pages"] == after["n_pages"]:
                break
            time.sleep(0.1)
        check(after["free_pages"] + after["cached_pages"] == after["n_pages"],
              f"pages leaked at idle: {after['n_pages'] - after['free_pages'] - after['cached_pages']}")
        n_tok = sum(len(r["tokens"]) for r in runs)
        ttft = [r["ttft"] for r in runs]
        same = sum(r["tokens"] == b[: len(r["tokens"])] for r, b in zip(runs, base_tokens))
        delta = {k: after[k] - before[k] for k in ("prefill_rows", "prefill_pieces", "prefill_dispatches",
                                                   "cached_prompt_tokens", "prompt_tokens", "prefill_token_area",
                                                   "chunk_dispatches", "slot_chunks", "tokens_out", "dispatch_block_s",
                                                   "prefill_block_s", "harvest_block_s")}
        # decode slots filled: tokens out over the chunks' slot-steps (phase 5's slot_occupancy)
        slot_steps = delta["chunk_dispatches"] * int(scfg.batch_size) * PagedDecodeEngine.__init__.__kwdefaults__["chunk"]
        occupancy = delta["tokens_out"] / max(slot_steps, 1)
        # which pass prefilled each prompt: a gate prompt's cached pages leave a
        # suffix pass; more than prefill_chunk + 1 tokens go in chunked pieces;
        # the rest through the flash kernel (#1)
        ps, chunk = 128, 512
        cached = [(len(p) - 1) // ps * ps if i < len(gate) else 0 for i, p in enumerate(prompts)]
        via = ["suffix" if c else ("pieces" if len(p) - 1 > chunk else "flash") for p, c in zip(prompts, cached)]
        tok_by = {k: sum(len(p) for p, v in zip(prompts, via) if v == k) for k in ("flash", "pieces", "suffix")}
        check(delta["cached_prompt_tokens"] == sum(cached), f"cached prompt tokens {delta['cached_prompt_tokens']} "
              f"!= the gate prompts' full pages {sum(cached)}")

        # the text paths
        code, plain_txt = post({"prompt": "the transcript of one two three", "max_tokens": 16})
        check(code == 200 and isinstance(plain_txt["choices"][0]["text"], str)
              and plain_txt["usage"]["prompt_tokens"] > 0, f"string prompt: {code} {plain_txt}")
        text = plain_txt["choices"][0]["text"]
        msgs = [{"role": "system", "content": "Transcribe the speech."}, {"role": "user", "content": "one two three"}]
        code, chat = post({"messages": msgs, "max_tokens": 16}, "/v1/chat/completions")
        check(code == 200 and chat["object"] == "chat.completion"
              and isinstance(chat["choices"][0]["message"]["content"], str), f"chat: {code} {chat}")
        chat_stream = http_stream(opener, url + "/v1/chat/completions", {"messages": msgs, "max_tokens": 16})
        ev = chat_stream["events"]
        check(chat_stream["status"] == 200 and chat_stream["done"] and ev[0]["choices"][0]["delta"] == {"role": "assistant"}
              and ev[-1]["usage"]["completion_tokens"] == len(chat_stream["tokens"]), f"streamed chat: {ev[:1]} {ev[-1:]}")
        check(chat_stream["tokens"] == chat["choices"][0]["token_ids"]
              and "".join(e["choices"][0]["delta"].get("content") or "" for e in ev[1:-1])
              == chat["choices"][0]["message"]["content"], "streamed chat differs from the same chat request")
        stop_note = "no stop (text shorter than 4 characters)"
        if len(text) >= 4:
            stop = text[len(text) // 2 : len(text) // 2 + 2]
            code, cut = post({"prompt": "the transcript of one two three", "max_tokens": 16, "stop": stop})
            check(code == 200 and cut["choices"][0]["finish_reason"] == "stop"
                  and cut["choices"][0]["text"] == text[: text.index(stop)], f"stop {stop!r}: {code} {cut}")
            stop_note = f"stop {stop!r} cut {len(text)} characters to {len(cut['choices'][0]['text'])}"
        sampled = [post({"prompt": gate[0][:64], "max_tokens": 16, "temperature": 1.0, "seed": 5}) for _ in range(2)]
        check(all(c == 200 for c, _ in sampled)
              and sampled[0][1]["choices"][0]["token_ids"] == sampled[1][1]["choices"][0]["token_ids"],
              "temperature 1, seed 5 twice gave different tokens")
        used["end"] = device_used_gib()
        check(used["end"] - used["after_64"] < 1.0, f"device memory grew {used['end'] - used['after_64']:.2f} GiB "
              "after the 64 requests")
        _, final_metrics = http_json(opener, url + "/metrics")

        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise RuntimeError("chip smoke check failed: the server did not exit within 60 s of SIGINT")
        check(rc == 0, f"the server exited with {rc} on SIGINT:\n{log_file.read_text()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(line) for line in counts_file.read_text().splitlines()]
    check(len(lines) == 1 and lines[0]["entry_point"] == "serve", f"the server's launch-count lines: {lines}")
    launches = lines[0]["launch_counts"]
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the HTTP server")

    # the hard gate: a direct engine built as run_server builds it, on the same
    # weights, fed the warm-ups and then the four gate prompts one at a time
    # through one stream (the same prefix-cache state as the server's)
    tokenizer, _ = setup_llama3_tokenizer(tok_path, verbose=False)
    eng = PagedDecodeEngine(
        loaded, cfg, pad_id=tokenizer.pad_id, n_slots=int(scfg.batch_size), max_context=int(scfg.max_cache_len),
        quantize=scfg.quantize_weights, speculate_k=int(scfg.speculate_k or 0),
        prefix_caching=bool(scfg.prefix_caching), prefill_chunk=scfg.prefill_chunk,
        admission_order=str(scfg.admission_order))
    check(eng.attn_impl == "kernel" and eng.n_pages == after["n_pages"], "direct engine differs from the server's")
    features = frozenset(f.strip() for f in str(scfg.server.sampling_features).split(",") if f.strip())
    eng.begin_stream(SamplingParams.from_cfg(scfg.sampling_params, list(tokenizer.stop_tokens)), features=features)
    direct = []
    try:
        for p, mt in [(p, 16) for p in warm] + [(p, 128) for p in gate]:
            rid = eng.add_request(p, max_tokens=mt)
            done = None
            while done is None:
                done = next((r["outputs"][0] for r in eng.step() if r["request_id"] == rid), None)
            direct.append(done["token_ids"])
    finally:
        eng.end_stream()
    for i, (a, b) in enumerate(zip(gated, direct[len(warm):])):
        check(a == b, f"gate request {i}: the server's {len(a)} tokens differ from the direct engine's "
              f"({next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))} agree)")
    del eng
    torch.cuda.empty_cache()
    _build.launch_counts.clear()

    s = final_metrics
    log(f"phase i HTTP server (python -m ssi_tpu_torch.cli.serve, conf/serve.yaml: 32 slots, max_cache_len 4096, "
        f"prefix cache, prefill_chunk 512; 1B bf16 step_0/): start to /health {t_health:.2f} s; 64 streamed "
        f"requests x <= 128 greedy tokens from 32 client threads: {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.0f} generated tok/s over HTTP (phase 5: {base_rate:.0f}, phase d: {gen_rate:.0f}); "
        f"TTFT p50 {percentile(ttft, 0.5):.3f} s, p90 {percentile(ttft, 0.9):.3f} s, max {max(ttft):.3f} s; "
        f"decode slot occupancy {occupancy:.3f}; host time blocked in the 64's chunk dispatches "
        f"{delta['dispatch_block_s']:.2f} s, prefill dispatches {delta['prefill_block_s']:.2f} s, harvest reads "
        f"{delta['harvest_block_s']:.3f} s; phase wall {time.perf_counter() - t_phase:.1f} s; on {smi}")
    log(f"  phase i prefill of the 64: prompts by pass {dict((k, via.count(k)) for k in tok_by)}, prompt tokens by "
        f"pass {tok_by} ({tok_by['flash'] / sum(tok_by.values()):.3f} through #1); counters: {delta}")
    log(f"  phase i /metrics at the end: {s}")
    log(f"  phase i 4 gate requests one at a time == a direct engine run, token for token; {same}/64 streams equal "
        f"to phase 5's tokens (bf16, timing-dependent batches: reported, not required); string prompt, chat, "
        f"streamed chat == chat, {stop_note}, seed 5 twice equal, n 4 greedy: 4 equal choices of "
        f"{len(gang['choices'][0]['token_ids'])} tokens; device memory in use "
        f"{', '.join(f'{k} {v:.2f} GiB' for k, v in used.items())}; server launches {launches}")
    return launches


def phase_flash_bwd(gen, hq=32, hkv=8, d=64, shapes=((4, 768), (2, 2048)), row=(2, 2048),
                    tag="phase 6 flash backward"):
    import torch
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
    )

    worst, worst_rel = {}, {}
    for b, s in shapes:  # 1B: B2 S2048 is the training path's shape
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                           for h in (hq, hkv, hkv, hq))
            seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
            for c in sorted(torch.randint(1, s, (3,), generator=gen, device="cuda").tolist()):
                seg[:, c:] += 1
            for name, causal, segs in (("causal", True, None), ("full", False, None), ("segments", True, seg)):
                o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segs)
                got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                # no atomics: a second launch gives the same bits
                again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=segs)
                # control: the plain gradients with every probability 5% low (lse + 0.05)
                ctrl = flash_attention_bwd_reference(q, k, v, o, lse + 0.05, do, causal=causal, segment_ids=segs)
                torch.cuda.synchronize()
                errs, rels, least = [], [], math.inf
                for gname, a, w, c, a2 in zip(("dq", "dk", "dv"), got, want, ctrl, again):
                    check(a.dtype == dtype, f"flash bwd {gname} dtype {a.dtype} != {dtype}")
                    check(torch.equal(a, a2), f"flash bwd {name} B{b} S{s} {key} {gname}: two launches differ")
                    err, rel, rc = hold(f"flash bwd {name} B{b} S{s} {gname}", a, w, key, [("p x 0.95", c)])
                    errs.append(err)
                    rels.append(rel)
                    least = min(least, rc)
                worst[key] = max(worst.get(key, 0.0), *errs)
                worst_rel[key] = max(worst_rel.get(key, 0.0), *rels)
                log(f"  flash bwd {name:8s} B{b} S{s} Hq{hq} Hkv{hkv} d{d} {key:8s}: rel dq {rels[0]:.2e}, dk {rels[1]:.2e}, "
                    f"dv {rels[2]:.2e} (limit {REL[key]}; control p x 0.95 >= {least:.2e}); max|err| dq {errs[0]:.3e}, "
                    f"dk {errs[1]:.3e}, dv {errs[2]:.3e}; bitwise equal over two launches")
                del o, lse, got, again, want, ctrl
            del q, k, v, do
            torch.cuda.empty_cache()
    rows = {}
    for b, s in shapes:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        t_k, t_p = in_turns(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                            lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True))
        # yardstick: the backward of PyTorch's attention on the same inputs (timed only)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        pairs = b * hq * s * (s + 1) / 2  # allowed causal (query, key) pairs over all q heads
        ops = 5 * 2 * pairs * d  # S, dP, dV, dK, dQ products, 2 FLOP per MAC
        issued = 7 * 2 * pairs * d  # the kernels form S and dP twice (dk/dv and dq): no atomics
        n_bytes = 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s  # q o do dq; k v dk dv; lse
        bound_ms, bound_by = bound(ops, n_bytes)
        log(f"  flash bwd time bf16 causal B{b} S{s} Hq{hq} Hkv{hkv} d{d}: kernel {t_k:.3f} ms ({ops / (t_k * 1e-3) / 1e12:.1f} "
            f"TFLOP/s counted on the 5 products, {issued / (t_k * 1e-3) / 1e12:.1f} issued on 7), plain {t_p:.3f} "
            f"ms, SDPA backward {library:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows[(b, s)] = {"max_abs_err": worst["bfloat16"], "rel_err": worst_rel["bfloat16"], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    log(f"{tag}: ok (rel err f32 {worst_rel['float32']:.2e}, bf16 {worst_rel['bfloat16']:.2e}; "
        f"max err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e})")
    return rows[row]


def phase_cross_entropy(gen, vocab: int, d: int = 2048, ns=(4096, 3072), tag: str = "phase 7 cross entropy"):
    import torch
    import torch.nn.functional as F

    from ssi_tpu_torch.ops.cross_entropy import (
        cross_entropy_de,
        cross_entropy_de_gemm,
        cross_entropy_dh,
        cross_entropy_dh_gemm,
        cross_entropy_dlogits,
        cross_entropy_lse,
        fused_cross_entropy,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_gemm_kernel,
        cross_entropy_de_kernel,
        cross_entropy_dh_gemm_kernel,
        cross_entropy_dh_kernel,
        cross_entropy_dlogits_kernel,
        cross_entropy_lse_kernel,
        fused_cross_entropy_kernel,
    )

    # (kernel, dtype) -> worst max |err| and worst relative error over the cases
    worst, worst_rel = {}, {}

    def note(name, key, err, rel):
        worst[name, key] = max(worst.get((name, key), 0.0), err)
        worst_rel[name, key] = max(worst_rel.get((name, key), 0.0), rel)

    def inputs(n, dtype, spread=1.0):
        """h ~ N(0, spread^2) and E at init_params' scale: logits of std ``spread``."""
        h = (torch.randn((n, d), generator=gen, device="cuda") * spread).to(dtype)
        e = (torch.randn((vocab, d), generator=gen, device="cuda") * d**-0.5).to(dtype)
        y = torch.randint(0, vocab, (n,), generator=gen, device="cuda", dtype=torch.int32)
        y[::7] = -100
        return h, e, y

    g = torch.tensor(1.0, device="cuda")
    # spread 1 is the model at init (softmax near uniform, ~1/V); spread 4 is a
    # trained-like spread, where the softmax puts real mass on a few rows
    for n in ns:  # one SFT micro-batch (2 x 2048), and a ragged count
        for dtype in (torch.float32, torch.bfloat16):
            for spread in (1.0, 4.0):
                key = str(dtype).split(".")[1]
                h, e, y = inputs(n, dtype, spread)
                what = f"cross entropy N{n} D{d} {key} spread {spread:g}"
                lse = cross_entropy_lse_kernel(h, e)
                check(torch.equal(cross_entropy_lse_kernel(h, e), lse), f"{what} lse: two launches differ")
                lse_p = cross_entropy_lse(h, e)
                loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
                dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
                check(torch.equal(cross_entropy_dlogits_kernel(h, e, y, lse, g), dl),
                      f"{what} dlogits: two launches differ")
                err_dl, rel_dl, _ = hold(f"{what} dlogits", dl, cross_entropy_dlogits(h, e, y, g), key)
                note("cross_entropy_dlogits", key, err_dl, rel_dl)
                del dl
                dh, dh_p = cross_entropy_dh_kernel(h, e, y, lse, g), cross_entropy_dh(h, e, y, g)
                de, de_p = cross_entropy_de_kernel(h, e, y, lse, g), cross_entropy_de(h, e, y, g)
                # no atomics: a second launch of each gradient gives the same bits
                check(torch.equal(cross_entropy_dh_kernel(h, e, y, lse, g), dh), f"{what} dh: two launches differ")
                check(torch.equal(cross_entropy_de_kernel(h, e, y, lse, g), de), f"{what} dE: two launches differ")
                # control for dE: the kernel itself fed every probability 5% low (lse + 0.05)
                de_c = cross_entropy_de_kernel(h, e, y, lse + 0.05, g)
                torch.cuda.synchronize()
                valid = y != -100
                n_valid = int(valid.sum())
                # lse: absolute, against a constant lse (its mean) as the control
                err_lse = (lse - lse_p).abs().max().item()
                check(err_lse <= LSE_ATOL, f"{what} lse: max err {err_lse:.3e} > {LSE_ATOL}")
                note("cross_entropy_lse", key, err_lse, rel_err(lse, lse_p))
                spread_lse = (lse_p - lse_p.mean()).abs().max().item()
                check(spread_lse > LSE_ATOL, f"{what} lse: a constant lse passes ({spread_lse:.3e} <= {LSE_ATOL})")
                # loss: relative to the sum, against the loss of lse + 0.05 as the control
                rel_loss = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
                check(rel_loss <= 1e-5, f"{what} loss: {loss.item()} vs plain {loss_p.item()} (rel {rel_loss:.2e})")
                check(0.05 * n_valid / abs(loss_p.item()) > 1e-5, f"{what} loss: the control lse + 0.05 passes")
                # dh: control drops the softmax term (keeps -g * E[label]). At spread 1
                # that term is ~0.5% of dh, inside the bf16 limit, so the control
                # applies where it can be told: f32, or spread 4
                onehot = torch.where(valid[:, None], -e[torch.where(valid, y, 0).long()].float(), 0.0) * g
                tell = dtype == torch.float32 or spread > 1.0
                err_dh, rel_dh, c_dh = hold(f"{what} dh", dh, dh_p, key,
                                            [("softmax term dropped", onehot)] if tell else [])
                note("cross_entropy_dh", key, err_dh, rel_dh)
                # dE: rows of labelled vocab entries (-g * sum of h) apart from the
                # rest, whose whole gradient is the softmax term
                labelled = torch.zeros(vocab, dtype=torch.bool, device="cuda")
                labelled[y[valid].long()] = True
                err_l, rel_l, _ = hold(f"{what} dE labelled rows", de[labelled], de_p[labelled], key)
                err_u, rel_u, c_de = hold(f"{what} dE unlabelled rows", de[~labelled], de_p[~labelled], key,
                                          [("kernel with lse + 0.05", de_c[~labelled])])
                note("cross_entropy_de", key, max(err_l, err_u), max(rel_l, rel_u))
                c_dh = f"{c_dh:.2e}" if tell else "not applied"
                log(f"  {what}: lse max err {err_lse:.2e} (limit {LSE_ATOL}; constant lse {spread_lse:.2e}); "
                    f"loss rel {rel_loss:.2e} (limit 1e-5); rel dlogits {rel_dl:.2e}, dh {rel_dh:.2e} (control "
                    f"{c_dh}), dE labelled {rel_l:.2e}, dE unlabelled {rel_u:.2e} (control {c_de:.2e}) (limit "
                    f"{REL[key]}); max|err| dh {err_dh:.2e}, dE {max(err_l, err_u):.2e}; lse, dlogits, dh and dE "
                    "bitwise equal over two launches")
                del h, e, y, lse, lse_p, dh, dh_p, de, de_p, de_c, onehot, labelled
                torch.cuda.empty_cache()

    n = 4096
    h, e, y = inputs(n, torch.bfloat16)
    lse = cross_entropy_lse_kernel(h, e)
    dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)

    def backward():  # the kernels' whole backward, as _CrossEntropyKernel.backward runs it
        dlogits = cross_entropy_dlogits_kernel(h, e, y, lse, g)
        return cross_entropy_dh_gemm_kernel(dlogits, e), cross_entropy_de_gemm_kernel(dlogits, h)

    t = {"cross_entropy_lse": in_turns(lambda: cross_entropy_lse_kernel(h, e), lambda: cross_entropy_lse(h, e), 5),
         "cross_entropy_dlogits": in_turns(lambda: cross_entropy_dlogits_kernel(h, e, y, lse, g),
                                           lambda: cross_entropy_dlogits(h, e, y, g), 3),
         "cross_entropy_dh": in_turns(lambda: cross_entropy_dh_gemm_kernel(dl, e),
                                      lambda: cross_entropy_dh_gemm(dl, e), 3),
         "cross_entropy_de": in_turns(lambda: cross_entropy_de_gemm_kernel(dl, h),
                                      lambda: cross_entropy_de_gemm(dl, h), 3)}
    t_bwd, t_bwd_p = in_turns(backward, lambda: (cross_entropy_dh(h, e, y, g), cross_entropy_de(h, e, y, g)), 3)
    # yardsticks, timed only: one PyTorch call for each GEMM; the logits product and
    # cross_entropy (two calls) and their backward
    lib_dh = time_ms(lambda: torch.mm(dl, e, out_dtype=torch.float32), iters=3)
    lib_de = time_ms(lambda: torch.mm(dl.t(), h, out_dtype=torch.float32), iters=3)
    hl, el = h.detach().requires_grad_(), e.detach().requires_grad_()
    yl = y.long()
    lib_fwd = time_ms(lambda: F.cross_entropy(hl @ el.T, yl, reduction="sum"), iters=5)
    loss = F.cross_entropy(hl @ el.T, yl, reduction="sum")
    lib_bwd = time_ms(lambda: torch.autograd.grad(loss, (hl, el), retain_graph=True), iters=3)
    ops = 2 * n * vocab * d  # one [N, D] x [D, V] product
    hb, eb, dlb = 2 * n * d, 2 * vocab * d, 2 * n * vocab
    rows = {}
    for name, (n_bytes, library) in {
        "cross_entropy_lse": (hb + eb + 4 * n, lib_fwd),
        "cross_entropy_dlogits": (hb + eb + 8 * n + dlb, None),  # h, E, lse, labels read; dlogits written
        "cross_entropy_dh": (dlb + eb + hb, lib_dh),
        "cross_entropy_de": (dlb + hb + eb, lib_de),
    }.items():
        bound_ms, bound_by = bound(ops, n_bytes)
        t_k, t_p = t[name]
        log(f"  {name} time bf16 N{n} D{d}: kernel {t_k:.3f} ms ({ops / (t_k * 1e-3) / 1e12:.1f} TFLOP/s), "
            f"plain {t_p:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; the kernel at {bound_ms / t_k:.1%} of it)"
            + (f", ptxas of its GEMM instance: {ptxas_of('LseEpi')}" if name == "cross_entropy_lse" else "")
            + (f", one PyTorch call {library:.3f} ms ({ops / (library * 1e-3) / 1e12:.1f} TFLOP/s)"
               if name != "cross_entropy_lse" and library is not None else "")
            + (f", F.cross_entropy(h @ E.T) {library:.3f} ms (two calls)" if name == "cross_entropy_lse" else ""))
        rows[name] = {"max_abs_err": worst[name, "bfloat16"], "rel_err": worst_rel[name, "bfloat16"], "ms": t_k,
                      "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library}
    bound_bwd, by_bwd = bound(3 * ops, hb + eb + 8 * n + hb + eb)  # h, E, lse, labels read; dh, dE written
    log(f"  cross-entropy backward bf16 N{n} D{d} (dlogits + dh + dE): kernels {t_bwd:.3f} ms "
        f"({3 * ops / (t_bwd * 1e-3) / 1e12:.1f} TFLOP/s), plain {t_bwd_p:.3f} ms, bound {bound_bwd:.3f} ms "
        f"({by_bwd}); library backward of h @ E.T + F.cross_entropy {lib_bwd:.3f} ms")
    log(f"  library yardstick N{n}: F.cross_entropy(h @ E.T) forward {lib_fwd:.3f} ms (two calls), "
        f"its backward {lib_bwd:.3f} ms (dh and dE together)")
    del h, e, y, lse, dl, hl, el, loss
    torch.cuda.empty_cache()
    log(f"{tag}: ok (worst rel err f32 / bf16: " + ", ".join(
        f"{name.split('_')[-1]} {worst_rel[name, 'float32']:.2e} / {worst_rel[name, 'bfloat16']:.2e}"
        for name in CE_REPLACES) + ")")
    return rows


def phase_train_parity(seed: int, cfg=None, tag: str = "phase 8 f32 train parity (1B width"):
    import numpy as np
    import torch

    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = cfg or model_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 512)).astype(np.int32)).cuda()
    labels = tokens.clone()
    labels[:, :128] = -100
    out = {}
    kernel_loss = make_loss_fn(cfg, remat=False)
    for kernels in (True, False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss = kernel_loss(tree, tokens, labels)[0] if kernels else plain_loss(tree, tokens, labels, cfg)
        out[kernels] = (loss.detach(), torch.autograd.grad(loss, leaves))
        del leaves, tree, loss
    (l_k, g_k), (l_p, g_p) = out[True], out[False]
    rel_loss = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    check(rel_loss <= 1e-4, f"f32 train parity: loss {l_k.item()} vs plain {l_p.item()}")
    worst = 0.0
    for i, (a, w) in enumerate(zip(g_k, g_p)):
        scale = w.abs().max().item()
        err = (a - w).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
        check(err <= 1e-4, f"f32 train parity: gradient leaf {i} differs by {err:.2e} of its largest entry")
    log(f"{tag}, B1 S512): loss {l_k.item():.6f} vs plain {l_p.item():.6f} "
        f"(rel {rel_loss:.2e}); {len(g_k)} gradient leaves, worst max|diff| / max|grad| {worst:.2e}")
    del params, out, g_k, g_p
    torch.cuda.empty_cache()


def sft_window(seed: int, vocab: int, accum: int = 4, batch: int = 2, seq: int = 2048):
    """A synthetic SFT window [accum, batch, seq] from ``seed``: random tokens,
    the first quarter of each row (the prompt) labelled -100, and a padded
    tail (pad id 0, labels -100) after a row length drawn from [3/4, 1] x seq."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (accum, batch, seq)).astype(np.int32)
    labels = tokens.copy()
    labels[..., : seq // 4] = -100
    lengths = rng.integers(3 * seq // 4, seq + 1, (accum, batch))
    tail = np.arange(seq)[None, None, :] >= lengths[..., None]
    tokens[tail] = 0
    labels[tail] = -100
    return torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()


def remat_parity(cfg, params, tokens, labels) -> None:
    """Every remat policy on one micro-batch from one state, on the card: the
    loss and every gradient equal remat "none"'s bit for bit, and
    ``save_qkv_mlp_attn``'s backward reuses the flash forward's o and lse (one
    forward launch per layer, as "none"; the other policies recompute it)."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.models.llama3 import REMAT_POLICIES
    from ssi_tpu_torch.train.optimizer import tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn

    ref, fwd = None, {}
    for remat in sorted(REMAT_POLICIES, key=lambda r: r != "none"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _build.launch_counts.clear()
        loss = make_loss_fn(cfg, remat=remat)(tree_unflatten(params, leaves), tokens, labels)[0]
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        fwd[remat] = _build.launch_counts.get("flash_attention_fwd", 0)
        once = remat in ("none", "save_qkv_mlp_attn")
        check(fwd[remat] == cfg.num_layers * (1 if once else 2),
              f"remat {remat}: {fwd[remat]} flash forward launches for {cfg.num_layers} layers")
        del leaves
        if ref is None:
            ref = (loss.detach(), grads)
            continue
        check(torch.equal(loss.detach(), ref[0]), f"remat {remat}: loss {loss.item()} != remat none's {ref[0].item()}")
        for i, (a, w) in enumerate(zip(grads, ref[1])):
            check(torch.equal(a, w), f"remat {remat}: gradient leaf {i} differs from remat none's by up to "
                                     f"{(a.float() - w.float()).abs().max().item():.3e}")
        del grads, loss
    n_leaves = len(ref[1])
    del ref
    _build.launch_counts.clear()
    torch.cuda.empty_cache()
    log(f"phase 9 remat parity (1B bf16, B{tokens.shape[0]} S{tokens.shape[1]}, one micro-batch): the loss and all "
        f"{n_leaves} gradient leaves of {', '.join(r for r in REMAT_POLICIES if r != 'none')} equal remat none's "
        f"bitwise; flash forward launches {fwd}")


def phase_train(seed: int, smi: str):
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.lr_schedule import constant_schedule
    from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state
    from ssi_tpu_torch.train.step import make_train_step

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    opt = AdamWConfig()
    state = {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}
    steps = {remat: make_train_step(cfg, opt, constant_schedule(opt.lr), clip_grad_norm=1.0, remat=remat,
                                     grad_accum_dtype=torch.float32) for remat in ("full", "save_qkv_mlp")}
    tokens, labels = sft_window(seed + 3, cfg.vocab_size)
    remat_parity(cfg, params, tokens[0], labels[0])
    # warm-up on the same window with every label ignored: first-use costs, and the
    # zero-token rule at full width (no update, step not advanced)
    probe = params["layers"]["wq"].clone()
    for step in steps.values():
        state, m = step(state, tokens, torch.full_like(labels, -100))
        torch.cuda.synchronize()
        check(not bool(m["applied"]) and state["step"] == 0 and torch.equal(params["layers"]["wq"], probe),
              "zero-token warm-up window changed the state")
    del probe

    def timed(remat: str) -> tuple[list[float], list[float], int, dict, float]:
        """3 optimizer steps on the repeated window: losses, step seconds,
        label tokens per step, launches, peak memory (GiB)."""
        nonlocal state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        losses, times, n_tok = [], [], 0
        for _ in range(3):
            t0 = time.perf_counter()
            state, m = steps[remat](state, tokens, labels)
            losses.append(float(m["loss_sum"]) / max(int(m["num_tokens"]), 1))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_tok = int(m["num_tokens"])
        return losses, times, n_tok, dict(_build.launch_counts), torch.cuda.max_memory_allocated() / 2**30

    # full remat, the selective policy of conf/sft.yaml, full again (untraced, in turns)
    runs = [("full", *timed("full")), ("save_qkv_mlp", *timed("save_qkv_mlp")), ("full", *timed("full"))]
    losses, times, n_tok, launches, peak = runs[0][1:]
    check(all(math.isfinite(x) for _, ls, *_ in runs for x in ls), f"non-finite training loss: {runs}")
    check(state["step"] == 9, f"step {state['step']} after 9 optimizer steps")
    check(losses[2] < losses[0], f"loss did not fall on a repeated window: {losses}")
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the training main path")
        check(runs[1][4].get(name, 0) > 0, f"kernel {name} was not launched with remat save_qkv_mlp")
    for remat, ls, ts, nt, counts, pk in runs:
        mean_s = sum(ts) / len(ts)
        log(f"phase 9 train bf16 (1B, window 4 x 2 x 2048, remat {remat}): loss per token "
            f"{', '.join(f'{x:.4f}' for x in ls)}; step ms {', '.join(f'{t * 1e3:.1f}' for t in ts)} "
            f"(mean {mean_s * 1e3:.1f}); {nt} label tokens per step = {nt / mean_s:.0f} label tok/s on {smi}; "
            f"peak memory {pk:.1f} GiB; launches per optimizer step "
            f"{ {k: v // 3 for k, v in sorted(counts.items())} }")
    del state, params, steps
    torch.cuda.empty_cache()
    return launches


# --- phase p: tensor-parallel training ------------------------------------------------------


def phase_vocab_slices(gen, vocabs=(133_258, 129_206), n: int = 4096, d: int = 2048, t: int = 2) -> dict:
    """Phase p1: kernels #5-#7 on a vocabulary cut into ``t`` slices, as
    ``t`` tp ranks run them, in one process: each slice's lse, the gathered
    ``[t, N]`` merged by ``merge_slices`` (the merge pass), the picked
    logit summed over the slices, each slice's dlogits pass on its remapped
    labels, dh summed over the slices and dE stacked; held to the plain
    version and to the whole-vocabulary kernels on the same inputs beside
    two controls (a merge without the last slice, labels not remapped).
    Returns the merge kernel's row and each pass's slice times."""
    import torch

    from ssi_tpu_torch.ops.cross_entropy import (
        cross_entropy_de,
        cross_entropy_dh,
        cross_entropy_lse,
        cross_entropy_lse_merge,
        fused_cross_entropy,
        slice_picked,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_gemm_kernel,
        cross_entropy_dh_gemm_kernel,
        cross_entropy_dlogits_kernel,
        cross_entropy_lse_kernel,
        cross_entropy_lse_merge_kernel,
        fused_cross_entropy_kernel,
        merge_slices,
    )

    g = torch.tensor(1.0, device="cuda")
    out = {}
    for vocab in vocabs:
        rows = vocab // t
        check(rows * t == vocab, f"phase p1: V {vocab} does not split {t} ways")
        h = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        e = (torch.randn((vocab, d), generator=gen, device="cuda") * d**-0.5).to(torch.bfloat16)
        y = torch.randint(0, vocab, (n,), generator=gen, device="cuda", dtype=torch.int32)
        y[::7] = -100
        valid = y != -100
        slices = [e[r * rows:(r + 1) * rows] for r in range(t)]
        parts = torch.stack([cross_entropy_lse_kernel(h, s) for s in slices])

        def slice_path(parts, remap=True):
            lse, picked, dh, de = None, 0.0, 0.0, []
            for r, s in enumerate(slices):
                lse, local = merge_slices(parts, y, r * rows, rows)
                local = local if remap else y  # the control reads only dh and dE
                picked = picked + slice_picked(h, s, local) if remap else picked
                dl = cross_entropy_dlogits_kernel(h, s, local, lse, g)
                dh = dh + cross_entropy_dh_gemm_kernel(dl, s).float()
                de.append(cross_entropy_de_gemm_kernel(dl, h))
                del dl
            return lse, torch.where(valid, lse - picked, 0.0).sum(), dh, torch.cat(de)

        lse, loss, dh, de = slice_path(parts)
        check(torch.equal(cross_entropy_lse_merge_kernel(parts), lse), "phase p1: two merge launches differ")
        # the whole-vocabulary kernels and the plain version on the same inputs
        lse_w = cross_entropy_lse_kernel(h, e)
        loss_w = fused_cross_entropy_kernel(h, e, y)
        dl_w = cross_entropy_dlogits_kernel(h, e, y, lse_w, g)
        dh_w, de_w = cross_entropy_dh_gemm_kernel(dl_w, e), cross_entropy_de_gemm_kernel(dl_w, h)
        del dl_w
        lse_p, loss_p = cross_entropy_lse(h, e), fused_cross_entropy(h, e, y)
        dh_p, de_p = cross_entropy_dh(h, e, y, g), cross_entropy_de(h, e, y, g)
        what = f"phase p1 V {vocab} in {t} slices of {rows} (N {n}, D {d}, bf16)"
        _, loss_c, _, _ = slice_path(parts[:-1])
        _, _, dh_c, de_c = slice_path(parts, remap=False)
        torch.cuda.synchronize()
        errs = {}
        for name, ref in (("plain", (lse_p, loss_p, dh_p, de_p)), ("whole kernels", (lse_w, loss_w, dh_w, de_w))):
            rl = rel_err(lse, ref[0])
            check(rl <= 1e-5, f"{what} lse vs {name}: rel {rl:.3e} > 1e-5")
            rloss = abs(loss.item() - ref[1].item()) / abs(ref[1].item())
            check(rloss <= 1e-5, f"{what} loss vs {name}: {loss.item()} vs {ref[1].item()} (rel {rloss:.2e})")
            rc = abs(loss_c.item() - ref[1].item()) / abs(ref[1].item())
            check(rc > 1e-5, f"{what}: the control 'merge without the last slice' passes ({rc:.2e})")
            _, rdh, cdh = hold(f"{what} dh vs {name}", dh, ref[2], "bfloat16", [("labels not remapped", dh_c)])
            _, rde, cde = hold(f"{what} dE vs {name}", de, ref[3], "bfloat16", [("labels not remapped", de_c)])
            errs[name] = (rl, rloss, rc, rdh, cdh, rde, cde)
        max_err = max((lse - lse_p).abs().max().item(), (de.float() - de_p.float()).abs().max().item(),
                      (dh - dh_p.float()).abs().max().item())
        log(f"  {what}: " + "; ".join(
            f"vs {k}: lse rel {v[0]:.2e}, loss rel {v[1]:.2e} (merge without a slice {v[2]:.2e}), dh {v[3]:.2e} "
            f"(not remapped {v[4]:.2e}), dE {v[5]:.2e} (not remapped {v[6]:.2e})" for k, v in errs.items())
            + " (limits: lse and loss 1e-5, dh and dE 1e-2)")
        del lse_p, loss_p, dh_p, de_p, dh_w, de_w, dh_c, de_c, dh, de

        # each pass on slice 0 beside the whole vocabulary, in turns
        s0, lse0 = slices[0], lse
        local0 = merge_slices(parts, y, 0, rows)[1]
        dl0 = cross_entropy_dlogits_kernel(h, s0, local0, lse0, g)
        dl_w = cross_entropy_dlogits_kernel(h, e, y, lse_w, g)
        times = {
            "cross_entropy_lse": in_turns(lambda: cross_entropy_lse_kernel(h, s0), lambda: cross_entropy_lse_kernel(h, e), 5),
            "cross_entropy_dlogits": in_turns(lambda: cross_entropy_dlogits_kernel(h, s0, local0, lse0, g),
                                              lambda: cross_entropy_dlogits_kernel(h, e, y, lse_w, g), 3),
            "cross_entropy_dh": in_turns(lambda: cross_entropy_dh_gemm_kernel(dl0, s0),
                                         lambda: cross_entropy_dh_gemm_kernel(dl_w, e), 3),
            "cross_entropy_de": in_turns(lambda: cross_entropy_de_gemm_kernel(dl0, h),
                                         lambda: cross_entropy_de_gemm_kernel(dl_w, h), 3),
        }
        log(f"  {what} times, one slice vs the whole vocabulary: " + ", ".join(
            f"{k.split('_')[-1]} {a:.3f} / {b:.3f} ms ({a / b:.3f}x)" for k, (a, b) in times.items()))
        if vocab == vocabs[0]:
            out["slice_ms"] = {k: {"slice_ms": a, "whole_ms": b} for k, (a, b) in times.items()}
            # device times of a replayed graph of 64 calls: the wrapper's host time exceeds the merge's
            merge = [lambda: cross_entropy_lse_merge_kernel(parts)] * 64
            plain = [lambda: cross_entropy_lse_merge(parts)] * 64
            t_p, t_k, t_k2, t_p2 = graph_ms(plain), graph_ms(merge), graph_ms(merge), graph_ms(plain)
            t_k, t_p = min(t_k, t_k2), min(t_p, t_p2)
            lib = graph_ms([lambda: torch.logsumexp(parts, dim=0)] * 64)
            merge_err = (cross_entropy_lse_merge_kernel(parts) - cross_entropy_lse_merge(parts)).abs().max().item()
            bound_ms, bound_by = bound(3 * t * n, (t + 1) * 4 * n)  # max, exp, add per part; parts read, lse written
            log(f"  merge pass [{t}, {n}] (graph replays): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.logsumexp {lib:.4f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by}); max |kernel - plain| {merge_err:.2e}")
            out["merge_row"] = {"max_abs_err": merge_err, "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib}
        del h, e, y, parts, slices, lse, lse_w, loss_w, dl0, dl_w, s0, local0
        torch.cuda.empty_cache()
    log(f"phase p1 vocab-parallel #5-#7: ok ({', '.join(str(v) for v in vocabs)} in {t} slices)")
    return out


def phase_tp_train(seed: int, smi: str) -> dict:
    """Phase p2: phase 9's SFT window through the tensor-parallel training
    path at tp 1 in a 1-rank NCCL group (``StateLayout.tensor_parallel``:
    the Megatron ops, the masked embedding lookup, the vocab-parallel
    cross-entropy with its merge pass, the dp x tp reducers, all identities
    here) beside the mesh-less step from the same state: 2 optimizer steps
    each; the losses, grad norms and every parameter and moment bitwise
    equal. Counts the tp path's collectives (at tp 1 the tp ones issue no
    call: no all-gather, only the dp column's all-reduces) and times a
    1-rank NCCL all-reduce of an activation and of the largest gradient
    beside a copy of each, which is what such a call would cost the card.
    Returns the tp path's launches."""
    import socket

    import torch
    import torch.distributed as dist

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.parallel import StateLayout, make_mesh
    from ssi_tpu_torch.train.lr_schedule import constant_schedule
    from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves, tree_map
    from ssi_tpu_torch.train.step import make_train_step

    cfg = model_config()
    tokens, labels = sft_window(seed + 3, cfg.vocab_size)
    opt = AdamWConfig()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, tp=1)
        check(mesh.tp_group is not None and dist.get_backend(mesh.tp_group) == "nccl",
              "phase p2: the tp-1 mesh carries no NCCL group")
        params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
        layout = StateLayout.build(mesh, tree_map(lambda x: tuple(x.shape), params), zero1=False, fsdp=False,
                                   num_kv_heads=cfg.num_kv_heads)
        check(layout.tensor_parallel() is not None and layout.tensor_parallel().head,
              "phase p2: the tp-1 layout takes no tensor-parallel path")
        runs, calls = {}, {}

        def counted(name, fn):
            def call(*args, **kwargs):
                calls[name] = calls.get(name, 0) + 1
                return fn(*args, **kwargs)
            return call

        for name, lay in (("none", None), ("tp", layout)):
            state = {"params": tree_map(lambda x: x.clone(), params), "step": 0}
            state["opt_state"] = init_opt_state(state["params"], opt)
            step = make_train_step(cfg, opt, constant_schedule(opt.lr), clip_grad_norm=1.0, remat="full",
                                   grad_accum_dtype=torch.float32, layout=lay)
            state, m = step(state, tokens, torch.full_like(labels, -100))  # first-use costs; no update
            torch.cuda.synchronize()
            check(not bool(m["applied"]) and state["step"] == 0, f"phase p2 {name}: the zero-token window applied")
            _build.launch_counts.clear()
            readings, times = [], []
            originals = {k: getattr(dist, k) for k in ("all_reduce", "all_gather_into_tensor")}
            for k, fn in originals.items():
                setattr(dist, k, counted(k, fn))
            try:
                for _ in range(2):
                    t0 = time.perf_counter()
                    state, m = step(state, tokens, labels)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    readings.append((m["loss_sum"].item(), int(m["num_tokens"]), m["grad_norm"].item()))
            finally:
                for k, fn in originals.items():
                    setattr(dist, k, fn)
            runs[name] = (readings, times, dict(_build.launch_counts), state)
            del step, m
        (r0, t0s, _, s0), (r1, t1s, launches, s1) = runs["none"], runs["tp"]
        check(r0 == r1, f"phase p2: the tp path's (loss sum, tokens, grad norm) {r1} != the mesh-less step's {r0}")
        for what in ("params", "mu", "nu"):
            a = tree_leaves(s0["params"] if what == "params" else s0["opt_state"][what])
            b = tree_leaves(s1["params"] if what == "params" else s1["opt_state"][what])
            check(all(torch.equal(x, z) for x, z in zip(a, b)), f"phase p2: {what} differ after 2 steps")
        for name in TRAIN_KERNELS + ("cross_entropy_lse_merge",):
            check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the tp training path")
        check(calls.get("all_gather_into_tensor", 0) == 0, f"phase p2: a tp all-gather ran at tp 1: {calls}")
        # what a 1-rank NCCL all-reduce costs the card: an activation [2, 2048, 2048] bf16, the embedding's f32
        # gradient, each beside a copy of the same bytes
        act = torch.randn((2, 2048, 2048), device="cuda").to(torch.bfloat16)
        big = torch.zeros(tuple(params["embed"].shape), dtype=torch.float32, device="cuda")
        costs = {}
        for what, x, iters in (("activation", act, 50), ("embed gradient", big, 5)):
            t_ar = time_ms(lambda: dist.all_reduce(x, group=mesh.tp_group), iters=iters)
            t_cp = time_ms(lambda: x.clone(), iters=iters)
            costs[what] = f"all-reduce {t_ar:.3f} ms, copy {t_cp:.3f} ms ({x.numel() * x.element_size() / 1e9:.3f} GB)"
        del act, big
        ms = {k: [t * 1e3 for t in ts] for k, ts in (("none", t0s), ("tp", t1s))}
        log(f"phase p2 train_tp (1B bf16, phase 9's window 4 x 2 x 2048, remat full, tp 1 in a 1-rank NCCL group): "
            f"loss sum, tokens and grad norm per step {r1}, every parameter and moment after 2 steps bitwise the "
            f"mesh-less step's; step ms tp {', '.join(f'{t:.1f}' for t in ms['tp'])}, mesh-less "
            f"{', '.join(f'{t:.1f}' for t in ms['none'])} (tp / none, second step {ms['tp'][1] / ms['none'][1]:.3f}) "
            f"on {smi}; launches {launches}; collectives in the tp run's 2 steps {calls}; at one rank, "
            + "; ".join(f"{k}: {v}" for k, v in costs.items()))
    finally:
        dist.destroy_process_group()
    del runs, params, s0, s1
    torch.cuda.empty_cache()
    return launches


# --- phase e: the training entry points -----------------------------------------------------


def cpt_rows(seed: int, n: int, n_dsus: int) -> list[dict]:
    """``n`` aligned rows as the CPT loader reads them: 20-40 task words with
    word-aligned times (0.2-0.6 s a word) and HuBERT-rate speech tokens
    (50 per second, 16 kHz / 320) over the utterance, no two neighbours equal."""
    import numpy as np

    from ssi_tpu_torch.wer_drive import WORDS

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        n_words = int(rng.integers(20, 41))
        ends = np.cumsum(rng.uniform(0.2, 0.6, n_words))
        starts = np.concatenate([[0.0], ends[:-1]])
        m = int(ends[-1] * 50) + 1
        steps = rng.integers(1, n_dsus, m)
        speech = (int(rng.integers(0, n_dsus)) + np.cumsum(steps)) % n_dsus
        rows.append({"tokenized": [WORDS[j] for j in rng.integers(0, len(WORDS), n_words)],
                     "align_t_starts": starts.tolist(), "align_t_ends": ends.tolist(),
                     "speech_tokens": speech.tolist()})
    return rows


def write_jsonl(path, rows) -> None:
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


class kept_training_states:
    """Keep each training state the Checkpointer writes at one of ``steps``
    (a hard link, ``training_state_step<N>.msgpack`` beside it: the next save
    replaces the file, and the link keeps the old one), so a run that
    overwrites its state at every save leaves the step-N state for a resume
    check."""

    def __init__(self, steps: set[int]):
        self.steps = steps

    def __enter__(self):
        from ssi_tpu_torch.checkpoint import Checkpointer

        self.original = original = Checkpointer.save_training_state
        steps = self.steps

        def save_and_keep(ckpt, **kwargs):
            path = original(ckpt, **kwargs)
            if kwargs["global_step"] in steps:
                os.link(path, path.with_name(f"training_state_step{kwargs['global_step']}.msgpack"))
            return path

        Checkpointer.save_training_state = save_and_keep
        return self

    def __exit__(self, *exc):
        from ssi_tpu_torch.checkpoint import Checkpointer

        Checkpointer.save_training_state = self.original


def read_metrics(out_dir) -> list[dict]:
    return [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


def step_readings(metrics: list[dict]) -> str:
    steps = [m for m in metrics if "loss" in m]
    return ", ".join(f"{m['duration_step'] * 1e3:.1f} ms ({m['tokens_per_second_per_gpu']:.0f} label tok/s)"
                     for m in steps)


def phase_training_cli(seed: int, smi: str):
    """Phase e: the training entry points at the full width of ``llama3_2_1b``:
    the extension CLI on a synthesized base, the SFT CLI with the WER drive's
    overrides (and its bitwise resume from step 2), the CPT CLI, and one
    traced optimizer step through the Trainer's ``profiler`` key."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.checkpoint import Checkpointer, msgpack_io
    from ssi_tpu_torch.checkpoint.convert import internal_to_hf
    from ssi_tpu_torch.checkpoint.safetensors_io import safe_open, save_file
    from ssi_tpu_torch.cli.extend_llama3_2 import main as extend_main, parse_args as extend_args
    from ssi_tpu_torch.cli.train_cpt import main as cpt_main
    from ssi_tpu_torch.cli.train_sft import main as sft_main
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.profile_decode import _device_summary
    from ssi_tpu_torch.speech import dsu2pua
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from ssi_tpu_torch.wer_drive import WORDS, build_base_tokenizer

    cfg = model_config()
    base_cfg = get_model_config("llama3_2_1b")  # n_dsus 0: the 128,256-row base
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        log(f"  phase e: {free_gb:.1f} GB free at {root}")
        check(free_gb > 24, f"phase e needs about 23 GB of disk; {free_gb:.1f} GB free")

        # 1. extend: a synthesized base (the drive's 128,000-entry tokenizer, random bf16
        # weights), then the extension CLI with the drive's arguments
        base, ext = root / "base", root / "extended"
        build_base_tokenizer(base / "original" / "tokenizer.model", WORDS)
        written = init_params(base_cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
        save_file(internal_to_hf(written, base_cfg), base / "model.safetensors", metadata={"format": "pt"})
        write_model_files(base, base_cfg)
        base_embed = written["embed"].float().cpu()
        del written
        torch.cuda.reset_peak_memory_stats()
        _, t_extend = run_cli(lambda a: extend_main(extend_args(a)), [
            "--n_new_dsus", str(cfg.n_dsus), "--sigma-scaling", "1.0", "--model-config", "llama3_2_1b",
            "--input_dir", str(base), "--output_dir", str(ext)])
        mem_extend = torch.cuda.max_memory_allocated() / 2**30
        hf = json.loads((ext / "config.json").read_text())
        with safe_open(next(ext.glob("*.safetensors"))) as f:
            embed = f.get_tensor("model.embed_tokens.weight")
        n_base = base_cfg.base_vocab_size_txt
        check(hf["vocab_size"] == cfg.vocab_size == embed.shape[0] == 133_258,
              f"extended vocab {hf['vocab_size']} / {embed.shape[0]}, expected 133,258")
        check(torch.equal(embed[:n_base], base_embed[:n_base]) and torch.equal(embed[-256:], base_embed[-256:]),
              "extension changed the base embedding rows")
        check(bool(torch.isfinite(embed[n_base:-256]).all()), "non-finite new embedding rows")
        tok, _ = setup_llama3_tokenizer(ext / "original" / "tokenizer.model", verbose=False)
        dsus = [0, 1, 4999, 17, 17]
        ids = tok.encode("".join(dsu2pua(d) for d in dsus), add_bos=False, add_eos=False)
        check(ids == [n_base + d for d in dsus], f"DSU span encodes to {ids}")
        del embed, base_embed
        ext_bytes = sum(p.stat().st_size for p in ext.glob("*.safetensors"))
        log(f"phase e extend CLI (1B, --n_new_dsus 5000 --sigma-scaling 1.0): {t_extend:.2f} s, "
            f"{ext_bytes / 1e9:.2f} GB of fp32 safetensors written; vocab 133,258, base rows unchanged, "
            f"DSU span encodes to its ids; peak memory {mem_extend:.1f} GiB")

        # 2. SFT with the drive's overrides (tools/wer_drive.py:449-473; log_interval 1 for
        # per-step readings), 4 steps, a save and a dev loss every 2
        train, dev = root / "sft_train.jsonl", root / "sft_dev.jsonl"
        write_jsonl(train, split_rows(seed + 11, 64, cfg.n_dsus))
        write_jsonl(dev, split_rows(seed + 12, 16, cfg.n_dsus))

        def sft_argv(out, *extra, train_split=train):
            return ["data=sft/mls-hubert_large_ll60k-layer_22",
                    *[a for split, path in (("train", train_split), ("dev", dev)) for a in (
                        f"data.{split}.dataset.source=json", f"+data.{split}.dataset.data_files={path}",
                        f"data.{split}.dataset.split=train")],
                    "data.train.dataloader.batch_size=2", "data.dev.dataloader.batch_size=2",
                    "gradient_accumulation_steps=4", "tokenizer.max_seq_len=2048", "optimizer.lr=2e-3",
                    "lr_scheduler.num_warmup_steps=200", "max_steps=4", "eval_steps=2", "save_steps=2",
                    "log_interval=1", "clip_grad_norm=1.0", "wandb.enabled=false", "loss_chunk_size=3072",
                    f"checkpointer.checkpoint_dir={ext}", f"tokenizer.path={ext / 'original' / 'tokenizer.model'}",
                    f"checkpointer.output_dir={out}", *extra]

        out = root / "sft"
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        with kept_training_states({2}):
            trainer, t_sft = run_cli(sft_main, sft_argv(out))
        launches = dict(_build.launch_counts)
        mem_sft = torch.cuda.max_memory_allocated() / 2**30
        check(trainer.cfg.remat == "save_qkv_mlp" and trainer.cfg.dtype == "bf16",
              f"SFT ran remat {trainer.cfg.remat}, dtype {trainer.cfg.dtype}")
        metrics = read_metrics(out)
        losses = [m["loss"] for m in metrics if "loss" in m]
        dev_losses = [m["dev_loss"] for m in metrics if "dev_loss" in m]
        check(trainer.global_step == 4 and len(losses) == 4 and len(dev_losses) == 2,
              f"SFT: step {trainer.global_step}, {len(losses)} losses, {len(dev_losses)} dev losses")
        check(all(math.isfinite(x) for x in losses + dev_losses), f"SFT losses {losses}, dev {dev_losses}")
        for name in TRAIN_KERNELS:
            check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the SFT entry point")
        save = dict(trainer.last_save_stats)
        e_digests = file_digests(out / "step_4")  # phase n's runs are held to these files
        t0 = time.perf_counter()
        reloaded = Checkpointer(out / "step_4", output_dir=root / "scratch",
                                model_expectations=cfg.checkpoint_expectations).load_params(cfg, torch.bfloat16, "cuda")
        t_reload = time.perf_counter() - t0
        final = {k: v.clone() for k, v in flat_params(trainer.state["params"]).items()}
        for name, w in flat_params(reloaded).items():
            check(torch.equal(final[name], w), f"step_4/ {name} differs from the trainer's parameters")
        del reloaded
        t0 = time.perf_counter()
        state = msgpack_io.load(out / "training_state.msgpack")
        t_state_load = time.perf_counter() - t0
        opt = state["optimizer"]
        check(state["global_step"] == 4 and int(opt["count"]) == 4 and list(opt) == ["count", "mu", "nu"]
              and torch.equal(opt["mu"]["embed"].cuda(), trainer.state["opt_state"]["mu"]["embed"]),
              "training_state.msgpack does not read back to the trainer's state")
        del state, opt, trainer
        shutil.rmtree(out / "step_4")
        (out / "training_state.msgpack").unlink()
        torch.cuda.empty_cache()
        log(f"phase e SFT CLI (1B bf16, remat save_qkv_mlp, window 4 x 2 x 2048, 64 rows): loss "
            f"{', '.join(f'{x:.4f}' for x in losses)}, dev loss {', '.join(f'{x:.4f}' for x in dev_losses)}; "
            f"JSONL duration_step {step_readings(metrics)}; CLI wall {t_sft:.2f} s; save at step 4: model "
            f"{save['model_s']:.2f} s = {save['model_bytes'] / 1e9 / save['model_s']:.2f} GB/s "
            f"({save['model_bytes'] / 1e9:.2f} GB), state {save['state_s']:.2f} s = "
            f"{save['state_bytes'] / 1e9 / save['state_s']:.2f} GB/s ({save['state_bytes'] / 1e9:.2f} GB); "
            f"step_4/ reload {t_reload:.2f} s, equal to the trainer's parameters bitwise; state read "
            f"{t_state_load:.2f} s; peak memory {mem_sft:.1f} GiB; on {smi}; launches {launches}")

        # 3. CPT (micro-batch 4 x accum 16 x seq 768, interleaved), 2 steps: the final checkpoint
        train_c, dev_c = root / "cpt_train.jsonl", root / "cpt_dev.jsonl"
        write_jsonl(train_c, cpt_rows(seed + 21, 128, cfg.n_dsus))
        write_jsonl(dev_c, cpt_rows(seed + 22, 16, cfg.n_dsus))
        out_c = root / "cpt"

        def cpt_argv(out, ckpt, train_split, dev_split, *extra):
            return ["data=cpt/mls-hubert_large_ll60k-layer_22",
                    *[a for split, path in (("train", train_split), ("dev", dev_split)) for a in (
                        f"data.{split}.dataset.source=json", f"+data.{split}.dataset.data_files={path}",
                        f"data.{split}.dataset.split=train")],
                    "max_steps=2", "log_interval=1", "clip_grad_norm=1.0", "wandb.enabled=false",
                    f"checkpointer.checkpoint_dir={ckpt}", f"tokenizer.path={ckpt / 'original' / 'tokenizer.model'}",
                    f"checkpointer.output_dir={out}", *extra]

        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        trainer, t_cpt = run_cli(cpt_main, cpt_argv(out_c, ext, train_c, dev_c))
        cpt_launches = dict(_build.launch_counts)
        mem_cpt = torch.cuda.max_memory_allocated() / 2**30
        metrics_c = read_metrics(out_c)
        losses_c = [m["loss"] for m in metrics_c if "loss" in m]
        check(trainer.cfg.gradient_accumulation_steps == 16 and trainer.geometry.batch_size == 4
              and trainer.cfg.tokenizer.max_seq_len == 768, "CPT did not run the conf's 4 x 16 x 768 window")
        check(len(losses_c) == 2 and all(math.isfinite(x) for x in losses_c), f"CPT losses {losses_c}")
        check((out_c / "step_2" / "model.safetensors.index.json").is_file()
              and (out_c / "training_state.msgpack").is_file(), "CPT wrote no final checkpoint at max_steps")
        save_c = dict(trainer.last_save_stats)
        del trainer
        shutil.rmtree(out_c)
        torch.cuda.empty_cache()
        log(f"phase e CPT CLI (1B bf16, remat save_qkv_mlp, window 16 x 4 x 768, interleaved): loss "
            f"{', '.join(f'{x:.4f}' for x in losses_c)}; steps {step_readings(metrics_c)}; CLI wall {t_cpt:.2f} s; "
            f"final checkpoint at step 2: model {save_c['model_s']:.2f} s, state {save_c['state_s']:.2f} s; "
            f"peak memory {mem_cpt:.1f} GiB; launches {cpt_launches}")

        # 4. overlap_io on and off, untraced: 6 SFT steps each from the extended base, the
        # dev loss only at step 6 and no save (steps 2-5 are read); every logged value but the timings agrees
        ab = {}
        for overlap in (True, False):
            out_ab = root / f"sft_overlap_{overlap}"
            with no_saves():
                trainer, _ = run_cli(sft_main, sft_argv(out_ab, "max_steps=6", "eval_steps=6", "save_steps=6",
                                                        f"overlap_io={str(overlap).lower()}"))
            del trainer
            ab[overlap] = {m["step"]: m for m in read_metrics(out_ab) if "loss" in m}
            shutil.rmtree(out_ab)
            torch.cuda.empty_cache()
        timing = ("duration_step", "tokens_per_second_per_gpu", "train_clock_time")
        check([{k: v for k, v in m.items() if k not in timing} for m in ab[True].values()]
              == [{k: v for k, v in m.items() if k not in timing} for m in ab[False].values()],
              "overlap_io on and off logged different values")
        # steps 2-5: the wall per step from train_clock_time (hours), and the mean duration_step
        ab_ms = {o: ((m[5]["train_clock_time"] - m[1]["train_clock_time"]) * 3600e3 / 4,
                     sum(m[k]["duration_step"] for k in range(2, 6)) * 1e3 / 4) for o, m in ab.items()}
        log(f"phase e overlap_io A/B (SFT CLI, 6 steps, dev loss only at step 6, no save; steps 2-5): "
            f"wall per step {ab_ms[True][0]:.1f} ms on, {ab_ms[False][0]:.1f} ms off; mean duration_step "
            f"{ab_ms[True][1]:.1f} ms on, {ab_ms[False][1]:.1f} ms off; JSONL duration_step on "
            f"{step_readings(list(ab[True].values()))}; off {step_readings(list(ab[False].values()))}; "
            f"losses and every other logged value equal; on {smi}")

        # 5. resume: a fresh Trainer from step_2/ and the step-2 state runs steps 3-4 equal
        # to the uninterrupted run, bitwise; step 3 is traced (after every untraced reading)
        out_r = root / "sft_resumed"
        with no_saves():  # steps 3-4 are held in memory
            trainer, t_resume = run_cli(sft_main, sft_argv(
                out_r, f"checkpointer.checkpoint_dir={out / 'step_2'}",
                f"checkpointer.training_state_checkpoint={out / 'training_state_step2.msgpack'}",
                f"profiler={{start_step: 2, num_steps: 1, dir: {root / 'profile'}}}"))
        metrics_r = read_metrics(out_r)
        losses_r = [m["loss"] for m in metrics_r if "loss" in m]
        check(losses_r == losses[2:], f"resumed losses {losses_r} != the uninterrupted run's {losses[2:]}")
        for name, w in flat_params(trainer.state["params"]).items():
            check(torch.equal(final[name], w), f"resumed step 4 {name} differs from the uninterrupted run's")
        check(trainer.profile_trace is not None and trainer.profile_trace.is_file(), "the profiler wrote no trace")
        dev_summary = _device_summary(str(trainer.profile_trace))
        traced = trainer.profile_wall_s * 1e3
        del trainer, final
        torch.cuda.empty_cache()
        shares = ", ".join(f"{k} {v * dev_summary['busy_ms']:.1f} ms" for k, v in
                           dev_summary["share_of_device_time"].items())
        log(f"phase e resume from step_2/ + its state: steps 3-4 losses and step_4 weights equal the "
            f"uninterrupted run's bitwise; CLI wall {t_resume:.2f} s (setup, resume load and 2 steps)")
        log(f"phase e traced step 3 (Trainer profiler key, one optimizer step, save_qkv_mlp): traced step "
            f"{traced:.1f} ms, device busy {dev_summary['busy_ms']:.1f} ms ({dev_summary['busy_ms'] / traced:.0%} "
            f"of the traced step), {dev_summary['kernels']} kernels; device time by class: {shares}")
        # phase q reads phase e's rows from a local dataset directory and splits its CPT rows by a raw regex
        local_launches = phase_local_sources(smi, root, ext, sft_argv, cpt_argv, {"train": train, "dev": dev},
                                             {"train": train_c, "dev": dev_c}, metrics, metrics_c)
        # phase k trains packed on this extended checkpoint before it is deleted (no second extension)
        t0 = time.perf_counter()
        packed_launches = phase_packed_training(seed, smi, root, sft_argv, metrics)
        log(f"  [phase k: {time.perf_counter() - t0:.1f} s]")
        # phase n trains across ranks (torchrun) on this extended checkpoint, held to phase e's run
        t0 = time.perf_counter()
        dp_launches = phase_distributed(seed, smi, root, sft_argv, {"metrics": metrics, "digests": e_digests,
                                                                    "peak_gib": mem_sft, "save": save})
        log(f"  [phase n: {time.perf_counter() - t0:.1f} s]")
        # phase m extends the same base by its compressed vocabulary (no second base)
        shutil.rmtree(ext)
        compressed_launches = phase_compressed(seed, smi, root, base, cpt_argv, metrics_c)
        return launches, packed_launches, compressed_launches, dp_launches, local_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase k: packed training at 1B -------------------------------------------------------------


def allowed_pairs(seg) -> int:
    """The (query, key) pairs causal attention within segments allows, over a
    batch of packed rows ``seg [B, S]``: L(L+1)/2 for each run of one segment
    id (the padding tail, segment 0, is one run too)."""
    total = 0
    for row in seg.tolist():
        run = 0
        for i, x in enumerate(row):
            run = run + 1 if i and x == row[i - 1] else 1
            total += run
    return total


def sdpa_with_mask(q, k, v, mask, do):
    """``scaled_dot_product_attention`` with a boolean mask (kv heads repeated
    to the q heads), on the first backend that takes it: returns (a function
    that runs its forward, one that runs the backward of one forward kept
    for it, the backend's name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n_rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.repeat_interleave(n, dim=2).transpose(1, 2).detach().requires_grad_()
                  for x, n in ((q, 1), (k, n_rep), (v, n_rep)))
    dot = do.transpose(1, 2)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def forward(backend=backend):
            with sdpa_kernel(backend), torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        return forward, lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), backend.name
    raise RuntimeError("no scaled_dot_product_attention backend takes a boolean mask here")


def phase_packed_kernels(gen, seg, hq=32, hkv=8, d=64) -> None:
    """#1/#3 at a pack layout (``seg [B, S]``: segments 1..k, then a tail of
    segment 0) vs their plain versions in f32 and bf16, each beside a
    segment-blind control (the plain result that ignores the segments), which
    must miss; bf16 times beside SDPA given the same boolean mask."""
    import torch

    from ssi_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_reference,
    )

    b, s = seg.shape
    least = math.inf
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype) for h in (hq, hkv, hkv, hq))
        o, lse = flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True, segment_ids=seg)
        blind, _ = flash_attention_reference(q, k, v, causal=True)
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()), f"packed flash {key}: non-finite o or lse")
        _, rel_o, ctrl = hold(f"packed flash fwd {key} o", o, o_ref, key, [("segment-blind", blind)])
        err_l = (lse - lse_ref).abs().max().item()
        check(err_l <= TOL[key], f"packed flash fwd {key}: max|lse err| {err_l:.3e} > {TOL[key]}")
        least = min(least, ctrl)
        grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=seg)
        want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True, segment_ids=seg)
        blind_g = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
        rel_g = []
        for name, a, w, c in zip(("dq", "dk", "dv"), grads, want, blind_g):
            _, rel, rc = hold(f"packed flash bwd {key} {name}", a, w, key, [("segment-blind", c)])
            rel_g.append(rel)
            least = min(least, rc)
        log(f"  packed flash B{b} S{s} Hq{hq} Hkv{hkv} d{d} {key:8s}: fwd o rel {rel_o:.2e}, max|lse err| {err_l:.2e}; "
            f"bwd rel dq {rel_g[0]:.2e}, dk {rel_g[1]:.2e}, dv {rel_g[2]:.2e} (limit {REL[key]}; segment-blind "
            f"controls >= {least:.2e})")
        del q, k, v, do, o, lse, o_ref, lse_ref, blind, grads, want, blind_g
        torch.cuda.empty_cache()
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    o, lse = flash_attention_fwd(q, k, v, causal=True, segment_ids=seg)
    fwd = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True, segment_ids=seg),
                   lambda: flash_attention_reference(q, k, v, causal=True, segment_ids=seg))
    bwd = in_turns(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=seg),
                   lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True, segment_ids=seg))
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]  # [B, 1, S, S]
    run_f, run_b, backend = sdpa_with_mask(q, k, v, mask, do)
    lib_f, lib_b = time_ms(run_f), time_ms(run_b)
    pairs = allowed_pairs(seg) * hq
    fwd_bound = bound(4 * pairs * d, 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s + 4 * b * s)
    bwd_bound = bound(10 * pairs * d, 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s + 4 * b * s)
    segs = [int(seg[i].max()) for i in range(b)]
    tails = [int((seg[i] == 0).sum()) for i in range(b)]
    log(f"  packed flash time bf16 B{b} S{s} (segments {segs}, padding tails {tails}; {pairs / (b * hq * s * (s + 1) / 2):.1%} "
        f"of the causal pairs allowed): fwd kernel {fwd[0]:.3f} ms, plain {fwd[1]:.3f} ms, SDPA {lib_f:.3f} ms "
        f"({backend}: a boolean mask, kv heads repeated), bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); bwd kernel "
        f"{bwd[0]:.3f} ms, plain {bwd[1]:.3f} ms, SDPA backward {lib_b:.3f} ms, bound {bwd_bound[0]:.4f} ms "
        f"({bwd_bound[1]})")
    del q, k, v, do, o, lse, mask
    torch.cuda.empty_cache()


def plain_packed_loss(params, tokens, labels, seg, pos, cfg):
    """``make_loss_fn``'s packed loss sum through the plain attention (within
    segments) and the plain cross-entropy, on the card."""
    from ssi_tpu_torch.models.llama3 import block, rms_norm, rope_for_positions, unembed
    from ssi_tpu_torch.ops.attention import reference_attention
    from ssi_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ssi_tpu_torch.train.step import shift_labels_packed

    cos, sin = rope_for_positions(pos, cfg)
    h = params["embed"][tokens.long()]
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        h = block(h, dict(zip(names, weights)), cos, sin, cfg,
                  lambda q, k, v: reference_attention(q, k, v, causal=True, segment_ids=seg))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return fused_cross_entropy(h.reshape(-1, h.shape[-1]), unembed(params), shift_labels_packed(labels, seg).reshape(-1))


def phase_packed_loss_f32(seed: int, packs: list, samples: list) -> str:
    """f32 at 1B width, the depth cut to 2 layers: the packed loss of two
    packs equals the sum over their samples run alone (the boundary-masked
    shift drops exactly the cross-sample labels), with the kernels and with
    the plain versions, within 1e-5 of the sum; the token counts equal."""
    import numpy as np
    import torch

    from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.step import make_loss_fn, shift_labels

    cfg = model_config(num_layers=2)
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    loss_fn = make_loss_fn(cfg, remat=False)
    batch = {k: torch.from_numpy(np.stack([p[k] for p in packs])).cuda()
             for k in ("tokens", "labels", "segment_ids", "positions")}
    with torch.no_grad():
        k_loss, k_n = loss_fn(params, batch["tokens"], batch["labels"], batch["segment_ids"], batch["positions"])
        p_loss = plain_packed_loss(params, batch["tokens"], batch["labels"], batch["segment_ids"], batch["positions"], cfg)
        solo_k = solo_p = 0.0
        solo_n = 0
        for row in samples:
            t = torch.tensor([row["tokens"]], dtype=torch.int32, device="cuda")
            y = torch.tensor([row["labels"]], dtype=torch.int32, device="cuda")
            ls, n = loss_fn(params, t, y)
            solo_k += float(ls)
            solo_n += int(n)
            solo_p += float(plain_loss(params, t, y, cfg))
            check(int((shift_labels(y) != CROSS_ENTROPY_IGNORE_IDX).sum()) == int(n), "solo token count")
    check(int(k_n) == solo_n, f"packed token count {int(k_n)} != the samples' {solo_n}")
    for name, got, want in (("kernels packed vs the kernels' per-sample sum", float(k_loss), solo_k),
                            ("plain packed vs the plain per-sample sum", float(p_loss), solo_p),
                            ("kernels packed vs plain packed", float(k_loss), float(p_loss))):
        check(abs(got - want) <= 1e-5 * abs(want), f"packed loss f32: {name}: {got} vs {want}")
    del params
    torch.cuda.empty_cache()
    return (f"packed loss f32 (1B width, 2 layers; 2 packs of {len(samples)} samples, {solo_n} label tokens): kernels "
            f"{float(k_loss):.6f} vs their per-sample sum {solo_k:.6f} (rel {abs(float(k_loss) - solo_k) / abs(solo_k):.2e}); "
            f"plain {float(p_loss):.6f} vs {solo_p:.6f} (rel {abs(float(p_loss) - solo_p) / abs(solo_p):.2e}); limit 1e-5")


def phase_packed_training(seed: int, smi: str, root, sft_argv, unpacked: list[dict]) -> dict:
    """Phase k: the SFT CLI with ``data.train.packed=true data.dev.packed=true``
    on phase e's extended checkpoint at phase e's window (4 x 2 x 2048): 112
    rows (phase e's 64 and 48 more: 27 packs, 3 optimizer steps an epoch), 4
    steps, a save and a packed dev loss every 2; losses finite and falling,
    every training kernel launched; a resume from ``step_2/`` equal to the
    uninterrupted run bitwise across the epoch boundary; #1/#3 at the
    run's pack layout vs plain beside a segment-blind control; the f32
    packed-loss identity; then 2 steps with ``pack_window`` 8. Returns the
    packed run's launch counts (the kernels line's ``train_packed``)."""
    import shutil

    import numpy as np
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.cli.train_sft import main as sft_main

    cfg = model_config()
    train = root / "sft_train_packed.jsonl"
    write_jsonl(train, split_rows(seed + 11, 112, cfg.n_dsus))  # its first 64 rows are phase e's
    packed = ["data.train.packed=true", "data.dev.packed=true"]
    out = root / "sft_packed"
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    with kept_training_states({2}):
        trainer, t_run = run_cli(sft_main, sft_argv(out, *packed, train_split=train))
    launches = dict(_build.launch_counts)
    mem = torch.cuda.max_memory_allocated() / 2**30
    ds = trainer.data_train.dataset
    geo = trainer.geometry
    check(type(ds).__name__ == "PackedDataset" and type(trainer.data_dev.dataset).__name__ == "PackedDataset",
          "the packed SFT run did not pack its splits")
    check(geo.steps_per_epoch < 4 and trainer.global_step == 4, f"packed SFT: {geo.steps_per_epoch} steps an epoch, "
          f"step {trainer.global_step}: the run must cross an epoch boundary in its 4 steps")
    metrics = read_metrics(out)
    losses = [m["loss"] for m in metrics if "loss" in m]
    dev_losses = [m["dev_loss"] for m in metrics if "dev_loss" in m]
    check(len(losses) == 4 and len(dev_losses) == 2 and all(math.isfinite(x) for x in losses + dev_losses),
          f"packed SFT losses {losses}, dev {dev_losses}")
    check(losses[-1] < losses[0], f"packed SFT losses do not fall: {losses}")
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the packed SFT entry point")
    rows = [ds.dataset[i] for i in range(len(ds.dataset))]
    seq = trainer.cfg.tokenizer.max_seq_len
    share_packed = sum(int((ds[i]["segment_ids"] > 0).sum()) for i in range(len(ds))) / (len(ds) * seq)
    share_rows = sum(len(r["tokens"]) for r in rows) / (len(rows) * seq)
    share_e = sum(len(r["tokens"]) for r in rows[:64]) / (64 * seq)
    labels_packed = sum(int((ds[i]["labels"] != -100).sum()) for i in range(len(ds))) / (len(ds) * seq)
    final = {k: v.clone() for k, v in flat_params(trainer.state["params"]).items()}
    n_first = [int(ds[i]["segment_ids"].max()) for i in range(2)]
    packs = [ds[0], ds[1]]
    samples = rows[: sum(n_first)]
    seg = torch.from_numpy(np.stack([p["segment_ids"] for p in packs])).cuda()
    del trainer
    shutil.rmtree(out / "step_4")
    torch.cuda.empty_cache()

    # the step-2 resume: steps 3-4 (the epoch ends after step 3) equal the uninterrupted run's, bitwise
    out_r = root / "sft_packed_resumed"
    with no_saves():  # steps 3-4 are held in memory
        trainer, t_resume = run_cli(sft_main, sft_argv(
            out_r, *packed, f"checkpointer.checkpoint_dir={out / 'step_2'}",
            f"checkpointer.training_state_checkpoint={out / 'training_state_step2.msgpack'}", train_split=train))
    losses_r = [m["loss"] for m in read_metrics(out_r) if "loss" in m]
    check(losses_r == losses[2:], f"packed resumed losses {losses_r} != the uninterrupted run's {losses[2:]}")
    for name, w in flat_params(trainer.state["params"]).items():
        check(torch.equal(final[name], w), f"packed resumed step 4 {name} differs from the uninterrupted run's")
    del trainer, final
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(out_r, ignore_errors=True)
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    phase_packed_kernels(gen, seg)
    loss_line = phase_packed_loss_f32(seed, packs, samples)

    # pack_window: 2 steps, the shuffle moved into the dataset, the sampler sequential
    out_w = root / "sft_packed_window"
    with no_saves():
        trainer, t_window = run_cli(sft_main, sft_argv(out_w, *packed, "data.train.pack_window=8",
                                                       "data.dev.pack_window=8", "max_steps=2", "eval_steps=2",
                                                       "save_steps=2", train_split=train))
    losses_w = [m["loss"] for m in read_metrics(out_w) if "loss" in m]
    check(type(trainer.data_train.dataset).__name__ == "WindowedPackedDataset" and not trainer.sampler_train.shuffle
          and len(losses_w) == 2 and all(math.isfinite(x) for x in losses_w),
          f"pack_window run: {type(trainer.data_train.dataset).__name__}, losses {losses_w}")
    n_window = len(trainer.data_train.dataset)
    del trainer
    shutil.rmtree(out_w, ignore_errors=True)
    torch.cuda.empty_cache()

    steps = [m for m in metrics if "loss" in m]
    base = [m for m in unpacked if "loss" in m]
    mean = lambda ms, k: sum(m[k] for m in ms[1:]) / max(len(ms) - 1, 1)  # steps 2-4: the first holds warm-up
    log(f"phase k packed SFT CLI (1B bf16, remat save_qkv_mlp, window 4 x 2 x 2048, {len(rows)} rows -> {len(ds)} "
        f"packs, {geo.steps_per_epoch} steps an epoch): loss {', '.join(f'{x:.4f}' for x in losses)}, dev loss "
        f"{', '.join(f'{x:.4f}' for x in dev_losses)}; JSONL duration_step {step_readings(metrics)}; steps 2-4 mean "
        f"{mean(steps, 'duration_step') * 1e3:.1f} ms and {mean(steps, 'tokens_per_second_per_gpu'):.0f} label tok/s "
        f"beside phase e's unpacked {mean(base, 'duration_step') * 1e3:.1f} ms and "
        f"{mean(base, 'tokens_per_second_per_gpu'):.0f} label tok/s ({mean(steps, 'tokens_per_second_per_gpu') / mean(base, 'tokens_per_second_per_gpu'):.2f}x); "
        f"non-pad share: packed rows {share_packed:.3f}, the same samples unpacked {share_rows:.3f}, phase e's 64 "
        f"rows {share_e:.3f} ({share_packed / share_e:.2f}x); label share of the packed rows {labels_packed:.3f}; "
        f"CLI wall {t_run:.2f} s; peak memory {mem:.1f} GiB; on {smi}; launches {launches}")
    log(f"phase k resume from step_2/ + its state across the epoch boundary: steps 3-4 losses and step_4 weights "
        f"equal the uninterrupted run's bitwise; CLI wall {t_resume:.2f} s")
    log(f"phase k {loss_line}")
    log(f"phase k pack_window 8: 2 steps, {n_window} packs an epoch, losses {', '.join(f'{x:.4f}' for x in losses_w)}; "
        f"CLI wall {t_window:.2f} s")
    return launches


# --- phase n: training across ranks (the dp axis) ----------------------------------------------

# torchrun's script for phase n: the SFT CLI's module run as ``python -m`` runs
# it (runpy), then this rank's readings (world size, backend, peak memory,
# the last save's seconds and each sharded optimizer save's) to argv[2]; argv[1]
# names a step whose state file and sharded optimizer directory are kept as
# hard links in <output_dir>/kept<step>/ (a later save replaces and prunes
# them), and argv[3] == "1" puts every rank on card 0 (the two-rank probe)
RANK_LAUNCHER = """
import time
t_start = time.perf_counter()
import json, logging, os, runpy, sys
from pathlib import Path
import torch
import torch.distributed as dist
from ssi_tpu_torch.checkpoint import Checkpointer, sharded_io
from ssi_tpu_torch.train.trainer import Trainer

keep, report = int(sys.argv[1]), Path(sys.argv[2])
if sys.argv[3] == "1":
    os.environ["LOCAL_RANK"] = "0"
seen = {"dcp_s": []}
setup, train = Trainer.setup, Trainer.train
cleanup, save_state, save_opt = Trainer.cleanup, Checkpointer.save_training_state, sharded_io.save_opt_state

def timed(name, fn):
    def run(self):
        t0 = time.perf_counter()
        seen.setdefault("at_s", {})[f"{name}_start"] = t0 - t_start
        out = fn(self)
        seen[f"{name}_s"] = time.perf_counter() - t0
        return out
    return run

def cleanup_and_read(self):
    seen.update(world_size=self.world_size, backend=dist.get_backend() if dist.is_initialized() else None,
                save=dict(self.last_save_stats), step=self.global_step)
    t0 = time.perf_counter()
    cleanup(self)
    seen["cleanup_s"] = time.perf_counter() - t0

def save_and_keep(ckpt, **kwargs):
    path = save_state(ckpt, **kwargs)
    if kwargs["global_step"] == keep:
        kept = ckpt.output_dir / f"kept{keep}"
        kept.mkdir()
        os.link(path, kept / path.name)
        marker = kwargs["optimizer_state"].get(sharded_io.DCP_DIR_KEY)
        for f in (ckpt.output_dir / marker).rglob("*") if marker else ():
            (kept / f.relative_to(ckpt.output_dir)).parent.mkdir(parents=True, exist_ok=True)
            os.link(f, kept / f.relative_to(ckpt.output_dir))
        (kept / "complete").touch()  # a run resumed from it may start now
    return path

def timed_save(*args, **kwargs):
    t0 = time.perf_counter()
    out = save_opt(*args, **kwargs)
    seen["dcp_s"].append(time.perf_counter() - t0)
    return out

Trainer.cleanup, Checkpointer.save_training_state, sharded_io.save_opt_state = cleanup_and_read, save_and_keep, timed_save
Trainer.setup, Trainer.train = timed("setup", setup), timed("train", train)
sys.argv = ["ssi_tpu_torch.cli.train_sft", *sys.argv[4:]]
runpy.run_module("ssi_tpu_torch.cli.train_sft", run_name="__main__")
seen["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
seen["process_s"] = time.perf_counter() - t_start
report.with_name(f"{report.stem}_rank{os.environ['RANK']}.json").write_text(json.dumps(seen))
# every file is written and closed, the process group destroyed: skip the
# interpreter's teardown of the CUDA context (seconds that would fall in the run)
logging.shutdown()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""

NCCL_PROBE = """
import os
import torch
import torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl")
t = torch.full((1,), float(int(os.environ["RANK"]) + 1), device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print(f"ALL_REDUCE {t.item()}", flush=True)
dist.destroy_process_group()
"""


def run_torchrun(target: list[str], n: int, log_path, env: dict, timeout: float) -> tuple[int, float]:
    """``python -m torch.distributed.run --standalone --nproc_per_node n`` on
    ``target``, its output to ``log_path``; in a session of its own, killed
    whole at ``timeout``. Returns (exit code, wall s)."""
    import signal

    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                 str(n), *target], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, time.perf_counter() - t0


def file_digests(step_dir) -> dict[str, str]:
    import hashlib

    out = {}
    for path in sorted(step_dir.glob("*.safetensors")):
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        out[path.name] = h.hexdigest()
    return out


def dcp_tensors(path) -> dict:
    """A sharded optimizer directory read whole on the host (no process group)."""
    import torch
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata()
    sd = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.state_dict_metadata.items()}
    dcp.load(sd, checkpoint_id=str(path), no_dist=True)
    return sd


def phase_distributed(seed: int, smi: str, root, sft_argv, e: dict) -> dict:
    """Phase n: the SFT CLI under ``torchrun --standalone --nproc_per_node 1``
    with ``parallel.distributed=true`` (NCCL at world size 1) on phase e's
    extended checkpoint, data and window: n1 ZeRO-1 (no dev evaluation) and
    n2 FSDP with the sharded optimizer state (saves at steps 2 and 4), run at
    once, and n3, n2 resumed from step 2, started once n1 has ended and n2
    has kept its step-2 state. At one rank each collective is the
    identity and no leaf is sharded, so n1's and n2's losses, grad norms and
    ``step_4/`` files and n2's dev losses equal phase e's undistributed run
    bitwise, and n3's steps 3-4, ``step_4/`` and step-4 moments equal n2's. Then two ranks on the one card, once: NCCL's
    answer is printed, and if it accepts them, n4 trains at dp 2 with the
    per-rank batch halved, held to n1's losses within 1e-2. ``e``: phase e's
    metrics, ``step_4/`` digests, peak memory and save readings. Returns the
    runs' launch counts (the kernels line's ``train_dp``)."""
    import concurrent.futures
    import shutil
    import threading

    import torch

    launcher, counts_file = root / "rank_launcher.py", root / "dp_launches.jsonl"
    launcher.write_text(RANK_LAUNCHER)
    env = {**os.environ, "PYTHONPATH": REPO, "SSI_TPU_TORCH_LAUNCH_COUNTS": str(counts_file)}
    dist_args = ["parallel.distributed=true"]

    def run(name: str, *extra, keep: int = 0, n: int = 1, one_card: bool = False) -> dict:
        out = root / name
        code, wall = run_torchrun([str(launcher), str(keep), str(root / f"{name}.json"), "1" if one_card else "0",
                                   *sft_argv(out, *dist_args, *extra)], n, root / f"{name}.log", env, 300)
        check(code == 0, f"phase n {name}: torchrun exited {code}:\n{(root / f'{name}.log').read_text()[-3000:]}")
        report = json.loads((root / f"{name}_rank0.json").read_text())
        metrics = read_metrics(out)
        return {"out": out, "wall": wall, "report": report, "metrics": metrics,
                "losses": [m["loss"] for m in metrics if "loss" in m],
                "norms": [m["grad_norm"] for m in metrics if "loss" in m],
                "dev": [m["dev_loss"] for m in metrics if "dev_loss" in m]}

    e_losses = [m["loss"] for m in e["metrics"] if "loss" in m]
    e_norms = [m["grad_norm"] for m in e["metrics"] if "loss" in m]
    e_dev = [m["dev_loss"] for m in e["metrics"] if "dev_loss" in m]
    # n1 and n2 run at once, and n3 starts once n1 has ended and n2 has kept its step-2 state (two 1B runs
    # share the card at a time, ~22 GiB each), and n1 runs no dev evaluation (eval_steps and save_steps past
    # max_steps: its one save is the final step_4/): to make room in the run for phase t. n2 holds the
    # distributed path's dev losses to phase e's. Two ranks on the one card, NCCL's answer, are asked while
    # n3 runs.
    probe = root / "nccl_probe.py"
    probe.write_text(NCCL_PROBE)
    asked: dict = {}

    def n3_from_n2_step2(n1_run, n2_run) -> dict:
        kept = root / "dp_n2" / "kept2" / "complete"  # the rank launcher writes it once step 2 is kept
        while not (kept.exists() and n1_run.done()) and not n2_run.done():
            time.sleep(0.5)
        check(kept.exists(), "n2 ended without keeping its step-2 state")
        asking = threading.Thread(target=lambda: asked.update(
            zip(("code", "seconds"), run_torchrun([str(probe)], 2, root / "nccl_probe.log", env, 120))))
        asking.start()
        out = run("dp_n3", "parallel.fsdp=true", "sharded_optimizer_state=true",
                  f"checkpointer.checkpoint_dir={root / 'dp_n2' / 'step_2'}",
                  f"checkpointer.training_state_checkpoint={root / 'dp_n2' / 'kept2' / 'training_state.msgpack'}")
        asking.join()
        return out

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        n1_run = pool.submit(run, "dp_n1", "parallel.zero1=true", "save_steps=6", "eval_steps=6")
        n2_run = pool.submit(run, "dp_n2", "parallel.fsdp=true", "sharded_optimizer_state=true", keep=2)
        n3_run = pool.submit(n3_from_n2_step2, n1_run, n2_run)
        n1, n2, n3 = n1_run.result(), n2_run.result(), n3_run.result()
    check(n1["report"]["world_size"] == 1 and n1["report"]["backend"] == "nccl",
          f"n1 ran at world size {n1['report']['world_size']} on {n1['report']['backend']}, not 1 on nccl")
    check(n1["losses"] == e_losses and n1["norms"] == e_norms and n1["dev"] == [],
          f"n1 (ZeRO-1, world 1, no dev evaluation) losses {n1['losses']} / norms {n1['norms']} / dev {n1['dev']} "
          f"!= phase e's {e_losses} / {e_norms} / []")
    check(file_digests(n1["out"] / "step_4") == e["digests"], "n1's step_4/ differs from phase e's")
    shutil.rmtree(n1["out"])

    check(n2["losses"] == e_losses and n2["norms"] == e_norms and n2["dev"] == e_dev,
          f"n2 (FSDP, sharded state, world 1) losses {n2['losses']} != phase e's {e_losses}")
    n2_digests = file_digests(n2["out"] / "step_4")
    check(n2_digests == e["digests"], "n2's step_4/ differs from phase e's")
    check(sorted(p.name for p in n2["out"].glob("optimizer_state_dcp_step*")) == ["optimizer_state_dcp_step4"],
          "n2 did not keep exactly its newest sharded optimizer directory")
    check(n3["losses"] == n2["losses"][2:] and n3["norms"] == n2["norms"][2:],
          f"n3 (resumed from step 2) losses {n3['losses']} != n2's {n2['losses'][2:]}")
    check(file_digests(n3["out"] / "step_4") == n2_digests, "n3's step_4/ differs from n2's")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        a, b = pool.map(dcp_tensors, [n2["out"] / "optimizer_state_dcp_step4", n3["out"] / "optimizer_state_dcp_step4"])
    check(sorted(a) == sorted(b) and int(a["count"]) == 4
          and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
          "n3's step-4 moments differ from n2's")
    n_moment_bytes = sum(t.numel() * t.element_size() for t in a.values())
    t_moments = time.perf_counter() - t0
    del a, b
    shutil.rmtree(n2["out"])
    shutil.rmtree(n3["out"])

    code, t_probe = asked["code"], asked["seconds"]
    text = (root / "nccl_probe.log").read_text()
    lines = [line.strip() for line in text.splitlines()]
    answer = next((x for x in lines if "Duplicate GPU" in x), None) or next((x for x in lines if "Error" in x), None)
    if code == 0:
        check(text.count("ALL_REDUCE 3.0") == 2, f"two ranks on one card: all-reduce gave\n{text[-2000:]}")
        n4 = run("dp_n4", "data.train.dataloader.batch_size=1", "save_steps=4", n=2, one_card=True)
        check(all(abs(a - b) <= 1e-2 * abs(b) for a, b in zip(n4["losses"], n1["losses"])) and len(n4["losses"]) == 4,
              f"n4 (dp 2 on one card) losses {n4['losses']} not within 1e-2 of n1's {n1['losses']}")
        answer = f"accepted: n4 losses {', '.join(f'{x:.4f}' for x in n4['losses'])}"
        shutil.rmtree(n4["out"])
    else:
        answer = f"refused (torchrun exit {code}): {answer or 'no error line'}"

    launches: dict[str, int] = {}
    for line in counts_file.read_text().splitlines():
        for name, count in json.loads(line)["launch_counts"].items():
            launches[name] = launches.get(name, 0) + count
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by phase n's runs")
    mean = lambda ms, k: sum(m[k] for m in ms[1:]) / 3  # noqa: E731  steps 2-4: the first holds warm-up
    steps = {name: [m for m in r["metrics"] if "loss" in m] for name, r in (("e", e), ("n1", n1), ("n2", n2))}
    log(f"phase n (torchrun --nproc_per_node 1, NCCL, world 1; 1B bf16, phase e's window 4 x 2 x 2048): n1 ZeRO-1 "
        f"(no dev evaluation) and n2 FSDP + sharded optimizer state, run at once with n3: losses, grad norms, step_4/ "
        f"and n2's dev losses equal phase e's bitwise; "
        f"n3 (n2 resumed from step 2): steps 3-4, step_4/ and the step-4 moments ({n_moment_bytes / 1e9:.2f} GB, "
        f"read back in {t_moments:.1f} s) equal n2's bitwise")
    log(f"phase n readings on {smi} (n1 and n2 at once, n3 with n2's last steps): steps 2-4 mean duration_step "
        f"phase e {mean(steps['e'], 'duration_step') * 1e3:.1f} "
        f"ms, n1 {mean(steps['n1'], 'duration_step') * 1e3:.1f}, n2 {mean(steps['n2'], 'duration_step') * 1e3:.1f} "
        f"({mean(steps['n1'], 'duration_step') / mean(steps['e'], 'duration_step'):.3f}x and "
        f"{mean(steps['n2'], 'duration_step') / mean(steps['e'], 'duration_step'):.3f}x); label tok/s e "
        f"{mean(steps['e'], 'tokens_per_second_per_gpu'):.0f}, n1 {mean(steps['n1'], 'tokens_per_second_per_gpu'):.0f}, "
        f"n2 {mean(steps['n2'], 'tokens_per_second_per_gpu'):.0f}; JSONL duration_step n1 {step_readings(n1['metrics'])}; "
        f"n2 {step_readings(n2['metrics'])}; peak memory e {e['peak_gib']:.1f} GiB, n1 {n1['report']['peak_gib']:.1f}, "
        f"n2 {n2['report']['peak_gib']:.1f}, n3 {n3['report']['peak_gib']:.1f}; save at step 4: e model "
        f"{e['save']['model_s']:.2f} s + state {e['save']['state_s']:.2f} s, n1 {n1['report']['save']['model_s']:.2f} + "
        f"{n1['report']['save']['state_s']:.2f} s, n2 {n2['report']['save']['model_s']:.2f} s + sharded moments "
        f"{', '.join(f'{x:.2f}' for x in n2['report']['dcp_s'])} s (steps 2, 4) + state file "
        f"{n2['report']['save']['state_s']:.2f} s, n3 {n3['report']['save']['model_s']:.2f} s + sharded moments "
        f"{', '.join(f'{x:.2f}' for x in n3['report']['dcp_s'])} s; launches {launches}")
    log("phase n where each torchrun run's wall went (s): " + "; ".join(
        f"{name} wall {r['wall']:.1f} = to setup {r['report']['at_s']['setup_start']:.1f}, setup "
        f"{r['report']['setup_s']:.1f}, train {r['report']['train_s']:.1f}, cleanup {r['report']['cleanup_s']:.1f}, "
        f"exit and launcher {r['wall'] - r['report']['process_s']:.1f}" for name, r in (("n1", n1), ("n2", n2), ("n3", n3))))
    log(f"phase n two ranks on one card (torchrun --nproc_per_node 2, NCCL, both on card 0; {t_probe:.1f} s): {answer}")
    return launches


# --- phase m: the BPE-compressed DSU axis at 1B ------------------------------------------------


def markov_dsu_rows(seed: int, n: int, units: int = 5000, out_degree: int = 8, hold: float = 0.25) -> list[dict]:
    """``n`` aligned CPT rows whose speech tokens walk a Markov chain, the shape
    of ``docs/COMPRESSED_DSU.md``'s corpus: a ``units``-entry alphabet with
    Zipf(1) weights, each unit with ``out_degree`` successors drawn by those
    weights, a hold (the unit repeats) with probability ``hold`` at each
    step; 8-14 task words of 0.2-0.6 s with HuBERT-rate tokens (50 per
    second) over the utterance."""
    import numpy as np

    from ssi_tpu_torch.wer_drive import WORDS

    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, units + 1)
    weights /= weights.sum()
    successors = rng.choice(units, size=(units, out_degree), p=weights)
    rows = []
    for _ in range(n):
        n_words = int(rng.integers(8, 15))
        ends = np.cumsum(rng.uniform(0.2, 0.6, n_words))
        starts = np.concatenate([[0.0], ends[:-1]])
        m = int(ends[-1] * 50) + 1
        moves, picks = rng.random(m) >= hold, rng.integers(0, out_degree, m)
        unit, speech = int(rng.choice(units, p=weights)), []
        for i in range(m):
            if i and moves[i]:
                unit = int(successors[unit, picks[i]])
            speech.append(unit)
        rows.append({"tokenized": [WORDS[j] for j in rng.integers(0, len(WORDS), n_words)],
                     "align_t_starts": starts.tolist(), "align_t_ends": ends.tolist(), "speech_tokens": speech})
    return rows


def phase_compressed(seed: int, smi: str, root, base, cpt_argv, base_cpt: list[dict]) -> dict:
    """Phase m: the BPE-compressed DSU axis through the port's CLIs at the full
    width of ``llama3_2_1b``, on phase e's synthesized base: merges trained
    by ``python -m ssi_tpu_torch.cli.train_dsu_bpe`` over a Markov DSU corpus
    (128 rows, 1,024 merges, deduplicated), appended to the base tokenizer
    with the modality tokens (n_new), the extension CLI with ``--n_new_dsus
    n_new`` and the compressed ``tokenizer.model`` swapped in, the CPT CLI
    with ``tokenizer.pattern=cl100k`` for 2 steps at phase e's window, the
    generation CLI with ``tokenizer.pattern=cl100k`` (16 prompts x 64
    greedy tokens), and #5-#7 held against their plain versions at the
    compressed vocabulary. Returns the CPT and generation runs' launch
    counts together (the kernels line's ``cpt_compressed``)."""
    from itertools import groupby
    import shutil

    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.cli.extend_llama3_2 import main as extend_main, parse_args as extend_args
    from ssi_tpu_torch.cli.generate import main as generate_main
    from ssi_tpu_torch.cli.train_cpt import main as cpt_main
    from ssi_tpu_torch.cli.train_dsu_bpe import main as bpe_main, parse_args as bpe_args
    from ssi_tpu_torch.data.cpt import TextCompletionDataset
    from ssi_tpu_torch.speech import dsu2pua
    from ssi_tpu_torch.tokenizer import load_tiktoken_bpe, setup_llama3_tokenizer
    from ssi_tpu_torch.tokenizer.bpe_train import merge_into_tokenizer

    t_phase = time.perf_counter()
    # the recipe's corpus is 1,500 rows and 4,096 merges; 128 rows (the CPT's two
    # windows) and 1,024 merges keep the trainer's host time near 11 s on the card's
    # machine (256 rows took 21.7 s, and the run passed half its time limit)
    rows = markov_dsu_rows(seed + 31, 128)
    corpus_file = root / "dsu_corpus.jsonl"
    write_jsonl(corpus_file, rows)

    # 1. merges over the corpus, through the CLI as a user runs it (host only)
    bpe_dir = root / "dsu_bpe"
    stats, t_bpe = run_cli(lambda a: bpe_main(bpe_args(a)), [
        str(bpe_dir), "--dataset", "json", "--data-files", str(corpus_file), "--n-merges", "1024", "--deduplicate"])
    check(stats["n_rows"] == len(rows) and stats["n_merges_learned"] == 1024, f"train_dsu_bpe stats {stats}")

    # 2. the merges appended to the base tokenizer, with the modality tokens
    compressed = root / "compressed_tokenizer.model"
    n_new = merge_into_tokenizer(base / "original" / "tokenizer.model", load_tiktoken_bpe(bpe_dir / "tokenizer.model"),
                                 compressed, use_modality_tokens=True)
    v_c = len(load_tiktoken_bpe(base / "original" / "tokenizer.model")) + n_new + 2 + 256  # 128,000 + n_new + 2 + 256

    # 3. the extension CLI by n_new rows, then the compressed tokenizer swapped in
    ext = root / "extended_compressed"
    _, t_extend = run_cli(lambda a: extend_main(extend_args(a)), [
        "--n_new_dsus", str(n_new), "--sigma-scaling", "1.0", "--model-config", "llama3_2_1b",
        "--input_dir", str(base), "--output_dir", str(ext)])
    shutil.copyfile(compressed, ext / "original" / "tokenizer.model")
    hf = json.loads((ext / "config.json").read_text())
    tok, special = setup_llama3_tokenizer(ext / "original" / "tokenizer.model", verbose=False, pattern="cl100k")
    check(hf["vocab_size"] == v_c == tok.vocab_size, f"compressed vocab: config {hf['vocab_size']}, "
          f"tokenizer {tok.vocab_size}, expected {v_c}")
    check((hf["bos_token_id"], hf["eos_token_id"]) == (tok.bos_id, tok.eos_id)
          == (special["<|begin_of_text|>"], special["<|end_of_text|>"]),
          f"config.json bos/eos {hf['bos_token_id']}/{hf['eos_token_id']} != the compressed tokenizer's "
          f"{tok.bos_id}/{tok.eos_id}")

    # the same rows under the PUA and the cl100k pattern; the host encode rate of each
    pua, _ = setup_llama3_tokenizer(ext / "original" / "tokenizer.model", verbose=False)
    counts = {}
    for seq_type in ("dsu_only", "interleaved"):
        for name, t in (("pua", pua), ("cl100k", tok)):
            ds = TextCompletionDataset(
                t, source="json", data_files=str(corpus_file), split="train", sequence_type=seq_type,
                deduplicate=True, use_modality_tokens=True,
                interleave_kwargs={"sampling_rate": 16000, "downsampling_ratio": 320, "mean_seq_len_tokens": 39.43,
                                   "binom_prob": 0.1})
            counts[seq_type, name] = sum(len(ds[i]["tokens"]) for i in range(len(ds)))
    check(counts["dsu_only", "cl100k"] < counts["dsu_only", "pua"],
          f"dsu_only: {counts['dsu_only', 'cl100k']} tokens under cl100k, not fewer than the PUA pattern's "
          f"{counts['dsu_only', 'pua']}")
    lines = ["".join(dsu2pua(k) for k, _ in groupby(r["speech_tokens"])) for r in rows]
    n_chars = sum(map(len, lines))
    rates = {}
    for name, t in (("pua", pua), ("cl100k", tok)):
        t0 = time.perf_counter()
        n_ids = sum(len(t.encode(line, add_bos=False, add_eos=False)) for line in lines)
        dt = time.perf_counter() - t0
        rates[name] = (n_chars / dt, n_ids / dt, n_ids)

    # 4. CPT through conf/cpt.yaml with the cl100k pattern: 2 steps at phase e's window
    out = root / "cpt_compressed"
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    trainer, t_cpt = run_cli(cpt_main, cpt_argv(
        out, ext, corpus_file, corpus_file, "tokenizer.pattern=cl100k", f"speech.n_dsus={n_new}"))
    launches = dict(_build.launch_counts)
    mem_cpt = torch.cuda.max_memory_allocated() / 2**30
    metrics = read_metrics(out)
    losses = [m["loss"] for m in metrics if "loss" in m]
    check(trainer.tokenizer.pattern == tok.pattern and trainer.cfg.speech.n_dsus == n_new,
          "the CPT CLI did not load the cl100k tokenizer at n_new")
    check(trainer.cfg.gradient_accumulation_steps == 16 and trainer.geometry.batch_size == 4
          and trainer.cfg.tokenizer.max_seq_len == 768, "CPT did not run the conf's 4 x 16 x 768 window")
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses), f"compressed CPT losses {losses}")
    n_dsu_tokens = trainer.token_type_counts_total.get("dsu", 0)
    check(n_dsu_tokens > 0, "compressed CPT counted no tokens in the appended range")
    for name in TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched by the compressed CPT run")
    del trainer
    shutil.rmtree(ext)
    torch.cuda.empty_cache()

    # 5. generation with the cl100k pattern from the CPT checkpoint: 16 prompts x 64 greedy tokens
    step = out / "step_2"
    split = root / "compressed_test.jsonl"
    write_jsonl(split, [{"speech_tokens": r["speech_tokens"], "transcript": " ".join(r["tokenized"]), "ID": f"m_{i}"}
                        for i, r in enumerate(rows[:16])])
    out_g = root / "generate_compressed"
    _build.launch_counts.clear()
    _, t_gen = run_cli(generate_main, [
        f"model={step}", f"experiments_root_dir={root / 'experiments'}",
        f"tokenizer.path={step / 'original' / 'tokenizer.model'}", "tokenizer.pattern=cl100k",
        f"speech.n_dsus={n_new}", "data=sft/mls-hubert_large_ll60k-layer_22", "data.test.dataset.source=json",
        f"+data.test.dataset.data_files={split}", "data.test.dataset.split=train", "gen.split=test",
        f"gen.output_dir={out_g}", "batch_size=16", "sampling_params.max_tokens=64", "dtype=bf16"])
    gen_launches = dict(_build.launch_counts)
    records = [json.loads(x) for x in (out_g / "json" / "test" / "generations.jsonl").read_text().splitlines()]
    check(len(records) == 16, f"compressed generate: {len(records)} records, expected 16")
    for r in records:
        o = r["outputs"][0]
        check(r["finished"] is True and 0 < len(o["token_ids"]) <= 64 and all(0 <= t < v_c for t in o["token_ids"]),
              f"compressed generate record {r['request_id']}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(o["text"] == tok.decode(o["token_ids"]), f"compressed generate record {r['request_id']}: its text is "
              "not the cl100k tokenizer's decode of its tokens")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(gen_launches.get(name, 0) > 0, f"kernel {name} was not launched by the compressed generation run")
    n_gen = sum(len(r["outputs"][0]["token_ids"]) for r in records)
    shutil.rmtree(out)
    shutil.rmtree(out_g)

    # 6. #5-#7 against their plain versions at the compressed vocabulary
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 97)
    phase_cross_entropy(gen, v_c, ns=(4096,), tag=f"phase m cross entropy at V_c {v_c:,}")

    log(f"phase m train_dsu_bpe CLI ({len(rows)} rows, {stats['n_dsu_tokens']} deduplicated DSUs, 1,024 merges): "
        f"{t_bpe:.2f} s; compression {stats['compression_ratio_chars_per_token']} chars/token (stats.json); "
        f"n_new {n_new}, V_c {v_c:,}; extension CLI {t_extend:.2f} s")
    log(f"phase m tokens of the {len(rows)} rows, PUA -> cl100k: dsu_only {counts['dsu_only', 'pua']} -> "
        f"{counts['dsu_only', 'cl100k']} ({counts['dsu_only', 'pua'] / counts['dsu_only', 'cl100k']:.3f}x), "
        f"interleaved {counts['interleaved', 'pua']} -> {counts['interleaved', 'cl100k']} "
        f"({counts['interleaved', 'pua'] / counts['interleaved', 'cl100k']:.3f}x)")
    log(f"phase m host encode rate of the {len(lines)} deduplicated DSU rows ({n_chars} DSUs; each row one piece "
        f"under cl100k): PUA {rates['pua'][0]:.0f} DSUs/s ({rates['pua'][1]:.0f} tokens/s, {rates['pua'][2]} "
        f"tokens), cl100k {rates['cl100k'][0]:.0f} DSUs/s ({rates['cl100k'][1]:.0f} tokens/s, "
        f"{rates['cl100k'][2]} tokens)")
    log(f"phase m CPT CLI (1B bf16, tokenizer.pattern=cl100k, speech.n_dsus={n_new}, window 16 x 4 x 768, "
        f"interleaved): loss {', '.join(f'{x:.4f}' for x in losses)}; steps {step_readings(metrics)} (phase e's "
        f"CPT: {step_readings(base_cpt)}); n_tokens.dsu {n_dsu_tokens}; CLI wall {t_cpt:.2f} s; peak memory "
        f"{mem_cpt:.1f} GiB; on {smi}; launches {launches}")
    log(f"phase m generate CLI (tokenizer.pattern=cl100k, 16 prompts x 64 greedy tokens, bf16): {n_gen} tokens, "
        f"every record finished and decodes; CLI wall {t_gen:.2f} s; launches {gen_launches}")
    log(f"  [phase m: {time.perf_counter() - t_phase:.1f} s]")
    return {name: launches.get(name, 0) + gen_launches.get(name, 0) for name in {*launches, *gen_launches}}


# --- phase q: local dataset sources and a raw split regex through the training CLIs ----------


class no_saves:
    """The Trainer's saves skipped (a run compared by its losses only)."""

    def __enter__(self):
        from ssi_tpu_torch.train.trainer import Trainer

        self.original = Trainer.save_checkpoint
        Trainer.save_checkpoint = lambda trainer: None
        return self

    def __exit__(self, *exc):
        from ssi_tpu_torch.train.trainer import Trainer

        Trainer.save_checkpoint = self.original


def hf_dataset_dir(directory, train_rows: list[dict], dev_rows: list[dict]) -> str:
    """``train_rows`` in two shards and ``dev_rows`` in one, as a downloaded HF
    dataset repo lays them out (``data/<split>-0000i-of-0000n.parquet`` and a
    README ``configs:`` block naming them); JSON-lines shards of the same
    names when pyarrow does not import. Returns the shards' extension."""
    from ssi_tpu_torch.utils import import_optional

    try:
        pa = import_optional("pyarrow", "Writing phase q's parquet shards")
        pq = import_optional("pyarrow.parquet", "Writing phase q's parquet shards")
    except ImportError:
        pq = None
    ext = "parquet" if pq is not None else "jsonl"
    (directory / "data").mkdir(parents=True)
    half = len(train_rows) // 2
    for name, part in (("train-00000-of-00002", train_rows[:half]), ("train-00001-of-00002", train_rows[half:]),
                       ("validation-00000-of-00001", dev_rows)):
        if pq is not None:
            pq.write_table(pa.Table.from_pylist(part), directory / "data" / f"{name}.parquet", row_group_size=16)
        else:
            write_jsonl(directory / "data" / f"{name}.jsonl", part)
    (directory / "README.md").write_text(
        f"---\nconfigs:\n- config_name: default\n  data_files:\n  - split: train\n    path: data/train-*.{ext}\n"
        f"  - split: validation\n    path: data/validation-*.{ext}\n---\n# phase q rows\n")
    return ext


def phase_local_sources(smi: str, root, ext, sft_argv, cpt_argv, sft_files, cpt_files, sft_metrics: list[dict],
                        cpt_metrics: list[dict]) -> dict:
    """Phase q: the slice's host modules on phase e's runs at the full width
    of ``llama3_2_1b``, inside phase e on its extended checkpoint. q1: phase
    e's SFT run for 2 steps (no save), both splits read from a local dataset
    directory in the HF repo layout (two parquet train shards, one validation
    shard, a README ``configs:`` block) holding phase e's rows, passed as
    ``data.{train,dev}.dataset.source=<dir>`` with no ``data_files``: losses,
    grad norms and the step-2 dev loss bitwise phase e's. q2: phase e's CPT
    run (2 steps, no save) with ``tokenizer.pattern`` the PUA pattern wrapped
    as ``(?:...)``, the same language in a string the C++ scanner does not
    take, so the ``regex`` route splits it: every CPT row's tokens equal the
    scanner's, losses and grad norms bitwise phase e's CPT. Prints the split
    read time (directory beside JSON lines), the host encode rate of each
    route, step readings and the phase's seconds. Returns both runs' launch
    counts together (the kernels line's ``train_local``)."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.cli.train_cpt import main as cpt_main
    from ssi_tpu_torch.cli.train_sft import main as sft_main
    from ssi_tpu_torch.data import _as_kwargs, load_hf_dataset
    from ssi_tpu_torch.data.cpt import TextCompletionDataset
    from ssi_tpu_torch.speech import dsu2pua
    from ssi_tpu_torch.tokenizer import CL100K_PATTERN_PUA, setup_llama3_tokenizer

    t_phase = time.perf_counter()

    def per_step(metrics, key):
        return [m[key] for m in metrics if "loss" in m][:2]

    # q1. SFT from a local dataset directory, both splits, no data_files
    rows = {name: [json.loads(line) for line in path.read_text().splitlines()] for name, path in sft_files.items()}
    directory = root / "sft_hf"
    shard_ext = hf_dataset_dir(directory, rows["train"], rows["dev"])
    reads = {}
    for name, read in (("jsonl", lambda: [load_hf_dataset("json", data_files=str(sft_files[s]), split="train")
                                          for s in ("train", "dev")]),
                       ("dir", lambda: [load_hf_dataset(str(directory), split=s) for s in ("train", "validation")])):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read()
            times.append(time.perf_counter() - t0)
        reads[name] = (min(times), got)
    check(reads["dir"][1] == reads["jsonl"][1], "the dataset directory's rows differ from phase e's JSON lines")
    argv = [a for a in sft_argv(root / "q1") if not a.startswith(("data.train.dataset.", "data.dev.dataset.",
                                                                   "+data.train.dataset.", "+data.dev.dataset."))]
    argv += [f"data.train.dataset.source={directory}", f"data.dev.dataset.source={directory}",
             "data.train.dataset.split=train", "data.dev.dataset.split=validation", "max_steps=2"]
    _build.launch_counts.clear()
    with no_saves():
        trainer, t_sft = run_cli(sft_main, argv)
    sft_launches = dict(_build.launch_counts)
    check(trainer.global_step == 2 and str(trainer.cfg.data.train.dataset.source) == str(directory),
          f"q1 ran {trainer.global_step} steps from {trainer.cfg.data.train.dataset.source}")
    del trainer
    torch.cuda.empty_cache()
    q1 = read_metrics(root / "q1")
    for key in ("loss", "grad_norm"):
        check(per_step(q1, key) == per_step(sft_metrics, key),
              f"q1 {key} {per_step(q1, key)} != phase e's {per_step(sft_metrics, key)}")
    dev_q1 = [m["dev_loss"] for m in q1 if "dev_loss" in m]
    dev_e = [m["dev_loss"] for m in sft_metrics if "dev_loss" in m][:1]
    check(dev_q1 == dev_e, f"q1 dev loss {dev_q1} != phase e's {dev_e}")
    for name in TRAIN_KERNELS:
        check(sft_launches.get(name, 0) > 0, f"kernel {name} was not launched by the q1 SFT run")

    # q2. CPT with a raw split regex: the PUA pattern wrapped, so the regex route splits it
    wrapped = f"(?:{CL100K_PATTERN_PUA})"
    tok_path = ext / "original" / "tokenizer.model"
    scanner, _ = setup_llama3_tokenizer(tok_path, verbose=False)
    try:
        regex_tok, _ = setup_llama3_tokenizer(tok_path, verbose=False, pattern=wrapped)
    except ImportError as e:
        check("'regex'" in str(e), f"the regex route's refusal does not name the package: {e}")
        try:
            run_cli(cpt_main, cpt_argv(root / "q2", ext, cpt_files["train"], cpt_files["dev"],
                                       f"tokenizer.pattern={wrapped}"))
        except ImportError as cli_error:
            check("'regex'" in str(cli_error), f"the CPT CLI's refusal does not name regex: {cli_error}")
        else:
            check(False, "the CPT CLI ran a raw regex without the regex package")
        log(f"phase q2: regex does not import here; the CPT CLI refuses tokenizer.pattern={wrapped[:24]}... "
            f"naming it: {e}")
        cpt_launches = {}
    else:
        _build.launch_counts.clear()
        with no_saves():
            trainer, t_cpt = run_cli(cpt_main, cpt_argv(root / "q2", ext, cpt_files["train"], cpt_files["dev"],
                                                        f"tokenizer.pattern={wrapped}"))
        cpt_launches = dict(_build.launch_counts)
        check(trainer.tokenizer.pattern == wrapped and trainer.tokenizer._split is not None,
              "the q2 CPT run did not take the regex route")
        kwargs = _as_kwargs(trainer.cfg.data.train.dataset)
        del trainer
        torch.cuda.empty_cache()
        ds = {name: TextCompletionDataset(tokenizer=t, **kwargs) for name, t in (("regex", regex_tok),
                                                                                 ("scanner", scanner))}
        n_rows = len(ds["regex"])
        n_tokens = 0
        for i in range(n_rows):
            a, b = ds["regex"][i]["tokens"], ds["scanner"][i]["tokens"]
            check(a == b, f"q2 CPT row {i}: the regex route's tokens differ from the scanner's")
            n_tokens += len(a)
        q2 = read_metrics(root / "q2")
        for key in ("loss", "grad_norm"):
            check(per_step(q2, key) == per_step(cpt_metrics, key),
                  f"q2 {key} {per_step(q2, key)} != phase e's CPT {per_step(cpt_metrics, key)}")
        for name in TRAIN_KERNELS:
            check(cpt_launches.get(name, 0) > 0, f"kernel {name} was not launched by the q2 CPT run")
        cpt_rows_ = [json.loads(line) for line in cpt_files["train"].read_text().splitlines()]
        texts = ["".join(dsu2pua(t) for t in r["speech_tokens"]) for r in cpt_rows_] + \
            [" ".join(r["tokenized"]) for r in cpt_rows_]
        n_chars = sum(map(len, texts))
        rates = {}
        for name, t in (("scanner", scanner), ("regex", regex_tok)):
            t0 = time.perf_counter()
            n_ids = sum(len(t.encode(x, add_bos=False, add_eos=False)) for x in texts)
            dt = time.perf_counter() - t0
            rates[name] = (n_chars / dt, n_ids / dt, n_ids)
        check(rates["regex"][2] == rates["scanner"][2], "the two routes encode the rows to different counts")
        log(f"phase q2 CPT CLI (1B bf16, tokenizer.pattern=(?:CL100K_PATTERN_PUA), the regex route; window 16 x 4 x "
            f"768, 2 steps, no save): loss {', '.join(f'{x:.4f}' for x in per_step(q2, 'loss'))}, losses and grad "
            f"norms bitwise phase e's CPT; all {n_rows} rows' tokens ({n_tokens}) equal the scanner's; steps "
            f"{step_readings(q2)} (phase e's CPT: {step_readings(cpt_metrics)}); CLI wall {t_cpt:.2f} s; "
            f"launches {cpt_launches}")
        log(f"phase q2 host encode rate of the {len(texts)} CPT rows' DSU strings and transcripts ({n_chars} chars, "
            f"{rates['regex'][2]} tokens): scanner {rates['scanner'][0]:.0f} chars/s ({rates['scanner'][1]:.0f} "
            f"tokens/s), regex route {rates['regex'][0]:.0f} chars/s ({rates['regex'][1]:.0f} tokens/s), "
            f"{rates['regex'][0] / rates['scanner'][0]:.3f}x; on {smi}")
    log(f"phase q1 SFT CLI (1B bf16, window 4 x 2 x 2048, 2 steps, no save) from a dataset directory ({shard_ext} "
        f"shards: 2 train, 1 validation, README configs), no data_files: loss "
        f"{', '.join(f'{x:.4f}' for x in per_step(q1, 'loss'))}, grad norms and the step-2 dev loss bitwise phase "
        f"e's; steps {step_readings(q1)} (phase e's: {step_readings(sft_metrics)}); CLI wall {t_sft:.2f} s; "
        f"split read (train + dev, best of 3): directory {reads['dir'][0] * 1e3:.1f} ms, JSON lines "
        f"{reads['jsonl'][0] * 1e3:.1f} ms; launches {sft_launches}; on {smi}")
    log(f"  [phase q: {time.perf_counter() - t_phase:.1f} s]")
    return {name: sft_launches.get(name, 0) + cpt_launches.get(name, 0) for name in {*sft_launches, *cpt_launches}}


# --- phase f: weight-only int8 and the port's WER drive ---------------------------------------


def phase_int8_serving(seed: int, smi: str, base_tokens, base_rate: float):
    """Phase f1: ``quantize_layer_weights_int8`` at 1B width on the card, held
    bitwise to the same f32 arithmetic on the CPU and to the per-element bound
    ``|w - q * scale| <= amax / 127``; then phase 5's 64 requests through the
    int8 engine (``quantize="int8"``)."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.generate.quant import _LAYER_MATMULS, _quantize, quantize_layer_weights_int8
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_layer_weights_int8(params)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    bytes_bf16 = sum(params["layers"][n].numel() * params["layers"][n].element_size() for n in _LAYER_MATMULS)
    bytes_q = sum(qparams["layers"][n]["q"].numel() for n in _LAYER_MATMULS)
    bytes_scale = sum(qparams["layers"][n]["scale"].numel() * 2 for n in _LAYER_MATMULS)
    worst = 0.0  # the largest |w - q * scale| / (amax / 127) over every weight
    for name in _LAYER_MATMULS:
        w, leaf = params["layers"][name], qparams["layers"][name]
        check(leaf["q"].dtype == torch.int8 and leaf["q"].is_cuda and leaf["scale"].dtype == torch.bfloat16
              and leaf["scale"].shape == (w.shape[0], 1, w.shape[2]), f"int8 {name}: not an int8 leaf on the card")
        ref = _quantize(w.cpu())  # the same f32 arithmetic on the CPU
        check(torch.equal(leaf["q"].cpu(), ref["q"]) and torch.equal(leaf["scale"].cpu(), ref["scale"]),
              f"int8 {name}: q or scale differs from the CPU's f32 arithmetic")
        for l in range(w.shape[0]):
            w32 = w[l].float()
            err = (w32 - leaf["q"][l].float() * leaf["scale"][l].float()).abs()
            limit = w32.abs().amax(dim=0, keepdim=True) / 127
            check(bool((err <= limit).all()), f"int8 {name} layer {l}: |w - q * scale| > amax / 127")
            worst = max(worst, (err / limit.clamp_min(1e-30)).max().item())
    del qparams, ref
    log(f"  int8 quantization (1B, 7 products x 16 layers) on the card: {t_quant * 1e3:.1f} ms; q and scale "
        f"bitwise equal to the CPU's f32 arithmetic; |w - q * scale| <= {worst:.3f} x amax / 127 (limit 1); "
        f"layer stack {bytes_bf16 / 1e9:.3f} GB bf16 -> {bytes_q / 1e9:.3f} GB int8 + {bytes_scale / 1e6:.3f} MB "
        f"bf16 scales")

    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16,
                            quantize="int8")
    del params
    check(eng.attn_impl == "kernel" and eng.params["layers"]["wq"]["q"].dtype == torch.int8,
          "int8 engine: not the kernels over int8 weights")
    eng.generate_batch(prompts[:8], SamplingParams(max_tokens=16))  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=128))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128,
              f"int8 request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"int8 request {i}: token out of vocab")
    parked = len(eng._free_pages) + len(eng._cache_lru)
    check(parked == eng.n_pages, f"int8 serving: pages leaked: {eng.n_pages - parked}")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the int8 serving path")
    n_tok = sum(len(o["token_ids"]) for o in outs)
    same = sum(o["token_ids"] == b for o, b in zip(outs, base_tokens))
    agree = [next((i for i, (x, y) in enumerate(zip(o["token_ids"], b)) if x != y), len(b))
             for o, b in zip(outs, base_tokens)]
    log(f"phase f1 int8 serving (1B, weight-only int8 layer stack, 32 slots): 64 requests x 128 tokens, {n_tok} "
        f"tokens in {wall:.2f} s = {n_tok / wall:.0f} generated tok/s (phase 5, bf16 weights: {base_rate:.0f}) on "
        f"{smi}; {same}/64 requests equal to phase 5's tokens, mean agreeing prefix {sum(agree) / len(agree):.1f} of "
        f"128 (int8 is not bitwise; reported, not required); launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_drive_kernels(gen):
    """Phase f2: the kernels at the 100m WER drive's shapes against their plain
    versions: flash forward (#1) and backward (#3) at the SFT micro-batch (B 32,
    S 160, 8 q / 4 kv heads, causal); the CE passes (#5-#7) at N 5,120, D 512,
    V 133,258; #8 at the decode shape (48 slots, 4 kv heads, n_rep 2, page 128,
    3 pages a slot, 8 layers). Times in bf16 beside the plain versions."""
    import torch

    from ssi_tpu_torch.ops.cross_entropy import (
        cross_entropy_de,
        cross_entropy_dh,
        cross_entropy_dlogits,
        cross_entropy_lse,
        fused_cross_entropy,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_gemm_kernel,
        cross_entropy_de_kernel,
        cross_entropy_dh_gemm_kernel,
        cross_entropy_dh_kernel,
        cross_entropy_dlogits_kernel,
        cross_entropy_lse_kernel,
        fused_cross_entropy_kernel,
    )
    from ssi_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_reference,
    )

    b, s, hq, hkv, d = 32, 160, 8, 4, 64
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype) for h in (hq, hkv, hkv, hq))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True)
        _, rel_o, _ = hold("drive flash fwd o", o, o_ref, key)
        err_l = (lse - lse_ref).abs().max().item()
        check(err_l <= TOL[key], f"drive flash fwd {key}: lse err {err_l} > {TOL[key]}")
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
        ctrl = flash_attention_bwd_reference(q, k, v, o, lse + 0.05, do, causal=True)
        rels = [hold(f"drive flash bwd {g}", a, w, key, [("p x 0.95", c)])[1]
                for g, a, w, c in zip(("dq", "dk", "dv"), got, want, ctrl)]
        msg = (f"  f2 flash B{b} S{s} Hq{hq} Hkv{hkv} causal {key}: fwd o rel {rel_o:.2e}, lse max err {err_l:.2e}; "
               f"bwd rel dq {rels[0]:.2e}, dk {rels[1]:.2e}, dv {rels[2]:.2e} (limit {REL[key]})")
        if dtype == torch.bfloat16:
            t_f = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                           lambda: flash_attention_reference(q, k, v, causal=True))
            t_b = in_turns(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                           lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True))
            msg += (f"; times fwd {t_f[0]:.4f} ms (plain {t_f[1]:.3f}), bwd {t_b[0]:.4f} ms (plain "
                    f"{t_b[1]:.3f})")
        log(msg)
        del q, k, v, do, o, lse, o_ref, lse_ref, got, want, ctrl
    torch.cuda.empty_cache()

    n, vocab, dm = 5120, 133_258, 512
    g = torch.tensor(1.0, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for spread in (1.0, 4.0):
            key = str(dtype).split(".")[1]
            h = (torch.randn((n, dm), generator=gen, device="cuda") * spread).to(dtype)
            e = (torch.randn((vocab, dm), generator=gen, device="cuda") * dm**-0.5).to(dtype)
            y = torch.randint(0, vocab, (n,), generator=gen, device="cuda", dtype=torch.int32)
            y[::7] = -100
            what = f"f2 cross entropy N{n} D{dm} {key} spread {spread:g}"
            lse = cross_entropy_lse_kernel(h, e)
            lse_p = cross_entropy_lse(h, e)
            err_lse = (lse - lse_p).abs().max().item()
            check(err_lse <= LSE_ATOL, f"{what} lse: max err {err_lse:.3e} > {LSE_ATOL}")
            loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
            rel_loss = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
            check(rel_loss <= 1e-5, f"{what} loss: {loss.item()} vs plain {loss_p.item()}")
            _, rel_dl, _ = hold(f"{what} dlogits", cross_entropy_dlogits_kernel(h, e, y, lse, g),
                                cross_entropy_dlogits(h, e, y, g), key)
            _, rel_dh, _ = hold(f"{what} dh", cross_entropy_dh_kernel(h, e, y, lse, g),
                                cross_entropy_dh(h, e, y, g), key)
            de, de_p = cross_entropy_de_kernel(h, e, y, lse, g), cross_entropy_de(h, e, y, g)
            unl = torch.ones(vocab, dtype=torch.bool, device="cuda")
            unl[y[y != -100].long()] = False
            _, rel_l, _ = hold(f"{what} dE labelled rows", de[~unl], de_p[~unl], key)
            _, rel_u, c_de = hold(f"{what} dE unlabelled rows", de[unl], de_p[unl], key,
                                  [("kernel with lse + 0.05", cross_entropy_de_kernel(h, e, y, lse + 0.05, g)[unl])])
            msg = (f"  {what}: lse max err {err_lse:.2e}, loss rel {rel_loss:.2e}, rel dlogits {rel_dl:.2e}, dh "
                   f"{rel_dh:.2e}, dE labelled {rel_l:.2e}, unlabelled {rel_u:.2e} (control {c_de:.2e}; limit "
                   f"{REL[key]})")
            if dtype == torch.bfloat16 and spread == 1.0:
                ops = 2 * n * vocab * dm
                t_lse = in_turns(lambda: cross_entropy_lse_kernel(h, e), lambda: cross_entropy_lse(h, e), 5)

                def backward():  # as _CrossEntropyKernel.backward runs it: one dlogits pass, two GEMMs
                    dlogits = cross_entropy_dlogits_kernel(h, e, y, lse, g)
                    return cross_entropy_dh_gemm_kernel(dlogits, e), cross_entropy_de_gemm_kernel(dlogits, h)

                t_bwd = in_turns(backward, lambda: (cross_entropy_dh(h, e, y, g), cross_entropy_de(h, e, y, g)), 3)
                b_one = bound(ops, 2 * (n + vocab) * dm)[0]
                msg += (f"; times lse {t_lse[0]:.3f} ms ({ops / (t_lse[0] * 1e-3) / 1e12:.0f} TFLOP/s, "
                        f"{b_one / t_lse[0]:.1%} of its bound; plain {t_lse[1]:.3f}), backward (dlogits + dh + dE) "
                        f"{t_bwd[0]:.3f} ms (plain {t_bwd[1]:.3f}); bound of one {n} x {vocab} x {dm} product "
                        f"{b_one:.3f} ms")
            log(msg)
            del h, e, y, lse, lse_p, de, de_p, unl
            torch.cuda.empty_cache()

    slots, hkv, n_rep, ps, max_pages, n_layers = 48, 4, 2, 128, 3, 8
    kernel, plain, lens_of = paged_call(1)
    hist = torch.randint(0, max_pages * ps, (slots,), generator=gen, device="cuda").to(torch.int32)
    hist[:4] = torch.tensor([0, ps - 1, ps, max_pages * ps - 1], dtype=torch.int32, device="cuda")
    active = torch.arange(slots, device="cuda") % 11 != 5
    seq_lens = lens_of(hist, active)
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        kp, vp, q, kn, vn, per_layer = paged_inputs(gen, dtype, 1, slots, hkv, n_rep, ps, max_pages, n_layers,
                                                    hist, active)
        table, write_rows = per_layer[3]
        kw = dict(k_new=kn, v_new=vn)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        got = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        again = kernel(q, kp, vp, table, seq_lens, write_rows=write_rows, **kw)
        ref = plain(q, kp_ref, vp_ref, table, seq_lens, write_rows=write_rows, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"f2 paged {key}: two launches differ")
        _, rel, _ = hold("f2 paged attention", got[active], ref[active], key)
        check(torch.equal(kp[:-1], kp_ref[:-1]) and torch.equal(vp[:-1], vp_ref[:-1]),
              f"f2 paged pools {key}: not bitwise equal outside the trash row")
        msg = f"  f2 paged #8, 48 slots, 4 kv heads, n_rep 2, 3 pages {key}: rel {rel:.2e} (limit {REL[key]})"
        if dtype == torch.bfloat16:
            n_bytes = int(hist[active].sum().item()) * hkv * 64 * 2 * 2
            t_k, t_p, _, _, gbs = paged_times(
                lambda t, w: kernel(q, kp, vp, t, seq_lens, write_rows=w, **kw),
                lambda t, w: plain(q, kp_ref, vp_ref, t, seq_lens, write_rows=w, **kw), per_layer, 3, n_bytes)
            msg += (f"; device time of a graph of the 8 layers in turn {t_k:.4f} ms ({gbs:.0f} GB/s of pages), "
                    f"plain {t_p:.3f} ms")
        log(msg)
        del kp, vp, kp_ref, vp_ref
    torch.cuda.empty_cache()
    log("phase f2 the kernels at the WER drive's shapes: ok")


def phase_wer_drive(smi: str, beside: dict | None = None):
    """Phase f3: ``python -m ssi_tpu_torch.wer_drive --smoke`` at its default
    ``llama3_2_100m``, run as a user runs it (a subprocess; each stage a
    subprocess of the port's CLI): extend, SFT, generate in bf16 and int8, and
    score, on the card. Each stage's process appends its kernel launch counts
    to the file that ``SSI_TPU_TORCH_LAUNCH_COUNTS`` names (the drive sets one
    per stage, ``_build.write_launch_counts``); their sum is the kernels
    line's ``launches_by_path["wer_drive"]``. The smoke recipe (8 steps, 256
    rows) checks the wiring: both WERs are computed and finite, not gated; the
    full drive's summary is committed under ``artifacts/wer_drive_torch/``.
    ``beside``: phase t3's tiny drive, started with this one
    (:func:`start_tiny_drive`); waited for before the traced step."""
    import shutil
    import tempfile
    from collections import Counter
    from pathlib import Path

    from ssi_tpu_torch.cli.train_sft import main as sft_main
    from ssi_tpu_torch.profile_decode import _device_summary
    from ssi_tpu_torch.wer_drive import extended_dir, parse_args as drive_args, sft_overrides

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_wer_drive_"))
    try:
        art = root / "art"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.wer_drive", "--smoke", "--workdir",
                               str(root / "wd"), "--artifacts-dir", str(art)], cwd=REPO, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, "the WER drive failed:\n" + "\n".join(
            (root / "wd" / "drive.log").read_text().splitlines()[-30:] if (root / "wd" / "drive.log").exists()
            else proc.stderr.splitlines()[-30:]))
        summary = json.loads((art / "summary.json").read_text())
        check(summary["hardware"] == smi, f"drive hardware {summary['hardware']!r}, expected {smi!r}")
        for tag in ("bf16", "int8"):
            check(math.isfinite(summary[f"wer_{tag}"]) and summary[f"wer_{tag}"] >= 0,
                  f"drive WER {tag}: {summary[f'wer_{tag}']}")
        counts = summary["launch_counts"]
        for name in TRAIN_KERNELS:
            check(counts["train"].get(name, 0) > 0, f"kernel {name} was not launched by the drive's SFT stage")
        for tag in ("bf16", "int8"):
            for name in ("flash_attention_fwd", "paged_attention_fused"):
                check(counts[f"generate_{tag}"].get(name, 0) > 0,
                      f"kernel {name} was not launched by the drive's {tag} generate stage")
        launches = sum((Counter(c) for c in counts.values()), Counter())
        sec, tr = summary["stage_seconds"], summary["train"]
        if beside is not None:  # the card to this process alone for the traced step
            wait_tiny_drive(beside)

        # the SFT stage again, in this process, on the drive's extended model and data with
        # its overrides but log_interval 1 and the Trainer's profiler key at step 6: per-step
        # readings and one traced step at the drive's shape (not counted in the drive's launches)
        args = drive_args(["--smoke"])
        ext = extended_dir(root / "wd", args)
        trainer, t_sft = run_cli(sft_main, [
            *sft_overrides(args, root / "wd" / "data"), "log_interval=1", f"checkpointer.checkpoint_dir={ext}",
            f"tokenizer.path={ext / 'original' / 'tokenizer.model'}", f"checkpointer.output_dir={root / 'sft'}",
            f"profiler={{start_step: 5, num_steps: 1, dir: {root / 'trace'}}}"])
        steps = [m for m in read_metrics(root / "sft") if "loss" in m]
        check(len(steps) == 8 and all(math.isfinite(m["loss"]) for m in steps), f"drive SFT: {len(steps)} steps")
        untraced = [m for m in steps if m["step"] in (2, 3, 4, 5)]
        step_ms = sum(m["duration_step"] for m in untraced) * 1e3 / len(untraced)
        label_tok_s = sum(m["tokens_per_second_per_gpu"] for m in untraced) / len(untraced)
        dev_summary = _device_summary(str(trainer.profile_trace))
        traced = trainer.profile_wall_s * 1e3
        shares = ", ".join(f"{k} {v * dev_summary['busy_ms']:.1f} ms" for k, v in
                           dev_summary["share_of_device_time"].items())
        losses = ", ".join(f"{m['loss']:.4f}" for m in steps)
        del trainer
        log(f"phase f3 WER drive (python -m ssi_tpu_torch.wer_drive --smoke: llama3_2_100m, {tr['max_steps']} SFT "
            f"steps, 256 rows; every stage a CLI subprocess on the card): WER bf16 {summary['wer_bf16']:.4f}, int8 "
            f"{summary['wer_int8']:.4f} (not gated at this size); assets {sec['assets']:.2f} s, extend "
            f"{sec['extend']:.2f} s, SFT stage {sec['train']:.2f} s (train loss not logged: log_interval 20 > "
            f"{tr['max_steps']} steps; final dev loss {tr['final_dev_loss']:.4f}), generate bf16 "
            f"{sec['generate_bf16']:.2f} s ({summary['decode_tok_s']['bf16']:.0f} tok/s), int8 "
            f"{sec['generate_int8']:.2f} s ({summary['decode_tok_s']['int8']:.0f} tok/s), score "
            f"{sec['score_bf16'] + sec['score_int8']:.2f} s; drive wall {wall:.2f} s; on {smi}; launches "
            f"{dict(launches)}")
        log(f"phase f3 the drive's SFT stage in this process (its overrides, log_interval 1, window 2 x 32 x <= 160): "
            f"JSONL duration_step {step_readings(steps)}; losses {losses}; "
            f"mean of steps 2-5 {step_ms:.1f} ms, {label_tok_s:.0f} label tok/s; traced step 6 {traced:.1f} ms, device "
            f"busy {dev_summary['busy_ms']:.1f} ms ({dev_summary['busy_ms'] / traced:.0%}), {dev_summary['kernels']} "
            f"kernels; device time by class: {shares}; CLI wall {t_sft:.2f} s")
        return dict(launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- head_dim 128: the kernels at the 3B and 8B shapes, phases g and h -------------------------


def phase_kernels_hd128(gen, vocab: int) -> dict:
    """The head_dim-128 instances against their plain versions, each beside a
    control that must miss, and timed beside SDPA or ``torch.mm``: the flash
    forward (#1/#2) and backward (#3/#4) at 3B's training shape (B 2, S 2048,
    24 q / 8 kv heads: n_rep 3) and 8B's largest prefill dispatch (B 8,
    S 768, 32 / 8); the CE kernels (#5-#7, one instance for every D) at 3B's
    D 3,072; #8 and #9 at 3B's and 8B's serving shapes and context 16,384.
    Returns the kernels-line rows of the head_dim-128 instances at 3B's
    shapes."""
    rows = {
        "flash_attention_fwd": phase_flash(gen, 24, 8, 128, shapes=((2, 2048),), row=(2, 2048),
                                           tag="phase 2g flash forward, 3B training shape"),
    }
    phase_flash(gen, 32, 8, 128, shapes=((8, 768),), row=(8, 768), tag="phase 2h flash forward, 8B prefill shape")
    rows["flash_attention_bwd"] = phase_flash_bwd(gen, 24, 8, 128, shapes=((2, 2048),), row=(2, 2048),
                                                  tag="phase 6g flash backward, 3B training shape")
    phase_flash_bwd(gen, 32, 8, 128, shapes=((8, 768),), row=(8, 768), tag="phase 6h flash backward, 8B prefill shape")
    phase_cross_entropy(gen, vocab, d=3072, ns=(4096,), tag="phase 7g cross entropy, 3B's D 3072")
    rows["paged_attention_fused"] = phase_paged(gen, 24, 8, 128, tag="phase 3g paged decode, 3B serving shape")
    phase_paged(gen, 32, 8, 128, tag="phase 3h paged decode, 8B serving shape")
    rows["paged_attention_multi"] = phase_paged_multi(gen, 24, 8, 128, tag="phase ag paged verify, 3B serving shape")
    phase_paged_multi(gen, 32, 8, 128, tag="phase ah paged verify, 8B serving shape")
    return rows


def write_sharded_model(step, cfg, seed: int, n_shards: int) -> dict:
    """An extended model dir as Llama 3.2 3B ships: random bf16 weights from
    ``seed`` in ``n_shards`` safetensors shards (the layers split between
    them) with ``model.safetensors.index.json``, the drive's 128,000-entry
    base tokenizer extended with the DSUs, and the HF model files. Returns
    the written HF tensors' sizes."""
    import torch

    from ssi_tpu_torch.checkpoint.convert import internal_to_hf
    from ssi_tpu_torch.checkpoint.safetensors_io import save_file
    from ssi_tpu_torch.extend import extend_tiktoken
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.wer_drive import WORDS, build_base_tokenizer

    tok_path = step / "original" / "tokenizer.model"
    build_base_tokenizer(tok_path, WORDS)
    extend_tiktoken(cfg.n_dsus, cfg.modality_tokens, tok_path, tok_path)
    hf = internal_to_hf(init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda"), cfg)
    names = sorted(hf)
    weight_map = {}
    for i in range(n_shards):
        shard = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        part = names[i::n_shards]
        save_file({k: hf[k] for k in part}, step / shard, metadata={"format": "pt"})
        weight_map.update({k: shard for k in part})
    total = sum(t.numel() * t.element_size() for t in hf.values())
    (step / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    write_model_files(step, cfg)
    del hf
    torch.cuda.empty_cache()
    return {"bytes": total}


G_LAYERS = 4  # phase g's 3B depth through the CLIs, of its 28 layers: the run's time limit


def phase_3b(seed: int, smi: str) -> dict:
    """Phase g: Llama 3.2 3B (D 3,072, 24 q / 8 kv heads of 128: n_rep 3)
    through the entry points at full width with its depth cut to
    ``G_LAYERS`` of its 28 layers (the registry's entry cut alike in this
    process while the CLIs run), random bf16 weights from ``seed``: an
    extended 3B dir in two shards; the SFT CLI with the drive's overrides
    (window 4 x 2 x 2048, 4 steps, one save; losses finite and falling,
    every training kernel launched); the generation CLI from the saved
    ``step_4/`` in bf16 and with ``quantize_weights=int8`` (32 finished
    records each, flash and paged launched); then f32 at 3B width with the
    depth cut to 2 layers: greedy tokens kernels == plain, ``speculate_k=3``
    == 0, loss and gradients within phase 8's limits. Returns launches by
    path."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.cli.generate import main as generate_main
    from ssi_tpu_torch.cli.train_sft import main as sft_main
    from ssi_tpu_torch.generate import last_run_stats
    from ssi_tpu_torch.models import configs as registry

    cut = model_config("llama3_2_3b", num_layers=2)
    phase_engine_f32(seed, cut, tag="phase g engine f32 (3B width, 2 of 28 layers, n_rep 3, head_dim 128")
    phase_spec_f32(seed, cut, tag="phase g spec f32 (3B width, 2 of 28 layers)")
    phase_train_parity(seed, cut, tag="phase g f32 train parity (3B width, 2 of 28 layers")

    cfg = model_config("llama3_2_3b", num_layers=G_LAYERS)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_3b_"))
    launches = {}
    entry = registry.MODEL_CONFIGS["llama3_2_3b"]
    registry.MODEL_CONFIGS["llama3_2_3b"] = entry.copy()  # the CLIs read the registry: the same depth there
    registry.MODEL_CONFIGS["llama3_2_3b"].num_layers = G_LAYERS
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        check(free_gb > 40, f"phase g needs about 33 GB of disk; {free_gb:.1f} GB free")
        ext = root / "extended"
        t0 = time.perf_counter()
        written = write_sharded_model(ext, cfg, seed, cfg.n_checkpoint_shards)
        t_synth = time.perf_counter() - t0
        shards = sorted(p.name for p in ext.glob("*.safetensors"))
        check(len(shards) == 2, f"3B dir holds {shards}")
        log(f"  phase g: {free_gb:.1f} GB free; extended 3B dir ({G_LAYERS} of 28 layers) in {len(shards)} shards + index "
            f"({written['bytes'] / 1e9:.2f} GB bf16) written in {t_synth:.1f} s")

        # SFT with the drive's overrides and model_config=llama3_2_3b, but for three, so that 4 steps show
        # the loss fall: an 8-row train split, one window's rows, so every step sees the same rows; lr 5e-4
        # after a 1-step warm-up (lr 0 at step 1). The drive's 200 warm-up steps move a random 3B too little
        # in 4 steps, and its 2e-3 without them diverges at step 4
        train, dev = root / "sft_train.jsonl", root / "sft_dev.jsonl"
        write_jsonl(train, split_rows(seed + 31, 8, cfg.n_dsus))
        write_jsonl(dev, split_rows(seed + 32, 16, cfg.n_dsus))
        out = root / "sft"
        argv = ["data=sft/mls-hubert_large_ll60k-layer_22", "model_config=llama3_2_3b",
                *[a for split, path in (("train", train), ("dev", dev)) for a in (
                    f"data.{split}.dataset.source=json", f"+data.{split}.dataset.data_files={path}",
                    f"data.{split}.dataset.split=train")],
                "data.train.dataloader.batch_size=2", "data.dev.dataloader.batch_size=2",
                "gradient_accumulation_steps=4", "tokenizer.max_seq_len=2048", "optimizer.lr=5e-4",
                "lr_scheduler.num_warmup_steps=1", "max_steps=4", "eval_steps=4", "save_steps=4",
                "log_interval=1", "clip_grad_norm=1.0", "wandb.enabled=false", "loss_chunk_size=3072",
                f"checkpointer.checkpoint_dir={ext}", f"tokenizer.path={ext / 'original' / 'tokenizer.model'}",
                f"checkpointer.output_dir={out}"]
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        trainer, t_sft = run_cli(sft_main, argv)
        launches["train_3b"] = dict(_build.launch_counts)
        mem = torch.cuda.max_memory_allocated() / 2**30
        check(trainer.cfg.remat == "save_qkv_mlp" and trainer.cfg.dtype == "bf16" and trainer.global_step == 4,
              f"3B SFT ran remat {trainer.cfg.remat}, dtype {trainer.cfg.dtype}, {trainer.global_step} steps")
        save = dict(trainer.last_save_stats)
        del trainer
        torch.cuda.empty_cache()
        metrics = read_metrics(out)
        losses = [m["loss"] for m in metrics if "loss" in m]
        dev_losses = [m["dev_loss"] for m in metrics if "dev_loss" in m]
        check(len(losses) == 4 and all(math.isfinite(x) for x in losses + dev_losses), f"3B SFT losses {losses}")
        check(losses[-1] < losses[0], f"3B SFT loss did not fall: {losses}")
        for name in TRAIN_KERNELS:
            check(launches["train_3b"].get(name, 0) > 0, f"kernel {name} was not launched by the 3B SFT entry point")
        step = out / "step_4"
        check(len(list(step.glob("*.safetensors"))) == 2, "3B step_4/ is not two shards")
        shutil.rmtree(ext)
        (out / "training_state.msgpack").unlink()
        log(f"phase g SFT CLI (3B bf16, {G_LAYERS} of 28 layers, model_config=llama3_2_3b, remat save_qkv_mlp, window "
            f"4 x 2 x 2048 over 8 rows, "
            f"lr 5e-4 after 1 warm-up step): "
            f"loss {', '.join(f'{x:.4f}' for x in losses)}, dev loss {', '.join(f'{x:.4f}' for x in dev_losses)}; "
            f"JSONL duration_step {step_readings(metrics)}; CLI wall {t_sft:.2f} s; save at step 4: model "
            f"{save['model_s']:.2f} s ({save['model_bytes'] / 1e9:.2f} GB, 2 shards), state {save['state_s']:.2f} s "
            f"({save['state_bytes'] / 1e9:.2f} GB); peak memory {mem:.1f} GiB; on {smi}; launches "
            f"{launches['train_3b']}")

        # the generation CLI from step_4/: 32 records (one wave of the 32 slots) in bf16, then int8
        split = root / "test.jsonl"
        write_jsonl(split, split_rows(seed + 7, 32, cfg.n_dsus))
        for path, extra in (("generate_3b", []), ("generate_3b_int8", ["quantize_weights=int8"])):
            out_g = root / path
            gen_argv = [
                f"model={step}", f"experiments_root_dir={root / 'experiments'}", "model_config=llama3_2_3b",
                f"tokenizer.path={step / 'original' / 'tokenizer.model'}",
                f"speech.n_dsus={cfg.n_dsus}", "data=sft/mls-hubert_large_ll60k-layer_22",
                "data.test.dataset.source=json", f"+data.test.dataset.data_files={split}",
                "data.test.dataset.split=train", "gen.split=test", f"gen.output_dir={out_g}", "batch_size=32",
                "sampling_params.max_tokens=128", "dtype=bf16", "observability=true", *extra]
            _build.launch_counts.clear()
            _, wall = run_cli(generate_main, gen_argv)
            launches[path] = dict(_build.launch_counts)
            stats = dict(last_run_stats)
            records = [json.loads(x) for x in (out_g / "json" / "test" / "generations.jsonl").read_text().splitlines()]
            check(len(records) == 32, f"{path}: {len(records)} records, expected 32")
            for r in records:
                o = r["outputs"][0]
                check(r["finished"] is True and o["finish_reason"] in ("stop", "length")
                      and 0 < len(o["token_ids"]) <= 128 and all(0 <= t < cfg.vocab_size for t in o["token_ids"]),
                      f"{path} record {r['request_id']}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
            for name in ("flash_attention_fwd", "paged_attention_fused"):
                check(launches[path].get(name, 0) > 0, f"kernel {name} was not launched by {path}")
            rate = records[0]["metrics"]["batch_tokens_per_second"]
            n_tok = records[0]["metrics"]["batch_generated_tokens"]
            log(f"phase g generate CLI (3B {'int8' if extra else 'bf16'}, {G_LAYERS} of 28 layers, from step_4/, 32 "
                f"records): checkpoint load "
                f"{stats['load_s']:.2f} s = {stats['load_bytes'] / 1e9 / stats['load_s']:.2f} GB/s "
                f"({stats['load_bytes'] / 1e9:.2f} GB); warm-up {stats['warmup_s']:.2f} s; generate "
                f"{stats['generate_s']:.2f} s, {n_tok} tokens = {rate:.0f} generated tok/s; CLI wall {wall:.2f} s; "
                f"on {smi}; launches {launches[path]}")
            torch.cuda.empty_cache()
    finally:
        registry.MODEL_CONFIGS["llama3_2_3b"] = entry
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_8b(seed: int, smi: str) -> dict:
    """Phase h: Llama 3.1 8B (D 4,096, 32 q / 8 kv heads of 128, FFN
    14,336, an untied ``lm_head``, rope ``scale_factor`` 8) serving at full
    width with the depth cut to 16 of its 32 layers (to keep the run inside
    half its time limit), random bf16 weights initialised on the card: phase 5's 64
    requests x 128 greedy tokens at 32 slots, then with ``speculate_k=3``,
    the prefix cache and ``prefill_chunk=512``; every request finishes, pages
    balance, #1, #8 and #9 launched. Then f32 greedy at 8B width with the
    depth cut to 2 layers: tokens kernels == plain. Returns launches by
    path."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params

    cfg = model_config("llama3_1_8b", num_layers=16)
    check(not cfg.tied_embeddings and cfg.scale_factor == 8 and cfg.head_dim == 128, "not the 8B architecture")
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in [*params["layers"].values(), params["embed"],
                                                          params["lm_head"]])
    prompts = prompts_from_seed(seed + 1, 64, cfg.vocab_size)
    launches, rates, tokens = {}, {}, {}
    for path, kw in (("serve_8b", {}), ("spec_serve_8b", dict(speculate_k=3, prefill_chunk=512))):
        eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16, **kw)
        check(eng.attn_impl == "kernel" and eng.prefix_caching, f"{path}: not the kernels with the prefix cache")
        eng.generate_batch(prompts_from_seed(seed + 5, 8, cfg.vocab_size), SamplingParams(max_tokens=16))  # warm-up
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=128))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = dict(_build.launch_counts)
        for i, o in enumerate(outs):
            check(o["finish_reason"] == "length" and len(o["token_ids"]) == 128
                  and all(0 <= t < cfg.vocab_size for t in o["token_ids"]),
                  f"{path} request {i}: {o['finish_reason']}, {len(o['token_ids'])} tokens")
        parked = len(eng._free_pages) + len(eng._cache_lru)
        check(parked == eng.n_pages, f"{path}: pages leaked: {eng.n_pages - parked}")
        need = ("flash_attention_fwd", "paged_attention_multi" if kw else "paged_attention_fused")
        for name in need:
            check(launches[path].get(name, 0) > 0, f"kernel {name} was not launched on the 8B path {path}")
        n_tok = sum(len(o["token_ids"]) for o in outs)
        rates[path] = n_tok / wall
        tokens[path] = [o["token_ids"] for o in outs]
        st = eng.last_stats
        extra = (f"tokens per verify {st['tokens_per_verify']:.3f}, {st['verify_steps']} verify steps, "
                 f"{st['prefill_pieces']} chunked prefill pieces, cached prompt tokens {st['cached_prompt_tokens']}; "
                 if kw else "")
        log(f"phase h serving 8B bf16 ({'speculate_k 3, prefix cache, prefill_chunk 512' if kw else 'speculate_k 0'}; "
            f"16 of 32 layers, {n_bytes / 1e9:.2f} GB of weights, untied lm_head, 32 slots): 64 requests x 128 tokens, "
            f"{n_tok} tokens "
            f"in {wall:.2f} s = {rates[path]:.0f} generated tok/s on {smi}; {extra}{st['chunk_dispatches']} chunks, "
            f"{st['prefill_dispatches']} prefill dispatches; launches {launches[path]}")
        del eng
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(tokens["serve_8b"], tokens["spec_serve_8b"]))
    log(f"  phase h: {same}/64 speculative requests equal to the k=0 tokens (bf16: reported, not required)")
    del params
    torch.cuda.empty_cache()
    phase_engine_f32(seed, model_config("llama3_1_8b", num_layers=2),
                     tag="phase h engine f32 (8B width, 2 of 32 layers, n_rep 4, head_dim 128, untied lm_head")
    return launches


# --- phase t: the shapes past the registry's (ROADMAP B1-B3) and tiny_test through its CLIs ----------------

# 100: not a multiple of 8, on the wrappers' padded copies; 136-256 on the hd-256 instances (256: Gemma's)
SHAPE_HEAD_DIMS = (16, 40, 72, 80, 96, 120, 100, 136, 200, 256)
SHAPE_DS = (64, 72, 100, 576, 960)  # the CE's D: tiny_test's, a multiple of 8 only, of none, SmolLM's two
# the paged core: (head_dim, T, n_rep, kv heads); T 1 is #8. tiny_test's heads (hd 16, 4 q / 2 kv), phi-2's hd 80,
# Phi-3-mini's hd 96, and 72 and 128 query rows of a kv head (two row groups: n_rep 9 at T 8; Llama 3.1 405B's
# 128 q / 8 kv heads at T 8; n_rep 128 at T 1); Gemma 2B's 8 q / 1 kv heads of 256 at T 1, 4 and 8; head_dims 36
# and 20, not multiples of 8 (the plain-load kernels)
SHAPE_PAGED = ((16, 1, 2, 2), (16, 4, 2, 2), (80, 1, 4, 8), (80, 4, 4, 8), (96, 1, 4, 8), (96, 8, 4, 8),
               (64, 8, 9, 2), (128, 8, 16, 8), (128, 1, 128, 2), (256, 1, 8, 1), (256, 4, 8, 1), (256, 8, 8, 1),
               (36, 1, 4, 2), (36, 4, 4, 2), (20, 8, 2, 2))


def nan_columns(x, width: int | None = None):
    """``x [..., d]`` as the first d columns of a ``[..., width]`` buffer
    whose other columns hold NaN (``width`` 128, or 256 past 128): a kernel
    that reads past d reads NaN."""
    import torch

    width = width or (256 if x.shape[-1] > 128 else 128)
    buf = torch.full((*x.shape[:-1], width), float("nan"), dtype=x.dtype, device=x.device)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


def instance_width(d: int) -> int:
    """The head_dim of the kernel instance that runs head_dim ``d``."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def phase_shapes_flash(gen) -> None:
    """Phase t1, #1-#4: the flash forward and backward at head_dims other
    than 64 and 128 (B 2, S 300, 8 q / 2 kv heads; causal, full, segment
    ids), f32 and bf16, q, k, v and do column slices of 128- or 256-wide
    buffers whose other columns hold NaN: o within ``TOL`` and ``REL`` beside
    a control that must miss (the plain forward with the scale of the
    instance's width, 1/sqrt(64, 128 or 256), as a kernel that took the
    padded width's scale would compute; at 256 itself each q head routed to
    the next kv head), lse within ``TOL``; dq, dk, dv within ``REL`` beside
    the plain gradients at lse + 0.05, bitwise equal over two launches."""
    import torch

    from ssi_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_reference,
    )

    b, s, hq, hkv = 2, 300, 8, 2
    seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg[:, 100:] = 1
    seg[1, 220:] = 2
    parts = []
    for d in SHAPE_HEAD_DIMS:
        worst, least = {}, math.inf
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            q, k, v, do = (nan_columns(torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype))
                           for h in (hq, hkv, hkv, hq))
            for name, causal, segs in (("causal", True, None), ("full", False, None), ("segments", True, seg)):
                o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segs)
                o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal, segment_ids=segs)
                if d == instance_width(d):  # no other scale to tell apart: the next kv head's keys
                    ctl_name, (o_ctl, _) = "kv heads shifted", flash_attention_reference(
                        q, k.roll(1, 2), v.roll(1, 2), causal=causal, segment_ids=segs)
                else:
                    ctl_name, (o_ctl, _) = "scale of the instance's width", flash_attention_reference(
                        q * (d / instance_width(d)) ** 0.5, k, v, causal=causal, segment_ids=segs)
                check(o.shape == q.shape and torch.isfinite(o.float()).all().item(), f"t1 flash d{d} {key}: o")
                check(torch.allclose(o.float(), o_ref.float(), atol=TOL[key], rtol=TOL[key])
                      and torch.allclose(lse, lse_ref, atol=TOL[key], rtol=TOL[key]),
                      f"t1 flash {name} d{d} {key}: o or lse past {TOL[key]}")
                _, rel, ctl = hold(f"t1 flash {name} d{d} o", o, o_ref, key, [(ctl_name, o_ctl)])
                got = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=segs)
                again = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=segs)
                want = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal=causal, segment_ids=segs)
                ctrl = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref + 0.05, do, causal=causal,
                                                     segment_ids=segs)
                rels = [rel]
                for gname, a, a2, w, c in zip(("dq", "dk", "dv"), got, again, want, ctrl):
                    check(a.shape == w.shape and torch.equal(a, a2), f"t1 flash bwd {name} d{d} {key} {gname}: "
                          "shape, or two launches differ")
                    _, r, rc = hold(f"t1 flash bwd {name} d{d} {gname}", a, w, key, [("p x 0.95", c)])
                    rels.append(r)
                    least = min(least, rc)
                worst[key] = max(worst.get(key, 0.0), *rels)
                least = min(least, ctl)
            del q, k, v, do
        parts.append(f"d{d} rel f32 {worst['float32']:.1e} bf16 {worst['bfloat16']:.1e}")
        log(f"  t1 flash d{d} (instance {instance_width(d)}; B{b} S{s} Hq{hq} Hkv{hkv}; causal, full, segments; "
            f"NaN past d): o, dq, dk, dv worst rel f32 {worst['float32']:.2e}, bf16 {worst['bfloat16']:.2e} (limits "
            f"{REL['float32']}, {REL['bfloat16']}); controls >= {least:.2e}; backward bitwise equal over two launches")
    torch.cuda.empty_cache()
    log(f"phase t1 flash #1-#4 at other head_dims: ok ({'; '.join(parts)})")


def phase_shapes_ce(gen, vocab: int = 20_011, n: int = 1000) -> None:
    """Phase t1, #5-#7: the CE kernels at D not a multiple of 128 (N 1,000,
    V 20,011, every 7th label ignored, logits of std 1 and 4), f32 and bf16,
    h a column slice of a wider buffer whose other columns hold NaN: lse
    within ``LSE_ATOL`` beside a control (the plain lse of h and E with their
    last 8 columns dropped: a kernel that lost the D tail) and the loss
    within 1e-5; dlogits off the labels beside the plain version at lse +
    0.05; dh beside dh without its softmax term (where that term exceeds the
    limit: f32, or spread 4, as phase 7); dE's unlabelled rows beside the
    plain version at lse + 0.05 (dlogits, dh and dE from the kernel's lse);
    lse, dh and dE bitwise equal over two launches."""
    import torch

    from ssi_tpu_torch.ops.cross_entropy import (
        cross_entropy_de,
        cross_entropy_dh,
        cross_entropy_dlogits,
        cross_entropy_lse,
        fused_cross_entropy,
    )
    from ssi_tpu_torch.ops.cross_entropy_cuda import (
        cross_entropy_de_kernel,
        cross_entropy_dh_kernel,
        cross_entropy_dlogits_kernel,
        cross_entropy_lse_kernel,
        fused_cross_entropy_kernel,
    )

    g = torch.tensor(1.0, device="cuda")
    parts = []
    for d in SHAPE_DS:
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            for spread in (1.0, 4.0):
                h = nan_columns((torch.randn((n, d), generator=gen, device="cuda") * spread).to(dtype), 1024)
                e = (torch.randn((vocab, d), generator=gen, device="cuda") * d**-0.5).to(dtype)
                y = torch.randint(0, vocab, (n,), generator=gen, device="cuda", dtype=torch.int32)
                y[::7] = -100
                what = f"t1 CE D{d} {key} spread {spread:g}"
                lse = cross_entropy_lse_kernel(h, e)
                check(torch.equal(cross_entropy_lse_kernel(h, e), lse), f"{what}: two lse launches differ")
                lse_p = cross_entropy_lse(h, e)
                err = (lse - lse_p).abs().max().item()
                ctl = (cross_entropy_lse(h[:, :-8], e[:, :-8]) - lse_p).abs().max().item()
                check(err <= LSE_ATOL < ctl, f"{what}: lse max err {err:.2e}, tail-dropped control {ctl:.2e}, "
                      f"limit {LSE_ATOL}")
                loss, loss_p = fused_cross_entropy_kernel(h, e, y), fused_cross_entropy(h, e, y)
                check(abs(loss.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item()), f"{what}: loss {loss.item()} "
                      f"vs plain {loss_p.item()}")
                valid = y != -100
                # dlogits at the labels (p - 1) apart from the rest (p alone, which lse + 0.05 moves by 5%)
                at_label = torch.zeros((n, vocab), dtype=torch.bool, device="cuda")
                at_label[valid.nonzero()[:, 0], y[valid].long()] = True
                dl = cross_entropy_dlogits_kernel(h, e, y, lse, g)
                dl_p = cross_entropy_dlogits(h, e, y, g, lse=lse)
                dl_c = cross_entropy_dlogits(h, e, y, g, lse=lse + 0.05)
                rels = [hold(f"{what} dlogits at the labels", dl[at_label], dl_p[at_label], key)[1],
                        hold(f"{what} dlogits off the labels", dl[~at_label], dl_p[~at_label], key,
                             [("lse + 0.05", dl_c[~at_label])])[1]]
                del dl, dl_p, dl_c, at_label
                dh = cross_entropy_dh_kernel(h, e, y, lse, g)
                check(torch.equal(cross_entropy_dh_kernel(h, e, y, lse, g), dh), f"{what}: two dh launches differ")
                # at spread 1 the softmax term is ~0.7% of dh, inside the bf16 limit (as in phase 7)
                no_softmax = torch.where(valid[:, None], -g * e.float()[y.clamp(min=0).long()], 0.0)
                tell = dtype == torch.float32 or spread > 1.0
                rels.append(hold(f"{what} dh", dh, cross_entropy_dh(h, e, y, g, lse=lse), key,
                                 [("without its softmax term", no_softmax)] if tell else [])[1])
                de = cross_entropy_de_kernel(h, e, y, lse, g)
                check(torch.equal(cross_entropy_de_kernel(h, e, y, lse, g), de), f"{what}: two dE launches differ")
                de_p = cross_entropy_de(h, e, y, g, lse=lse)
                unl = torch.ones(vocab, dtype=torch.bool, device="cuda")
                unl[y[valid].long()] = False
                rels.append(hold(f"{what} dE labelled rows", de[~unl], de_p[~unl], key)[1])
                rels.append(hold(f"{what} dE unlabelled rows", de[unl], de_p[unl], key,
                                 [("lse + 0.05", cross_entropy_de(h, e, y, g, lse=lse + 0.05)[unl])])[1])
                check(dh.shape == h.shape and de.shape == e.shape, f"{what}: dh {tuple(dh.shape)}, dE {tuple(de.shape)}")
                worst[key] = max(worst.get(key, 0.0), *rels)
                del h, e, y, lse, lse_p, dh, de, de_p, no_softmax, unl
        parts.append(f"D{d} rel f32 {worst['float32']:.1e} bf16 {worst['bfloat16']:.1e}")
        torch.cuda.empty_cache()
    log(f"phase t1 cross entropy #5-#7 at any D (N {n}, V {vocab}; NaN past D in h's buffer; lse, loss, dlogits, "
        f"dh, dE each beside a control that misses; lse, dh, dE bitwise over two launches): ok ({'; '.join(parts)})")


def phase_shapes_paged(gen) -> None:
    """Phase t1, #8/#9 at ``SHAPE_PAGED``: 12 slots on a table of three
    splits (histories 0, 1, on and one key past split boundaries, the full
    context less T, an inactive slot), pages of 16 and 128, f32 and bf16,
    every pool cell outside the histories NaN or +-Inf in the kernel's pools
    (0 in the plain version's): attention within ``TOL`` and ``REL`` beside a
    control that must miss (at a head_dim of its own the plain output with
    the scale of the instance's width, else each q head routed to the next
    kv head), two launches bitwise equal, pools bitwise equal except the
    trash row (poisoned cells read as 0)."""
    import torch

    from ssi_tpu_torch.generate.paged_cuda import SPLIT_KEYS, row_groups, split_plan

    poison = torch.tensor((float("nan"), float("inf"), float("-inf")), device="cuda")
    parts = []
    for hd, t_q, n_rep, hkv in SHAPE_PAGED:
        kernel, plain, lens_of = paged_call(t_q)
        worst = {}
        for ps in (16, 128):
            max_pages = 3 * SPLIT_KEYS // ps
            per_split, n_splits = split_plan(max_pages, ps)
            sk, cap = per_split * ps, max_pages * ps
            hist = [0, 1, ps - 1, sk - 1, sk, sk + 1, 2 * sk + 1, cap - t_q, 37, 500, 2000, 3000]
            slots = len(hist)
            active = torch.ones(slots, dtype=torch.bool, device="cuda")
            active[8] = False
            hist = torch.tensor(hist, dtype=torch.int32, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                key = str(dtype).split(".")[1]
                kp, vp, q, kn, vn, ((table, write),) = paged_inputs(gen, dtype, t_q, slots, hkv, n_rep, ps,
                                                                    max_pages, 1, hist, active, hd)
                lens = lens_of(hist, active)
                used = torch.zeros(kp.shape[:2], dtype=torch.bool, device="cuda")
                keys = torch.arange(cap, device="cuda")
                in_hist = keys[None, :] < hist[:, None]
                used[table[:, keys // ps].long()[in_hist], (keys % ps).expand(slots, -1)[in_hist]] = True
                for pool in (kp, vp):
                    pool[~used] = 0
                kp_ref, vp_ref = kp.clone(), vp.clone()
                cells = torch.randint(0, 3, (int((~used).sum()), kp.shape[2]), generator=gen, device="cuda")
                for pool in (kp, vp):
                    pool[~used] = poison[cells].to(dtype)
                kw = dict(k_new=kn, v_new=vn, write_rows=write)
                got = kernel(q, kp, vp, table, lens, **kw)
                again = kernel(q, kp, vp, table, lens, **kw)
                if hd != instance_width(hd):
                    ctl_name, ctl = "scale of the instance's width", plain(
                        q * (hd / instance_width(hd)) ** 0.5, kp_ref.clone(), vp_ref.clone(), table, lens, **kw)
                else:  # one kv head: each query routed to the next q head's
                    ctl_name, ctl = "kv heads shifted", plain(q.roll(n_rep if hkv > 1 else 1, -2), kp_ref.clone(),
                                                              vp_ref.clone(), table, lens, **kw)
                ref = plain(q, kp_ref, vp_ref, table, lens, **kw)
                torch.cuda.synchronize()
                what = f"t1 paged hd{hd} T{t_q} n_rep {n_rep} ps {ps} {key}"
                check(torch.equal(got, again), f"{what}: two launches differ")
                check(torch.allclose(got[active].float(), ref[active].float(), atol=TOL[key], rtol=TOL[key]),
                      f"{what}: attention past {TOL[key]}")
                _, rel, _ = hold(what, got[active], ref[active], key, [(ctl_name, ctl[active])])
                for pool, pool_ref in ((kp, kp_ref), (vp, vp_ref)):
                    check(torch.equal(torch.nan_to_num(pool[:-1], nan=0.0, posinf=0.0, neginf=0.0), pool_ref[:-1]),
                          f"{what}: pools not bitwise equal outside the trash row")
                worst[key] = max(worst.get(key, 0.0), rel)
                del kp, vp, kp_ref, vp_ref, q, kn, vn, got, again, ref, ctl, used, cells
            torch.cuda.empty_cache()
        rows = t_q * n_rep
        parts.append(f"hd{hd} T{t_q} {rows} rows ({row_groups(rows)} group{'s' * (row_groups(rows) > 1)}): rel f32 "
                     f"{worst['float32']:.1e} bf16 {worst['bfloat16']:.1e}")
    log(f"phase t1 paged #8/#9 at other head_dims and past 64 query rows (3 splits, pages 16 and 128, NaN/Inf in "
        f"every unused cell; each beside a control that misses, two launches bitwise equal, pools bitwise): ok "
        f"({'; '.join(parts)})")


def phase_shapes_times(gen, vocab: int) -> dict:
    """Phase t2: the new shapes' rows, each kernel against its plain version
    (bf16 and f32) and timed in bf16 beside its bound and the library call:
    #1-#4 at head_dim 80 and 96 at 1B's head layout (32 q / 8 kv) at B 8,
    S 768 and B 2, S 2048 beside SDPA; #5-#7 at D 576 and 960 (SmolLM-135M's
    and -360M's) at N 4,096, V 133,258 beside ``h @ E.T`` + ``F.cross_entropy``
    and ``torch.mm``; #8 at head_dim 96 (32 slots, 8 kv heads, n_rep 4,
    context 1,280, a graph of 16 layers); #9 at Llama 3.1 405B's head layout
    (128 q / 8 kv heads of 128: 128 query rows of a kv head at T 8, 64 at
    T 4); then the hd-256 instances at Gemma 2B's heads (8 q / 1 kv) and
    Gemma 7B's (16 / 16): #1-#4 at B 8, S 768 and B 2, S 2048 beside SDPA,
    #8/#9 at 32 slots, context 1,280, T 1, 4 and 8 (the kernels line reads
    T 4, T 8 under ``t8``); #8/#9 at head_dims 36 and 20 on the plain-load
    kernels (1B's 32 q / 8 kv heads); and :func:`split_study`. Returns their
    rows."""
    rows = {}
    for d in (80, 96):
        shapes = ((8, 768), (2, 2048))
        rows[f"flash_attention_fwd_hd{d}"] = phase_flash(gen, 32, 8, d, shapes=shapes, row=(2, 2048),
                                                         tag=f"phase t2 flash forward, head_dim {d}")
        rows[f"flash_attention_bwd_hd{d}"] = phase_flash_bwd(gen, 32, 8, d, shapes=shapes, row=(2, 2048),
                                                             tag=f"phase t2 flash backward, head_dim {d}")
    for d in (576, 960):
        rows.update({f"{name}_d{d}": row for name, row in phase_cross_entropy(
            gen, vocab, d=d, ns=(4096,), tag=f"phase t2 cross entropy, D {d}").items()})
    rows["paged_attention_fused_hd96"] = phase_paged(gen, 32, 8, 96, tag="phase t2 paged decode, head_dim 96")
    rows["paged_attention_multi_405b"] = phase_paged_multi(gen, 128, 8, 128,
                                                           tag="phase t2 paged verify, 405B's heads (T 4: 64 rows, "
                                                               "T 8: 128)")
    for name, hq, hkv in (("gemma2b", 8, 1), ("gemma7b", 16, 16)):
        shapes = ((8, 768), (2, 2048))
        what = f"{name[:-2].capitalize()} {name[-2:].upper()}'s heads ({hq} q / {hkv} kv of 256)"
        rows[f"flash_attention_fwd_{name}"] = phase_flash(gen, hq, hkv, 256, shapes=shapes, row=(2, 2048),
                                                          tag=f"phase t2 flash forward, {what}")
        rows[f"flash_attention_bwd_{name}"] = phase_flash_bwd(gen, hq, hkv, 256, shapes=shapes, row=(2, 2048),
                                                              tag=f"phase t2 flash backward, {what}")
        # one kv head: a layer's pages are 42 MB, so 16 layers in turn keep L2 from serving them; 16 kv heads: 4
        layers = 16 if hkv == 1 else 4
        rows[f"paged_attention_fused_{name}"] = phase_paged(gen, hq, hkv, 256, n_layers=layers, long_context=False,
                                                            tag=f"phase t2 paged decode, {what}")
        rows[f"paged_attention_multi_{name}"] = phase_paged_multi(gen, hq, hkv, 256, n_layers=layers,
                                                                  long_context=False,
                                                                  tag=f"phase t2 paged verify, {what}")
    for hd in (36, 20):
        rows[f"paged_attention_fused_hd{hd}"] = phase_paged(gen, 32, 8, hd, long_context=False,
                                                            tag=f"phase t2 paged decode, head_dim {hd} (plain loads)")
        rows[f"paged_attention_multi_hd{hd}"] = phase_paged_multi(gen, 32, 8, hd, long_context=False,
                                                                  tag=f"phase t2 paged verify, head_dim {hd} (plain "
                                                                      "loads)")
    for key, row in rows.items():  # the rows that run the plain-load kernels, not the TMA kernel
        if key.endswith(("_hd36", "_hd20")):
            row["source"] = "ssi_tpu_torch/csrc/paged_split.cuh"
    rows["paged_attention_fused_gemma2b"]["split_study"] = split_study(gen)
    return rows


def split_study(gen, hq: int = 8, hkv: int = 1, hd: int = 256, n_layers: int = 16) -> dict:
    """#8 at Gemma 2B's heads (one kv head), 32 slots, context 1,280: the
    split plan gives each (slot, kv head) one split of 1,280 keys, 32 blocks
    on the card's 132 SMs. The same call with shorter splits (``SPLIT_KEYS``
    640, 320 and 128: 2, 4 and 10 splits, merged in the launch), each held to
    the plain version, timed as a graph of the 16 layers in turn, the plan's
    own splits and 320 twice, in turns. A measurement only: the plan the port
    runs is not changed. Returns {split keys: (splits a slot, ms)}."""
    import torch

    from ssi_tpu_torch.generate import paged_cuda

    slots, ps, max_ctx = 32, 128, 1280
    kernel, plain, _ = paged_call(1)
    lens = torch.randint(1, max_ctx + 1, (slots,), generator=gen, device="cuda").to(torch.int32)
    hist = lens - 1
    kp, vp, q, kn, vn, per_layer = paged_inputs(gen, torch.bfloat16, 1, slots, hkv, hq // hkv, ps, max_ctx // ps,
                                                n_layers, hist, lens > 0, hd)
    kw = dict(k_new=kn, v_new=vn)
    table, write = per_layer[0]
    ref = plain(q, kp.clone(), vp.clone(), table, lens, write_rows=write, **kw)
    default = paged_cuda.SPLIT_KEYS
    calls = [lambda t=t, w=w: kernel(q, kp, vp, t, lens, write_rows=w, **kw) for t, w in per_layer]
    ms, splits = {}, {}
    try:
        for keys in (default, 640, 320, 128, 320, default):
            paged_cuda.SPLIT_KEYS = keys
            splits[keys] = paged_cuda.split_plan(max_ctx // ps, ps)[1]
            hold(f"split study, {keys}-key splits", kernel(q, kp, vp, table, lens, write_rows=write, **kw), ref,
                 "bfloat16")
            ms[keys] = min(ms.get(keys, math.inf), graph_ms(calls))
    finally:
        paged_cuda.SPLIT_KEYS = default
    n_bytes = int(hist.sum().item()) * hkv * hd * 2 * 2
    log(f"  split study, #8 at {hq} q / {hkv} kv heads of {hd}, 32 slots, context {max_ctx} (bf16, a graph of "
        f"{n_layers} layers in turn; {n_bytes / 1e6:.1f} MB of pages a layer): "
        + ", ".join(f"{k}-key splits ({splits[k]} a slot, {slots * hkv * splits[k]} blocks) {v:.4f} ms = "
                    f"{n_bytes / (v * 1e-3) / 1e9:.0f} GB/s" for k, v in ms.items())
        + f"; the port's plan keeps {default}-key splits")
    del kp, vp, q, kn, vn, per_layer, calls, ref
    torch.cuda.empty_cache()
    return {str(k): [splits[k], v] for k, v in ms.items()}


def gemma2b_config(num_layers: int = 2):
    """Llama 3.2 1B's registry entry (D 2,048, FFN 8,192, its vocabulary with
    5,000 DSUs) with Gemma 2B's attention: 8 q / 1 kv heads of 256
    (google/gemma-2b ``config.json``), ``num_layers`` deep. Built here, not
    registered: the registry holds no such model."""
    cfg = model_config("llama3_2_1b", num_layers=num_layers)
    cfg.num_heads, cfg.num_kv_heads = 8, 1
    check(cfg.head_dim == 256 and cfg.embed_dim == 2048 and cfg.intermediate_dim == 8192,
          f"Gemma 2B layout: head_dim {cfg.head_dim}, D {cfg.embed_dim}, FFN {cfg.intermediate_dim}")
    return cfg


def tiny_heads_config(head_dim: int):
    """``tiny_test`` (2 layers; 5,000 DSUs, as phase t3's f32 checks run it)
    with 4 q / 2 kv heads of ``head_dim``: D = 4 x head_dim."""
    cfg = model_config("tiny_test")
    cfg.embed_dim = 4 * head_dim
    check(cfg.head_dim == head_dim, f"tiny layout: head_dim {cfg.head_dim}")
    return cfg


def phase_gemma2b(seed: int, smi: str) -> dict:
    """Phase t4: a 2-layer model at Gemma 2B's attention layout
    (:func:`gemma2b_config`: 8 q / 1 kv heads of 256 at D 2,048) through the
    port's engine and trainer, random weights from ``seed``. f32: the paged
    engine's greedy tokens with the kernels (prefill #1 at hd 256, decode #8)
    equal the plain versions' and a full-recompute oracle (phase 4's check);
    ``speculate_k=3`` (verify #9) equals k 0, kernels and plain (phase b's);
    the loss and gradients of a B1 S512 micro-batch, kernels against plain,
    within phase 8's and g's limits (1e-4). bf16: 16 requests x 64 greedy
    tokens at k 0 through the engine (every record finished, pages balance);
    one SFT window (2 x 2 x 2048, full remat) through ``make_train_step``
    launching #1, #3 and #5-#7, loss finite, and the kernels' loss and
    gradients of one micro-batch against the plain versions' in bf16 (loss
    1e-2 relative, each gradient leaf within 2e-2 in relative norm: bf16
    rounds P and dS before the products, which the plain path does in f32).
    Then the same engine checks at tiny layouts with heads of 36 and 20 (not
    multiples of 8: #8/#9 on the plain-load kernels, #1/#3 on padded copies).
    Returns launches by path."""
    import torch

    from ssi_tpu_torch import _build
    from ssi_tpu_torch.generate.engine import SamplingParams
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.lr_schedule import constant_schedule
    from ssi_tpu_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves, tree_unflatten
    from ssi_tpu_torch.train.step import make_loss_fn, make_train_step

    cfg = gemma2b_config()
    launches = {}
    _build.launch_counts.clear()
    phase_engine_f32(seed, cfg, tag="phase t4 engine f32 (Gemma 2B's heads: 8 q / 1 kv of 256, D 2048, 2 layers")
    phase_spec_f32(seed, cfg, tag="phase t4 spec f32 (Gemma 2B's heads, 2 layers)")
    phase_train_parity(seed, cfg, tag="phase t4 f32 train parity (Gemma 2B's heads, 2 layers")
    launches["gemma2b_f32"] = dict(_build.launch_counts)

    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    prompts = prompts_from_seed(seed + 1, 16, cfg.vocab_size)
    eng = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=32, page_size=128, prompt_bucket=128, chunk=16)
    check(eng.attn_impl == "kernel", f"engine on CUDA resolved attn_impl {eng.attn_impl!r}")
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=64))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["gemma2b_serve"] = dict(_build.launch_counts)
    for i, o in enumerate(outs):
        check(o["finish_reason"] == "length" and len(o["token_ids"]) == 64
              and all(0 <= t < cfg.vocab_size for t in o["token_ids"]), f"t4 bf16 request {i}: {o['finish_reason']}")
    check(len(eng._free_pages) + len(eng._cache_lru) == eng.n_pages, "t4 bf16 engine: pages leaked")
    for name in ("flash_attention_fwd", "paged_attention_fused"):
        check(launches["gemma2b_serve"].get(name, 0) > 0, f"kernel {name} was not launched by t4's bf16 serving")
    n_tok = sum(len(o["token_ids"]) for o in outs)
    log(f"phase t4 engine bf16 (Gemma 2B's heads, 2 layers): 16 requests x 64 greedy tokens, {n_tok} tokens in "
        f"{wall:.2f} s (first batch: first-use costs included) on {smi}; launches {launches['gemma2b_serve']}")
    del eng, outs
    torch.cuda.empty_cache()

    # the bf16 loss and gradients of one micro-batch: kernels against plain
    tokens, labels = sft_window(seed + 5, cfg.vocab_size, accum=2, batch=2, seq=2048)
    res = {}
    for kernels in (True, False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss = (make_loss_fn(cfg, remat="full")(tree, tokens[0], labels[0])[0] if kernels
                else plain_loss(tree, tokens[0], labels[0], cfg))
        res[kernels] = (loss.detach().float(), torch.autograd.grad(loss, leaves))
        del leaves, tree, loss
    (l_k, g_k), (l_p, g_p) = res[True], res[False]
    rel_loss = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    check(math.isfinite(l_k.item()) and rel_loss <= REL["bfloat16"], f"t4 bf16 loss {l_k.item()} vs plain {l_p.item()}")
    worst = max(rel_err(a, w) for a, w in zip(g_k, g_p))
    check(worst <= 2e-2, f"t4 bf16 gradients: worst leaf rel {worst:.2e} > 2e-2")
    del res, g_k, g_p

    opt = AdamWConfig()
    state = {"params": params, "opt_state": init_opt_state(params, opt), "step": 0}
    step = make_train_step(cfg, opt, constant_schedule(opt.lr), clip_grad_norm=1.0, remat="full",
                           grad_accum_dtype=torch.float32)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state, m = step(state, tokens, labels)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    launches["gemma2b_train"] = dict(_build.launch_counts)
    loss = float(m["loss_sum"]) / max(int(m["num_tokens"]), 1)
    check(math.isfinite(loss) and bool(m["applied"]) and state["step"] == 1, f"t4 bf16 SFT window: loss {loss}")
    for name in TRAIN_KERNELS:
        check(launches["gemma2b_train"].get(name, 0) > 0, f"kernel {name} was not launched by t4's SFT window")
    log(f"phase t4 train bf16 (Gemma 2B's heads, 2 layers, window 2 x 2 x 2048, full remat): micro-batch loss "
        f"{l_k.item():.5f} vs plain {l_p.item():.5f} (rel {rel_loss:.2e}, limit {REL['bfloat16']}), gradient leaves "
        f"worst rel {worst:.2e} (limit 2e-2); one optimizer step {t_step * 1e3:.0f} ms (first: first-use costs "
        f"included), loss per token {loss:.4f}; launches {launches['gemma2b_train']}")
    del state, step, params, tokens, labels
    torch.cuda.empty_cache()

    for hd in (36, 20):  # #8/#9 on the plain-load kernels in bf16 and f32; #1/#3 on padded copies
        small = tiny_heads_config(hd)
        _build.launch_counts.clear()
        phase_engine_f32(seed, small, tag=f"phase t4 engine f32 (tiny_test at 4 q / 2 kv heads of {hd}")
        phase_spec_f32(seed, small, tag=f"phase t4 spec f32 (tiny_test, heads of {hd})")
        params = init_params(small, seed=seed, dtype=torch.bfloat16, device="cuda")
        for k in (0, 3):  # k 0 decodes by #8, k 3 verifies by #9
            eng = PagedDecodeEngine(params, small, pad_id=0, n_slots=8, page_size=16, prompt_bucket=16, chunk=4,
                                    speculate_k=k)
            outs = eng.generate_batch(prompts_from_seed(seed + 2, 8, small.vocab_size),
                                      SamplingParams(temperature=0.0, max_tokens=24))
            check(all(o["finish_reason"] == "length" and len(o["token_ids"]) == 24 for o in outs),
                  f"t4 bf16 tiny hd{hd} k {k}: records unfinished")
            del eng, outs
        launches[f"tiny_hd{hd}"] = dict(_build.launch_counts)
        for name in ("flash_attention_fwd", "paged_attention_fused", "paged_attention_multi"):
            check(launches[f"tiny_hd{hd}"].get(name, 0) > 0, f"kernel {name} was not launched at head_dim {hd}")
        log(f"phase t4 tiny_test at heads of {hd}: f32 tokens kernels == plain == oracle, k 3 == k 0; bf16 at "
            f"speculate_k 0 and 3, 8 requests x 24 tokens finished; launches {launches[f'tiny_hd{hd}']}")
        del params
    torch.cuda.empty_cache()
    return launches


TINY_DRIVE_ARGS = ["--smoke", "--model-config", "tiny_test", "--max-seq-len", "512"]  # its rows run to ~300 tokens


def start_tiny_drive() -> dict:
    """Start phase t3's ``wer_drive --smoke --model-config tiny_test`` as a
    subprocess (its output into files beside its workdir) and return its
    handle for :func:`phase_tiny_drive`. The run starts it beside phase f3's
    drive, which holds the card as lightly (a 100m and a tiny model, host
    bound CLI processes), and waits for it before f3's traced step; killed
    at exit if still running."""
    import atexit
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tiny_drive_"))
    wd, art = root / "wd", root / "art"
    out, err = open(root / "stdout.txt", "w"), open(root / "stderr.txt", "w")
    proc = subprocess.Popen([sys.executable, "-m", "ssi_tpu_torch.wer_drive", *TINY_DRIVE_ARGS, "--workdir", str(wd),
                             "--artifacts-dir", str(art)], cwd=REPO, stdout=out, stderr=err, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "root": root, "wd": wd, "art": art, "t0": time.perf_counter(), "files": (out, err)}


def wait_tiny_drive(run: dict) -> dict:
    """Wait for the drive :func:`start_tiny_drive` started (at most 900 s);
    records its wall seconds and exit code."""
    if "wall" not in run:
        try:
            run["proc"].wait(timeout=max(1.0, 900 - (time.perf_counter() - run["t0"])))
        except subprocess.TimeoutExpired:
            run["proc"].kill()
            run["proc"].wait()
        run["wall"] = time.perf_counter() - run["t0"]
        for f in run["files"]:
            f.close()
    return run


def phase_tiny_drive(seed: int, smi: str, run: dict | None = None) -> dict:
    """Phase t3: ``tiny_test`` (2 layers, D 64, 4 q / 2 kv heads of 16) on
    the card through its entry points. First f32 greedy tokens at its width,
    the kernels against the plain versions (phases 4 and b's checks:
    identical tokens, equal to a full-recompute oracle, ``speculate_k=3`` ==
    0). Then ``python -m ssi_tpu_torch.wer_drive --smoke --model-config
    tiny_test`` (``--max-seq-len 512``: its byte-level rows run to ~300
    tokens, which the drive's truncation guard refuses at 160) as a user runs
    it, every stage a CLI subprocess on the card: assets, extend, SFT,
    generate in bf16 and int8, score; both WERs finite, the summary's
    ``hardware`` this card, #1, #3, #5, #6, #7 launched by the SFT stage and
    #1 and #8 by each generate stage. Then the generation CLI once more on
    the drive's checkpoint with ``speculate_k=3`` (#1 and #9 launched, every
    record finished). Each stage's process reports its launches through
    ``SSI_TPU_TORCH_LAUNCH_COUNTS``; their sum is the kernels line's
    ``launches_by_path["tiny_drive"]``. Nothing on this path can reach a
    plain version: the wrappers take it only for CPU tensors. ``run``: the
    drive as :func:`start_tiny_drive` started it (beside phase f3), else it
    starts here."""
    import shutil
    from collections import Counter

    cfg = model_config("tiny_test")
    phase_engine_f32(seed, cfg, tag="phase t3 engine f32 (tiny_test: hd 16, 4 q / 2 kv heads, D 64")
    phase_spec_f32(seed, cfg, tag="phase t3 spec f32 (tiny_test)")
    run = wait_tiny_drive(run or start_tiny_drive())
    root, wd, art, wall = run["root"], run["wd"], run["art"], run["wall"]
    try:
        check(run["proc"].returncode == 0, "the tiny_test drive failed:\n" + "\n".join(
            (wd / "drive.log").read_text().splitlines()[-30:] if (wd / "drive.log").exists()
            else (root / "stderr.txt").read_text().splitlines()[-30:]))
        summary = json.loads((art / "summary.json").read_text())
        check(summary["hardware"] == smi, f"tiny drive hardware {summary['hardware']!r}, expected {smi!r}")
        for tag in ("bf16", "int8"):
            check(math.isfinite(summary[f"wer_{tag}"]) and summary[f"wer_{tag}"] >= 0,
                  f"tiny drive WER {tag}: {summary[f'wer_{tag}']}")
        counts = summary["launch_counts"]
        for name in TRAIN_KERNELS:
            check(counts["train"].get(name, 0) > 0, f"kernel {name} was not launched by the tiny drive's SFT stage")
        for tag in ("bf16", "int8"):
            for name in ("flash_attention_fwd", "paged_attention_fused"):
                check(counts[f"generate_{tag}"].get(name, 0) > 0,
                      f"kernel {name} was not launched by the tiny drive's {tag} generate stage")

        # the generation CLI again on the drive's checkpoint, with speculation: #9
        step = sorted(wd.glob("experiments/**/checkpoints/step_*"), key=lambda p: p.stat().st_mtime)[-1]
        spec_counts, out = root / "spec.jsonl", root / "gen_spec"
        env = {**os.environ, "SSI_TPU_HOME": str(wd), "PYTHONPATH": REPO,
               "SSI_TPU_TORCH_LAUNCH_COUNTS": str(spec_counts)}
        t1 = time.perf_counter()
        spec = subprocess.run([sys.executable, "-m", "ssi_tpu_torch.cli.generate", f"model={step}",
                               "model_config=tiny_test", "base_model_name=tiny_test",
                               "data=sft/mls-hubert_large_ll60k-layer_22", "data.test.dataset.source=json",
                               f"+data.test.dataset.data_files={wd / 'data' / 'test.jsonl'}",
                               "data.test.dataset.split=train", "gen.split=test", f"gen.output_dir={out}",
                               "batch_size=48", "speculate_k=3"],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        t_spec = time.perf_counter() - t1
        check(spec.returncode == 0, f"the tiny spec generate run failed:\n{spec.stderr[-3000:]}")
        spec_launches = Counter()
        for line in spec_counts.read_text().splitlines():
            spec_launches.update(json.loads(line)["launch_counts"])
        for name in ("flash_attention_fwd", "paged_attention_multi"):  # every decode step verifies: #9, not #8
            check(spec_launches.get(name, 0) > 0, f"kernel {name} was not launched by the tiny spec generate run")
        records = [json.loads(x) for x in next(out.rglob("generations.jsonl")).read_text().splitlines()]
        check(len(records) == summary["corpus"]["n_test"]
              and all(r["finished"] and r["outputs"][0]["token_ids"] for r in records),
              f"tiny spec generate: {len(records)} records")
        launches = sum((Counter(c) for c in counts.values()), Counter()) + spec_launches
        sec = summary["stage_seconds"]
        log(f"phase t3 tiny_test drive (python -m ssi_tpu_torch.wer_drive {' '.join(TINY_DRIVE_ARGS)}; every stage a "
            f"CLI subprocess on the card): WER bf16 {summary['wer_bf16']:.4f}, int8 {summary['wer_int8']:.4f} (not "
            f"gated); assets {sec['assets']:.2f} s, extend {sec['extend']:.2f} s, SFT {sec['train']:.2f} s (final dev "
            f"loss {summary['train']['final_dev_loss']:.4f}), generate bf16 {sec['generate_bf16']:.2f} s "
            f"({summary['decode_tok_s']['bf16']:.0f} tok/s), int8 {sec['generate_int8']:.2f} s, score "
            f"{sec['score_bf16'] + sec['score_int8']:.2f} s; drive wall {wall:.2f} s (beside phase f3's drive when the "
            f"run holds both); the generation CLI with "
            f"speculate_k=3 {t_spec:.2f} s ({len(records)} records, launches {dict(spec_launches)}); on {smi}; "
            f"launches {dict(launches)}")
        return dict(launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default="", help="comma-separated phase groups to run alone while developing "
                        "(1b: phases 2-f, i, j, k, l, n, m and q; e: phases e, q, k, n and m alone; p: phase p alone; hd128: "
                        "the head_dim-128 kernel phases; g; h; tiny: phase t); prints no result line")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    groups = set(filter(None, args.only.split(","))) or {"1b", "hd128", "g", "h", "tiny"}

    t_start = t_last = time.perf_counter()

    def mark(what: str) -> None:
        """The seconds a phase took, and since the start (the run's time limit is the card's)."""
        nonlocal t_last
        now = time.perf_counter()
        log(f"  [{what}: {now - t_last:.1f} s; {now - t_start:.1f} s since the start]")
        t_last = now

    smi = phase_device()
    phase_build()
    count_paged_kernels()
    mark("phases 0-1")
    if "1b" in groups:
        rows = {"flash_attention_fwd": phase_flash(gen), "paged_attention_fused": phase_paged(gen),
                "paged_attention_multi": phase_paged_multi(gen)}
        mark("phases 2, 3, a")
        phase_engine_f32(args.seed)
        phase_spec_f32(args.seed)
        serve_launches, base_tokens, base_rate = phase_engine_bf16(args.seed, smi)
        spec_launches = phase_spec_serving(args.seed, smi, base_tokens, base_rate)
        tp_launches = phase_serve_tp(args.seed, smi, base_rate)
        mark("phases 4, b, 5, c, o")
        phase_paged_shared(gen)
        phase_parallel_f32(args.seed)
        serve_n_launches = phase_gangs_and_depth(args.seed, smi, base_tokens, base_rate)
        mark("phase j")
        gen_launches, http_launches = phase_generate_cli(args.seed, smi, base_tokens, base_rate)
        mark("phases d, i, l")
        rows["flash_attention_bwd"] = phase_flash_bwd(gen)
        rows.update(phase_cross_entropy(gen, model_config().vocab_size))
        phase_train_parity(args.seed)
        train_launches = phase_train(args.seed, smi)
        mark("phases 6-9")
        p1 = phase_vocab_slices(gen)
        tp_train_launches = phase_tp_train(args.seed, smi)
        rows["cross_entropy_lse_merge"] = p1["merge_row"]
        for name, times in p1["slice_ms"].items():
            rows[name]["tp2_slice"] = times
        mark("phase p")
        (train_cli_launches, packed_launches, compressed_launches, dp_launches,
         local_launches) = phase_training_cli(args.seed, smi)
        mark("phases e, q, k, n, m")
        int8_launches = phase_int8_serving(args.seed, smi, base_tokens, base_rate)
        phase_drive_kernels(gen)
        tiny_run = start_tiny_drive() if "tiny" in groups else None  # phase t3's drive, beside f3's
        drive_launches = phase_wer_drive(smi, beside=tiny_run)
        mark("phase f")
    if "p" in groups and "1b" not in groups:
        phase_vocab_slices(gen)
        phase_tp_train(args.seed, smi)
        mark("phase p")
    if "e" in groups and "1b" not in groups:
        phase_training_cli(args.seed, smi)
        mark("phases e, q, k, n, m")
    if "hd128" in groups:
        rows128 = phase_kernels_hd128(gen, model_config().vocab_size)
        mark("phases 2g-ah")
    launches_big = {}  # the 3B and 8B paths' launches, by path
    if "g" in groups:
        launches_big.update(phase_3b(args.seed, smi))
        mark("phase g")
    if "h" in groups:
        launches_big.update(phase_8b(args.seed, smi))
        mark("phase h")
    if "tiny" in groups:
        phase_shapes_flash(gen)
        phase_shapes_ce(gen)
        phase_shapes_paged(gen)
        mark("phase t1")
        shape_rows = phase_shapes_times(gen, model_config().vocab_size)
        mark("phase t2")
        tiny_launches = phase_tiny_drive(args.seed, smi, tiny_run if "1b" in groups else None)
        mark("phase t3")
        t4_launches = phase_gemma2b(args.seed, smi)
        mark("phase t4")
    if args.only:
        log(f"partial run (--only {args.only}): no result line")
        return 0

    sources = {"flash_attention_fwd": ("flash_hopper_fwd.cu", FLASH_REPLACES),  # bf16, both head dims
               "paged_attention_fused": ("paged_attention.cu", PAGED_REPLACES),
               "paged_attention_multi": ("paged_attention.cu", PAGED_MULTI_REPLACES),
               "flash_attention_bwd": ("flash_hopper_bwd.cuh", FLASH_BWD_REPLACES),  # bf16, every head dim
               # bf16: the lse's partial pass and the backward's three products on one Hopper GEMM
               **{name: ("cross_entropy_hopper.cu", CE_REPLACES[name])
                  for name in ("cross_entropy_lse", "cross_entropy_dlogits", "cross_entropy_dh", "cross_entropy_de")},
               # the logsumexp's merge pass, launched alone to merge the tp ranks' slices
               "cross_entropy_lse_merge": ("cross_entropy.cu", CE_REPLACES["cross_entropy_lse"])}
    kernels = []
    for name, (source, replaces) in sources.items():
        by_path = {"serve": serve_launches.get(name, 0), "spec_serve": spec_launches.get(name, 0),
                   "generate": gen_launches.get(name, 0), "train": train_launches.get(name, 0),
                   "train_cli": train_cli_launches.get(name, 0), "int8_serve": int8_launches.get(name, 0),
                   "wer_drive": drive_launches.get(name, 0), "serve_http": http_launches.get(name, 0),
                   "serve_n": serve_n_launches.get(name, 0), "train_packed": packed_launches.get(name, 0),
                   "cpt_compressed": compressed_launches.get(name, 0), "train_dp": dp_launches.get(name, 0),
                   "serve_tp": tp_launches.get(name, 0), "train_tp": tp_train_launches.get(name, 0),
                   "train_local": local_launches.get(name, 0), "tiny_drive": tiny_launches.get(name, 0)}
        if name.startswith("cross_entropy"):  # one instance for every D: 3B's training launches it too
            by_path["train_3b"] = launches_big["train_3b"].get(name, 0)
        # phase t2's rows of this kernel at the shapes past the registry's (head_dim 80 / 96, D 576 / 960, ...);
        # those at Gemma 2B's heads and at head_dims 36 / 20 with their launches by phase t4's paths
        other = {key.rsplit("_", 1)[1]: row for key, row in shape_rows.items() if key.rsplit("_", 1)[0] == name}
        for shape, row in other.items():
            paths = [p for p in t4_launches if p.startswith("gemma2b")] if shape == "gemma2b" else (
                [f"tiny_{shape}"] if f"tiny_{shape}" in t4_launches else [])  # Gemma 7B's heads run on no path
            if paths:
                row["launches_by_path"] = {p: t4_launches[p].get(name, 0) for p in paths}
                row["launches"] = sum(row["launches_by_path"].values())
        kernels.append({"name": name, "route": "cuda", "source": f"ssi_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **rows[name], **({"other_shapes": other} if other else {})})
    # the head_dim-128 instances of the attention kernels, launched by the 3B and 8B paths
    for name, row in rows128.items():
        source, replaces = sources[name]
        by_path = {path: counts.get(name, 0) for path, counts in launches_big.items()}
        check(sum(by_path.values()) > 0, f"the head_dim-128 {name} was launched on no 3B or 8B path")
        kernels.append({"name": f"{name}_hd128", "route": "cuda", "source": f"ssi_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path, **row})
    # the head_dim-256 instances (the backward's dK/dV a kernel of its own), launched by phase t4's Gemma 2B
    # layout; their numbers are phase t2's at Gemma 2B's heads
    for name in ("flash_attention_fwd", "flash_attention_bwd", "paged_attention_fused", "paged_attention_multi"):
        source, replaces = sources[name]
        row = dict(shape_rows[f"{name}_gemma2b"])
        source = f"ssi_tpu_torch/csrc/{source}"
        by_path = {path: counts.get(name, 0) for path, counts in t4_launches.items() if path.startswith("gemma2b")}
        check(sum(by_path.values()) > 0, f"the head_dim-256 {name} was launched on no phase t4 path")
        row.pop("launches_by_path", None)
        row.pop("launches", None)
        kernels.append({"name": f"{name}_hd256", "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path, **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
