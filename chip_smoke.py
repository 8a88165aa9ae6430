#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (accelerate_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits nonzero, with no
result line, without them or outside a checkout of the repository. Phases,
each printing one JSON line; any failure ends the run with a nonzero exit:

1. card: the card's name and power limit; the flash kernels are built from
   ``accelerate_tpu_torch/ops/csrc`` (one nvcc per source, in parallel),
   with ptxas's registers and spills and the counts of wgmma (HGMMA), TMA
   load (UTMALDG), mma.sync (HMMA) and FMA (FFMA) instructions in each
   library's SASS; ``sass_ok`` holds each library to its design
   (``DESIGNS``): the bf16/fp16 libraries to wgmma and TMA loads and no
   mma.sync, the fp32 one to FMA and no tensor-core product.
2. kernels: the forward, dQ and dK/dV kernels against their plain PyTorch
   versions (fp32 on the same inputs; tolerances by dtype in ``TOLS``) at
   the training shapes, GQA cases with ragged tails (causal and not,
   groups of 2, 4 and 8), q, k and v as strided views of one fused QKV
   buffer, the visible, fully masked and partly masked offset cases, head
   dim 256 in bf16 and fp16, fp16 at 64 and 128, fp32 at 64, 128 and 256,
   and head dims 80 and 96, which the wrappers pad; dQ and dK/dV, each
   launched twice, must agree with themselves bit for bit in every
   variant.
3. timings of every built variant (``TIMED``: bf16, fp16 and fp32 at head
   dims 64 and 128 at the training shape and 256 at a Gemma-2B-like one,
   head dim 96 padded, and bf16 d128 at phase 18's Mixtral step and
   cp_generate prefill shapes) beside its bound and its plain version; SDPA's
   forward beside the forward kernel, and SDPA's backward (dq, dk, dv in
   one call) beside the dQ and dK/dV kernels' sum.
4. one train step of the tiny Llama on the card (kernels) and on the CPU
   (plain versions) from the same numpy-seeded weights: loss and grad norm.
5. the main path: the Llama train step that bench.py measures (1.06B
   parameters, seq 2048, batch 4, bf16 with fp32 masters, AdamW, remat
   "dots", flash attention) for 2 warm-up and 5 timed steps, with the
   kernels' launch counts.
6. profile: one more full-width step under torch.profiler, device time by
   kernel category and the share of the step with no kernel running.
7. generate: greedy generate() of the tiny fp32 Llama on the card against
   the CPU (a plain batch and a left-padded batch with EOS), then bench.py's
   decode row at full width: the same 1.06B Llama in bf16, prompt (1, 64),
   32 new tokens, bf16 and int8 weights, one warm-up and one timed call
   each; prefill and per-token decode times beside the per-token bound,
   and the decode steps' device-busy time and idle share from
   torch.profiler.
8. serving: ServingEngine.run of the tiny fp32 Llama against generate() on
   the card, then the engine at full width on the serving row of
   benchmarks/generate_bench.py (8 slots, 32 greedy requests of 4-63
   prompt tokens with bimodal budgets, replayed open loop at their Poisson
   arrival times, 8 per second): aggregate tok/s, ticks, occupancy, TTFT
   p50/p95 on the host clock, peak memory; then steady 8-slot decode ticks
   under torch.profiler.
9. loop: phase 5's Llama as a whole training loop. A ColumnDataset of 48
   sequences of 2,049 token ids from default_rng(9), prepared with the
   seedable sampler (batch 4, drop_last: 12 batches an epoch);
   adamw(warmup_cosine_decay_schedule(0, 3e-4, 2, 12), weight_decay=0.1)
   and its scheduler; automatic checkpoint naming with total_limit=1. Eight
   steps from the loader, save_state() after step 4 (mid-epoch), two more
   steps under torch.profiler; then a fresh Accelerator with weights from
   another seed load_state()s the checkpoint and takes steps 5-8. The
   resumed run must take the same samples, the same rates and bit-equal
   losses and grad norms, with the step count at 4 after the load and 8
   after, every kernel launched 18 times a step, and the native host
   library writing and reading the checkpoint. Prints save and load seconds
   split into host copies and disk, bytes and GB/s, the loader wait and the
   loader-fed step ms beside phase 5's, the idle share, peak memory and the
   checkpoint directory's free space. The checkpoint is removed at the end.
10. data parallelism: ``chip_smoke.py --child`` runs with torchrun's
   environment, so that it joins a process group of one (NCCL) and this
   process's singletons stay untouched. There phase 5's model, batch and
   steps go through prepare() with the FSDP plugin, which shards the model
   with FSDP2: the first three losses and grad norms must be phase 5's
   (``DP_REL_TOL``), with 18 launches per kernel per step; the collectives
   of ``utils/operations.py`` must round-trip; phase 9's loop must resume
   bit-equal under FSDP2 (at ``CUT_LOOP_LAYERS`` of its 18 layers: the
   12.67 GB save and load at full depth are phase 9's); phase 4's tiny
   step under DDP (no plugin) must
   give phase 4's numbers, and with ``attention_impl="ring"`` and
   ``"ulysses"`` over the 6-D mesh (``pp = cp = sp = tp = 1``) bit for
   bit. Prints the FSDP2 step ms, idle share and peak memory beside phase
   5's (the loop's steps are not profiled again: their device time is the
   FSDP2 step's). The
   child also runs phase 12 (c), phase 14 (a)'s overflow under FSDP2 and
   phase 15 (c). The child's failure fails the run.
11. sequence parallelism. A chip call has one GPU, so every rank's share
   of the ring runs in this process, through ``parallel/cp.py``'s per-step
   helpers (``chunk_forward``, ``chunk_backward``) with the transfers done
   in place, and Ulysses through ``parallel/sp.py``'s layouts. (a) At
   bench.py's seq-8192 attention shape (B=2, S=8192, Hq=Hkv=16, D=128,
   bf16, causal) and at GQA 16:4, over 4 virtual ranks (2,048-token
   chunks): both rotate methods and Ulysses against one
   ``flash_attention_with_lse`` call on the whole sequence (out, lse, dQ,
   dK, dV within ``TOLS["bfloat16"]``), each timed beside it, with each
   kernel's launches. (b) bench.py's seq-8192 row: the 1.06B Llama at
   batch 2, remat "flash" (stepping down to "minimal" on OOM), 2 warm-up
   and 3 timed steps with flash attention (step ms, tok/s, MFU, idle share
   of one profiled step, peak memory); then the weights drawn again from
   the same seed and one step with every block's attention through (a)'s
   ring schedule: loss within 1e-3 and grad norm within 2e-2 of the first
   flash step's, relative, with 16 launches per kernel per layer; a second
   ring step gives its warm time.
12. the imperative loop. (a) Phase 5's model (weights from seed 0), batch
   and optimizer at 4 accumulation steps: 3 fused steps (the batch split
   into 1-row microbatches), then 3 windows of the loop a user writes,
   ``with acc.accumulate(model): loss = acc.backward(loss_fn, mb);
   acc.clip_grad_norm_(None, 1.0); opt.step(); opt.zero_grad()`` over
   ``batch[i::4]``, the rows the fused split gives microbatch i. Losses and
   grad norms within ``DP_REL_TOL`` of the fused step's (and whether they
   are bit-equal), 3 optimizer steps and 12 microbatches, every kernel
   launched once per layer per microbatch; each run's ms per optimizer
   step on the host clock, device-busy ms and idle share of one more
   profiled step, and peak memory. (b) ``find_executable_batch_size``
   from 64 rows around one full-width forward and backward of (a)'s
   model: the size that ran, the halvings, and the allocated bytes back
   within 64 MiB of their value before the search. (c) phase 10's child
   runs (a)'s loop under FSDP2 (set_requires_gradient_sync(False) on the
   microbatches that do not end a window): within ``DP_REL_TOL`` of (a)'s
   fused step, with its ms, idle share and peak memory.
13. observability. (a) Phase 9's loop (its data, schedule and model) with
   ``log_with=["json", "tensorboard"]`` and ``TelemetryKwargs(profile=True,
   log_every=2, straggler_probe_every=2)``: 8 steps inside
   ``accelerator.profile()`` (schedule wait 1, warmup 1, active 2, repeat
   1), ``accelerator.log`` of each loss, ``save_state()`` after step 4,
   ``end_training()``. TensorBoard must drop with the JAX package's
   warning where its package is missing, else hold the losses; the JSON
   tracker holds the 8 losses and the summaries of steps 2, 4, 6 and 8;
   the telemetry JSONL holds 8 step records of the JAX schema (4 samples,
   no recompile), data waits summing to what the loader's hook reported,
   peak memory equal to ``max_memory_allocated`` after each step, one
   checkpoint event within 5 % of the save's own seconds and one summary;
   the profiler's 8 records (7 lagged, the last at close) sum to their
   walls; the one traced window (steps 3-4) launches each flash kernel 18
   times a step; the flight bundle holds the 8 records. (b) With telemetry
   off, then on: host-clock ms, device-busy ms and, under
   torch.profiler, the synchronisations and device-to-host copies of a
   step, which must be equal; the counted FLOPs beside bench.py's model.
   (c) One window of phase 12's imperative loop (4 one-row microbatches):
   one ``optimizer_step`` record with its backward and apply seconds.
   (d) Phase 8's engine and trace, replayed without telemetry, then with a
   recorder's ``telemetry=``: tick records that sum to their
   walls, the serving block's TTFT equal to ``stats()``, tok/s of both
   beside phase 8's.

14. reduced precision. (a) Phase 5's model, batch and step under
   ``mixed_precision="fp16"`` with ``LlamaConfig(dtype=float16)`` and the
   default ``GradScalerKwargs`` (init scale 65536) for 2 warm-up and 10
   timed steps: per step its loss, grad norm, scale and whether it was
   skipped; step ms, tok/s, peak memory; the fp16 flash kernels 18 times
   each a step; one profiled step (device-busy ms, idle share, and its
   synchronisations and device-to-host copies, which must equal phase
   13's bf16 step's). Then one step whose loss is multiplied by inf: the
   parameters, AdamW's moments and step counts stay bit-equal
   (``torch.equal`` on the card), the optimizer's count and the step
   count hold, the scale halves (floor 1.0), and the next step applies.
   Phase 10's child runs the same overflow under FSDP2. (b) bench.py's fp8
   row: the same step under ``mixed_precision="fp8"`` with
   ``LlamaConfig(fp8=True, fp8_format="HYBRID")`` (bf16 compute), 2
   warm-up and 10 timed steps: ms, tok/s, MFU over the bf16 peak as
   bench.py reckons it, peak memory, ``fp8_speedup`` (its tok/s over phase
   5's), every fp8 product on ``torch._scaled_mm`` (21 a layer a step:
   the remat ``dots`` policy keeps the forward's), the device ms of one
   profiled step split into fp8 products, quantization (amax, casts,
   transposed copies), flash and the rest; the first loss within 5 % of
   phase 5's (``tests/test_fp8.py``'s bound) and a descending loss. (c)
   The fp8 linear at the 1.06B projection shapes (8192 tokens: 2048 →
   2048, 2048 → 5632, 5632 → 2048), bf16 operands, for HYBRID and E4M3
   (``_scaled_mm``) and E5M2 (dequantized to bf16, then a bf16 product):
   output, dX and dW against the plain version (fp32 on the codes) within
   ``TOLS["bfloat16"]``; ``_quant``'s codes and scales equal to the CPU's
   bit for bit; the forward product's ms beside its bound (fp8 peak
   1,979 TFLOP/s), the plain version's, a bf16 ``torch.mm``'s and one
   quantization's.

15. distributed checkpoints. (a) Phase 9's loop (its data, schedule and
   1.06B model's widths at ``CUT_LOOP_LAYERS`` of its 18 layers: 4.04 GB;
   phase 9 writes the full depth's 12.67 GB) with
   ``FullyShardedDataParallelPlugin(state_dict_type=
   "DISTRIBUTED_STATE_DICT")`` and no process group: ``save_state()``
   after step 4 writes torch.distributed.checkpoint's files; a fresh
   Accelerator with weights from another seed ``load_state()``s them and
   takes steps 5-8, bit-equal to the uninterrupted run, every kernel
   launched once a layer a step. (b) The same loop with ``save_state(block=
   False)`` after step 4: steps 5 and 6 run while the checkpoint persists,
   then ``wait_for_checkpoint()``, steps 7 and 8, a second background save
   (its stall, with the pinned copies of the first reused; removed once
   written), and the resume as in (a).
   Prints the save's and the load's seconds, bytes and GB/s beside phase
   9's safetensors ones; the stall (seconds until ``save_state`` returned)
   beside the blocking saves'; steps 5-6's ms with the save in flight
   beside steps 7-8's and (a)'s; ``wait_for_checkpoint``'s seconds; the
   host's MemAvailable before the save and the bytes staged; the
   checkpoint directory's free space. Each checkpoint is removed before
   the next; without room on disk or in host memory the phase fails. (c)
   In phase 10's child (NCCL, a group of one), at phase 4's tiny width so
   that the whole run stays under 600 s: (a)'s blocking save and resume
   under FSDP2, bit-equal; phase 4's step under ``SHARD_GRAD_OP``,
   ``NO_SHARD``, ``HYBRID_SHARD`` and ``DeepSpeedPlugin(zero_stage=2)``,
   each within ``DP_REL_TOL`` of phase 4's loss and grad norm, DDP
   exactly under ``NO_SHARD``, each kernel launched once per layer.

16. serving, the rest. (a) The tiny fp32 Llama on the card and on the
   CPU: the engine greedy at speculate_k 0, 2 and 4 and over int8 KV pages
   (card tokens against the CPU's under the near-tie rule, the speculative
   rows against the k=0 rows), sampled speculation at k 2 and 4 in two
   slot orders (each request's tokens follow its generator), the int8
   codes and scales of one tensor on both devices bit for bit,
   speculative_generate, and beam_search at 1 beam (greedy generate's
   tokens) and 4. (b) Phase 8's 1.06B bf16 Llama, 8 slots: phase 8's trace
   and the same arrivals with repetitive prompts (an 8-token motif
   repeated 8 times: templated code, logs, JSON), each at speculate_k 0
   and 4 (speculate_ngram 16): every status ok, drafted >= accepted and the
   rows' counts summing to stats()["speculation"], the k=4 greedy rows
   equal to the k=0 rows up to a tie gap derived in the run from three
   forward paths over the same rows (``bf16_tie_gap``), acceptance on the
   repetitive trace above 0; acceptance, tokens per tick, tok/s, TTFT and
   the decode tick's host and device ms and idle share. (c) Phase 8's
   trace over int8 KV pages: every status ok, the cache's bytes exactly
   (D + 4) / (2 D) of the bf16 cache's, the first decode step's logits
   within ``INT8_LOGIT_REL`` of the bf16 cache's; tok/s, the tick, peak
   memory, the share of greedy tokens equal to the bf16 run's and the
   device ms the eager dequantization adds to a tick. (d) One engine: a
   burst of 32 requests before the first tick into a queue of 8 under
   ``reject``, ``shed_oldest`` and ``block`` (the shed requests are the
   ones ``expected_shed`` names), deadlines that expire mid-decode (those
   requests ``timeout``, their slots reused), NaN in one live slot's KV
   rows (quarantined, the request retried and ``ok`` with a clean run's
   greedy tokens) and every live slot poisoned (``ServingStalledError``
   within ``max_idle_ticks`` ticks); each faults block and window. (e)
   bench.py's decode row through speculative_generate with the target as
   its own draft and with a 2-layer draft (tokens equal to greedy
   generate's up to the tie gap; target passes, ms per token beside
   phase 7's) and beam_search with 4 beams (its length-normalised score at
   least greedy's, within ``BEAM_SCORE_REL``). No flash kernel is on this
   path; its launches, counted from zero, are in the kernel summary.
17. the Llama decoder chassis. (a) Phase 4's tiny width with Gemma's knobs
   and with Granite's constants, biases, layernorm, an ungated MLP and
   partial rotary: one bf16 step on the card and on the CPU from the same
   numpy-seeded weights, loss and grad norm within phase 4's tolerance.
   (b) Gemma-2B (google/gemma-2b's config.json through
   ``gemma_config_from_hf``: 2.5B parameters, head dim 256, 8 query heads
   over 1 KV head, vocabulary 256,000) with seeded random weights: batch
   2 x seq 2048, bf16 over fp32 masters, adamw, clipping, remat "dots",
   flash attention, ``fused_cross_entropy_loss`` in chunks of 256; 2
   warm-up and 5 timed steps on one batch with the flash kernels' launches
   counted from zero (18 of each a step, all of the bf16 head-dim-256
   variant), ms per step, MFU, peak memory, one profiled step (idle share,
   device time by category); then the fused loss and one step of
   ``cross_entropy_loss`` on the same state and an unseen batch (within
   ``FUSED_LOSS_REL``; the two steps' peaks side by side). (c) Its decode row (phase 7's, bf16
   and int8 weights) beside the 5.01 GB per-token bound. (d) Its engine on
   phase 8's trace cut to 16 requests. (e) A tiny Gemma written as a
   Hugging Face checkpoint and read back by ``model_from_pretrained``:
   logits equal bit for bit.
18. the Mixtral family and long-context generation. (a) Phase 4's tiny
   width with 4 experts, top 2 and capacity factor 0.5 (tokens drop): one
   bf16 step on the card and on the CPU from the same numpy-seeded
   weights, loss, aux loss and grad norm within phase 4's tolerance, equal
   dropped counts, each layer's chosen experts of the two steps equal
   wherever the k-th and (k+1)-th router probabilities lie further apart
   than the tie gap the two steps' router inputs allow (those inputs
   within phase 4's tolerance), and each layer's routing on the card from
   the CPU step's router inputs equal to the CPU's above ``TIE_GAP``. (b)
   Mixtral-8x7B
   (mistralai/Mixtral-8x7B-v0.1's config.json through
   ``mixtral_config_from_hf``, seeded random weights) at 2 layers: batch 2
   x seq 2048 (batch 1 where 2 does not fit, said so), bf16 over fp32
   masters, adamw, clipping, remat "dots", flash attention,
   ``moe_cross_entropy_loss``; 2 warm-up and 5 timed steps with the flash
   kernels' launches counted from zero (2 of each a step, all
   ``*.bf16.d128``), ms, tok/s, MFU over the active parameters, peak
   memory, the dropped share, and one profiled step with the router,
   dispatch, expert products and combine as categories of their own. (c)
   Phase 7's decode row at 8 layers in bf16 beside the routed experts' and
   all experts' per-token bounds. (d) Phase 8's engine on 16 requests; its
   greedy tokens against generate()'s on the fp32 model of the same width
   and depth. (e) cp_generate at one process on phase 7's 1.06B Llama,
   prompt (1, 8192), 32 new tokens: tokens equal generate()'s under the
   near-tie rule (the tie gap from the plain bf16 and fp32 prefills), the
   kernel prefill's last logits within ``CP_LOGITS_DELTA`` of the plain
   bf16 one's, prefill ms, ms a token, peak memory, 18 forward launches.
   (f) A tiny Mixtral written as a Hugging Face checkpoint and read back:
   logits equal bit for bit. Phase 2 holds the kernels at the Mixtral
   step's attention shape (B2 S2048 Hq32 Hkv8 D128) and at cp_generate's
   prefill (B1 S8192 H16 D128), and phase 3 times them there.
19. GPT-2, GPT-NeoX, OPT, T5 and Whisper (``FAMILY_ROWS``: the JAX
   package's gpt2_xl, pythia_1b, opt_1b3, t5_base and whisper_large
   presets at their published widths, seeded random weights). (a) Each
   family's tiny model on the card and on the CPU from the same
   numpy-seeded weights: fp32 greedy generate() tokens under the near-tie
   rule (TF32 off), for T5 and Whisper also beam_search() with a decoder
   prompt, equal; one bf16 train step, loss within 2e-2. (b) Each
   full-width model's train step through prepare_train_step (bf16 over
   fp32 masters, adamw(3e-4, weight_decay=0.1), clipping, remat on every
   block): GPT-2 XL 4 x 1024, Pythia-1B 4 x 2048, OPT-1.3B 4 x 2048,
   T5-base 8 x (512 encoder, 128 decoder), Whisper-large 2 x (3000, 80)
   features and 128 decoder tokens; 2 warm-up and 3 timed steps (the batch
   halved on OOM, said so), ms, tokens/s, MFU from the counted FLOPs (the
   formula in the row), peak memory, one profiled step (device-busy ms,
   idle share, categories); losses start near ln(vocab) and fall, and no
   flash kernel launches (these families attend with materialised scores,
   as their JAX modules do). (c) Each trained model in bf16: the causal
   ones' decode row (prompt (1, 64), 32 new tokens), T5's 32 tokens from
   a 512-token input, Whisper's from (1, 3000, 80) features with its
   start-of-transcript prompt and forced language, task and no-timestamps
   tokens; the encoder's ms apart; ms a token, device ms, idle share
   beside the bytes bound (the decoder's weights, the self-attention K/V
   and the cross-attention K/V). (d) OPT-1.3B's engine on phase 8's trace
   cut to 16 requests: each row equal to generate()'s of its prompt under
   the tie gap ``bf16_tie_gap`` derives; an encoder-decoder module
   refused. (e) A tiny checkpoint of each family in transformers' names
   and layouts (``HF_LAYOUT``) read by model_from_pretrained from its
   directory: logits equal bit for bit to the in-memory load's.
20. BERT, ViT, CLIP and ResNet (``ENCODER_ROWS``: the JAX package's
   bert_large, vit_base, CLIPConfig's defaults (openai/clip-vit-base-patch32)
   and resnet50 presets at their published widths, numpy-seeded
   weights). (a) Each family's tiny model: one bf16 train step on the card
   and on the CPU from the same numpy-seeded weights, loss within 2e-2.
   (b) Each full-width model's train step through prepare_train_step (bf16
   over fp32 masters, adamw(3e-4, weight_decay=0.1), clipping):
   BERT-large's masked LM on 16 x 512 tokens, 15 % masked, with the
   preset's dropout drawn from a torch.Generator; ViT-B/16 on 64 images of
   224^2 and 1000 labels; CLIP ViT-B/32 on 128 pairs of 77 text tokens and
   224^2 images; ResNet-50 on 64 images of 224^2 with mutable_state (the
   running statistics); 2 warm-up and 3 timed steps, ms, tokens/s or
   images/s, MFU from the module's shapes (the formula in the row; the
   convolutions' MACs for ResNet), peak memory, one profiled step
   (device-busy ms by matmul/conv, elementwise and softmax, BatchNorm,
   AdamW, BatchNorm's kernels moved one by one out of the category they
   fell in, the categories adding up to the busy total; idle share); the
   timed steps' mean loss below the first, no
   flash kernel launches (materialised attention and convolutions, as in
   the JAX modules), ResNet's running statistics moved and its eval-mode
   logits reading them. (c) A tiny BERT, ViT and CLIP written in
   transformers' names and layouts (``HF_LAYOUT``) and read back by
   model_from_pretrained: outputs equal bit for bit. (d) FSDP2 over a
   process group of one (NCCL): every family's tiny model, the eleven the
   port trains, gets one unit on each block and on the root (ROADMAP.md
   fault 7), and one train step through them.

21. big-model inference. (a) Llama-2-7B's published widths at its 32
   layers (``LLAMA2_7B``: 6.74B parameters, bf16 weights of std 0.02 from
   seed 21, flash attention) written as the JAX package's sharded
   safetensors checkpoint (flax names, 2 GB shards) and dispatched by
   ``load_checkpoint_and_dispatch(device_map="auto")`` within 6 GiB on the
   card and 6 GiB of pinned host memory, the rest in the disk store: one
   warm and one counted forward of a (1, 1024) prompt, streamed; then the
   same checkpoint loaded whole on the card (fp32 masters: the same bf16
   values at use) and its forward. The logits must be equal bit for bit
   (the same kernels on the same bf16 values in the same order), the flash
   forward kernel launched 32 times in each forward, and the streamed
   forward's ``max_memory_allocated`` above what was allocated before it
   at most the card's budget plus two blocks. Prints the bytes in each
   tier, both forwards' seconds, the bytes copied host to device and their
   GB/s, ``last_stream_peak_bytes``, the host's MemAvailable and the free
   disk (without the room the phase fails). (b) ``load_and_quantize_model``
   of the resident model at 8 and 4 bits (NF4), bf16 compute: bytes under
   the JAX package's shares of the fp32 masters' (``QUANT_GATES``), logits
   equal bit for bit to the model of the dequantized weights; the bytes,
   forward ms, peak, and the cosine and greedy agreement against bf16 at
   32 layers and at the first ``QUANT_DEPTHS`` layers; the JAX package's
   own test (its tiny Llama, fp32) on the card under its cosine,
   agreement and bytes gates. (c) The seven streamed families' tiny models
   (``STREAM_FAMILIES``, fp32): ``dispatch_model`` over the card, the host
   and the disk, ``cpu_offload``, ``disk_offload`` and
   ``cpu_offload_with_hook`` chained to a second model: each within
   ``STREAM_CARD_REL`` of the model resident on the card (bit-equality
   printed) and ``STREAM_REL`` of the port on the CPU, every call
   streamed. (d) A megatron-core checkpoint of
   Llama-2-7B's widths at 2 layers, TP 2 x PP 2 (``mp_rank_0T_00P``, bf16,
   its args) through ``load_megatron_model`` onto the card: logits equal bit
   for bit to the model built from the same flax tree directly.
22. tensor parallelism at ``tp=2`` as two processes on the one card
   (``chip_smoke.py --tp-child``, both on cuda:0 through ``LOCAL_RANK=0``),
   each joining a gloo group itself: NCCL refuses two ranks on one device,
   and gloo stages every all-reduce through the host, so the step's ms are
   gloo's, not NCCL's. (a) Phase 5's model, weights, batch and optimizer
   with ``llama_tp_rules``: 3 steps whose losses and grad norms are within
   ``TP_REL_TOL`` of phase 5's first three on both ranks (equal on both),
   each flash kernel launched 18 times a step on each rank at 8 heads;
   the step ms, one profiled step's device-busy ms by category and idle
   share, the peak memory and the all-reduces a step with their bytes.
   (b) Phase 7's bf16 decode row at ``tp=2``: the greedy tokens equal
   phase 7's off near-ties, and the teacher-forced logits of phase 7's
   row within a bound of phase 7's; the tie gap and the bound are
   ``TP_PLAIN_FACTOR`` times phase 7's own bf16-against-fp32 difference on
   that row; ms, kernel launches and all-reduces a token. Phases 2 and 3
   check and time the kernels at each rank's attention shape (B4 S2048
   H8 D128).
23. pipeline parallelism, the comm hooks and ``LocalSGD``, run by phase
   22's two processes after its work (no second spawn or rendezvous); gloo
   stages every send and all-reduce through the host. (a) GPipe at
   ``pp=2``: phase 5's model, weights, batch and optimizer, 9 layers a
   rank, 4 microbatches of one row, 3 steps whose losses and grad norms
   are within ``PP_REL_TOL`` of phase 5's first three on both ranks (equal
   on both), each flash kernel launched 36 times a step on each rank;
   step ms, one profiled step's device-busy ms by category and idle share,
   the peak memory, the point-to-point sends and bytes a step (and those
   staged through the host). (b) Interleaved, ``pp_virtual_stages=3``:
   chunks ``{d, d+2, d+4}`` of 3 layers, 2 microbatches of 2 rows, the
   same gate at 18 launches. (c) ``prepare_pippy``: the pipelined forward
   of phase 5's batch against the same model resident on the card
   (relative L2 of the logits within ``PIPPY_REL_TOL``, argmax equal where
   the top-2 gap exceeds the measured difference), and a tiny GPT-2's
   pipelined logits on the card against the CPU's. (d) The comm hooks at
   ``dp_replicate=2``, phase 5's widths at 2 of its 18 layers (gloo's
   all-reduce of the whole model's fp32 gradients would take seconds a
   step), each rank on its half of phase 5's batch: ``"no"``, ``"fp16"``,
   ``"bf16"`` and ``"powersgd"`` (rank 8) for 3 steps each, the wire
   hooks' losses within ``HOOK_LOSS_TOL`` of ``"no"``'s, PowerSGD's first
   loss equal to it and its later ones finite, and its reduced gradients
   within ``POWERSGD_PLAIN_TOL`` of the hook's plain version (the same
   algorithm on both ranks' gradients in fp64 on the card); step ms and
   wire bytes a step. (e) ``LocalSGD(local_sgd_steps=2)`` over 4 steps of
   (d)'s model, the ranks on different batches: the parameters differ
   across the ranks before each boundary and are bit-equal after it.
   Phases 2 and 3 check and time the kernels at the GPipe microbatch
   shape (B1 S2048 H16 D128).
24. expert parallelism, run by phase 22's two processes after phase 23:
   phase 18 (b)'s Mixtral-8x7B step (its widths at 2 layers, weights,
   batch of 2 × 2048 and optimizer) with ``mixtral_tp_rules(ep_axes=...)``
   and FSDP2 on the rest. (a) ``ep_size=2`` over ``dp_shard=2``: one row
   a rank, 4 of the 8 experts a rank; (b) ``sp_size=2`` with
   ``ep_size=2`` (ep over ``sp``): both rows, half the sequence a rank,
   Ulysses attention, the routing's slot order over the processes'
   chunks. Each: 3 steps on both ranks (equal on both) against phase 18
   (b)'s first three: step 1's loss within ``EP_STEP1_LOSS_TOL``, its
   grad norm within ``EP_STEP1_NORM_TOL`` and its dropped choices equal; steps 2-3 within
   ``EP_REL_TOL``, their drops within ``EP_DROP_SHARE`` of the routed
   count plus ``EP_REL_TOL`` of phase 18's drops; 2 launches a kernel a
   step on each rank, ``estimate_per_chip`` within
   ``EP_ESTIMATE_SHARE`` of each rank's peak; step ms, one profiled
   step's device-busy ms by category and idle share, the token
   exchange's calls and bytes a step (all staged through the host over
   gloo); then greedy ``generate`` of 8 tokens from phase 7's (1, 64)
   prompt with the experts split, equal on both ranks and held to the
   plain dropless decode of the same weights with the stacks gathered
   whole (tokens off near-ties, teacher-forced logits within
   ``TP_PLAIN_FACTOR`` times the plain bf16 logits' distance from fp32),
   its top-2 gaps and ms a token. ``chip_smoke.py --drop-witness`` runs
   ``drop_shift_witness``, which shows why the gate widens after step 1.
   Phases 2 and 3 check and time the kernels at each rank's attention:
   (a) B1 S2048 Hq32 Hkv8 D128, (b) after the Ulysses exchange B2 S2048
   Hq16 Hkv16 D128 (the kv heads repeated up to the q heads first, as
   the JAX package does).
25. the rest of item 6, run by phase 22's two processes after phase 24
   (``rest_child``, judged by ``rest_gate``): (a) phase 14 (b)'s fp8 step
   (HYBRID) at ``tp=2``: 3 steps within ``TP_REL_TOL`` of phase 14 (b)'s
   first three, equal on both ranks, every product on ``_scaled_mm``, one
   launch a kernel a layer a step; step ms, the amax all-reduces a step
   and their share of the step, the peak, one profiled step's device-busy
   ms by category. (b) phase 23 (d)'s 2-layer model in fp8 at
   ``dp_replicate=2``, each rank on half of phase 5's batch: step 1's
   scales equal on both ranks, 3 steps within ``TP_REL_TOL`` of the
   parent's one-process steps on the whole batch (``fp8_batch_steps``);
   one step under the ``"fp16"`` comm hook: each rank's own scales, no
   amax collective, its loss within ``HOOK_LOSS_TOL``. (c) ``generate``
   over ``tp=2`` of GPT-2 XL and T5-base from phase 19's seeds in bf16
   (phase 19's decode inputs, 8 greedy tokens): tokens equal to the same
   weights decoded on one process off near-ties, teacher-forced logits
   within ``TP_PLAIN_FACTOR`` times the reference's bf16-against-fp32
   difference; ms and all-reduces a token. (d) phase 18 (b)'s Mixtral
   step at ``pp=2`` (one layer a stage, GPipe over its two rows): phase
   24's gates against phase 18 (b), two launches a kernel a step; step
   ms, sends and bytes, the peak, the aux loss. (e) phase 23 (d)'s model
   at ``pp=2`` under ``DISTRIBUTED_STATE_DICT``: a save, a load into a
   fresh prepare and the next step bit-equal to the step without the
   round trip; the same model under FSDP2 at ``dp_shard=2`` saved whole
   (``SHARDED_STATE_DICT``, through ``gather_shards`` on the card) and
   resumed by the parent on one process, bit-equal; seconds and bytes.
26. fault tolerance, chaos and SDC (``ft_phase``, judged by ``ft_gate``).
   (a) phase 5's Llama at 4 of its 18 layers under
   ``FaultToleranceKwargs(sentinel="rollback")``: 8 steps, saves after
   steps 2 (a ``size`` manifest) and 4 (``sha256``), the chaos schedule
   ``FT_SCHEDULE`` (the second save's first attempt torn, a slow step at
   tick 2, nonfinite metrics at tick 5): the torn save retried clean, the
   rollback to step 4, every step's loss bit-equal to the fault-free run
   with the manager off, no ``.tmp`` left, host syncs a step equal with
   the manager on and off, a truncated newest checkpoint skipped for the
   older one; step ms on and off, save s under both checksums (the
   commit's share), verify-on-load s, rollback s. (b) ``chip_smoke.py
   --ft-child`` twice in turn: the first sends itself SIGTERM after step
   3, saves and exits 75; the second, with ``ACCELERATE_RESTART_ATTEMPT=1``
   and ``automatic_resume``, resumes and takes steps 4-6 bit-equal to (a)'s
   fault-free run; both start with the phase and wait for their turns,
   the first's beside (a)'s fault-free run, the second's beside (d), which
   measure no time. (c) in phase 22's two processes after phase 25 (and
   (e)): 2 of phase 5's layers at ``dp_replicate=2``, each rank on the
   same row, the SDC sentinel voting every step: a transient ``bit_flip``
   of rank 1's digest repaired (no majority, the probe rerunning the
   golden step with the golden digest, rollback to step 1) with the
   replay's losses and digests those of the first pass, then a sticky
   flip: rank 1 writes ``sdc_quarantine.json`` and exits 79 for real (the
   gates of phases 22-25 read its 79 as 0 when the record names it, and
   rank 0 leaves without a collective); the digest's device ms and the
   vote's host ms. (d) phase 8's 8-slot engine on phase 7's model: a
   ``decode_tick`` poison fails exactly its request (no retry) and the
   other rows equal the fault-free run's; ``DecodeCanary(every=16)`` reads
   no mismatch fault-free and one or more under a bit flip of its own
   slot; SIGTERM drains the engine (the queue shed, the two requests in
   flight finished) and its exit code is 75. (e) in the same processes
   before (c): phase 20 (b)'s BERT-large and phase 19 (b)'s T5-base steps
   at ``pp=2`` (BERT's 24 layers split; T5's 11 ``rest`` blocks do not
   divide and stay whole on both stages): step 1's loss within
   ``PP_FAMILY_REL_TOL`` of the one-process step 1, equal on both ranks.

Then the kernel summary line (one entry per kernel of every timed
variant) and, last, the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Peak rates of the card (NVIDIA H100 SXM data sheet, dense): bf16 and fp16
# tensor-core FLOP/s, fp8's, fp32 FLOP/s on the CUDA cores, HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_FP8_FLOPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# By the kernels' input dtype: the peak rate of its products and its bytes
# per element (fp32 inputs run on the CUDA cores: flash_f32.cu).
DTYPE_PEAK = {"bfloat16": (PEAK_BF16_FLOPS, 2), "float16": (PEAK_BF16_FLOPS, 2),
              "float32": (PEAK_FP32_FLOPS, 4)}

# Each kernel against its plain version (fp32 on the same inputs): output
# and gradients as relative error in norm, lse as absolute error. fp16 is
# held to bf16's tolerance (its mantissa is finer); fp32 kernels multiply in
# fp32 and differ from the plain version only in the order of their sums.
TOLS = {"bfloat16": (1e-2, 2e-2, 5e-3), "float16": (1e-2, 2e-2, 5e-3),
        "float32": (1e-4, 1e-4, 1e-4)}
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
SLICE = dict(b=4, s=2048, hq=16, hkv=16, d=128)
# Gemma-2B's attention (8 query heads, 1 KV head, head dim 256) at seq 2048.
GEMMA_LIKE = dict(b=2, s=2048, hq=8, hkv=1, d=256)
# Mixtral-8x7B's attention (32 query heads over 8 KV heads, head dim 128) at
# phase 18's step shape.
MIXTRAL_LIKE = dict(b=2, s=2048, hq=32, hkv=8, d=128)
# Phase 18's cp_generate prefill: phase 7's 1.06B Llama (16 heads of dim
# 128) over a (1, 8192) prompt, the forward kernel once a layer.
CP_GEN_LIKE = dict(b=1, s=8192, hq=16, hkv=16, d=128)
# Phase 21's streamed and resident forwards: Llama-2-7B (32 heads of 128)
# over a (1, 1024) prompt, the forward kernel once a layer.
LLAMA2_7B_LIKE = dict(b=1, s=1024, hq=32, hkv=32, d=128)
# Phase 22's step at tp=2: each rank's attention, 8 of phase 5's 16 heads.
TP_RANKS = 2
TP_LIKE = dict(SLICE, hq=SLICE["hq"] // TP_RANKS, hkv=SLICE["hkv"] // TP_RANKS)
# Phase 23's GPipe step at pp=2: one microbatch of one of phase 5's rows.
PP_MICROBATCHES = SLICE["b"]
PP_LIKE = dict(SLICE, b=SLICE["b"] // PP_MICROBATCHES)
# Phase 24's ranks: (a) ep=2 over dp_shard=2, each rank one of phase 18
# (b)'s two rows (Mixtral's attention at batch 1); (b) sp=2 with ep=2,
# after the Ulysses exchange both rows over the whole sequence at half the
# heads, the kv heads repeated up to the q heads first (as the JAX package
# does).
EP_RANKS = 2
EP_LIKE = dict(MIXTRAL_LIKE, b=MIXTRAL_LIKE["b"] // EP_RANKS)
SP_EP_LIKE = dict(MIXTRAL_LIKE, hq=MIXTRAL_LIKE["hq"] // EP_RANKS,
                  hkv=MIXTRAL_LIKE["hq"] // EP_RANKS)
# The main paths whose launches the kernels line reports: phase 5's Llama
# train step (bf16 d128), phase 17's Gemma-2B train step (bf16 d256), phase
# 18's Mixtral-8x7B train step (bf16 d128, GQA 4:1) and its cp_generate
# prefill (bf16 d128 at seq 8192, the forward kernel), and phase 21's
# Llama-2-7B forward streamed past a budget on the card (the forward kernel),
# phase 22's step at tp=2 (each rank's counts: rank 0's are reported), and
# phase 23's GPipe and interleaved steps at pp=2 (rank 0's), and phase 24's
# Mixtral steps under ep (rank 0's), and phase 25's fp8 step at tp=2, its
# Mixtral step at pp=2 and its DCP round trip's steps at pp=2 (rank 0's).
MAIN_PATHS = ("train_step", "gemma_2b_step", "mixtral_8x7b_step", "cp_generate",
              "big_model_stream", "tp_step", "pp_step", "pp_interleaved_step", "ep_step",
              "sp_ep_step", "fp8_tp_step", "pp_mixtral_step", "pp_dcp_step")
# The other runs whose launches the line lists by path, outside "launches".
OTHER_PATHS = ("imperative_loop", "observed_loop", "observed_imperative", "observed_serving",
               "fp16_step", "fp8_step", "dcp_loop", "dcp_async_loop", "serving_rest",
               "big_model_resident", "tp_generate", "pippy_forward", "ep_generate", "ft_loop")
_TRAINING_PATHS = ("train_step", "gemma_2b_step", *OTHER_PATHS)
# Phase 3 times every built variant (hopper_flash.variant) at the shape its
# users give it: head dims 64 and 128 at the training shape, 256 at the
# Gemma-like one, and one head dim the wrappers pad (96, run at 128). The
# first is the main path's. Each entry is (name, dtype, shape, paths): the
# kernels line names it by its variant, with the name appended where one is
# given, and counts there the launches of those paths at that variant.
TIMED = [(None, "bfloat16", SLICE, _TRAINING_PATHS),
         (None, "bfloat16", dict(SLICE, d=64), _TRAINING_PATHS),
         (None, "bfloat16", GEMMA_LIKE, _TRAINING_PATHS),
         (None, "float16", SLICE, _TRAINING_PATHS),
         (None, "float16", dict(SLICE, d=64), _TRAINING_PATHS),
         (None, "float16", GEMMA_LIKE, _TRAINING_PATHS),
         (None, "float32", SLICE, _TRAINING_PATHS),
         (None, "float32", dict(SLICE, d=64), _TRAINING_PATHS),
         (None, "float32", GEMMA_LIKE, _TRAINING_PATHS),
         (None, "bfloat16", dict(SLICE, d=96), _TRAINING_PATHS),
         ("mixtral_8x7b", "bfloat16", MIXTRAL_LIKE, ("mixtral_8x7b_step",)),
         ("cp_generate_8192", "bfloat16", CP_GEN_LIKE, ("cp_generate",)),
         ("llama2_7b_stream", "bfloat16", LLAMA2_7B_LIKE, ("big_model_stream",
                                                           "big_model_resident")),
         ("tp2_heads8", "bfloat16", TP_LIKE, ("tp_step", "tp_generate", "fp8_tp_step")),
         ("pp_microbatch", "bfloat16", PP_LIKE, ("pp_step", "pp_interleaved_step",
                                                  "pippy_forward", "pp_dcp_step")),
         ("ep_row", "bfloat16", EP_LIKE, ("ep_step", "ep_generate", "pp_mixtral_step")),
         ("sp_ep_ulysses", "bfloat16", SP_EP_LIKE, ("sp_ep_step",))]
SOURCES = {"flash_fwd": "accelerate_tpu_torch/ops/csrc/flash_fwd.cu",
           "flash_dq": "accelerate_tpu_torch/ops/csrc/flash_dq.cu",
           "flash_dkv": "accelerate_tpu_torch/ops/csrc/flash_dkv.cu",
           "flash_f32": "accelerate_tpu_torch/ops/csrc/flash_f32.cu"}
REPLACES = {"flash_fwd": "accelerate_tpu/ops/pallas_flash.py:72",
            "flash_dq": "accelerate_tpu/ops/pallas_flash.py:185",
            "flash_dkv": "accelerate_tpu/ops/pallas_flash.py:226"}
# The Llama widths bench.py measures (bench.py:_build_config, big-HBM rung).
FULL_WIDTH = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                  num_hidden_layers=18, num_attention_heads=16, num_key_value_heads=16)
GEN_PROMPT, GEN_NEW_TOKENS = 64, 32   # bench.py's decode row: prompt (1, 64), 32 new
# Decode steps under torch.profiler for the device-busy time a token; the
# profile's parsing takes far longer than the steps it records.
PROFILED_DECODE_STEPS = 8
# benchmarks/generate_bench.py --serving with its defaults: --requests,
# --slots, --qps, --prompt-len, --new-tokens.
SERVING_ROW = dict(requests=32, slots=8, qps=8.0, prompt_len=64, new_tokens=64)
# Greedy tokens of two devices must agree wherever the reference's top-2
# logit gap exceeds this; below it, fp32 rounding may pick either token.
TIE_GAP = 1e-4
# Phase 9: the training loop around phase 5's step.
LOOP = dict(rows=48, batch=4, steps=8, save_after=4, profile_steps=2, data_seed=9,
            init_seeds=(0, 1), weight_decay=0.1,
            schedule=dict(init_value=0.0, peak_value=3e-4, warmup_steps=2, decay_steps=12))
# Phase 10's loop under FSDP2 and phase 15's DCP loops at this many of
# phase 9's 18 layers: the same saves, loads and bit-equal resumes, 4.04 GB
# checkpoints where phase 9 writes the full depth's 12.67 GB.
CUT_LOOP_LAYERS = 4
# Where the checkpoint goes when the temporary directory lacks the room
# (listed in .gitignore; removed at the end of the phase).
CKPT_FALLBACK = Path(__file__).resolve().parent / ".smoke_ckpt"


# Seconds since the script started go on every line it prints.
RUN_START = time.perf_counter()


def emit(obj):
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - RUN_START}), flush=True)


def rel_err(got, ref):
    ref_norm = float(ref.float().norm())
    diff = float((got.float() - ref.float()).norm())
    return diff / ref_norm if ref_norm > 0 else diff


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def inputs(b, s, hq, hkv, d, seed, fused_qkv=False, dtype="bfloat16", device="cuda"):
    """q, k, v, dout of `dtype` and an fp32 lse cotangent from a seed; with
    `fused_qkv`, q, k and v are strided views of one (B, S, Hq+2·Hkv, D)
    buffer, as a fused QKV projection gives them."""
    import torch

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    if fused_qkv:
        qkv = rnd(b, s, hq + 2 * hkv, d).to(dt)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    else:
        q, k, v = (rnd(b, s, h, d).to(dt) for h in (hq, hkv, hkv))
    dout = rnd(b, s, hq, d).to(dt)
    g_lse = rnd(b, hq, s)
    return q, k, v, dout, g_lse


def check_kernels(hf, name, b, s, hq, hkv, d, q_offset=0, k_offset=0, seed=0, causal=True,
                  fused_qkv=False, dtype="bfloat16", device="cuda"):
    """Kernel against plain version on the same inputs of `dtype`; returns
    errors, the variant each kernel ran (``hopper_flash.variant``) and
    whether it passed TOLS. dQ and dK/dV are launched twice and must agree
    with themselves bit for bit: every variant writes each output row from
    one block, with no atomics."""
    import torch

    q, k, v, dout, g_lse = inputs(b, s, hq, hkv, d, seed, fused_qkv, dtype, device)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    out, lse = hf.flash_fwd_cuda(q, k, v, **kw)
    out_ref, lse_ref = hf.flash_fwd_plain(q.float(), k.float(), v.float(), **kw)
    delta = ((dout.float() * out_ref).sum(-1).transpose(1, 2) - g_lse).contiguous()
    dq = hf.flash_dq_cuda(q, k, v, dout, lse_ref, delta, **kw)
    dq2 = hf.flash_dq_cuda(q, k, v, dout, lse_ref, delta, **kw)
    dk, dv = hf.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, **kw)
    dk2, dv2 = hf.flash_dkv_cuda(q, k, v, dout, lse_ref, delta, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    ref_args = (q.float(), k.float(), v.float(), dout.float(), lse_ref, delta)
    dq_ref = hf.flash_dq_plain(*ref_args, **kw)
    dk_ref, dv_ref = hf.flash_dkv_plain(*ref_args, **kw)
    lse_err = float((lse - lse_ref).abs().max())
    fully_masked = bool((out_ref == 0).all())
    width = hf.built_head_dim(d)
    errs = {
        "case": name, "shape": [b, s, hq, hkv, d], "dtype": dtype, "causal": causal,
        "fused_qkv": fused_qkv, "q_offset": q_offset, "k_offset": k_offset,
        "variants": {kname: hf.variant(kname, q.dtype, width) for kname in KERNELS},
        "library": hf.source("flash_fwd", q.dtype), "padded_to": width if width != d else None,
        "out_rel": rel_err(out, out_ref), "lse_abs": lse_err,
        "dq_rel": rel_err(dq, dq_ref), "dk_rel": rel_err(dk, dk_ref), "dv_rel": rel_err(dv, dv_ref),
        "dq_repeat_identical": bool(torch.equal(dq, dq2)),
        "dkv_repeat_identical": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
        "max_abs": {
            "flash_fwd": float((out.float() - out_ref).abs().max()),
            "flash_dq": float((dq.float() - dq_ref).abs().max()),
            "flash_dkv": max(float((dk.float() - dk_ref).abs().max()),
                             float((dv.float() - dv_ref).abs().max())),
        },
    }
    tol_out, tol_grad, tol_lse = TOLS[dtype]
    errs["tolerance"] = {"out_rel": tol_out, "grad_rel": tol_grad, "lse_abs": tol_lse}
    ok = (errs["out_rel"] <= tol_out and lse_err <= tol_lse
          and max(errs["dq_rel"], errs["dk_rel"], errs["dv_rel"]) <= tol_grad)
    if fully_masked:
        # No key visible: exact zeros and lse ~ -1e30, gradients exactly 0.
        errs["exact_zero_out"] = bool((out == 0).all())
        ok = (errs["exact_zero_out"] and float(lse.max()) < -1e29
              and all(bool((x == 0).all()) for x in (dq, dk, dv)))
        errs["lse_max"] = float(lse.max())
    errs["ok"] = ok and errs["dq_repeat_identical"] and errs["dkv_repeat_identical"]
    return errs


# The design each kernel library is built to, and so what its SASS must
# show: the wgmma libraries wgmma products (HGMMA) on TMA-loaded tiles
# (UTMALDG) and no mma.sync (HMMA); the fp32 library FMA on the CUDA cores
# (FFMA) and no tensor-core product of either kind.
DESIGNS = {"flash_fwd": "wgmma", "flash_dq": "wgmma", "flash_dkv": "wgmma",
           "flash_f32": "cuda-core fma"}


def sass_counts(names):
    """Counts of wgmma (HGMMA), TMA load (UTMALDG), mma.sync (HMMA) and fp32
    FMA (FFMA) instructions in each built library, from cuobjdump beside
    nvcc."""
    from pathlib import Path

    from accelerate_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).resolve().parent / "cuobjdump"
    if not cuobjdump.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({cuobjdump})")
    counts = {}
    for name in names:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in ("HGMMA", "UTMALDG", "HMMA", "FFMA")}
    return counts


def sass_ok(sass):
    """Whether every kernel library was built to its design (DESIGNS).
    `sass` maps each library to its counts (sass_counts)."""
    def built_to_design(name):
        c = sass.get(name)
        if c is None:
            return False
        if DESIGNS[name] == "wgmma":
            return c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        return c["FFMA"] > 0 and c["HGMMA"] == 0 and c["HMMA"] == 0

    return all(built_to_design(name) for name in DESIGNS)


def causal_pairs(s):
    return s * (s + 1) // 2


def bounds(b, s, hq, hkv, d, dtype="bfloat16", causal=True):
    """Least time (ms) each kernel could take at these shapes: the larger of
    its FLOPs over the peak rate for its dtype and its bytes over HBM rate.
    D is the caller's: a padded head dim counts the unpadded work."""
    peak, elem = DTYPE_PEAK[dtype]
    pairs = b * hq * (causal_pairs(s) if causal else s * s)
    q_bytes, kv_bytes, stat_bytes = b * s * hq * d * elem, b * s * hkv * d * elem, b * hq * s * 4
    work = {  # (matmuls of 2·D FLOP per visible pair, bytes read once + written once)
        "flash_fwd": (2, q_bytes + 2 * kv_bytes + q_bytes + stat_bytes),
        "flash_dq": (3, 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + q_bytes),
        "flash_dkv": (4, 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + 2 * kv_bytes),
    }
    out = {}
    for name, (mms, nbytes) in work.items():
        flop_ms = mms * 2 * d * pairs / peak * 1e3
        byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
        out[name] = (max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes")
    return out


def time_variant(hf, dtype, shape):
    """Each kernel's ms at `shape` (causal) for `dtype`, beside its plain
    version's, its bound and SDPA's forward and backward on the same
    inputs."""
    import torch
    import torch.nn.functional as F

    b, s, hq, hkv, d = (shape[x] for x in ("b", "s", "hq", "hkv", "d"))
    q, k, v, dout, g_lse = inputs(b, s, hq, hkv, d, seed=7, dtype=dtype)
    out, lse = hf.flash_fwd_cuda(q, k, v)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
    ms = {
        "flash_fwd": cuda_ms(lambda: hf.flash_fwd_cuda(q, k, v), 20),
        "flash_dq": cuda_ms(lambda: hf.flash_dq_cuda(q, k, v, dout, lse, delta), 20),
        "flash_dkv": cuda_ms(lambda: hf.flash_dkv_cuda(q, k, v, dout, lse, delta), 20),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: hf.flash_fwd_plain(q, k, v), 3, warmup=1),
        "flash_dq": cuda_ms(lambda: hf.flash_dq_plain(q, k, v, dout, lse, delta), 3, warmup=1),
        "flash_dkv": cuda_ms(lambda: hf.flash_dkv_plain(q, k, v, dout, lse, delta), 3, warmup=1),
    }
    # Library yardstick: scaled_dot_product_attention on (B, H, S, D) views,
    # with its own GQA where the heads are grouped.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    gqa = {"enable_gqa": True} if hq != hkv else {}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(sdpa, 20)
    o = sdpa()
    g = dout.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True), 20)
    width = hf.built_head_dim(d)
    return {
        "dtype": dtype, "shape": shape, "padded_to": width if width != d else None,
        "variants": {name: hf.variant(name, q.dtype, width) for name in KERNELS},
        "ms": ms, "plain_ms": plain_ms, "bound": bounds(b, s, hq, hkv, d, dtype),
        # SDPA's backward yields dq, dk and dv in one call: it stands beside
        # the sum of the dQ and dK/dV kernels, and beside neither alone.
        "library_ms": {"flash_fwd": sdpa_fwd, "flash_dq+flash_dkv": sdpa_bwd},
    }


def _tiny_step_inputs():
    """Phase 4's tiny bf16 Llama (remat "dots"), numpy-seeded weights and
    one batch."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, remat=True, remat_policy="dots")
    rng = np.random.default_rng(0)
    ref = LlamaForCausalLM(cfg)
    weights = {
        n: torch.from_numpy(np.ones(p.shape, np.float32) if n.endswith("norm.weight")
                            else (rng.standard_normal(p.shape) * 0.02).astype(np.float32))
        for n, p in ref.state_dict().items()
    }
    ids = rng.integers(0, cfg.vocab_size, size=(2, 129)).astype(np.int64)
    return cfg, weights, {"x": ids[:, :-1], "y": ids[:, 1:]}


def tiny_step(cfg, weights, batch, cpu, acc_kw=None):
    """One step of the tiny Llama through a fresh Accelerator (`acc_kw`
    goes to it: phase 15 (c)'s strategies): its metrics and whether DDP
    ran it (over a process group without a plugin, or under NO_SHARD)."""
    from accelerate_tpu_torch import Accelerator, Model, adamw
    from accelerate_tpu_torch.models import LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(weights)
    acc = Accelerator(mixed_precision="bf16", cpu=cpu, **(acc_kw or {}))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(
        lambda m, bt: cross_entropy_loss(m(bt["x"]), bt["y"]), max_grad_norm=1.0)
    _, metrics = step(acc.train_state, batch)
    return {k: float(v) for k, v in metrics.items()}, model.forward_module is not model.module


def tiny_step_parity():
    """One bf16 train step of the tiny Llama on the card and on the CPU."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    cfg, weights, batch = _tiny_step_inputs()
    results = {}
    for cpu in (False, True):
        PartialState._reset_state()
        results["cpu" if cpu else "cuda"], _ = tiny_step(cfg, weights, batch, cpu)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    rel = {k: abs(results["cuda"][k] - results["cpu"][k]) / abs(results["cpu"][k])
           for k in ("loss", "grad_norm")}
    return results, rel


def full_width_steps(hf, device="cuda", width=FULL_WIDTH, batch_size=SLICE["b"],
                     seq=SLICE["s"], remat_policy="dots", timed=5):
    """Phase 5: the 1.06B Llama train step through prepare() with the FSDP
    plugin (FSDP2 over a process group, the plain step alone) for 2 warm-up
    and `timed` timed steps (phase 11 runs it at seq 8192)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Model, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy=remat_policy, attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(),
                      cpu=device == "cpu")
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    n_params = model.num_parameters()
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch_size, seq + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    state = acc.train_state
    warmup = 2

    # The main path: counts from 0 just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    first = []  # the first three steps' metrics, read after the timed window
    for _ in range(warmup):
        state, metrics = step(state, batch)
        first.append(metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timed):
        state, metrics = step(state, batch)
        if i == 0:
            first.append(metrics)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches = dict(hf.LAUNCHES)
    variant_launches = dict(hf.VARIANT_LAUNCHES)
    first = [(float(m["loss"]), float(m["grad_norm"])) for m in first]
    losses = [first[0][0], first[1][0], float(metrics["loss"])]

    tok_s = batch_size * seq / dt
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq
    return {
        "phase": "main_path", "n_params": n_params, "batch": batch_size, "seq": seq,
        "n_layers": cfg.num_hidden_layers, "remat_policy": cfg.remat_policy,
        "sharded": model.sharded, "steps": warmup + timed, "step_ms": dt * 1e3,
        "tok_s": tok_s, "mfu": tok_s * flops_per_token / PEAK_BF16_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses, "first_metrics": first, "grad_norm": float(metrics["grad_norm"]),
        "launches": launches, "variant_launches": variant_launches,
        "launches_per_step": {k: v / (warmup + timed) for k, v in launches.items()},
        "ln_vocab": math.log(cfg.vocab_size),
        "_step": (step, state, batch), "_acc": acc, "_module": module,
    }


def _category(name):
    low = name.lower()
    for kernel in KERNELS:
        if f"{kernel}_kernel" in name or f"{kernel}_f32_kernel" in name:
            return kernel
    if any(x in low for x in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matmul"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach)"
    if low.startswith(("memcpy", "memset")):
        return "copy/memset"
    return "other kernels"


def profile_steps(step, state, batch, step_ms, steps=2, host=True, categorise=None,
                  categories=(), attribution=None):
    """Device time per full-width step by kernel category, over `steps`
    profiled steps, and the share of the unprofiled step time (`step_ms`,
    phase 5) during which no kernel ran. The profiler slows the host, so
    its own wall time is reported but not used for the idle share. With
    ``host=False`` the card's kernels only are traced (no host ops).
    ``categorise`` and ``categories`` go to ``device_times``;
    ``attribution`` (``batch_norm_attribution``) is a context manager around
    the profiled steps that yields ``split(prof, steps, by_cat)``, which
    moves a module's kernels from their categories into one of its own."""
    import torch
    from torch.profiler import profile

    torch.cuda.synchronize()
    with (attribution() if attribution else contextlib.nullcontext()) as split, \
            profile(activities=profiled_activities(host)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, by_cat, top, n_kernels = device_times(prof, steps, categorise=categorise,
                                                   categories=categories)
    if split is not None:
        split(prof, steps, by_cat)
    return {"phase": "profile", "steps": steps, "profiled_wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
            "idle_share": 1.0 - busy_ms / step_ms if top else None,
            "ms_per_step_by_category": by_cat, "top_kernels_ms_per_step": top,
            "host_ops_ms_per_step": host_ops(prof, steps) if host else None,
            "kernels_per_step": n_kernels}


def device_times(prof, steps, n_top=12, categorise=None, categories=()):
    """Kernel time per step from a torch.profiler run of `steps` steps: the
    busy total, the time by category (``categorise`` of the kernel's name,
    ``_category`` by default; each of ``categories`` present even at 0),
    the top kernels by name and the number of kernels per step."""
    from torch.autograd import DeviceType

    categorise = categorise or _category
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_cat, by_name = dict.fromkeys(categories, 0.0), {}
    for e in kernels:
        us, cat = e.device_time_total, categorise(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / steps
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return (sum(by_cat.values()), by_cat, [[name[:90], ms] for name, ms in top],
            len(kernels) / steps)


def host_ops(prof, steps, n_top=8):
    """The torch ops with the most host (self CPU) time per step under the
    profiler, which slows the host: [name, ms per step, calls per step]."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:n_top]
    return [[e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps] for e in rows]


# ---------------------------------------------------------------------------
# Phases 7 and 8: generation and serving
# ---------------------------------------------------------------------------


def decode_bound(width, weight_bytes, ctx=0):
    """Least time (ms) of one decode token at batch 1, and its bytes: the
    block projections at `weight_bytes` per parameter (int8: 1, plus one
    fp32 scale per output channel), the LM head and norms in bf16, and the
    K/V of `ctx` cached positions read and one position written. The
    FLOPs (2 per parameter) take a few microseconds: bytes bound it."""
    h, inter, layers = width["hidden_size"], width["intermediate_size"], \
        width["num_hidden_layers"]
    q_out = h // width["num_attention_heads"] * width["num_attention_heads"]
    kv = h // width["num_attention_heads"] * width["num_key_value_heads"]
    block = layers * (h * q_out + 2 * h * kv + q_out * h + 3 * h * inter)
    nbytes = block * weight_bytes
    if weight_bytes == 1:
        nbytes += layers * (q_out + 2 * kv + h + 2 * inter + h) * 4
    nbytes += width["vocab_size"] * h * 2 + (2 * layers + 1) * h * 2
    nbytes += layers * 2 * (ctx + 1) * kv * 2
    return nbytes / PEAK_HBM_BYTES * 1e3, nbytes


def first_divergence(ref_rows, got_rows, ref_gaps, tie_gap=TIE_GAP):
    """Where two devices' greedy tokens first part, row by row, per the
    near-tie rule: one entry per row, None when the row is equal, else its
    first differing position with the reference's top-2 logit gap at that
    step and whether it is a near-tie (gap <= tie_gap), where either token
    is right. Rows are the new tokens only; after a row parts, its later
    tokens follow other prefixes and are not compared."""
    out = []
    for r, (ref, got) in enumerate(zip(ref_rows, got_rows)):
        split = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b), None)
        if split is None:
            out.append(None)
        else:
            gap = float(ref_gaps[r][split])
            out.append({"pos": split, "gap": gap, "near_tie": gap <= tie_gap})
    return out


def parity_ok(divergences) -> bool:
    """Every row equal, or parted first at a near-tie."""
    return all(d is None or d["near_tie"] for d in divergences)


def generate_gate(res) -> bool:
    """Phase 7 passes when the tiny card/CPU tokens agree under the
    near-tie rule, and at full width every token lies in [0, vocab) and
    every logit is finite, for bf16 and int8 weights."""
    return (all(parity_ok(rows) for rows in res["tiny"].values())
            and all(v["tokens_in_vocab"] and v["logits_finite"]
                    for v in res["full_width"].values()))


def serving_trace(vocab, requests, qps, prompt_len, new_tokens, seed=1, **_):
    """generate_bench.py's Poisson serving trace, drawn in its order from
    default_rng(seed): prompt lengths in [4, prompt_len), budgets half in
    [4, 12) and half in [new_tokens // 2, new_tokens], prompts, and
    arrival times (s) at `qps` requests per second."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, max(9, prompt_len), requests)
    budgets = np.where(rng.random(requests) < 0.5, rng.integers(4, 12, requests),
                       rng.integers(max(2, new_tokens // 2), new_tokens + 1, requests)).astype(int)
    prompts = [rng.integers(1, vocab, (int(n),), dtype=np.int32) for n in lengths]
    arrivals = np.cumsum(rng.exponential(1.0 / qps, requests))
    return lengths, budgets, prompts, arrivals


def serving_gate(rows, prompts, budgets, stats, vocab) -> bool:
    """Phase 8 passes when every request came back as its prompt and its
    whole budget of new tokens in [0, vocab) (greedy, no EOS), and the
    engine counts them all."""
    if len(rows) != len(prompts) or stats["requests_completed"] != len(prompts):
        return False
    if stats["tokens_out"] != sum(int(b) for b in budgets):
        return False
    for row, prompt, budget in zip(rows, prompts, budgets):
        p = len(prompt)
        if len(row) != p + budget or list(row[:p]) != list(prompt):
            return False
        if not all(0 <= int(t) < vocab for t in row[p:]):
            return False
    return True


def _greedy_gaps(cfg, model, rows, prompt_len, mask=None):
    """(B, N) top-2 logit gaps of the greedy steps that produced
    rows[:, prompt_len:], from one teacher-forced cached forward."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import generation as gen

    b, t = rows.shape
    kwargs = {}
    if mask is not None:
        valid = np.concatenate([mask.astype(bool), np.ones((b, t - prompt_len), bool)], 1)
        kwargs = {"pad_offset": torch.from_numpy(np.argmax(mask, 1)).to(rows.device),
                  "kv_valid": torch.from_numpy(valid).to(rows.device)}
    logits, _ = plan_of(model)(cfg, model, rows, gen.init_cache(
        cfg, b, t, device=rows.device), return_all=True, **kwargs)
    top2 = torch.topk(logits[:, prompt_len - 1:t - 1], 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def profiled_activities(host=True):
    """torch.profiler's activities: the card's kernels, and the host's ops
    with ``host`` (or where there is no card: a rehearsal on the CPU)."""
    import torch
    from torch.profiler import ProfilerActivity

    if host or not torch.cuda.is_available():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CUDA]


def plan_of(model):
    """The cached forward of ``model``'s class (a module, a ``Model`` or a
    decode-quantized model): the Llama chassis's, or another family's."""
    from accelerate_tpu_torch import generation as gen

    return gen._generation_plan(getattr(model, "module", model))


def _tiny_module(device, seed=0):
    """The tiny fp32 Llama with numpy-seeded weights (std 1/sqrt(fan-in),
    so greedy steps are rarely near-ties)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    rng = np.random.default_rng(seed)
    module.load_state_dict({
        n: torch.from_numpy(np.ones(p.shape, np.float32) if p.dim() == 1 else (
            rng.standard_normal(p.shape) / (1.0 if "embed" in n else math.sqrt(p.shape[1])))
            .astype(np.float32))
        for n, p in module.state_dict().items()})
    return cfg, module.to(device)


def tiny_generate_parity(device="cuda"):
    """Greedy generate() of the tiny fp32 Llama on the card and on the CPU
    from the same weights: a plain batch, and a left-padded batch with EOS.
    TF32 stays off, so the card computes in fp32."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import generate

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the fp32 comparison needs them off")
    cfg, cpu_model = _tiny_module("cpu")
    _, card_model = _tiny_module(device)
    rng = np.random.default_rng(1)
    s, n = 16, 24
    ids = rng.integers(1, cfg.vocab_size, (2, s))
    mask = np.ones((2, s), np.int64)
    mask[1, :5] = 0
    padded = ids * mask
    eos = int(generate(cpu_model, ids, max_new_tokens=3)[0, -1])
    cases = {"plain": (ids, {}),
             "left_padded_eos": (padded, dict(attention_mask=mask, eos_token_id=eos,
                                              pad_token_id=0))}
    out = {}
    for name, (x, kw) in cases.items():
        ref = generate(cpu_model, x, max_new_tokens=n, **kw)
        got = generate(card_model, x, max_new_tokens=n, **kw).cpu()
        gaps = _greedy_gaps(cfg, cpu_model, ref, s, kw.get("attention_mask"))
        out[name] = first_divergence(ref[:, s:].tolist(), got[:, s:].tolist(), gaps)
    return out


def _decode_steps(cfg, params, prompt, n, profiled=False, fwd=None, host=True):
    """Prefill, then `n` greedy decode steps as generate() runs them (with
    the plan `fwd`, by default the Llama chassis's): returns (decode
    seconds, all logits finite, and with `profiled` the torch.profiler run
    of the decode steps alone, else None; ``host=False`` traces the card's
    kernels only, which parses several times faster)."""
    import contextlib

    import torch
    from torch.profiler import profile

    from accelerate_tpu_torch import generation as gen

    fwd = fwd or gen._llama_forward_cached
    cache = gen.init_cache(cfg, prompt.shape[0], prompt.shape[1] + n + 1, device=prompt.device)
    logits, cache = fwd(cfg, params, prompt, cache)
    finite = [torch.isfinite(logits).all()]
    tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    with (profile(activities=profiled_activities(host)) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            logits, cache = fwd(cfg, params, tok[:, None], cache)
            finite.append(torch.isfinite(logits).all())
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return dt, bool(torch.stack(finite).all()), prof


def full_width_generate(device="cuda"):
    """bench.py's decode row on the port's 1.06B Llama (``decode_row``).
    Returns the phase's numbers and the bf16 module."""
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**FULL_WIDTH, max_position_embeddings=2048, dtype=torch.bfloat16)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    module.to(torch.bfloat16)
    return decode_row(cfg, module, FULL_WIDTH, device), module


def decode_variant(cfg, model, prompt, device="cuda", profiled=PROFILED_DECODE_STEPS,
                   host=True):
    """bench.py's decode row for one model (bf16 or int8 weights): one
    warm-up and one timed generate() of 32 new tokens after `prompt`, then
    prefill and decode-step times and a profile of `profiled` decode steps
    (the prefill outside it; with ``host=False`` the card's kernels only,
    and no host ops). Returns (the new tokens, the numbers)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.generation import _decode_params, init_cache

    fwd = plan_of(model)
    generate(model, prompt, max_new_tokens=GEN_NEW_TOKENS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=GEN_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = out[0, GEN_PROMPT:].cpu().numpy()
    params = _decode_params(model)
    prefill = []
    for _ in range(3):
        cache = init_cache(cfg, 1, GEN_PROMPT + GEN_NEW_TOKENS, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(cfg, params, prompt, cache)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    steps = GEN_NEW_TOKENS - 1
    decode_s, finite, _ = _decode_steps(cfg, params, prompt, steps, fwd=fwd)
    _, finite_p, prof = _decode_steps(cfg, params, prompt, profiled, profiled=True, fwd=fwd,
                                      host=host)
    busy_ms, by_cat, top, n_kernels = device_times(prof, profiled, n_top=8)
    decode_ms = decode_s * 1e3 / steps
    return row, {
        "decode_tok_s": GEN_NEW_TOKENS / wall, "generate_ms": wall * 1e3,
        "prefill_ms": float(np.median(prefill)), "decode_ms_per_token": decode_ms,
        "device_busy_ms_per_token": busy_ms,
        "idle_share": 1.0 - busy_ms / decode_ms if top else None,
        "kernels_per_token": n_kernels, "ms_per_token_by_category": by_cat,
        "top_kernels_ms_per_token": top,
        "host_ops_ms_per_token": host_ops(prof, profiled) if host else None,
        "tokens_in_vocab": bool(((row >= 0) & (row < cfg.vocab_size)).all()),
        "logits_finite": finite and finite_p,
    }


def decode_prompt(cfg, device="cuda"):
    """bench.py's decode prompt: (1, 64) ids from default_rng(0)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, GEN_PROMPT))).to(device)


def decode_row(cfg, module, width, device="cuda"):
    """bench.py's decode row: bf16 and int8-weight generate() of `module`
    (bf16 weights), prompt (1, 64), 32 new tokens (``decode_variant``),
    beside the per-token bound of `width`."""
    import torch

    from accelerate_tpu_torch import Model, quantize_model_for_decode

    prompt = decode_prompt(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    models = {"bf16": Model(module)}
    models["int8"] = quantize_model_for_decode(models["bf16"])
    rows, res = {}, {}
    for name, model in models.items():
        rows[name], res[name] = decode_variant(cfg, model, prompt, device)
        bound_ms, bound_bytes = decode_bound(width, 2 if name == "bf16" else 1,
                                             ctx=GEN_PROMPT + GEN_NEW_TOKENS // 2)
        res[name].update(bound_ms_per_token=bound_ms, bound_bytes_per_token=bound_bytes,
                         bound_share=bound_ms / res[name]["decode_ms_per_token"])
    del models
    return {
        "decode_tok_s_bf16": res["bf16"]["decode_tok_s"],
        "decode_tok_s_int8": res["int8"]["decode_tok_s"],
        "int8_decode_speedup": res["int8"]["decode_tok_s"] / res["bf16"]["decode_tok_s"],
        "int8_tokens_equal_bf16": float((rows["int8"] == rows["bf16"]).mean()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "variants": res, "rows": {k: v.tolist() for k, v in rows.items()},
    }


def tiny_serving_parity(device="cuda"):
    """ServingEngine.run of the tiny fp32 Llama on the card (3 slots, mixed
    prompt lengths, chunked prefill) against generate() of each prompt
    alone, under the near-tie rule."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import ServingConfig, ServingEngine, generate

    cfg, model = _tiny_module(device)
    rng = np.random.default_rng(2)
    lengths, budgets = [3, 7, 12, 20, 5, 9], [6, 4, 8, 3, 5, 7]
    prompts = [rng.integers(1, cfg.vocab_size, (n,)) for n in lengths]
    engine = ServingEngine(model, ServingConfig(n_slots=3, max_len=64, prefill_chunks=[4, 8]))
    outs = engine.run(prompts, max_new_tokens=budgets)
    divergences = []
    for prompt, budget, got in zip(prompts, budgets, outs):
        ref = generate(model, prompt[None], max_new_tokens=budget)
        gaps = _greedy_gaps(cfg, model, ref, len(prompt))
        divergences += first_divergence([ref[0, len(prompt):].tolist()],
                                        [got[len(prompt):].tolist()], gaps)
    torch.cuda.synchronize()
    return divergences


def full_width_serving(module, row=SERVING_ROW, keep_rows=False):
    """The engine at full width on generate_bench.py's serving row: its
    Poisson trace replayed open loop after one warm-up request, with the
    row's ServingConfig (8 slots, max_len from the trace, chunks up to the
    prompt length). Phases 17-19 cut the trace to fewer requests (`row`);
    any family with a generation plan serves. With `keep_rows` the result
    also holds the rows, prompts and budgets (``_rows``, ``_prompts``,
    ``_budgets``: not JSON; phase 19 pops them)."""
    import torch

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine
    from accelerate_tpu_torch.serving import replay_trace

    vocab = module.config.vocab_size
    lengths, budgets, prompts, arrivals = serving_trace(vocab, **row)
    t_cap = int(max(lengths + budgets)) + 8
    engine = ServingEngine(Model(module), ServingConfig(
        n_slots=row["slots"], max_len=t_cap, max_prefill_chunk=max(16, row["prompt_len"])))
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, wall = replay_trace(engine, prompts, arrivals=list(arrivals),
                              max_new_tokens=[int(b) for b in budgets])
    stats = engine.stats()
    ticks = decode_tick_profile(engine, vocab)
    return {
        "trace": {**row, "seed": 1, "arrivals_span_s": float(arrivals[-1]),
                  "prompt_tokens_total": int(lengths.sum()),
                  "budget_tokens_total": int(budgets.sum())},
        "max_len": t_cap, "ladder": engine.ladder, "wall_s": wall,
        "tok_s": stats["tokens_out"] / wall, "stats": stats,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kv_cache_gib": (engine._cache.k.nbytes + engine._cache.v.nbytes) / 2**30,
        "kv_cache_bytes": engine._cache.k.nbytes + engine._cache.v.nbytes,
        "decode_ticks": ticks,
        "ok": serving_gate(rows, prompts, budgets.tolist(), stats, vocab),
        **({"_rows": rows, "_prompts": prompts, "_budgets": budgets} if keep_rows else {}),
    }


def decode_tick_profile(engine, vocab, n=10, profiled=4):
    """Steady decode ticks with every slot live (prompts of up to 64
    tokens, no prefill left): host-clock ms per tick over `n` ticks, then
    `profiled` more under torch.profiler for the device-busy ms and the
    idle share (its parsing takes far longer than the ticks)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    budget = 3 * n + 4
    for _ in range(engine.n_slots):
        engine.submit(rng.integers(0, vocab, size=min(64, engine.t_max - budget)),
                      max_new_tokens=budget)
    while engine._queue or engine._prefilling:
        engine.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        engine.tick()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            engine.tick()
    live = len(engine._decoding)
    while engine.pending:
        engine.tick()
    engine.poll()
    busy_ms, by_cat, top, n_kernels = device_times(prof, profiled, n_top=6)
    return {"live_slots": live, "tick_ms": tick_ms, "device_busy_ms_per_tick": busy_ms,
            "idle_share": 1.0 - busy_ms / tick_ms if top else None,
            "kernels_per_tick": n_kernels, "ms_per_tick_by_category": by_cat,
            "top_kernels_ms_per_tick": top}


# ---------------------------------------------------------------------------
# Phase 9: the training loop
# ---------------------------------------------------------------------------


class RandomSampler:
    """Only its name counts: prepare() shuffles such a loader with the
    seedable sampler."""


class LoopSpec:
    """What a user passes to prepare() as a loader: a dataset, a batch size,
    a shuffling sampler, drop_last."""

    def __init__(self, dataset, batch_size):
        self.dataset, self.batch_size = dataset, batch_size
        self.sampler, self.drop_last = RandomSampler(), True


def llama_n_params(width) -> int:
    """Parameters of the untied Llama of these widths."""
    h, inter, layers = width["hidden_size"], width["intermediate_size"], \
        width["num_hidden_layers"]
    d = h // width["num_attention_heads"]
    q, kv = width["num_attention_heads"] * d, width["num_key_value_heads"] * d
    block = h * q + 2 * h * kv + q * h + 3 * h * inter + 2 * h
    return 2 * width["vocab_size"] * h + layers * block + h


def cut_loop_width(width) -> dict:
    """``width`` at ``CUT_LOOP_LAYERS`` layers (fewer where it has fewer)."""
    return dict(width, num_hidden_layers=min(CUT_LOOP_LAYERS, width["num_hidden_layers"]))


def checkpoint_root(need_bytes, fallback=CKPT_FALLBACK):
    """A fresh directory with room for `need_bytes` (and a quarter more):
    under the temporary directory, else under `fallback`. Returns it and
    what was found."""
    tried = {}
    for base in (None, fallback):
        if base is not None:
            Path(base).mkdir(parents=True, exist_ok=True)
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
        free = shutil.disk_usage(root).free
        tried[root] = free
        if free >= 1.25 * need_bytes:
            return root, {"dir": root, "free_bytes": free, "need_bytes": need_bytes,
                          "tried_free_bytes": tried}
        os.rmdir(root)
    raise RuntimeError(f"no directory with {need_bytes} bytes free for the checkpoint: {tried}")


def build_loop(device, width, seq, project_dir, init_seed, tokens, keep_group=False,
               acc_kw=None, state_dict_type="SHARDED_STATE_DICT"):
    """Phase 5's model and step as a user's loop builds them: Accelerator
    with a project directory, prepare(model, adamw(schedule), loader,
    schedule), prepare_train_step. A fresh Accelerator each time; with
    `keep_group`, over the process group this process belongs to; `acc_kw`
    goes to the Accelerator (phase 13's trackers and handlers);
    `state_dict_type` is the checkpoint's format (phase 15:
    DISTRIBUTED_STATE_DICT)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator, ColumnDataset, FullyShardedDataParallelPlugin, Model, ProjectConfiguration,
        adamw, warmup_cosine_decay_schedule)
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState) + (() if keep_group else (PartialState,)):
        cls._reset_state()
    acc = Accelerator(
        mixed_precision="bf16", cpu=device == "cpu",
        fsdp_plugin=FullyShardedDataParallelPlugin(state_dict_type=state_dict_type),
        project_config=ProjectConfiguration(project_dir=project_dir,
                                            automatic_checkpoint_naming=True, total_limit=1),
        **(acc_kw or {}))
    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash")
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(init_seed))
    schedule = warmup_cosine_decay_schedule(**LOOP["schedule"])
    dataset = ColumnDataset(ids=tokens, idx=np.arange(len(tokens)))
    _, _, loader, sched = acc.prepare(
        Model(module), adamw(schedule, weight_decay=LOOP["weight_decay"]),
        LoopSpec(dataset, LOOP["batch"]), schedule)

    def loss_fn(model, batch):
        ids = batch["ids"].long()
        return cross_entropy_loss(model(ids[:, :-1]), ids[:, 1:])

    return acc, acc.prepare_train_step(loss_fn, max_grad_norm=1.0), loader, sched, schedule


def loop_steps(acc, step, it, sched, n):
    """`n` steps from a loader's iterator, as a user's loop takes them.
    Returns the steps' (sample indices, loss, grad norm, lr) as device
    values where they are on the device, and the host seconds spent
    waiting for the loader."""
    rows, wait = [], 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - t0
        _, metrics = step(acc.train_state, batch)
        sched.step()
        rows.append((batch["idx"], metrics["loss"], metrics["grad_norm"],
                     acc.train_state.optimizer.param_groups[0]["lr"]))
    return rows, wait


def loop_records(rows) -> dict:
    """Host values of loop_steps' rows (reading them waits for the card)."""
    return {"indices": [r[0].tolist() for r in rows], "loss": [float(r[1]) for r in rows],
            "grad_norm": [float(r[2]) for r in rows], "lr": [float(r[3]) for r in rows]}


def loop_gate(first, resumed, lrs, step_after_load, step_after, launches, n_layers,
              native_ok) -> dict:
    """Phase 9's checks. `first` holds the uninterrupted run's steps after
    the save and `resumed` the resumed run's (loop_records); `lrs` the
    schedule's rates for those steps; `launches` each run's kernel counts
    over its `steps` steps as (counts, steps)."""
    after = LOOP["steps"] - LOOP["save_after"]
    checks = {
        "same_indices": first["indices"] == resumed["indices"],
        "lr_follows_schedule": all(
            math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-15)
            for run in (first, resumed) for a, b in zip(run["lr"], lrs)),
        "bit_equal_loss": first["loss"] == resumed["loss"],
        "bit_equal_grad_norm": first["grad_norm"] == resumed["grad_norm"],
        "finite": all(math.isfinite(x) for run in (first, resumed)
                      for x in run["loss"] + run["grad_norm"]),
        "step_after_load": step_after_load == LOOP["save_after"],
        "step_after": step_after == LOOP["steps"],
        "launches": all(n == n_layers * steps for counts, steps in launches
                        for n in counts.values()),
        "native": native_ok,
    }
    checks["ok"] = all(checks.values()) and len(first["loss"]) == after
    return checks


def mem_available_bytes():
    """The host's MemAvailable (``/proc/meminfo``), or None where there is
    no such file."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def loop_phase(hf, fixed_step_ms, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
               profile_steps=LOOP["profile_steps"], keep_group=False,
               state_dict_type="SHARDED_STATE_DICT", async_save=False):
    """Phase 9 (see the module docstring), and phase 15's loops: with
    `state_dict_type="DISTRIBUTED_STATE_DICT"` the checkpoint is
    torch.distributed.checkpoint's (the native library writes nothing
    then), and with `async_save` it is saved with ``block=False``: steps 5
    and 6 run while it persists, then ``wait_for_checkpoint``. Returns its
    report with the checks of loop_gate."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import native

    save_after, steps = LOOP["save_after"], LOOP["steps"]
    tokens = np.random.default_rng(LOOP["data_seed"]).integers(
        0, width["vocab_size"], (LOOP["rows"], seq + 1), dtype=np.int32)
    n_params = llama_n_params(width)
    root, disk = checkpoint_root(n_params * 4 * 3)
    gib = 2**30
    dcp = state_dict_type == "DISTRIBUTED_STATE_DICT"

    def timed(fn):
        """fn()'s result and its ms on the host clock, between synchronisations."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def peak_since_last(key):
        """Peak allocation since the last call, then a fresh window."""
        mem[key] = torch.cuda.max_memory_allocated() / gib
        torch.cuda.reset_peak_memory_stats()

    mem, ms = {"allocated_at_start": torch.cuda.memory_allocated() / gib}, {}
    try:
        native.reset_paths()
        torch.cuda.reset_peak_memory_stats()
        acc, step, loader, sched, schedule = build_loop(
            device, width, seq, root, LOOP["init_seeds"][0], tokens, keep_group,
            state_dict_type=state_dict_type)
        it = iter(loader)
        hf.reset_launch_counts()
        head, _ = loop_steps(acc, step, it, sched, 1)
        (more, _), t = timed(lambda: loop_steps(acc, step, it, sched, save_after - 1))
        head += more
        ms["before_save"] = t / (save_after - 1)
        peak_since_last("steps_before_save")
        if async_save:
            # The host must hold the staged copy: the state's fp32 params
            # and moments (a quarter more for the rest of the process).
            avail = mem_available_bytes()
            if avail is not None and avail < 1.25 * n_params * 4 * 3:
                raise RuntimeError(f"the host has {avail} bytes available, too few to stage "
                                   f"the {n_params * 4 * 3}-byte checkpoint")
            _, stall_ms = timed(lambda: acc.save_state(block=False))
            save = dict(acc.checkpoint_stats)
            peak_since_last("save")
            in_flight = 2
            (tail, wait), t = timed(lambda: loop_steps(acc, step, it, sched, in_flight))
            ms["in_flight"] = t / in_flight
            t0 = time.perf_counter()
            acc.wait_for_checkpoint()
            wait_s = time.perf_counter() - t0
            save.update(acc.checkpoint_stats)
            save["async"] = {"stall_s": stall_ms / 1e3, "wait_s": wait_s,
                             "mem_available_before_save": avail,
                             "staged_bytes": save.get("staged_bytes")}
            (more, wait2), t = timed(lambda: loop_steps(
                acc, step, it, sched, steps - save_after - in_flight))
            ms["after_wait"] = t / (steps - save_after - in_flight)
            ms["after_save"] = (ms["in_flight"] * in_flight + t) / (steps - save_after)
            tail, wait = tail + more, wait + wait2
            # A second background save of the same tensors reuses the
            # pinned copies of the first: its stall is the copy alone.
            second = os.path.join(root, "second_save")
            _, stall2_ms = timed(lambda: acc.save_state(second, block=False))
            stage2_s = acc.checkpoint_stats.get("stage_s")
            acc.wait_for_checkpoint()
            shutil.rmtree(second, ignore_errors=True)
            save["async"].update({"second_stall_s": stall2_ms / 1e3, "second_stage_s": stage2_s,
                                  "second_persist_s": acc.checkpoint_stats.get("persist_s")})
        else:
            acc.save_state()
            save = dict(acc.checkpoint_stats)
            peak_since_last("save")
            (tail, wait), t = timed(lambda: loop_steps(acc, step, it, sched, steps - save_after))
            ms["after_save"] = t / (steps - save_after)
        launches = [(dict(hf.LAUNCHES), steps)]
        variant_launches = dict(hf.VARIANT_LAUNCHES)
        step_count = acc.train_state.step
        busy_ms = None
        if profile_steps:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                loop_steps(acc, step, it, sched, profile_steps)
                torch.cuda.synchronize()
            busy_ms = device_times(prof, profile_steps)[0]
        first = loop_records(head + tail)
        peak_since_last("steps_after_save")
        it.close()
        if async_save:
            acc.end_training()  # frees the pinned copies the background save kept
        del acc, step, loader, sched, it, head, tail
        gc.collect()
        torch.cuda.empty_cache()

        acc, step, loader, sched, _ = build_loop(
            device, width, seq, root, LOOP["init_seeds"][1], tokens, keep_group,
            state_dict_type=state_dict_type)
        torch.cuda.reset_peak_memory_stats()
        acc.load_state()
        load = dict(acc.checkpoint_stats)
        peak_since_last("load")
        step_after_load = acc.train_state.step
        hf.reset_launch_counts()
        it = iter(loader)
        (rows, _), t = timed(lambda: loop_steps(acc, step, it, sched, steps - save_after))
        ms["resumed"] = t / (steps - save_after)
        launches.append((dict(hf.LAUNCHES), steps - save_after))
        resumed = loop_records(rows)
        step_after = acc.train_state.step
        peak_since_last("resumed_steps")
        it.close()
        del acc, step, loader, sched, it, rows
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    paths = {k: dict(v) for k, v in native.PATHS.items()}
    lib = native.get_lib()
    # DCP writes and reads its own files: the native library is phase 9's.
    native_ok = dcp or (lib is not None
                        and paths.get("pwrite_segments", {}).get("native", 0) > 0
                        and paths.get("pread_segments", {}).get("native", 0) > 0)
    after = {k: v[save_after:] for k, v in first.items()}
    checks = loop_gate(after, resumed, [schedule(k) for k in range(save_after, steps)],
                       step_after_load, step_after, launches, width["num_hidden_layers"],
                       native_ok)
    return {
        "phase": "loop", "state_dict_type": state_dict_type, "async_save": async_save,
        "n_params": n_params, "rows": LOOP["rows"], "batch": LOOP["batch"],
        "seq": seq, "steps": steps, "save_after": save_after, "step_count": step_count,
        "first_losses": first["loss"], "after_save": after, "resumed": resumed,
        "save": {**save, "gb_per_s": save["bytes"] / save["seconds"] / 1e9},
        "load": {**load, "gb_per_s": save["bytes"] / load["seconds"] / 1e9},
        "checkpoint_disk": disk,
        "loader_wait_ms_per_step": wait * 1e3 / (steps - save_after),
        "step_ms": ms["after_save"], "step_ms_by_window": ms,
        "phase5_fixed_batch_step_ms": fixed_step_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / ms["after_save"] if busy_ms else None,
        "peak_mem_gib": max(v for k, v in mem.items() if k != "allocated_at_start"),
        "mem_gib": mem, "launches": [c for c, _ in launches],
        "variant_launches": variant_launches,
        "native": {"library": str(native.lib_path()) if lib is not None else None,
                   "build_error": native.BUILD_ERROR, "paths": paths},
        "checks": checks, "ok": checks["ok"],
    }


# ---------------------------------------------------------------------------
# Phase 10: data parallelism over a process group, in a child process
# ---------------------------------------------------------------------------

# Phase 10's gates against phases 4 and 5 of the parent: at world size 1
# FSDP2 and DDP run the same arithmetic, but FSDP2's global grad norm is
# reduced over its mesh as a DTensor (a square root of a sum of squares),
# which may round the clip factor differently in its last bit.
DP_REL_TOL = 1e-4


def torchrun_env(port: int) -> dict:
    """torchrun's variables for one process of a group of one."""
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_child(args: dict, timeout: float):
    """``chip_smoke.py --child '<args>'`` with torchrun's environment, so
    that it joins a process group of its own and the singletons of this
    process stay untouched. Returns its exit code, its JSON lines and the
    end of its standard error."""
    env = {**os.environ, **torchrun_env(free_port())}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                           json.dumps(args)], env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=Path(__file__).resolve().parent)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return proc.returncode, lines, proc.stderr[-4000:]


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a)


def data_parallel_phase(hf, args, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
                        batch_size=SLICE["b"], profile=True):
    """Phase 10, run by the child. Over the group of one that torchrun's
    environment makes (NCCL on the card): phase 5's model, batch and steps
    through prepare() with the FSDP plugin, which shards it with FSDP2; the
    collectives' round trip; phase 9's loop, saved and resumed in a fresh
    Accelerator; and phase 4's tiny step under DDP (no plugin). `args`
    holds the parent's phase 4 and 5 numbers to hold these to."""
    import torch

    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
    from accelerate_tpu_torch.utils import operations

    partial = PartialState(cpu=device == "cpu")
    group = {"backend": partial.backend, "world": partial.num_processes,
             "distributed_type": partial.distributed_type.value}
    main = full_width_steps(hf, device=device, width=width, batch_size=batch_size, seq=seq)
    step, state, batch = main.pop("_step")
    acc = main.pop("_acc")
    main.pop("_module")
    prof = profile_steps(step, state, batch, main["step_ms"], steps=1) if profile else None

    x = torch.arange(24.0, device=acc.device).reshape(4, 6)
    obj = [{"a": 1}, "b"]
    trips = {
        "gather": torch.equal(acc.gather(x), x),
        "reduce_sum": torch.equal(acc.reduce(x), x),
        "reduce_mean": torch.equal(acc.reduce(x, reduction="mean"), x),
        "broadcast": torch.equal(operations.broadcast(x.clone()), x),
        "pad_across_processes": torch.equal(acc.pad_across_processes(x, dim=1), x),
        "gather_object": operations.gather_object(obj) == obj,
        "broadcast_object_list": operations.broadcast_object_list(list(obj)) == obj,
    }
    del step, state, batch, acc
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()

    # The loop's steps are not profiled here: their device time is the FSDP2
    # step's, profiled above.
    loop = loop_phase(hf, main["step_ms"], device=device,
                      width=cut_loop_width(width),
                      seq=seq, profile_steps=0, keep_group=True)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 12 (c): the imperative loop under FSDP2, held to the parent's
    # fused step in phase 12.
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    imperative = accumulation_run(hf, loop=True, device=device, width=width, seq=seq,
                                  batch_size=batch_size, profile=profile)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, weights, tiny_batch = _tiny_step_inputs()
    ddp_metrics, ddp_wrapped = tiny_step(cfg, weights, tiny_batch, cpu=device == "cpu")
    # Ring and Ulysses over the 6-D mesh of one process (pp = cp = sp = tp = 1).
    seq_metrics = {impl: tiny_step(dataclasses.replace(cfg, attention_impl=impl), weights,
                                   tiny_batch, cpu=device == "cpu")[0]
                   for impl in ("ring", "ulysses")}
    mesh = AcceleratorState().device_mesh
    mesh_axes = [list(mesh.mesh_dim_names), list(mesh.shape)]
    # Phase 14 (a) under FSDP2: an fp16 step, an overflowed one and the next.
    gc.collect()
    torch.cuda.empty_cache()
    fp16 = fp16_steps(hf, device=device, width=width, seq=seq, batch_size=batch_size, warmup=0,
                      timed=1, profile=False)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 15 (c), at phase 4's tiny width (the whole run stays under
    # 600 s): phase 15 (a)'s DCP loop under FSDP2, then phase 4's step under
    # every other sharding strategy and a DeepSpeed stage.
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    dcp_loop = loop_phase(hf, main["step_ms"], device=device, width=TINY_WIDTH,
                          seq=TINY_SEQ, profile_steps=0, keep_group=True,
                          state_dict_type="DISTRIBUTED_STATE_DICT")
    gc.collect()
    torch.cuda.empty_cache()
    strategies = strategy_steps(hf, args["tiny_step"], cpu=device == "cpu")

    phase5 = args["phase5"]
    rel = [[_rel(a, b) for a, b in zip(got, ref)]
           for got, ref in zip(main["first_metrics"], phase5["first_metrics"])]
    ddp_rel = {k: _rel(ddp_metrics[k], args["tiny_step"][k]) for k in ("loss", "grad_norm")}
    checks = {
        "group_of_one": group["world"] == 1 and group["backend"] == (
            "gloo" if device == "cpu" else "nccl"),
        "fsdp2_sharded": main["sharded"],
        "losses_match_phase5": len(rel) == 3 and max(max(r) for r in rel) <= DP_REL_TOL,
        "launches": all(n == main["n_layers"] for n in main["launches_per_step"].values()),
        "collectives_round_trip": all(trips.values()),
        "loop_resumes_bit_equal": loop["ok"],
        "ddp_wrapped": ddp_wrapped,
        "ddp_matches_phase4": max(ddp_rel.values()) <= DP_REL_TOL,
        "mesh_6d": mesh_axes == [["pp", "dp_replicate", "dp_shard", "cp", "sp", "tp"],
                                 [1, 1, 1, 1, 1, 1]],
        "ring_ulysses_bit_equal_to_phase4": all(m == args["tiny_step"]
                                                for m in seq_metrics.values()),
        "fp16_overflow_skipped": fp16["sharded"] and all(fp16["overflow"][k] for k in (
            "params_bit_equal", "moments_bit_equal", "scale_backed_off", "step_held",
            "next_applied")),
        "dcp_loop_resumes_bit_equal": dcp_loop["ok"],
        "strategies_match_phase4": sorted(strategies) == sorted(STRATEGY_RUNS) and all(
            r["ok"] for r in strategies.values()),
    }
    checks["ok"] = all(checks.values())
    return {
        "phase": "data_parallel", "group": group,
        "fsdp2": {**{k: v for k, v in main.items() if k != "phase"},
                  "rel_to_phase5": rel,
                  "bit_equal_to_phase5": [list(m) for m in main["first_metrics"]]
                  == [list(m) for m in phase5["first_metrics"]],
                  "phase5_step_ms": phase5["step_ms"],
                  "phase5_peak_mem_gib": phase5["peak_mem_gib"],
                  "device_busy_ms_per_step": prof and prof["device_busy_ms_per_step"],
                  "idle_share": prof and prof["idle_share"]},
        "collectives": trips, "loop": loop,
        "ddp_tiny": {"metrics": ddp_metrics, "phase4": args["tiny_step"], "rel": ddp_rel,
                     "bit_equal": ddp_metrics == args["tiny_step"]},
        "mesh": mesh_axes, "seq_tiny": seq_metrics, "imperative": imperative, "fp16": fp16,
        "phase15": {"dcp_loop": dcp_loop, "strategies": strategies},
        "checks": checks, "ok": checks["ok"],
    }


# Phase 15 (c): the strategies phase 4's step runs under in phase 10's child
# besides FULL_SHARD, and the DeepSpeed stage; phase 4's tiny Llama as
# widths (LlamaConfig.tiny) and its sequence length.
STRATEGY_RUNS = ("SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD", "zero2")
TINY_WIDTH = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2)
TINY_SEQ = 128


def strategy_steps(hf, phase4, cpu=False):
    """Phase 4's tiny step under each of STRATEGY_RUNS (a
    ``sharding_strategy``, or ``DeepSpeedPlugin(zero_stage=2)``), over the
    group of one: loss and grad norm within DP_REL_TOL of phase 4's (and
    whether bit-equal), each kernel launched once per layer, and DDP
    exactly under NO_SHARD."""
    from accelerate_tpu_torch import DeepSpeedPlugin, FullyShardedDataParallelPlugin

    cfg, weights, batch = _tiny_step_inputs()
    out = {}
    for name in STRATEGY_RUNS:
        plugin = (DeepSpeedPlugin(zero_stage=2) if name == "zero2" else
                  FullyShardedDataParallelPlugin(sharding_strategy=name))
        acc_kw = ({"deepspeed_plugin": plugin} if name == "zero2" else {"fsdp_plugin": plugin})
        strategy = (plugin.to_fsdp_plugin() if name == "zero2" else plugin).sharding_strategy
        hf.reset_launch_counts()
        metrics, ddp = tiny_step(cfg, weights, batch, cpu, acc_kw)
        launches = dict(hf.LAUNCHES)
        rel = {k: _rel(metrics[k], phase4[k]) for k in ("loss", "grad_norm")}
        out[name] = {
            "sharding_strategy": strategy, "ddp": ddp, "metrics": metrics, "rel_to_phase4": rel,
            "bit_equal_to_phase4": metrics == phase4, "launches": launches,
            "ok": max(rel.values()) <= DP_REL_TOL and ddp == (strategy == "NO_SHARD")
            and all(n == cfg.num_hidden_layers for n in launches.values()),
        }
    return out


# ---------------------------------------------------------------------------
# Phase 15: DISTRIBUTED_STATE_DICT checkpoints, blocking and in the
# background, and (from phase 10's child) the sharding strategies
# ---------------------------------------------------------------------------


def _io(stats, seconds_key="seconds"):
    """Seconds, bytes and GB/s of a save's or load's stats."""
    seconds, nbytes = stats.get(seconds_key), stats.get("bytes")
    return {"seconds": seconds, "bytes": nbytes,
            "gb_per_s": nbytes / seconds / 1e9 if seconds and nbytes else None}


def distributed_checkpoint_phase(hf, phase9, dp_child, device="cuda", width=FULL_WIDTH,
                                 seq=SLICE["s"]):
    """Phase 15 (see the module docstring). `phase9` is phase 9's report
    (its safetensors save and load go beside DCP's), `dp_child` phase 10's
    child report (its ``phase15``: (c))."""
    import torch

    width = cut_loop_width(width)
    blocking = loop_phase(hf, phase9["phase5_fixed_batch_step_ms"], device=device, width=width,
                          seq=seq, profile_steps=0, state_dict_type="DISTRIBUTED_STATE_DICT")
    gc.collect()
    torch.cuda.empty_cache()
    background = loop_phase(hf, phase9["phase5_fixed_batch_step_ms"], device=device,
                            width=width, seq=seq, profile_steps=0,
                            state_dict_type="DISTRIBUTED_STATE_DICT", async_save=True)
    gc.collect()
    torch.cuda.empty_cache()
    child = dp_child.get("phase15") or {}
    strategies = child.get("strategies") or {}
    asynchronous = background["save"]["async"]
    windows = background["step_ms_by_window"]
    checks = {
        "dcp_resumes_bit_equal": blocking["ok"],
        "async_resumes_bit_equal": background["ok"],
        "async_returned_before_persisting": bool(background["save"].get("persisting_at_return")),
        "fsdp2_dcp_resumes_bit_equal": bool(child.get("dcp_loop", {}).get("ok")),
        "strategies_within_dp_rel_tol": sorted(strategies) == sorted(STRATEGY_RUNS)
        and all(r["ok"] for r in strategies.values()),
    }
    checks["ok"] = all(checks.values())
    return {
        "phase": "distributed_checkpoint",
        "save": {"safetensors_phase9": _io(phase9["save"]), "dcp": _io(blocking["save"]),
                 "dcp_async_persist": _io(background["save"], "persist_s")},
        "load": {"safetensors_phase9": _io(phase9["load"]), "dcp": _io(blocking["load"]),
                 "dcp_after_async": _io({**background["load"],
                                         "bytes": background["save"]["bytes"]})},
        "async": {"stall_s": asynchronous["stall_s"],
                  "second_save_stall_s": asynchronous.get("second_stall_s"),
                  "second_save_stage_s": asynchronous.get("second_stage_s"),
                  "blocking_dcp_save_s": blocking["save"]["seconds"],
                  "blocking_safetensors_save_s": phase9["save"]["seconds"],
                  "stage_s": background["save"].get("stage_s"),
                  "wait_for_checkpoint_s": asynchronous["wait_s"],
                  "persist_s": background["save"]["persist_s"],
                  "steps_5_6_ms_in_flight": windows["in_flight"],
                  "steps_7_8_ms_after_wait": windows["after_wait"],
                  "steps_5_8_ms_blocking_run": blocking["step_ms_by_window"]["after_save"],
                  "mem_available_before_save_bytes": asynchronous["mem_available_before_save"],
                  "staged_bytes": asynchronous["staged_bytes"],
                  "checkpoint_disk": background["checkpoint_disk"]},
        "blocking": blocking, "background": background,
        "strategies": strategies,
        "fsdp2_dcp_loop": child.get("dcp_loop"),
        "checks": checks, "ok": checks["ok"],
    }


# ---------------------------------------------------------------------------
# Phase 11: sequence parallelism, every rank's share in one process
# ---------------------------------------------------------------------------

# bench.py's seq-8192 row (bench.py:_build_config, big-HBM rung): batch 2,
# remat "flash" stepping down to "minimal" on OOM; its attention shape; and
# the virtual ranks the sequence is split over (2,048-token chunks).
SEQ_ROW = dict(b=2, s=8192, hq=16, hkv=16, d=128)
SEQ_ROW_POLICIES = ("flash", "minimal")
SEQ_RANKS = 4
# Phase 11 (b): the ring step's loss and grad norm against the flash step's
# on the same weights and batch.
SEQ_LOSS_RTOL, SEQ_GNORM_RTOL = 1e-3, 2e-2


def ring_schedule_forward(qs, ks, vs, causal, method):
    """The forward of every rank of a ring over len(qs) ranks, each holding
    its chunk (qs[i], ks[i], vs[i]), through parallel/cp.py's per-step
    helper; the transfers are done in place (rank i receives rank i-1's
    K/V). Returns each rank's merged (out fp32, lse)."""
    import torch

    from accelerate_tpu_torch.parallel.cp import chunk_forward, ring_source

    cp, s = len(qs), qs[0].shape[1]
    if method == "allgather":
        k_all, v_all = torch.cat(ks, 1), torch.cat(vs, 1)
        return [chunk_forward(qs[i], k_all, v_all, None, None, causal=causal, q_offset=i * s,
                              k_offset=0) for i in range(cp)]
    held, res = list(zip(ks, vs)), [(None, None)] * cp
    for step in range(cp):
        res = [chunk_forward(qs[i], *held[i], *res[i], causal=causal, q_offset=i * s,
                             k_offset=ring_source(i, step, cp) * s) for i in range(cp)]
        held = [held[(i - 1) % cp] for i in range(cp)]
    return res


def ring_schedule_backward(qs, ks, vs, douts, outs, lses, causal, method):
    """The backward of every rank of the ring, through parallel/cp.py's
    per-step helper with the fp32 dK/dV accumulators moved with their
    chunk in place. `outs` are the merged outputs in q's dtype. Returns
    each rank's fp32 (dq, dk, dv)."""
    import torch

    from accelerate_tpu_torch.ops.hopper_flash import output_delta
    from accelerate_tpu_torch.parallel.cp import chunk_backward, ring_source

    cp, s = len(qs), qs[0].shape[1]
    deltas = [output_delta(o, d) for o, d in zip(outs, douts)]
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)  # noqa: E731
    dqs = [zeros(q) for q in qs]
    if method == "allgather":
        k_all, v_all = torch.cat(ks, 1), torch.cat(vs, 1)
        dk_all, dv_all = zeros(k_all), zeros(v_all)
        for i in range(cp):
            chunk_backward(qs[i], k_all, v_all, douts[i], lses[i], deltas[i], dqs[i], dk_all,
                           dv_all, causal=causal, q_offset=i * s, k_offset=0)
        return dqs, list(dk_all.chunk(cp, 1)), list(dv_all.chunk(cp, 1))
    held = [(k, v, zeros(k), zeros(v)) for k, v in zip(ks, vs)]
    for step in range(cp):
        for i in range(cp):
            k, v, dk, dv = held[i]
            chunk_backward(qs[i], k, v, douts[i], lses[i], deltas[i], dqs[i], dk, dv,
                           causal=causal, q_offset=i * s, k_offset=ring_source(i, step, cp) * s)
        held = [held[(i - 1) % cp] for i in range(cp)]
    return dqs, [h[2] for h in held], [h[3] for h in held]


def ulysses_schedule(qs, ks, vs, causal):
    """Every rank's Ulysses attention (parallel/sp.py's layouts and
    flash_attention_with_lse, differentiable), the all-to-alls done in
    place: each rank's (out, lse of its heads over the whole sequence)."""
    import torch

    from accelerate_tpu_torch.ops import flash_attention_with_lse
    from accelerate_tpu_torch.ops.flash_attention import _repeat_kv
    from accelerate_tpu_torch.parallel import sp as sp_mod

    n, hq = len(qs), qs[0].shape[2]
    kvs = [_repeat_kv(k, v, hq) for k, v in zip(ks, vs)]
    ks, vs = [kv[0] for kv in kvs], [kv[1] for kv in kvs]

    def exchange(bufs):  # rank r receives entry r of every rank's buffer
        return [torch.stack([bufs[j][r] for j in range(n)]) for r in range(n)]

    def seq_to_heads(xs):
        return [sp_mod.unpack_seq_to_heads(r)
                for r in exchange([sp_mod.pack_seq_to_heads(x, n) for x in xs])]

    heads = [flash_attention_with_lse(q, k, v, causal=causal)
             for q, k, v in zip(seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs))]
    outs = [sp_mod.unpack_heads_to_seq(r)
            for r in exchange([sp_mod.pack_heads_to_seq(o, n) for o, _ in heads])]
    return outs, [lse for _, lse in heads]


def _chunks(x, n):
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def sequence_parallel_attention(hf, b, s, hq, hkv, d, n=SEQ_RANKS, dtype="bfloat16",
                                device="cuda", iters=10, seed=31):
    """Phase 11 (a): at one shape, the ring (both rotate methods) and
    Ulysses over `n` virtual ranks in one process against one
    flash_attention_with_lse call on the whole sequence (its forward and
    its autograd backward): out, lse, dq, dk, dv as relative error in norm
    (lse absolute), within TOLS[dtype]; each schedule's and the one call's
    forward and backward ms, each schedule's device-busy ms for one forward
    and backward, and each kernel's launches per schedule."""
    import torch

    from accelerate_tpu_torch.ops import flash_attention_with_lse

    q, k, v, dout, _ = inputs(b, s, hq, hkv, d, seed, dtype=dtype, device=device)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out_ref, lse_ref = flash_attention_with_lse(*leaves)
    out_ref.backward(dout)
    ref = {"out": out_ref.detach(), "lse": lse_ref.detach(),
           **{f"d{name}": x.grad for name, x in zip("qkv", leaves)}}
    qs, ks, vs, douts = (_chunks(x, n) for x in (q, k, v, dout))

    def one_call_fwd():
        return hf.flash_fwd(q, k, v)

    delta = hf.output_delta(out_ref, dout)

    def one_call_bwd():
        return hf.flash_bwd(q, k, v, dout, lse_ref.detach(), delta)

    # Three kernel launches: their CUDA-event times are their device times.
    results = {"one_call": {"fwd_ms": cuda_ms(one_call_fwd, iters),
                            "bwd_ms": cuda_ms(one_call_bwd, iters)}}
    tol_out, tol_grad, tol_lse = TOLS[dtype]
    for method in ("alltoall", "allgather", "ulysses"):
        hf.reset_launch_counts()
        if method == "ulysses":
            rank_leaves = [[x.detach().requires_grad_() for x in xs] for xs in (qs, ks, vs)]
            outs, lses = ulysses_schedule(*rank_leaves, causal=True)
            torch.autograd.backward(outs, douts)
            got = {"out": torch.cat(outs, 1).detach(), "lse": torch.cat(lses, 1).detach(),
                   **{f"d{name}": torch.cat([x.grad for x in xs], 1)
                      for name, xs in zip("qkv", rank_leaves)}}
            launches = dict(hf.LAUNCHES)
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: ulysses_schedule(qs, ks, vs, causal=True), iters)

            def fwd_bwd():
                torch.autograd.backward(ulysses_schedule(*rank_leaves, causal=True)[0], douts)

            # Its backward is autograd's: timed with a forward, less the forward.
            bwd_ms = cuda_ms(fwd_bwd, iters) - fwd_ms
        else:
            res = ring_schedule_forward(qs, ks, vs, True, method)
            outs = [o.to(q.dtype) for o, _ in res]
            lses = [lse for _, lse in res]
            dqs, dks, dvs = ring_schedule_backward(qs, ks, vs, douts, outs, lses, True, method)
            got = {"out": torch.cat(outs, 1), "lse": torch.cat(lses, 2),
                   "dq": torch.cat(dqs, 1).to(q.dtype), "dk": torch.cat(dks, 1).to(k.dtype),
                   "dv": torch.cat(dvs, 1).to(v.dtype)}
            launches = dict(hf.LAUNCHES)

            def fwd(method=method):
                return ring_schedule_forward(qs, ks, vs, True, method)

            def bwd(method=method, outs=outs, lses=lses):
                return ring_schedule_backward(qs, ks, vs, douts, outs, lses, True, method)

            def fwd_bwd():
                fwd()
                bwd()

            fwd_ms, bwd_ms = cuda_ms(fwd, iters), cuda_ms(bwd, iters)
        if device == "cuda":
            torch.cuda.synchronize()
        errs = {key: rel_err(got[key], ref[key]) for key in ("out", "dq", "dk", "dv")}
        errs["lse_abs"] = float((got["lse"] - ref["lse"]).abs().max())
        ok = (errs["out"] <= tol_out and errs["lse_abs"] <= tol_lse
              and max(errs["dq"], errs["dk"], errs["dv"]) <= tol_grad)
        results[method] = {"errors": errs, "ok": ok, "launches": launches,
                           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                           "device_busy_ms": device_busy_ms(fwd_bwd)}
    return {"shape": dict(b=b, s=s, hq=hq, hkv=hkv, d=d), "ranks": n, "dtype": dtype,
            "tolerance": {"out_rel": tol_out, "grad_rel": tol_grad, "lse_abs": tol_lse},
            "bound_ms": {k: v[0] for k, v in bounds(b, s, hq, hkv, d, dtype).items()},
            **results}


def device_busy_ms(fn):
    """The device time of the kernels one call of `fn` runs, from
    torch.profiler: beside the host-clock ms it shows whether the host's
    launches or the kernels bound a schedule."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_times(prof, 1)[0]


def attention_gate(cases) -> bool:
    """Every schedule of every shape within tolerance, each with the
    launches its schedule makes: n² per kernel for the ring (n steps on each
    of n ranks), n for the allgather ring and for Ulysses (one call per
    rank)."""
    for case in cases:
        n = case["ranks"]
        want = {"alltoall": n * n, "allgather": n, "ulysses": n}
        for method, count in want.items():
            r = case[method]
            if not r["ok"] or any(r["launches"][kname] != count for kname in KERNELS):
                return False
    return True


def in_process_ring_attention(n, method="alltoall"):
    """An attention function for ``LlamaAttention.attn_fn`` that runs the
    ring's schedule over `n` virtual ranks on chunks of the whole sequence
    (phase 11 (b)); its backward is the ring's backward."""
    import torch

    class Ring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            qs, ks, vs = (_chunks(x, n) for x in (q, k, v))
            res = ring_schedule_forward(qs, ks, vs, causal, method)
            outs = [o.to(q.dtype) for o, _ in res]
            ctx.save_for_backward(q, k, v, *outs, *(lse for _, lse in res))
            ctx.causal = causal
            return torch.cat(outs, 1)

        @staticmethod
        def backward(ctx, dout):
            q, k, v, *saved = ctx.saved_tensors
            qs, ks, vs = (_chunks(x, n) for x in (q, k, v))
            dqs, dks, dvs = ring_schedule_backward(qs, ks, vs, _chunks(dout.to(q.dtype), n),
                                                   saved[:n], saved[n:], ctx.causal, method)
            return (torch.cat(dqs, 1).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
                    torch.cat(dvs, 1).to(v.dtype), None)

    def attn_fn(q, k, v, *, causal=True):
        return Ring.apply(q, k, v, causal)

    return attn_fn


def seq_row_steps(hf, device="cuda", width=FULL_WIDTH, batch_size=SEQ_ROW["b"],
                  seq=SEQ_ROW["s"], timed=3, profile=True):
    """Phase 11 (b): bench.py's seq-8192 row, remat "flash" stepping down to
    "minimal" on OOM, for 2 warm-up and `timed` steps with
    attention_impl="flash"; then the weights are drawn again from the same
    seed and one step runs with every block's attention through the ring
    schedule over SEQ_RANKS virtual ranks: its loss and grad norm against
    the first flash step's, and its launches; a second ring step gives its
    warm time, and a third its device time under the profiler."""
    import torch

    for policy in SEQ_ROW_POLICIES:
        try:
            row = full_width_steps(hf, device=device, width=width, batch_size=batch_size,
                                   seq=seq, remat_policy=policy, timed=timed)
            break
        except torch.OutOfMemoryError:
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise RuntimeError("the seq-8192 row ran out of memory at every remat policy")
    step, state, batch = row.pop("_step")
    row.pop("_acc")
    module = row.pop("_module")
    prof = profile_steps(step, state, batch, row["step_ms"], steps=1) if profile else None

    with torch.no_grad():
        module.init_weights(torch.Generator(device=device).manual_seed(0))
    for layer in module.model.layers:
        layer.self_attn.attn_fn = in_process_ring_attention(SEQ_RANKS)
    torch.cuda.synchronize()
    hf.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(hf.LAUNCHES)
    # A second ring step, warm, for its time (the weights have moved).
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    ring = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "first_step_ms": first_ms, "step_ms": (time.perf_counter() - t0) * 1e3,
            "launches": launches,
            "launches_per_layer": {k: v / row["n_layers"] for k, v in launches.items()}}
    if profile:
        ring_prof = profile_steps(step, state, batch, ring["step_ms"], steps=1)
        ring.update({k: ring_prof[k] for k in ("device_busy_ms_per_step", "idle_share",
                                                "ms_per_step_by_category")})
    flash_first = {"loss": row["first_metrics"][0][0], "grad_norm": row["first_metrics"][0][1]}
    ring["rel"] = {k: _rel(ring[k], flash_first[k]) for k in ("loss", "grad_norm")}
    del step, state, batch, module
    return {**{k: v for k, v in row.items() if k != "phase"},
            "device_busy_ms_per_step": prof and prof["device_busy_ms_per_step"],
            "idle_share": prof and prof["idle_share"],
            "ms_per_step_by_category": prof and prof["ms_per_step_by_category"],
            "ring_step": ring, "flash_first_step": flash_first}


def seq_row_gate(row) -> bool:
    """The flash steps' losses finite and the first near ln(vocab), each
    kernel launched once per layer per step; the ring step's loss within
    SEQ_LOSS_RTOL and grad norm within SEQ_GNORM_RTOL of the first flash
    step's, with SEQ_RANKS² forward launches per layer under remat "flash"
    (each chunk's outputs kept: no forward kernel in the recompute), twice
    that under "minimal", and SEQ_RANKS² dQ and dK/dV launches per layer."""
    ring, n2 = row["ring_step"], SEQ_RANKS * SEQ_RANKS
    fwd_per_layer = n2 * (2 if row["remat_policy"] == "minimal" else 1)
    return (all(math.isfinite(x) for x in row["losses"])
            and abs(row["losses"][0] - row["ln_vocab"]) < 1.0
            and all(n == row["n_layers"] for n in row["launches_per_step"].values())
            and ring["rel"]["loss"] <= SEQ_LOSS_RTOL and ring["rel"]["grad_norm"] <= SEQ_GNORM_RTOL
            and ring["launches_per_layer"] == {"flash_fwd": fwd_per_layer, "flash_dq": n2,
                                               "flash_dkv": n2})


def sequence_parallel_phase(hf, device="cuda", width=FULL_WIDTH, shape=SEQ_ROW, seq=None,
                            batch_size=None, iters=10, profile=True):
    """Phase 11: (a) at bench.py's seq-8192 attention shape, MHA and GQA
    16:4; (b) the seq-8192 row's train step, then one step through the
    ring schedule."""
    import torch

    gqa = dict(shape, hkv=shape["hq"] // 4)
    attention = [sequence_parallel_attention(hf, **sh, device=device, iters=iters)
                 for sh in (shape, gqa)]
    gc.collect()
    torch.cuda.empty_cache()
    row = seq_row_steps(hf, device=device, width=width, seq=seq or shape["s"],
                        batch_size=batch_size or shape["b"], profile=profile)
    checks = {"attention": attention_gate(attention), "seq_row": seq_row_gate(row)}
    checks["ok"] = all(checks.values())
    return {"phase": "sequence_parallel", "attention": attention, "seq_row": row,
            "checks": checks, "ok": checks["ok"]}


# ---------------------------------------------------------------------------
# Phase 12: the imperative loop against the fused step, and the batch search
# ---------------------------------------------------------------------------

# Phase 12: gradient accumulation steps (phase 5's 4 rows: 1-row
# microbatches), optimizer steps of each run, and where the batch-size
# search starts.
IMPERATIVE = dict(ga=4, steps=3, search_start=64)
# The batch search must hand back what it allocated, within this.
SEARCH_MEM_SLACK = 64 * 2**20


def accumulation_run(hf, loop, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
                     batch_size=SLICE["b"], ga=IMPERATIVE["ga"], steps=IMPERATIVE["steps"],
                     profile=True, keep=False):
    """Phase 5's model (weights from seed 0), batch and optimizer at
    ``ga`` accumulation steps, for ``steps`` optimizer steps: the fused
    step (``loop=False``) or the imperative loop over the microbatches
    ``batch[i::ga]`` (the rows the fused step's split gives microbatch i),
    ``accumulate`` / ``backward`` / ``clip_grad_norm_(None, 1.0)`` /
    ``opt.step()`` / ``opt.zero_grad()``. With the FSDP plugin: FSDP2 over
    a process group, the plain step alone. The kernel launches are counted
    from 0 over the steps. Then one more optimizer step under
    torch.profiler (device-busy ms and idle share against the host-clock
    ms of the steps after the first). With ``keep`` the Accelerator,
    optimizer and loss function stay in the result (``_run``)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Model, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(),
                      gradient_accumulation_steps=ga, cpu=device == "cpu")
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, opt = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))

    def loss_fn(m, b):
        return cross_entropy_loss(m(b["x"]), b["y"])

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch_size, seq + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    flags = []
    if loop:
        def step(state, b):
            losses = []
            for i in range(ga):
                with acc.accumulate(model):
                    losses.append(acc.backward(loss_fn, {k: v[i::ga] for k, v in b.items()}))
                    norm = acc.clip_grad_norm_(None, 1.0)
                    flags.append(acc.sync_gradients)
                    opt.step()
                    opt.zero_grad()
            # Summed in the fused step's order, so that equal losses add up equal.
            return state, {"loss": sum(losses) / ga, "grad_norm": norm}
    else:
        step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    state = acc.train_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    metrics, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm_ms = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
    prof = profile_steps(step, state, batch, warm_ms, steps=1) if profile else None
    out = {
        "loop": "imperative" if loop else "fused", "ga": ga, "batch": batch_size, "seq": seq,
        "sharded": model.sharded, "n_layers": cfg.num_hidden_layers, "steps": steps,
        "optimizer_steps": acc.train_state.step - (1 if profile else 0),
        "metrics": [[float(m["loss"]), float(m["grad_norm"])] for m in metrics],
        "step_ms": step_ms, "warm_step_ms": warm_ms, "peak_mem_gib": peak,
        "launches": launches, "variant_launches": variant_launches,
        "launches_per_microbatch": {k: v / (steps * ga) for k, v in launches.items()},
        "sync_flags": flags[:steps * ga],
        "device_busy_ms_per_step": prof and prof["device_busy_ms_per_step"],
        "idle_share": prof and prof["idle_share"],
        "ms_per_step_by_category": prof and prof["ms_per_step_by_category"],
        "profiled_wall_ms_per_step": prof and prof["profiled_wall_ms_per_step"],
        "host_ops_ms_per_step": prof and prof["host_ops_ms_per_step"],
    }
    if keep:
        out["_run"] = (acc, opt, loss_fn, cfg)
    del step, state, batch
    return out


def batch_size_search(acc, opt, loss_fn, cfg, device="cuda", seq=SLICE["s"],
                      start=IMPERATIVE["search_start"]):
    """Phase 12 (b): ``find_executable_batch_size`` from ``start`` rows
    around one forward and backward of the prepared model
    (``acc.backward``, then ``opt.zero_grad()``): the sizes tried, the one
    that ran, and the allocated bytes before and after the search."""
    import torch

    from accelerate_tpu_torch.utils import find_executable_batch_size

    tried = []
    gen = torch.Generator(device=device).manual_seed(12)

    @find_executable_batch_size(starting_batch_size=start)
    def forward_backward(batch_size):
        tried.append(batch_size)
        ids = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1), generator=gen,
                            device=device)
        loss = acc.backward(loss_fn, {"x": ids[:, :-1], "y": ids[:, 1:]})
        opt.zero_grad()
        return float(loss)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = forward_backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    return {"start": start, "tried": tried, "batch_size": tried[-1], "halvings": len(tried) - 1,
            "loss": loss, "seconds": seconds, "allocated_before": before,
            "allocated_after": after}


def imperative_gate(fused, loop, search, fsdp_loop) -> dict:
    """Phase 12's checks: (a) the loop's losses and grad norms within
    DP_REL_TOL of the fused step's, ``ga`` microbatches and one optimizer
    step a window, each kernel launched once per layer per microbatch;
    (b) the search settled below its start and gave its memory back; (c)
    the FSDP2 loop of phase 10's child within DP_REL_TOL of the fused
    step, its model sharded, its kernels launched as (a)'s."""
    def close(run):
        return (len(run["metrics"]) == len(fused["metrics"])
                and all(_rel(a, b) <= DP_REL_TOL for got, ref in zip(
                    run["metrics"], fused["metrics"]) for a, b in zip(got, ref)))

    def launched(run):
        return all(n == run["n_layers"] * run["ga"] * run["steps"]
                   for n in run["launches"].values())

    ga, steps = loop["ga"], loop["steps"]
    checks = {
        "loop_matches_fused": close(loop),
        "optimizer_steps": loop["optimizer_steps"] == fused["optimizer_steps"] == steps,
        "windows": loop["sync_flags"] == ([False] * (ga - 1) + [True]) * steps,
        "launches": launched(loop),
        "finite": all(math.isfinite(x) for run in (fused, loop) for m in run["metrics"]
                      for x in m),
        "search_settled_below_start": 0 < search["batch_size"] < search["start"],
        "search_gave_memory_back": abs(search["allocated_after"] - search["allocated_before"])
        <= SEARCH_MEM_SLACK,
        "fsdp2_loop_matches_fused": bool(fsdp_loop) and fsdp_loop["sharded"] and close(fsdp_loop),
        "fsdp2_loop_launches": bool(fsdp_loop) and launched(fsdp_loop),
    }
    checks["ok"] = all(checks.values())
    return checks


def imperative_phase(hf, fsdp_loop, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
                     batch_size=SLICE["b"], search_start=IMPERATIVE["search_start"],
                     profile=True):
    """Phase 12 (see the module docstring); ``fsdp_loop`` is (c), the child's
    run of phase 10."""
    import torch

    kw = dict(device=device, width=width, seq=seq, batch_size=batch_size, profile=profile)
    fused = accumulation_run(hf, loop=False, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    loop = accumulation_run(hf, loop=True, keep=True, **kw)
    search = batch_size_search(*loop.pop("_run"), device=device, seq=seq, start=search_start)
    gc.collect()
    torch.cuda.empty_cache()
    checks = imperative_gate(fused, loop, search, fsdp_loop)
    return {"phase": "imperative_loop", "fused": fused, "loop": loop,
            "bit_equal": loop["metrics"] == fused["metrics"],
            "rel_to_fused": [[_rel(a, b) for a, b in zip(g, r)]
                             for g, r in zip(loop["metrics"], fused["metrics"])],
            "batch_search": search, "fsdp2_loop": fsdp_loop,
            "checks": checks, "ok": checks["ok"]}


# ---------------------------------------------------------------------------
# Phase 13: the loop and the engine with the library's observability on
# ---------------------------------------------------------------------------

# (a) phase 9's loop with trackers, telemetry, the profiler and a traced
# window; (b) host-clock steps with telemetry off and on (a block each),
# each block `cost_steps` steps after one warm-up, then
# one step under torch.profiler; the flight bundle's exit code.
OBSERVED = dict(steps=8, save_after=4, log_every=2, probe_every=2,
                schedule=dict(wait=1, warmup=1, active=2, repeat=1), cost_steps=4,
                flight_code=75, trackers=("json", "tensorboard"))
# The identity of a profiler record: its terms sum to wall_s within 1e-9
# relative, beside the half nanosecond to which each of its numbers is
# rounded (as the JAX package rounds them).
IDENTITY_REL = 1e-9
# Host-device synchronisations counted per step by telemetry_cost.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def sums_to_wall(rec) -> bool:
    terms = rec["terms"]
    return abs(sum(terms.values()) - rec["wall_s"]) <= (
        IDENTITY_REL * rec["wall_s"] + 0.5e-9 * (len(terms) + 1))


def sync_counts(prof, steps=1) -> dict:
    """Per step of a torch.profiler run: the host calls that wait for the
    card (``SYNC_CALLS``) and the device-to-host copies."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(SYNC_CALLS + ("memcpy_dtoh",), 0)
    for e in prof.events():
        if e.name in out:
            out[e.name] += 1
        elif e.device_type == DeviceType.CUDA and "DtoH" in e.name:
            out["memcpy_dtoh"] += 1
    return {k: v / steps for k, v in out.items()}


def trace_launches(path) -> dict:
    """Launches of each flash kernel in a Chrome trace of torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = dict.fromkeys(KERNELS, 0)
    for e in events:
        if e.get("cat") == "kernel" and _category(e.get("name", "")) in counts:
            counts[_category(e["name"])] += 1
    return counts


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


class _Messages:
    """The warnings a logger emits inside the block."""

    def __init__(self, name):
        import logging

        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def counted_flops_model(width, batch, seq) -> dict:
    """What capture_cost's FLOP count should be for one step of the Llama,
    beside bench.py's FLOP model: the counter sees the products only
    (6 FLOPs per weight of a projection per token, no embedding lookup, no
    norm) and attention over the causal pairs at 4 forward and 10
    backward FLOPs per pair and head dim; bench.py counts 6 per parameter,
    embedding included, and 12·L·H·S per token of full attention."""
    h, layers, vocab = width["hidden_size"], width["num_hidden_layers"], width["vocab_size"]
    n = llama_n_params(width)
    tokens = batch * seq
    projections = n - vocab * h - (2 * layers + 1) * h
    attention = 14 * layers * batch * h * seq * (seq + 1) // 2
    return {"bench_model": 6 * n * tokens + 12 * layers * h * seq * tokens,
            "counted_model": 6 * projections * tokens + attention,
            "embedding_in_bench": 6 * vocab * h * tokens,
            "attention_in_bench": 12 * layers * h * seq * tokens, "attention_counted": attention}


def telemetry_cost(hf, acc, step, loader, sched, recorder, device="cuda",
                   cost_steps=OBSERVED["cost_steps"]):
    """(b): the same step with telemetry off and on (the recorder set on the
    Accelerator and the loader, or None), in blocks off, on: one warm-up
    step, ``cost_steps`` steps on the host clock, one step under
    torch.profiler for its device-busy ms, its launches and its
    synchronisations. No profiler may be running when it starts."""
    import torch
    from torch.autograd.profiler import _is_profiler_enabled
    from torch.profiler import ProfilerActivity, profile

    free_before = not _is_profiler_enabled
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    # The recorder's own host time: its step hook, and the JSONL writes in it.
    spent = {"on_train_step": 0.0, "_write": 0.0}
    for name in spent:
        inner = getattr(recorder, name)

        def timed_hook(*a, _inner=inner, _name=name, **k):
            t = time.perf_counter()
            try:
                return _inner(*a, **k)
            finally:
                spent[_name] += time.perf_counter() - t

        setattr(recorder, name, timed_hook)
    blocks = []
    for on in (False, True):
        acc.telemetry = loader._telemetry = recorder if on else None
        it = iter(loader)
        step(acc.train_state, next(it))
        sched.step()
        torch.cuda.synchronize()
        for name in spent:
            spent[name] = 0.0
        t0 = time.perf_counter()
        for _ in range(cost_steps):
            step(acc.train_state, next(it))
            sched.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / cost_steps
        hook_ms = {k: v * 1e3 / cost_steps for k, v in spent.items()}
        with profile(activities=activities) as prof:
            step(acc.train_state, next(it))
            sched.step()
            torch.cuda.synchronize()
        it.close()
        busy = device_times(prof, 1)[0]
        blocks.append({"telemetry": on, "step_ms": ms, "device_busy_ms": busy,
                       "recorder_ms": hook_ms, "syncs": sync_counts(prof)})
    for name in spent:
        delattr(recorder, name)
    acc.telemetry = loader._telemetry = recorder

    off, on = blocks
    return {"profiler_free_before": free_before, "blocks": blocks,
            "step_ms": {"off": off["step_ms"], "on": on["step_ms"]},
            "device_busy_ms": {"off": off["device_busy_ms"], "on": on["device_busy_ms"]},
            "recorder_ms": on["recorder_ms"],
            "syncs_equal": all(b["syncs"] == blocks[0]["syncs"] for b in blocks)}


def observed_imperative(hf, acc, loader, recorder, ga=IMPERATIVE["ga"]):
    """(c): one window of phase 12's imperative loop (``ga`` microbatches of
    one row) with telemetry on: its optimizer_step record and the kernels'
    launches."""
    from accelerate_tpu_torch.models import cross_entropy_loss

    def loss_fn(model, b):
        ids = b["ids"].long()
        return cross_entropy_loss(model(ids[:, :-1]), ids[:, 1:])

    acc.telemetry = loader._telemetry = recorder
    acc.gradient_accumulation_steps = ga
    model, opt = acc._models[0], acc._optimizers[0]
    it = iter(loader)
    batch = next(it)
    it.close()
    hf.reset_launch_counts()
    flags = []
    for i in range(ga):
        with acc.accumulate(model):
            acc.backward(loss_fn, {"ids": batch["ids"][i::ga]})
            flags.append(acc.sync_gradients)
            opt.step()
            opt.zero_grad()
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    records = [r for r in _jsonl(recorder.path) if r["event"] == "optimizer_step"]
    return {"ga": ga, "sync_flags": flags, "records": records, "launches": launches,
            "variant_launches": variant_launches}


def observed_serving(hf, module, recorder, phase8_tok_s=None, row=SERVING_ROW):
    """(d): phase 8's engine and trace, replayed by an engine without
    telemetry and one with ``telemetry=recorder`` (and its profiler, whose
    ring must hold every tick of a replay), in the order off, on:
    the observed engine's tick records and serving block against its
    stats() (its last replay), tok/s of each replay beside phase 8's."""
    import torch

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine
    from accelerate_tpu_torch.serving import replay_trace

    vocab = module.config.vocab_size
    lengths, budgets, prompts, arrivals = serving_trace(vocab, **row)
    cfg = ServingConfig(n_slots=row["slots"], max_len=int(max(lengths + budgets)) + 8,
                        max_prefill_chunk=max(16, row["prompt_len"]))
    engines = {False: ServingEngine(Model(module), cfg),
               True: ServingEngine(Model(module), cfg, telemetry=recorder)}
    for engine in engines.values():
        engine.warmup()
    replays = []
    for on in (False, True):
        engine = engines[on]
        engine.reset_metrics()
        torch.cuda.synchronize()
        hf.reset_launch_counts()
        rows, wall = replay_trace(engine, prompts, arrivals=list(arrivals),
                                  max_new_tokens=[int(b) for b in budgets])
        stats = engine.stats()
        replays.append({"telemetry": on, "tok_s": stats["tokens_out"] / wall, "wall_s": wall,
                        "ticks": stats["ticks"], "ttft_p50_s": stats["ttft_p50_s"],
                        "ttft_p95_s": stats["ttft_p95_s"],
                        "ok": serving_gate(rows, prompts, budgets.tolist(), stats, vocab)})
        if on:
            launches, observed = dict(hf.VARIANT_LAUNCHES), stats
            ticks_lagged = recorder.profiler.summary()["ticks"]
    metrics = recorder.hub.render()
    recorder.close()
    ticks = recorder.profiler.records()
    records = _jsonl(recorder.path)
    block = [r for r in records if r["event"] == "serving_summary"][-1]
    done = [r for r in records if r["event"] == "serving_request_done"]
    checks = {
        "requests": all(r["ok"] for r in replays),
        "ticks_sum_to_wall": len(ticks) == observed["ticks"] and all(
            sums_to_wall(r) for r in ticks),
        "ticks_lagged": ticks_lagged == observed["ticks"] - 1,
        "serving_block_ttft": (block["ttft_p50_s"], block["ttft_p95_s"]) == (
            observed["ttft_p50_s"], observed["ttft_p95_s"]),
        # The observed engine's warm-up request and its replay.
        "request_records": len(done) == 1 + len(prompts),
        "hub": "accelerate_tpu_slo_serving_availability_burn_rate 0.0" in metrics,
    }

    return {"replays": replays, "tok_s": {"off": replays[0]["tok_s"], "on": replays[1]["tok_s"]},
            "phase8_tok_s": phase8_tok_s, "ticks": observed["ticks"], "tick_records": len(ticks),
            "tick_terms_mean_s": recorder.profiler.summary()["tick_terms_mean_s"],
            "ttft_p50_s": observed["ttft_p50_s"], "ttft_p95_s": observed["ttft_p95_s"],
            "variant_launches": launches, "checks": checks}


def observed_phase(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], phase8_tok_s=None,
                   phase9=None, cost_steps=OBSERVED["cost_steps"], serving_row=SERVING_ROW):
    """Phase 13 (see the module docstring). Returns its report with its
    checks."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.profiler import dump_flight, exit_class_name
    from accelerate_tpu_torch.telemetry import STEP_RECORD_KEYS, TelemetryRecorder
    from accelerate_tpu_torch.utils import ProfileKwargs, TelemetryKwargs
    from accelerate_tpu_torch.utils.imports import is_tensorboard_available

    t_start = time.perf_counter()
    steps, save_after = OBSERVED["steps"], OBSERVED["save_after"]
    every = OBSERVED["log_every"]
    tokens = np.random.default_rng(LOOP["data_seed"]).integers(
        0, width["vocab_size"], (LOOP["rows"], seq + 1), dtype=np.int32)
    root, disk = checkpoint_root(llama_n_params(width) * 4 * 3)
    handlers = [TelemetryKwargs(profile=True, log_every=every,
                                straggler_probe_every=OBSERVED["probe_every"]),
                ProfileKwargs(schedule_option=OBSERVED["schedule"])]
    try:
        with _Messages("accelerate_tpu_torch.tracking") as warned:
            acc, step, loader, sched, _ = build_loop(
                device, width, seq, root, LOOP["init_seeds"][0], tokens,
                acc_kw=dict(log_with=list(OBSERVED["trackers"]), kwargs_handlers=handlers))
        tel = acc.telemetry
        hook = []  # the loader's waits, as its hook reports them
        add = tel.add_data_wait
        tel.add_data_wait = lambda s: (hook.append(s), add(s))[1]
        acc.init_trackers("chip_smoke", config={**width, "seq": seq, "batch": LOOP["batch"]})

        # (a) the main path of this phase: counts from 0 just before, read just after
        it = iter(loader)
        hf.reset_launch_counts()
        losses, peaks = [], []
        with acc.profile() as session:
            for i in range(steps):
                _, metrics = step(acc.train_state, next(it))
                peaks.append(torch.cuda.max_memory_allocated())
                sched.step()
                session.step()
                losses.append(float(metrics["loss"]))
                acc.log({"loss": losses[-1]}, step=i + 1)
                if i + 1 == save_after:
                    acc.save_state()
                    save = dict(acc.checkpoint_stats)
        launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
        it.close()
        lagged = len(tel.profiler.records())
        acc.end_training()
        prof_records = tel.profiler.records()
        flight_path = dump_flight(tel, OBSERVED["flight_code"], reason="chip_smoke phase 13")
        with open(flight_path) as f:
            flight = json.load(f)
        records = _jsonl(tel.path)
        logged = _jsonl(os.path.join(acc.logging_dir, "chip_smoke.metrics.jsonl"))
        tb = None
        if "tensorboard" in acc.log_with:
            from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

            ea = EventAccumulator(os.path.join(acc.logging_dir, "chip_smoke"))
            ea.Reload()
            tb = [(e.step, e.value) for e in ea.Scalars("loss")]
        trace_dirs = [os.path.relpath(d, root) for d in session.trace_dirs]
        traced = {k: v / 2 for k, v in trace_launches(
            os.path.join(session.trace_dirs[0], "trace.json")).items()} if trace_dirs else {}
        cost = dict(tel.profiler._cost or {})
        # The checkpoint goes before (b): its pages, still being written
        # back, would slow the recorder's writes.
        shutil.rmtree(os.path.dirname(save["dir"]), ignore_errors=True)

        # (b) the cost of telemetry; (c) the imperative loop: a second
        # recorder on the same Accelerator (its own JSONL), no FLOP count
        acc.trackers = []
        recorder = TelemetryRecorder(acc, TelemetryKwargs(
            profile={"capture_cost": False}, log_every=every,
            straggler_probe_every=OBSERVED["probe_every"],
            output_dir=os.path.join(root, "telemetry_cost")))
        costs = telemetry_cost(hf, acc, step, loader, sched, recorder, device=device,
                               cost_steps=cost_steps)
        imperative = observed_imperative(hf, acc, loader, recorder)
        acc.free_memory()  # closes the recorder
        del step, loader, sched, it, metrics
        gc.collect()
        torch.cuda.empty_cache()

        # (d) phase 8's engine, with a recorder on (a)'s Accelerator
        cfg = LlamaConfig(**width, max_position_embeddings=2048, dtype=torch.bfloat16)
        module = LlamaForCausalLM(cfg, device=acc.device)
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        module.to(torch.bfloat16)
        serving = observed_serving(hf, module, TelemetryRecorder(acc, TelemetryKwargs(
            profile={"ring_size": 4096}, output_dir=os.path.join(root, "telemetry_serving"))),
            phase8_tok_s, row=serving_row)
        del module
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    n_layers = width["num_hidden_layers"]
    step_recs = [r for r in records if r["event"] == "step"]
    log_recs = [r for r in logged if r["event"] == "log"]
    tel_steps = [r["step"] for r in log_recs if "telemetry/step_time_s" in r["values"]]
    saves = [r for r in records if r["event"] == "checkpoint_save"]
    opt_recs = imperative["records"]
    tb_ok = (tb == [(i + 1, x) for i, x in enumerate(losses)] if tb is not None
             else "Tried adding logger tensorboard, but that package is not installed."
             in warned.messages)
    checks = {
        "tensorboard": tb_ok and ("tensorboard" in acc.log_with) == is_tensorboard_available(),
        "json_tracker_losses": [r["values"]["loss"] for r in log_recs
                                if "loss" in r["values"]] == losses,
        "json_tracker_telemetry": tel_steps == list(range(every, steps + 1, every)),
        "step_records": len(step_recs) == steps and all(
            set(r) == set(STEP_RECORD_KEYS) | {"t_mono"} and r["samples"] == LOOP["batch"]
            and r["recompiles"] == 0 for r in step_recs),
        "data_wait_sums": math.isclose(sum(r["data_wait_s"] for r in step_recs), sum(hook),
                                       rel_tol=1e-9, abs_tol=1e-12),
        "hbm_peak_matches": [r["hbm_peak_bytes"] for r in step_recs] == peaks,
        "checkpoint_save_event": len(saves) == 1 and abs(
            saves[0]["seconds"] - save["seconds"]) <= 0.05 * save["seconds"],
        "summary_record": sum(r["event"] == "summary" for r in records) == 1,
        "profiler_records": lagged == steps - 1 and len(prof_records) == steps,
        "profiler_sums": all(sums_to_wall(r) for r in prof_records),
        "one_window": trace_dirs == ["cycle_0"],
        "trace_launches": traced == {k: n_layers for k in KERNELS},
        "launches": all(n == n_layers * steps for n in launches.values()),
        "flight": (os.path.basename(flight_path)
                   == f"flight_{exit_class_name(OBSERVED['flight_code'])}.json"
                   and [e["step"] for e in flight["entries"]] == list(range(1, steps + 1))),
        "finite": all(math.isfinite(x) for x in losses),
        "flops_counted": cost.get("flops", 0) > 0,
        "no_added_sync": costs["syncs_equal"],
        "profilers_apart": costs["profiler_free_before"],
        "imperative_records": len(opt_recs) == 1 and opt_recs[0]["backward_s"] > 0
        and opt_recs[0]["apply_s"] > 0,
        "imperative_launches": all(n == n_layers * imperative["ga"]
                                   for n in imperative["launches"].values()),
        **{f"serving_{k}": v for k, v in serving["checks"].items()},
    }
    checks["ok"] = all(checks.values())
    flops = counted_flops_model(width, LOOP["batch"], seq)
    return {
        "phase": "observability", "seconds": time.perf_counter() - t_start,
        "trackers": acc.log_with, "tracker_warnings": warned.messages,
        "losses": losses, "launches": launches, "variant_launches": variant_launches,
        "traced_launches_per_step": traced, "trace_dirs": trace_dirs,
        "step_records": [{k: r[k] for k in ("step", "wall_s", "data_wait_s", "samples",
                                             "recompiles", "hbm_peak_bytes")} for r in step_recs],
        "checkpoint_save_s": {"event": saves[0]["seconds"] if saves else None,
                              "stats": save["seconds"]},
        "profile_summary": tel.profiler.summary(), "flight_entries": len(flight["entries"]),
        "flops": {"counted": cost.get("flops"), **flops,
                  "counted_over_model": cost.get("flops", 0) / flops["counted_model"],
                  "counted_over_bench": cost.get("flops", 0) / flops["bench_model"]},
        "telemetry_cost": {**costs, "phase9_step_ms": phase9 and phase9.get("step_ms"),
                           "phase9_device_busy_ms": phase9 and phase9.get(
                               "device_busy_ms_per_step")},
        "imperative": {k: v for k, v in imperative.items() if k != "records"}
        | {"records": [{k: r[k] for k in ("step", "wall_s", "backward_s", "apply_s")}
                       for r in opt_recs]},
        "serving": serving, "checkpoint_disk": disk, "checks": checks, "ok": checks["ok"],
    }


# ---------------------------------------------------------------------------
# Phase 14: reduced precision — the fp16 step with loss scaling, the fp8 step
# ---------------------------------------------------------------------------

# (a) the fp16 step: warm-up and timed steps (12 in all), then the injected
# overflow and the step after it; (b) the fp8 step, bench.py's fp8 row (10
# timed iterations after warm-up); (c) the fp8 linear at the 1.06B model's
# projection shapes (tokens, in, out): q/k/v/o, gate/up, down.
PRECISION = dict(fp16_warmup=2, fp16_timed=10, fp8_warmup=2, fp8_timed=10,
                 linear_shapes=((8192, 2048, 2048), (8192, 2048, 5632), (8192, 5632, 2048)))
# tests/test_fp8.py:188-228's bound between the fp8 and bf16 first losses.
FP8_LOSS_RTOL = 0.05
FP8_FORMATS = ("HYBRID", "E4M3", "E5M2")
# fp8 products of one projection a step: the forward's, dX's and dW's (the
# remat "dots" policy keeps the forward's, so the recompute adds none).
FP8_PRODUCTS = 3
FP8_PROJECTIONS = 7
# What a profiled step may not add over phase 13's bf16 step.
SYNC_KEYS = ("cudaStreamSynchronize", "cudaEventSynchronize", "memcpy_dtoh")


def _local_tensor(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _precision_run(precision, device, width, seq, batch_size, fp8=False):
    """Phase 5's model (weights from seed 0), batch and optimizer under
    ``mixed_precision=precision`` (fp16: a float16 model; fp8: bf16 with
    HYBRID fp8 projections), with the FSDP plugin. The loss function
    multiplies its loss by inf while ``poison["on"]``."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Model, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for cls in (AcceleratorState, GradientState):  # the precision is AcceleratorState's
        cls._reset_state()
    cfg = LlamaConfig(**width, max_position_embeddings=seq,
                      dtype=torch.float16 if precision == "fp16" else torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash", fp8=fp8,
                      fp8_format="HYBRID")
    acc = Accelerator(mixed_precision=precision, fsdp_plugin=FullyShardedDataParallelPlugin(),
                      cpu=device == "cpu")
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    poison = {"on": False}

    def loss_fn(m, b):
        loss = cross_entropy_loss(m(b["x"]), b["y"])
        return loss * math.inf if poison["on"] else loss

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch_size, seq + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    return cfg, acc, model, step, batch, poison


def profiled_step(step, state, batch, step_ms, device="cuda", annotate=()):
    """One step under torch.profiler: device-busy ms, idle share against
    ``step_ms``, ms by kernel category, the synchronisations and D2H copies
    (``sync_counts``), and the device ms under each ``record_function``
    label of ``annotate`` ((module, function name, label) triples wrapped
    for the step) and of the ``aten::_scaled_mm`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    originals = []
    for module, name, label in annotate:
        inner = getattr(module, name)

        def wrapped(*a, _inner=inner, _label=label, **k):
            with record_function(_label):
                return _inner(*a, **k)

        originals.append((module, name, inner))
        setattr(module, name, wrapped)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    try:
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        for module, name, inner in originals:
            setattr(module, name, inner)
    busy, by_cat, top, _ = device_times(prof, 1)
    labels = {label for _, _, label in annotate} | {"aten::_scaled_mm"}
    by_label = dict.fromkeys(sorted(labels), 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in by_label:
            by_label[e.name] += e.device_time_total / 1e3
    return {"device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms if top else None,
            "ms_by_category": by_cat, "top_kernels_ms": top, "ms_by_label": by_label,
            "syncs": sync_counts(prof)}


def overflow_check(acc, step, batch, poison):
    """One step whose loss is multiplied by inf, then one plain step: the
    parameters, AdamW's moments and step counts (compared on the device
    with ``torch.equal``), the optimizer's count and ``state.step`` must
    stay as they were, the scale back off (floor 1.0), and the next step
    apply."""
    import torch

    state = acc.train_state
    opt, ls = state.optimizer, state.loss_scale
    params = [_local_tensor(p.detach()).clone() for p in state.model.parameters()]
    moments = [_local_tensor(v).clone() for s in opt.state.values() for v in s.values()]
    before = {"scale": float(ls.scale), "growth_tracker": int(ls.growth_tracker),
              "step": int(state.step), "count": opt.count}
    poison["on"] = True
    try:
        state, bad = step(state, batch)
    finally:
        poison["on"] = False
    after = {"scale": float(ls.scale), "growth_tracker": int(ls.growth_tracker),
             "step": int(state.step), "count": opt.count}
    params_equal = all(torch.equal(a, _local_tensor(p.detach()))
                       for a, p in zip(params, state.model.parameters()))
    moments_equal = all(torch.equal(a, _local_tensor(v)) for a, v in zip(
        moments, (v for s in opt.state.values() for v in s.values())))
    state, good = step(state, batch)
    applied = int(state.step) == before["step"] + 1 and not all(
        torch.equal(a, _local_tensor(p.detach())) for a, p in zip(params, state.model.parameters()))
    del params, moments
    return {"before": before, "after": after, "loss": float(bad["loss"]),
            "grad_norm": float(bad["grad_norm"]), "next_loss": float(good["loss"]),
            "params_bit_equal": params_equal, "moments_bit_equal": moments_equal,
            "scale_backed_off": after["scale"] == max(before["scale"] * 0.5, 1.0)
            and after["growth_tracker"] == 0,
            "step_held": (after["step"], after["count"]) == (before["step"], before["count"]),
            "next_applied": applied}


def fp16_steps(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
               warmup=PRECISION["fp16_warmup"], timed=PRECISION["fp16_timed"], profile=True):
    """(a): the fp16 step for ``warmup`` + ``timed`` steps with the kernel
    launches counted from 0, per step its loss, grad norm, scale and
    whether it was skipped (read after the timed window); one profiled
    step; then ``overflow_check``."""
    import torch

    cfg, acc, model, step, batch, poison = _precision_run("fp16", device, width, seq,
                                                          batch_size)
    state = acc.train_state
    ls = state.loss_scale
    records = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = step(state, batch)
            records.append((m["loss"], m["grad_norm"], ls.scale.clone(), state.step.clone()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step, applied = [], 0
    for loss, gnorm, scale, count in records:
        per_step.append({"loss": float(loss), "grad_norm": float(gnorm), "scale": float(scale),
                         "skipped": int(count) == applied})
        applied = int(count)
    prof = profiled_step(step, state, batch, dt * 1e3, device) if profile else None
    overflow = overflow_check(acc, step, batch, poison)
    tok_s = batch_size * seq / dt
    return {"n_layers": cfg.num_hidden_layers, "sharded": model.sharded,
            "steps": warmup + timed, "step_ms": dt * 1e3, "tok_s": tok_s,
            "peak_mem_gib": peak, "per_step": per_step,
            "overflowed_steps": sum(r["skipped"] for r in per_step),
            "launches": launches, "variant_launches": variant_launches,
            "launches_per_step": {k: v / (warmup + timed) for k, v in launches.items()},
            "ln_vocab": math.log(cfg.vocab_size), "overflow": overflow,
            "profile": prof}


def fp8_steps(hf, fp8_ops, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
              batch_size=SLICE["b"], warmup=PRECISION["fp8_warmup"],
              timed=PRECISION["fp8_timed"], profile=True):
    """(b): bench.py's fp8 row, the 1.06B step with HYBRID fp8 projections,
    ``warmup`` + ``timed`` steps with the launches and the fp8 products'
    paths counted from 0; one profiled step, its device ms split into the
    fp8 products, the quantization (amax, casts, transposed copies) and the
    rest."""
    import torch

    cfg, acc, model, step, batch, _ = _precision_run("fp8", device, width, seq, batch_size,
                                                     fp8=True)
    state = acc.train_state
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    fp8_ops.reset_paths()
    norms = []
    for _ in range(warmup):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    paths = dict(fp8_ops.PATHS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = None
    if profile:
        prof = profiled_step(step, state, batch, dt * 1e3, device, annotate=(
            (fp8_ops, "_quant", "fp8_quantize"), (fp8_ops, "_transposed", "fp8_quantize")))
        flash = sum(prof["ms_by_category"].get(k, 0.0) for k in KERNELS)
        gemm, quant = prof["ms_by_label"]["aten::_scaled_mm"], prof["ms_by_label"]["fp8_quantize"]
        prof["split_ms"] = {"fp8_gemm": gemm, "quantization": quant, "flash": flash,
                            "rest": prof["device_busy_ms"] - gemm - quant - flash}
    tok_s = batch_size * seq / dt
    n_params = model.num_parameters()
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq
    return {"n_layers": cfg.num_hidden_layers, "steps": warmup + timed, "step_ms": dt * 1e3,
            "tok_s": tok_s, "mfu": tok_s * flops_per_token / PEAK_BF16_FLOPS,
            "peak_mem_gib": peak, "losses": [float(x) for x in losses], "paths": paths,
            # Phase 25 (a)'s reference: its steps start from these weights and batch.
            "first_metrics": [(float(l), float(n)) for l, n in zip(losses, norms)][:TP_STEPS],
            "launches": launches, "variant_launches": variant_launches, "profile": prof}


def fp8_reference(fp8_ops, x, w, g, fwd, bwd):
    """The fp8 linear's forward and gradients through the plain version of
    the product (fp32 on the codes) on x's device."""
    xq, sx = fp8_ops._quant(x, fwd)
    wq, sw = fp8_ops._quant(w, fwd)
    gq, sg = fp8_ops._quant(g, bwd)
    plain = fp8_ops.fp8_mm_plain
    return (plain(xq, wq.t(), sx, sw, x.dtype), plain(gq, wq, sg, sw, x.dtype),
            plain(gq.t(), xq, sg, sx, w.dtype))


def fp8_linear_cases(fp8_ops, device="cuda", shapes=PRECISION["linear_shapes"], iters=20):
    """(c): at each projection shape, bf16 x (tokens, in), w (out, in) and
    a cotangent: ``_quant``'s codes and scales against the CPU's bit for
    bit; for each format the fp8 linear's output, dX and dW against the
    plain version (``TOLS["bfloat16"]``), the path its products took, and
    the forward product's ms beside its bound, the plain version's and a
    bf16 ``torch.mm``'s, and one quantization's ms."""
    import torch

    tol_out, tol_grad, _ = TOLS["bfloat16"]
    cases = []
    for m, k, n in shapes:
        gen = torch.Generator(device=device).manual_seed(m + k + n)
        x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device=device) * 0.02).to(torch.bfloat16)
        g = (torch.randn(m, n, generator=gen, device=device) * 1e-3).to(torch.bfloat16)
        codes_equal = True
        for t, dt in ((x, torch.float8_e4m3fn), (w, torch.float8_e4m3fn),
                      (g, torch.float8_e5m2)):
            q, s = fp8_ops._quant(t, dt)
            qc, sc = fp8_ops._quant(t.cpu(), dt)
            codes_equal &= (torch.equal(q.view(torch.uint8).cpu(), qc.view(torch.uint8))
                            and float(s) == float(sc))
        for fmt in FP8_FORMATS:
            fwd, bwd = fp8_ops._fmt_dtypes(fmt)
            fp8_ops.reset_paths()
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            y = fp8_ops.fp8_dot_general(fmt, native=True)(xr, wr)
            y.backward(g)
            paths = dict(fp8_ops.PATHS)
            ref = fp8_reference(fp8_ops, x, w, g, fwd, bwd)
            got = (y.detach(), xr.grad, wr.grad)
            err = dict(zip(("out", "dx", "dw"), (rel_err(a, b) for a, b in zip(got, ref))))
            max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            expect = "dequantized" if fmt == "E5M2" else "scaled_mm"
            xq, sx = fp8_ops._quant(x, fwd)
            wq, sw = fp8_ops._quant(w, fwd)
            ms = cuda_ms(lambda: fp8_ops.fp8_mm(xq, wq.t(), sx, sw, torch.bfloat16), iters)
            plain_ms = cuda_ms(lambda: fp8_ops.fp8_mm_plain(xq, wq.t(), sx, sw, torch.bfloat16),
                               iters)
            bf16_ms = cuda_ms(lambda: torch.mm(x, w.t()), iters)
            quant_ms = cuda_ms(lambda: fp8_ops._quant(x, fwd), iters)
            flops, nbytes = 2 * m * k * n, (m * k + n * k) + 2 * m * n
            peak = PEAK_FP8_FLOPS if expect == "scaled_mm" else PEAK_BF16_FLOPS
            bound = max(flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3
            cases.append({
                "shape": [m, k, n], "format": fmt, "rel_err": err, "max_abs_err": max_abs,
                "paths": paths, "path": expect, "codes_equal": codes_equal,
                "forward_ms": ms, "plain_ms": plain_ms, "bf16_mm_ms": bf16_ms,
                "quantize_ms": quant_ms, "bound_ms": bound,
                "bound_by": "operations" if flops / peak > nbytes / PEAK_HBM_BYTES else "bytes",
                "ok": (err["out"] <= tol_out and err["dx"] <= tol_grad and err["dw"] <= tol_grad
                       and paths[expect] == 3 and sum(paths.values()) == 3)})
    return cases


def precision_gate(fp16, fp8, linear, phase5, bf16_syncs, dp_fp16=None) -> dict:
    """Phase 14's checks: (a) finite losses starting near ln(vocab), some
    steps applied, each fp16 flash kernel once per layer per step, the
    overflowed step leaving every parameter, moment and count and backing
    off the scale, the step after it applied, and no synchronisation or
    D2H copy over phase 13's bf16 step; (b) every fp8 product on
    ``_scaled_mm``, each bf16 flash kernel once per layer per step, the
    first loss within FP8_LOSS_RTOL of phase 5's and the loss descending;
    (c) every linear case within tolerance, on its path, with the codes
    equal to the CPU's; phase 10's child's fp16 overflow under FSDP2."""
    n_layers, ov = fp16["n_layers"], fp16["overflow"]
    fp8_products = FP8_PRODUCTS * FP8_PROJECTIONS * fp8["n_layers"] * fp8["steps"]

    def flash_each(run, tag):
        return all(run["variant_launches"].get(f"{k}.{tag}.d128", 0) == n_layers * run["steps"]
                   for k in KERNELS)

    losses = [r["loss"] for r in fp16["per_step"]]
    checks = {
        "fp16_losses": all(math.isfinite(x) for x in losses)
        and abs(losses[0] - fp16["ln_vocab"]) < 1.0,
        "fp16_applied": fp16["overflowed_steps"] < fp16["steps"],
        "fp16_flash_launches": flash_each(fp16, "f16"),
        "overflow_params_bit_equal": ov["params_bit_equal"],
        "overflow_moments_bit_equal": ov["moments_bit_equal"],
        "overflow_scale_backed_off": ov["scale_backed_off"],
        "overflow_step_held": ov["step_held"],
        "overflow_next_applied": ov["next_applied"],
        "fp16_no_added_sync": bool(fp16["profile"]) and bf16_syncs is not None and all(
            fp16["profile"]["syncs"][k] == bf16_syncs[k] for k in SYNC_KEYS),
        "fp8_on_scaled_mm": fp8["paths"] == {"scaled_mm": fp8_products, "dequantized": 0,
                                             "plain": 0},
        "fp8_flash_launches": flash_each(fp8, "bf16"),
        "fp8_first_loss": _rel(fp8["losses"][0], phase5["losses"][0]) <= FP8_LOSS_RTOL,
        "fp8_descends": all(math.isfinite(x) for x in fp8["losses"])
        and fp8["losses"][-1] < fp8["losses"][0],
        "linear_within_tolerance": bool(linear) and all(c["ok"] for c in linear),
        "quantize_bit_equal": bool(linear) and all(c["codes_equal"] for c in linear),
        "fsdp2_fp16_overflow": bool(dp_fp16) and dp_fp16["sharded"] and all(
            dp_fp16["overflow"][k] for k in ("params_bit_equal", "moments_bit_equal",
                                             "scale_backed_off", "step_held", "next_applied")),
    }
    checks["ok"] = all(checks.values())
    return checks


def precision_phase(hf, phase5, bf16_syncs=None, dp_fp16=None, device="cuda",
                    width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"], profile=True,
                    linear_shapes=PRECISION["linear_shapes"]):
    """Phase 14 (see the module docstring). ``phase5`` holds the main path's
    losses and tok/s, ``bf16_syncs`` phase 13's counts for a bf16 step
    and ``dp_fp16`` phase 10's child's fp16 run under FSDP2."""
    import torch

    from accelerate_tpu_torch.ops import fp8 as fp8_ops
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    t_start = time.perf_counter()
    kw = dict(device=device, width=width, seq=seq, batch_size=batch_size, profile=profile)
    fp16 = fp16_steps(hf, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    fp8 = fp8_steps(hf, fp8_ops, **kw)
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    linear = fp8_linear_cases(fp8_ops, device=device, shapes=linear_shapes)
    fp8["fp8_speedup"] = fp8["tok_s"] / phase5["tok_s"]
    fp8["phase5"] = {"tok_s": phase5["tok_s"], "first_loss": phase5["losses"][0]}
    checks = precision_gate(fp16, fp8, linear, phase5, bf16_syncs, dp_fp16)
    return {"phase": "reduced_precision", "seconds": time.perf_counter() - t_start,
            "fp16": fp16, "fp8": fp8, "fp8_linear": linear, "fsdp2_fp16": dp_fp16,
            "bf16_syncs": bf16_syncs, "checks": checks, "ok": checks["ok"]}


# ---------------------------------------------------------------------------
# Phase 16: serving, the rest
# ---------------------------------------------------------------------------

SERVING_REST = dict(
    spec_k=4, spec_ngram=16, motif=8, motif_repeats=8,      # (b)
    burst=32, queue_depth=8, burst_prompt=16, burst_budget=8,  # (d)
    deadline_s=1.5, deadline_budget=200, idle_ticks=5, poison_budget=16,
    draft_layers=2, draft_tokens=4, beams=4,                  # (e)
    tie_rows=2)
# (c): the first decode step's logits over int8 pages against the bf16
# cache's, as the relative L2 error of the whole (slots, vocab) block.
INT8_LOGIT_REL = 5e-2
# (e): beam search's length-normalised log-probability may fall below
# greedy's by this much relative (both recomputed by one teacher-forced
# bf16 forward) and still pass.
BEAM_SCORE_REL = 1e-3


def expected_shed(policy, n, cap):
    """The indices shed when ``n`` requests reach a queue of ``cap`` before
    the first tick: ``reject`` sheds the ones that find it full,
    ``shed_oldest`` the oldest, ``block`` none (submit ticks until there is
    room)."""
    over = max(0, n - cap)
    return {"reject": list(range(cap, n)) if over else [],
            "shed_oldest": list(range(over)), "block": []}[policy]


def int8_bytes_ok(int8_bytes, bf16_bytes, head_dim) -> bool:
    """int8 pages (codes plus one fp32 scale per row of the head dim) take
    exactly (D + 4) / (2 D) of a 16-bit cache's bytes."""
    return int8_bytes * 2 * head_dim == bf16_bytes * (head_dim + 4)


def speculation_counts_ok(rows, block) -> bool:
    """Every row drafted at least what it accepted, and the rows' counts
    sum to the engine's speculation block."""
    return (all(r["drafted"] >= r["accepted"] for r in rows)
            and sum(r["drafted"] for r in rows) == block["drafted"]
            and sum(r["accepted"] for r in rows) == block["accepted"])


def _drain(engine) -> dict:
    """Tick until nothing is pending: every poll row by id."""
    rows = {r["id"]: r for r in engine.poll()}
    while engine.pending:
        engine.tick()
        rows.update((r["id"], r) for r in engine.poll())
    return rows


def _engine_rows(engine, prompts, budgets):
    """Submit every prompt, tick until drained: the poll rows in order."""
    ids = [engine.submit(p, max_new_tokens=int(b)) for p, b in zip(prompts, budgets)]
    rows = _drain(engine)
    return [rows[i] for i in ids]


def _replay_rows(engine, prompts, arrivals, budgets):
    """``replay_trace`` that keeps every poll row (status, counts): the
    rows in input order and the wall time."""
    from accelerate_tpu_torch.serving import replay_trace

    ids, seen = [], {}
    submit, poll = engine.submit, engine.poll

    def submit_and_keep(*args, **kwargs):
        ids.append(submit(*args, **kwargs))
        return ids[-1]

    def poll_and_keep():
        out = poll()
        seen.update((r["id"], r) for r in out)
        return out

    engine.submit, engine.poll = submit_and_keep, poll_and_keep
    try:
        _, wall = replay_trace(engine, prompts, arrivals=list(arrivals),
                               max_new_tokens=[int(b) for b in budgets])
    finally:
        del engine.submit, engine.poll
    order = sorted(range(len(prompts)), key=lambda i: float(arrivals[i]))
    by_input = dict(zip(order, ids))
    return [seen[by_input[i]] for i in range(len(prompts))], wall


def _row_gaps(cfg, model, row, prompt_len, device):
    """Top-2 logit gaps over a row's new tokens, from one teacher-forced
    prefill."""
    import torch

    t = torch.as_tensor(row[None]).long().to(device)
    return _greedy_gaps(cfg, model, t, prompt_len)[0]


def tiny_serving_rest_parity(device="cuda"):
    """(a) The tiny fp32 Llama on the card and on the CPU: the engine at
    speculate_k 0, 2 and 4 greedy and over int8 pages, sampled speculation
    in two slot orders, int8 codes of one tensor on both devices,
    speculative_generate and beam_search."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (ServingConfig, ServingEngine, beam_search, generate,
                                      speculative_generate)
    from accelerate_tpu_torch.generation import quantize_kv_page

    cfg, cpu_model = _tiny_module("cpu")
    _, card_model = _tiny_module(device)
    rng = np.random.default_rng(4)
    lengths, budgets = [5, 12, 20, 7, 16, 9], [10, 7, 8, 12, 9, 6]
    prompts = [np.resize(rng.integers(1, cfg.vocab_size, 3), n) if i % 2
               else rng.integers(1, cfg.vocab_size, n) for i, n in enumerate(lengths)]
    base = dict(n_slots=3, max_len=28, prefill_chunks=[4, 8], speculate_ngram=8)

    def run(model, **kw):
        return _engine_rows(ServingEngine(model, ServingConfig(**base, **kw)), prompts, budgets)

    out, card = {"card_vs_cpu": {}, "spec_vs_k0": {}}, {}
    for name, kw in {"k0": {}, "k2": dict(speculate_k=2), "k4": dict(speculate_k=4),
                     "int8": dict(cache_dtype=torch.int8)}.items():
        ref, got = run(cpu_model, **kw), run(card_model, **kw)
        card[name] = got
        out["card_vs_cpu"][name] = [
            first_divergence([list(r["tokens"][len(p):])], [list(g["tokens"][len(p):])],
                             [_row_gaps(cfg, cpu_model, r["tokens"], len(p), "cpu")])[0]
            for p, r, g in zip(prompts, ref, got)]
        out[f"{name}_ok"] = all(r["status"] == "ok" for r in got)
    for name in ("k2", "k4"):
        out["spec_vs_k0"][name] = [
            first_divergence([list(a["tokens"][len(p):])], [list(b["tokens"][len(p):])],
                             [_row_gaps(cfg, card_model, a["tokens"], len(p), device)])[0]
            for p, a, b in zip(prompts, card["k0"], card[name])]
        out[f"{name}_accepted"] = sum(r["accepted"] for r in card[name])

    out["sampled_follow_generators"] = {}
    for k in (2, 4):
        scfg = ServingConfig(**base, speculate_k=k, temperature=0.9, top_k=40)
        runs = []
        for order in (list(range(6)), [5, 3, 1, 0, 2, 4]):
            engine = ServingEngine(card_model, scfg)
            ids = [engine.submit(prompts[i], max_new_tokens=budgets[i],
                                 generator=torch.Generator(device=device).manual_seed(100 + i))
                   for i in order]
            rows = _drain(engine)
            runs.append({i: rows[rid]["tokens"].tolist() for i, rid in zip(order, ids)})
        out["sampled_follow_generators"][f"k{k}"] = runs[0] == runs[1]

    x = np.random.default_rng(5).standard_normal((3, 4, 2, 128)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 0, :16] = np.asarray([127, -127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                                  -126.5, 0, 4.5, 5.5, -3.5, 64.5]) * 2.0 ** -3
    x[0, 1, 0, 16:] = 0.0
    codes = {}
    for name, t in {"halves": torch.from_numpy(x),
                    "bf16_rows": torch.from_numpy(x).bfloat16()}.items():
        a, b = quantize_kv_page(t), quantize_kv_page(t.to(device))
        codes[name] = (torch.equal(a.data, b.data.cpu()) and torch.equal(a.scale, b.scale.cpu()))
    out["int8_codes_bit_equal"] = codes

    prompt = rng.integers(1, cfg.vocab_size, (1, 12))
    ref = generate(cpu_model, prompt, max_new_tokens=16)
    gaps = _greedy_gaps(cfg, cpu_model, ref, 12)
    spec = {dev: speculative_generate(m, m, prompt, 16, num_draft_tokens=3).cpu()
            for dev, m in (("cpu", cpu_model), ("card", card_model))}
    out["speculative_generate"] = first_divergence(
        ref[:, 12:].tolist(), spec["card"][:, 12:].tolist(), gaps)
    out["speculative_generate_cpu_equal"] = torch.equal(spec["cpu"], ref)
    card_greedy = generate(card_model, prompt, max_new_tokens=16).cpu()
    beams = {n: beam_search(card_model, prompt, 16, num_beams=n).cpu() for n in (1, 4)}
    out["beam1_vs_greedy"] = first_divergence(card_greedy[:, 12:].tolist(),
                                              beams[1][:, 12:].tolist(), gaps)
    out["beam4_card_equals_cpu"] = torch.equal(
        beams[4], beam_search(cpu_model, prompt, 16, num_beams=4))
    return out


def tiny_rest_ok(res) -> bool:
    return (all(parity_ok(v) for v in res["card_vs_cpu"].values())
            and all(parity_ok(v) for v in res["spec_vs_k0"].values())
            and all(res[f"{n}_ok"] for n in ("k0", "k2", "k4", "int8"))
            and all(res["sampled_follow_generators"].values())
            and all(res["int8_codes_bit_equal"].values())
            and parity_ok(res["speculative_generate"]) and parity_ok(res["beam1_vs_greedy"]))


def _windowed_logits(cfg, model, row, prompt_len, width, device):
    """fp32 logits predicting row[prompt_len:] from the prompt's prefill
    and then windows of ``width`` tokens (width 1: the one-token decode
    path; width k+1: the verify forward's shape)."""
    import torch

    from accelerate_tpu_torch import generation as gen

    ids = torch.as_tensor(row[None]).long().to(device)
    t = ids.shape[1]
    cache = gen.init_cache(cfg, 1, t + width, device=device)
    fwd = plan_of(model)
    logits, cache = fwd(cfg, model, ids[:, :prompt_len], cache)
    out = [logits]
    pos = prompt_len
    while pos < t - 1:
        chunk = ids[:, pos:min(pos + width, t - 1)]
        logits, cache = fwd(cfg, model, chunk, cache, return_all=True)
        out.extend(logits[:, j] for j in range(chunk.shape[1]))
        pos += chunk.shape[1]
    return torch.stack(out, dim=1)[0]  # (new tokens, V)


def bf16_tie_gap(cfg, model, rows, prompt_lens, k, device):
    """The bf16 tie gap, from this run: over sample rows, the largest
    difference ``delta`` of one logit computed by two of three paths (one
    prefill over the row, which the gaps come from; the one-token decode
    path; (k+1)-token windows). A k row can part from its 0 row where the
    one-token and window paths swap the top two (a gap under 2 delta by the
    one-token path), which the prefill path sees under 4 delta. Returns
    (4 delta, delta)."""
    import torch

    from accelerate_tpu_torch import generation as gen

    delta = 0.0
    for row, p in zip(rows, prompt_lens):
        ids = torch.as_tensor(row[None]).long().to(device)
        full, _ = plan_of(model)(cfg, model, ids, gen.init_cache(
            cfg, 1, ids.shape[1], device=device), return_all=True)
        paths = [full[0, p - 1:-1], _windowed_logits(cfg, model, row, p, 1, device),
                 _windowed_logits(cfg, model, row, p, k + 1, device)]
        delta = max(delta, *(float((a - b).abs().max())
                             for a, b in ((paths[0], paths[1]), (paths[1], paths[2]))))
    return 4 * delta, delta


def phase8_run(phase8) -> dict:
    """Phase 8's replay of its trace (``full_width_serving`` with
    ``keep_rows``: the same weights, engine settings and arrivals) as (b)'s
    speculate_k=0 run on that trace, in (b)'s row format: every request
    came back ``ok`` (phase 8's gate), none drafted."""
    stats = phase8["stats"]
    rows = [{"tokens": r, "status": "ok", "drafted": 0, "accepted": 0} for r in phase8["rows"]]
    return {"rows": rows, "wall_s": phase8["wall_s"], "tok_s": phase8["tok_s"],
            "ttft_p50_s": stats["ttft_p50_s"], "ttft_p95_s": stats["ttft_p95_s"],
            "speculation": stats["speculation"], "decode_steps": stats["decode_steps"],
            "peak_mem_gib": phase8["peak_mem_gib"], "statuses_ok": True,
            "counts_ok": speculation_counts_ok(rows, stats["speculation"]),
            "decode_ticks": phase8["decode_ticks"], "from_phase8": True}


def speculation_at_width(module, row=SERVING_ROW, rest=SERVING_REST, device="cuda",
                         phase8=None):
    """(b) The engine at speculate_k 0 and k on phase 8's trace and on the
    same arrivals with repetitive prompts (a motif repeated), with decode
    ticks profiled on phase 8's trace; the k runs' greedy rows against the
    0 runs' under the bf16 tie gap derived here. With ``phase8`` (its rows
    kept) phase 8's own replay stands for the 0 run on its trace, which it
    would repeat."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine

    cfg, vocab, k = module.config, module.config.vocab_size, rest["spec_k"]
    lengths, budgets, prompts, arrivals = serving_trace(vocab, **row)
    rng = np.random.default_rng(16)
    motifs = [np.tile(rng.integers(1, vocab, rest["motif"]), rest["motif_repeats"])
              for _ in prompts]
    runs, caches = {}, {}
    for trace, trace_prompts in (("phase8", prompts), ("repetitive", motifs)):
        t_cap = int(max(len(p) + b for p, b in zip(trace_prompts, budgets))) + 8
        for kk in (0, k):
            if trace == "phase8" and kk == 0 and phase8 is not None:
                runs[trace, kk] = phase8_run(phase8)
                caches[kk] = {"t_max": phase8["max_len"], "bytes": phase8["kv_cache_bytes"]}
                continue
            engine = ServingEngine(Model(module), ServingConfig(
                n_slots=row["slots"], max_len=t_cap, max_prefill_chunk=max(16, row["prompt_len"]),
                speculate_k=kk, speculate_ngram=rest["spec_ngram"]))
            engine.warmup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rows, wall = _replay_rows(engine, trace_prompts, arrivals, budgets)
            stats = engine.stats()
            runs[trace, kk] = {
                "rows": rows, "wall_s": wall, "tok_s": stats["tokens_out"] / wall,
                "ttft_p50_s": stats["ttft_p50_s"], "ttft_p95_s": stats["ttft_p95_s"],
                "speculation": stats["speculation"], "decode_steps": stats["decode_steps"],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "statuses_ok": all(r["status"] == "ok" for r in rows),
                "counts_ok": speculation_counts_ok(rows, stats["speculation"])}
            if trace == "phase8":
                runs[trace, kk]["decode_ticks"] = decode_tick_profile(engine, vocab)
                caches[kk] = {"t_max": engine.t_max,
                              "bytes": engine._cache.k.nbytes + engine._cache.v.nbytes}
    # The tie gap from the run, and each k row's first parting from its 0 row.
    sample = runs["phase8", 0]["rows"][:rest["tie_rows"]]
    tie_gap, delta = bf16_tie_gap(cfg, module, [r["tokens"] for r in sample],
                                  [len(p) for p in prompts[:rest["tie_rows"]]], k, device)
    divergences = {}
    for trace, trace_prompts in (("phase8", prompts), ("repetitive", motifs)):
        out = []
        for p, a, b in zip(trace_prompts, runs[trace, 0]["rows"], runs[trace, k]["rows"]):
            new_a, new_b = list(a["tokens"][len(p):]), list(b["tokens"][len(p):])
            if new_a == new_b:
                out.append(None)
                continue
            gaps = _row_gaps(cfg, module, a["tokens"], len(p), device)
            out.append(first_divergence([new_a], [new_b], [gaps], tie_gap=tie_gap)[0])
        divergences[trace] = out
    report = {f"{trace}_k{kk}": {key: v for key, v in r.items() if key != "rows"}
              for (trace, kk), r in runs.items()}
    checks = {
        "statuses_ok": all(r["statuses_ok"] for r in runs.values()),
        "counts_ok": all(r["counts_ok"] for r in runs.values()),
        "greedy_rows_equal_k0": all(parity_ok(v) for v in divergences.values()),
        "repetitive_acceptance": (runs["repetitive", k]["speculation"]["acceptance_rate"]
                                  or 0) > 0}
    return {"runs": report, "bf16_tie_gap": tie_gap, "bf16_logit_delta": delta,
            "divergences": divergences, "checks": checks,
            "_rows": runs["phase8", 0]["rows"], "_cache": caches[0], "_trace": (
                lengths, budgets, prompts, arrivals)}


def int8_pages_at_width(module, bf16, row=SERVING_ROW, device="cuda"):
    """(c) Phase 8's trace over int8 KV pages beside (b)'s bf16 k=0 run:
    statuses, the cache's bytes, the first decode step's logits against
    the bf16 cache's, tok/s, ticks, peak memory and agreeing tokens."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine
    from accelerate_tpu_torch import generation as gen

    cfg, vocab = module.config, module.config.vocab_size
    lengths, budgets, prompts, arrivals = bf16["_trace"]
    ref_cache = bf16["_cache"]
    engine = ServingEngine(Model(module), ServingConfig(
        n_slots=row["slots"], max_len=ref_cache["t_max"],
        max_prefill_chunk=max(16, row["prompt_len"]), cache_dtype=torch.int8))
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, wall = _replay_rows(engine, prompts, arrivals, budgets)
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ticks = decode_tick_profile(engine, vocab)
    int8_bytes = engine._cache.k.nbytes + engine._cache.v.nbytes
    bf16_bytes = ref_cache["bytes"]

    # The first decode step after a prefill of 8 prompts of 64 tokens, fed
    # the same tokens (the bf16 cache's greedy ones) over both caches.
    ids = torch.from_numpy(np.random.default_rng(17).integers(
        1, vocab, (row["slots"], 64))).to(device)
    logits, nxt = {}, None
    for name, dtype in (("bf16", None), ("int8", torch.int8)):
        cache = gen.init_cache(cfg, row["slots"], 72, dtype=dtype, device=device)
        first, cache = gen._llama_forward_cached(cfg, module, ids, cache)
        nxt = torch.argmax(first, -1)[:, None] if nxt is None else nxt
        logits[name], _ = gen._llama_forward_cached(cfg, module, nxt, cache)
    diff = logits["int8"] - logits["bf16"]
    rel = float(diff.norm() / logits["bf16"].norm())
    new = [(a["tokens"][len(p):], b["tokens"][len(p):])
           for p, a, b in zip(prompts, bf16["_rows"], rows)]
    agree = float(np.mean(np.concatenate([a == b for a, b in new])))
    bf16_ticks = bf16["runs"]["phase8_k0"]["decode_ticks"]
    return {
        "tok_s": stats["tokens_out"] / wall, "bf16_tok_s": bf16["runs"]["phase8_k0"]["tok_s"],
        "ttft_p50_s": stats["ttft_p50_s"], "ttft_p95_s": stats["ttft_p95_s"],
        "peak_mem_gib": peak, "bf16_peak_mem_gib": bf16["runs"]["phase8_k0"]["peak_mem_gib"],
        "cache_bytes": int8_bytes, "bf16_cache_bytes": bf16_bytes,
        "bytes_ratio": int8_bytes / bf16_bytes,
        "bytes_ratio_expected": (cfg.head_dim + 4) / (2 * cfg.head_dim),
        "first_decode_logits_rel_err": rel, "first_decode_logits_max_abs_err":
            float(diff.abs().max()), "rel_err_limit": INT8_LOGIT_REL,
        "greedy_tokens_agree_bf16": agree, "decode_ticks": ticks,
        "dequant_device_ms_per_tick": (
            ticks["device_busy_ms_per_tick"] - bf16_ticks["device_busy_ms_per_tick"]),
        "checks": {"statuses_ok": all(r["status"] == "ok" for r in rows),
                   "bytes_ratio": int8_bytes_ok(int8_bytes, bf16_bytes, cfg.head_dim),
                   "first_decode_logits": rel <= INT8_LOGIT_REL}}


def admission_at_width(module, tie_gap, row=SERVING_ROW, rest=SERVING_REST, device="cuda"):
    """(d) Admission control and the fault paths on one engine at full
    width: a burst into a bounded queue under each policy, deadlines that
    expire mid-decode, NaN in a live slot's cache rows, then every live
    slot poisoned until the hang guard raises."""
    import dataclasses

    import numpy as np

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine, ServingStalledError

    cfg, vocab = module.config, module.config.vocab_size
    rng = np.random.default_rng(18)
    engine = ServingEngine(Model(module), ServingConfig(
        n_slots=row["slots"], max_len=rest["burst_prompt"] + rest["deadline_budget"] + 8))
    engine.warmup()
    out, checks = {"burst": {}}, {}

    def configure(**kw):
        engine.config = dataclasses.replace(engine.config, **kw)
        engine.reset_metrics()

    burst = [rng.integers(1, vocab, rest["burst_prompt"]) for _ in range(rest["burst"])]
    for policy in ("reject", "shed_oldest", "block"):
        configure(max_queue_depth=rest["queue_depth"], overload_policy=policy)
        rows = _engine_rows(engine, burst, [rest["burst_budget"]] * rest["burst"])
        shed = [i for i, r in enumerate(rows) if r["status"] == "shed"]
        out["burst"][policy] = {"shed": shed, "faults": engine.fault_stats(),
                                "window": engine.window_stats()}
        checks[f"burst_{policy}"] = (
            shed == expected_shed(policy, rest["burst"], rest["queue_depth"])
            and all(r["status"] == "ok" for i, r in enumerate(rows) if i not in shed))

    configure(max_queue_depth=None)
    n = row["slots"]
    timed = [rng.integers(1, vocab, rest["burst_prompt"]) for _ in range(n)]
    ids = [engine.submit(p, max_new_tokens=rest["deadline_budget"],
                         deadline_s=rest["deadline_s"]) for p in timed]
    after = [engine.submit(p, max_new_tokens=rest["burst_budget"]) for p in burst[:n]]
    done = _drain(engine)
    dl, rows = [done[i] for i in ids], [done[i] for i in after]
    stats = engine.stats()
    out["deadline"] = {"new_tokens": [r["new_tokens"] for r in dl],
                       "statuses": [r["status"] for r in dl],
                       "slot_reuses": stats["slot_reuses"], "faults": engine.fault_stats(),
                       "window": engine.window_stats()}
    checks["deadline"] = (len(dl) == n and all(r["status"] == "timeout" for r in dl)
                          and any(0 < r["new_tokens"] < rest["deadline_budget"] for r in dl)
                          and all(r["status"] == "ok" for r in rows)
                          and stats["slot_reuses"] >= n)

    configure()
    victims = burst[:4]
    clean = _engine_rows(engine, victims, [rest["poison_budget"]] * 4)
    ids = [engine.submit(p, max_new_tokens=rest["poison_budget"]) for p in victims]
    while engine._queue or engine._prefilling:
        engine.tick()
    engine.tick()
    slot = next(s for s, r in engine._decoding.items() if r.id == ids[0])
    engine._cache.k[:, slot] = float("nan")
    engine._cache.v[:, slot] = float("nan")
    done = _drain(engine)
    got = [done[i] for i in ids]
    div = [first_divergence([list(c["tokens"][len(p):])], [list(g["tokens"][len(p):])],
                            [_row_gaps(cfg, module, c["tokens"], len(p), device)],
                            tie_gap=tie_gap)[0]
           if list(c["tokens"]) != list(g["tokens"]) else None
           for p, c, g in zip(victims, clean, got)]
    out["poison"] = {"slot": slot, "attempts": [r["attempt"] for r in got],
                     "statuses": [r["status"] for r in got], "divergence": div,
                     "faults": engine.fault_stats(), "window": engine.window_stats()}
    checks["poison"] = (all(r["status"] == "ok" for r in got) and got[0]["attempt"] == 2
                        and parity_ok(div) and engine.fault_stats()["slot_quarantines"] == 1)

    configure(max_idle_ticks=rest["idle_ticks"])
    live = len(engine._free)
    for p in burst[:live]:
        engine.submit(p, max_new_tokens=rest["deadline_budget"])
    while engine._queue or engine._prefilling:
        engine.tick()
    for s in list(engine._decoding):
        engine._cache.k[:, s] = float("nan")
        engine._cache.v[:, s] = float("nan")
    ticks, error = 0, None
    try:
        while engine.pending and ticks <= 10 * rest["idle_ticks"]:
            ticks += 1
            engine.tick()
    except ServingStalledError as exc:
        error = str(exc)
    out["stall"] = {"ticks_to_raise": ticks, "error": error, "faults": engine.fault_stats(),
                    "window": engine.window_stats()}
    checks["stall"] = error is not None and ticks <= 1 + rest["idle_ticks"] and \
        f"{row['slots']}/{row['slots']} slots quarantined" in error
    out["checks"] = checks
    return out


def _sequence_score(cfg, model, row, prompt_len, length_penalty=1.0):
    """A sequence's length-normalised log-probability from one
    teacher-forced forward."""
    import torch

    from accelerate_tpu_torch import generation as gen

    ids = row.long()
    logits, _ = gen._llama_forward_cached(cfg, model, ids, gen.init_cache(
        cfg, 1, ids.shape[1], device=ids.device), return_all=True)
    logp = torch.log_softmax(logits[0, prompt_len - 1:-1], dim=-1)
    new = ids[0, prompt_len:]
    return float(logp.gather(1, new[:, None]).sum()) / new.numel() ** length_penalty


def generation_rest_at_width(module, tie_gap, rest=SERVING_REST, device="cuda",
                             width=FULL_WIDTH, n_new=GEN_NEW_TOKENS, prompt_len=GEN_PROMPT):
    """(e) bench.py's decode row (prompt (1, 64), 32 new tokens) through
    speculative_generate with the target as its own draft and with a
    2-layer draft, and through beam_search: tokens against greedy
    generate(), target passes and ms per token."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import beam_search, generate, speculative_generate
    from accelerate_tpu_torch import generation as gen
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = module.config
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, prompt_len))).to(device)

    def timed(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / n_new

    greedy, greedy_ms = timed(lambda: generate(module, prompt, max_new_tokens=n_new))
    gaps = _row_gaps(cfg, module, greedy[0].cpu().numpy(), prompt_len, device)
    dcfg = LlamaConfig(**dict(width, num_hidden_layers=rest["draft_layers"]),
                       max_position_embeddings=cfg.max_position_embeddings, dtype=cfg.dtype)
    draft = LlamaForCausalLM(dcfg, device=device)
    draft.init_weights(torch.Generator(device=device).manual_seed(1))
    draft.to(cfg.dtype)
    plan = gen.GENERATION_PLANS["LlamaForCausalLM"]
    out = {"greedy_ms_per_token": greedy_ms}
    for name, d in (("self_draft", module), ("small_draft", draft)):
        windows = [0]

        def counted(*args, **kw):
            windows[0] += bool(kw.get("return_all"))
            return plan(*args, **kw)

        gen.GENERATION_PLANS["LlamaForCausalLM"] = counted
        try:
            got, ms = timed(lambda: speculative_generate(
                module, d, prompt, n_new, num_draft_tokens=rest["draft_tokens"]))
        finally:
            gen.GENERATION_PLANS["LlamaForCausalLM"] = plan
        # Per call (the warm-up's and the timed one's windows are counted):
        # the prefill, each window, and a rewind after every window but the
        # last.
        per_call = windows[0] // 2
        out[name] = {"ms_per_token": ms, "target_passes": 2 * per_call, "windows": per_call,
                     "divergence": first_divergence(
                         greedy[:, prompt_len:].tolist(), got[:, prompt_len:].tolist(), [gaps],
                         tie_gap=tie_gap)[0]}
    del draft
    beams, beam_ms = timed(lambda: beam_search(module, prompt, n_new, num_beams=rest["beams"]))
    scores = {"beam": _sequence_score(cfg, module, beams, prompt_len),
              "greedy": _sequence_score(cfg, module, greedy, prompt_len)}
    out["beam_search"] = {"ms_per_token": beam_ms, "num_beams": rest["beams"],
                          "score": scores["beam"], "greedy_score": scores["greedy"],
                          "equals_greedy": torch.equal(beams, greedy)}
    out["checks"] = {
        "self_draft": out["self_draft"]["divergence"] is None
        or out["self_draft"]["divergence"]["near_tie"],
        "small_draft": out["small_draft"]["divergence"] is None
        or out["small_draft"]["divergence"]["near_tie"],
        "beam_score": scores["beam"] >= scores["greedy"] - BEAM_SCORE_REL * abs(scores["greedy"])}
    return out


def serving_rest_phase(hf, phase7=None, device="cuda", width=FULL_WIDTH, row=SERVING_ROW,
                       rest=SERVING_REST, phase8=None):
    """Phase 16: (a) tiny parity on the card; (b)-(e) at full width with
    phase 8's 1.06B bf16 Llama (weights from seed 0); ``phase8``: phase 8's
    replay with its rows, which (b) reuses. No flash kernel lies on this
    path: the launches, counted from zero, are printed."""
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    hf.reset_launch_counts()
    tiny = tiny_serving_rest_parity(device)
    cfg = LlamaConfig(**width, max_position_embeddings=2048, dtype=torch.bfloat16)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    module.to(torch.bfloat16)
    spec = speculation_at_width(module, row, rest, device, phase8)
    tie_gap = spec["bf16_tie_gap"]
    int8 = int8_pages_at_width(module, spec, row, device)
    for key in ("_rows", "_cache", "_trace"):
        spec.pop(key)
    admission = admission_at_width(module, tie_gap, row, rest, device)
    generation = generation_rest_at_width(module, tie_gap, rest, device, width)
    launches = dict(hf.VARIANT_LAUNCHES)
    checks = {"tiny": tiny_rest_ok(tiny),
              **{f"speculation_{k}": v for k, v in spec["checks"].items()},
              **{f"int8_{k}": v for k, v in int8["checks"].items()},
              **{f"admission_{k}": v for k, v in admission["checks"].items()},
              **{f"generation_{k}": v for k, v in generation["checks"].items()}}
    del module
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "serving_rest", "tiny": tiny, "speculation": spec, "int8_pages": int8,
            "admission": admission, "generation": generation,
            "phase7_decode_ms_per_token": phase7, "variant_launches": launches,
            "phase_s": time.perf_counter() - t0, "checks": checks, "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 17: the Llama decoder chassis, and Gemma-2B at full width
# ---------------------------------------------------------------------------

# google/gemma-2b's config.json (Hugging Face Hub), as gemma_config_from_hf
# reads it: GeGLU, norm weights computed as w + 1, embeddings scaled by
# sqrt(hidden), tied; 2,506,172,416 parameters.
GEMMA_2B = dict(model_type="gemma", vocab_size=256000, hidden_size=2048,
                intermediate_size=16384, num_hidden_layers=18, num_attention_heads=8,
                num_key_value_heads=1, head_dim=256, max_position_embeddings=8192,
                rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)
# (b): batch 2 x seq 2048, 2 warm-up and 5 timed steps, the fused loss in
# chunks of 256; (d): phase 8's trace cut to 16 requests.
GEMMA_ROW = dict(batch=2, seq=2048, warmup=2, timed=5, chunk_size=256, requests=16)
# (a): phase 4's tiny width with Gemma's knobs, and with Granite's constants,
# biases, layernorm, an ungated MLP and partial rotary.
CHASSIS_KNOBS = {
    "gemma": dict(hidden_act="gelu_tanh", rms_norm_plus_one=True, scale_embeddings=True,
                  tie_word_embeddings=True),
    "granite_bias": dict(norm_type="layernorm", attention_bias=True, attention_out_bias=True,
                         mlp_bias=True, mlp_gated=False, partial_rotary_factor=0.5,
                         embedding_multiplier=3.0, residual_multiplier=0.5,
                         attention_multiplier=0.08, logits_scaling=2.0,
                         hidden_act="gelu_pytorch_tanh"),
}
# The fused loss against the naive one on the same state: both losses on
# the learnt batch, and on an unseen batch the losses and the fused loss's
# gradient norm against the naive step's (bf16 logits either way; the sums
# differ in order).
FUSED_LOSS_REL = 1e-3
# (e): a tiny Gemma written as a Hugging Face checkpoint and read back.
TINY_GEMMA = dict(GEMMA_2B, vocab_size=256, hidden_size=128, intermediate_size=384,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                  head_dim=64, max_position_embeddings=512)


def _chassis_step_inputs(knobs):
    """Phase 4's tiny bf16 Llama (remat "dots") with ``knobs``:
    numpy-seeded weights (matrices and biases of std 0.02, norm weights of
    one, zero for Gemma's w + 1) and one batch."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, remat=True, remat_policy="dots", **knobs)
    rng = np.random.default_rng(0)
    weights = {}
    for n, p in LlamaForCausalLM(cfg, device="meta").state_dict().items():
        if p.dim() == 1 and not n.endswith("bias"):
            a = np.full(p.shape, 0.0 if cfg.rms_norm_plus_one else 1.0, np.float32)
        else:
            a = (rng.standard_normal(p.shape) * 0.02).astype(np.float32)
        weights[n] = torch.from_numpy(a)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 129)).astype(np.int64)
    return cfg, weights, {"x": ids[:, :-1], "y": ids[:, 1:]}


def tiny_chassis_parity(device="cuda"):
    """(a) One bf16 step of each tiny chassis on `device` (the kernels) and
    on the CPU (the plain versions): loss and grad norm within phase 4's
    tolerance."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    out = {}
    for name, knobs in CHASSIS_KNOBS.items():
        cfg, weights, batch = _chassis_step_inputs(knobs)
        res = {}
        for label, cpu in (("card", device == "cpu"), ("cpu", True)):
            PartialState._reset_state()
            res[label], _ = tiny_step(cfg, weights, batch, cpu)
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        rel = {k: abs(res["card"][k] - res["cpu"][k]) / abs(res["cpu"][k])
               for k in ("loss", "grad_norm")}
        out[name] = {**res, "rel": rel,
                     "ok": all(math.isfinite(v) for r in res.values() for v in r.values())
                     and max(rel.values()) <= 2e-2}
    return out


def gemma_train_steps(hf, device="cuda", width=GEMMA_2B, row=GEMMA_ROW):
    """(b) Gemma-2B's train step (seeded random weights, bf16 compute over
    fp32 masters, adamw, clipping, remat "dots", flash attention, the fused
    loss) on one fixed batch: the counted run, a profile of two more steps,
    then both losses on that batch, and the fused loss's backward and one
    step of the naive loss on the same state and a second batch."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Model, adamw
    from accelerate_tpu_torch.models import (
        LlamaForCausalLM,
        cross_entropy_loss,
        fused_cross_entropy_loss,
    )
    from accelerate_tpu_torch.models.hub import gemma_config_from_hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    seq, bs, chunk = row["seq"], row["batch"], row["chunk_size"]
    cfg = dataclasses.replace(gemma_config_from_hf(width), dtype=torch.bfloat16, remat=True,
                              remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(),
                      cpu=device == "cpu")
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    n_params = model.num_parameters()
    step = acc.prepare_train_step(
        lambda m, b: fused_cross_entropy_loss(m, b["x"], b["y"], chunk_size=chunk),
        max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(bs, seq + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    state, n_steps = acc.train_state, row["warmup"] + row["timed"]

    # The main path of this phase: counts from 0 just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    losses = []
    for _ in range(row["warmup"]):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(row["timed"]):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / row["timed"]
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak_fused = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    profile = profile_steps(step, state, batch, dt * 1e3, steps=1)

    # Both losses on the same state, each pair through one call path (a
    # forward outside the step's compute cast against the step's own loss
    # differs by more than the two losses do): on the fixed batch, learnt
    # by now (loss near 0.02), two forwards; on a batch the steps have not
    # seen, the fused loss's backward (no update) and one step of the naive
    # loss. Losses and gradient norms held to FUSED_LOSS_REL.
    def fused(m, b):
        return fused_cross_entropy_loss(m, b["x"], b["y"], chunk_size=chunk)

    def naive(m, b):
        return cross_entropy_loss(m(b["x"]), b["y"])

    with torch.no_grad():
        learnt = {"fused_loss": float(fused(model, batch)),
                  "naive_loss": float(naive(model, batch))}
    learnt["rel"] = abs(learnt["fused_loss"] - learnt["naive_loss"]) / abs(learnt["naive_loss"])
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(bs, seq + 1))
    held = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
            "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    state.optimizer.zero_grad(set_to_none=True)  # the last step's gradients
    fused_loss = float(acc.backward(fused, held))
    fused_grad_norm = float(acc.clip_grad_norm_(None, 1.0))
    naive_step = acc.prepare_train_step(naive, max_grad_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = naive_step(state, held)
    naive_loss, naive_grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    peak_naive = torch.cuda.max_memory_allocated() / 2**30
    fused_naive_rel = {"loss": abs(fused_loss - naive_loss) / abs(naive_loss),
                       "grad_norm": abs(fused_grad_norm - naive_grad_norm) / naive_grad_norm}

    tok_s = bs * seq / dt
    flops_per_token = 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq
    want = {hf.variant(k, torch.bfloat16, hf.built_head_dim(cfg.head_dim)): cfg.num_hidden_layers
            * n_steps for k in KERNELS}
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        "losses_fall": losses[-1] < losses[0],
        # remat "dots" keeps the forward's outputs: one launch of each kernel
        # per layer and step, all of the bf16 head-dim-256 variant.
        "flash_launches": launches == {k: cfg.num_hidden_layers * n_steps for k in KERNELS}
        and variant_launches == want,
        "fused_equals_naive": max(*fused_naive_rel.values(), learnt["rel"]) <= FUSED_LOSS_REL,
    }
    del acc, model, module, state, step, naive_step, batch, held
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "config": {k: getattr(cfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "hidden_act",
            "rms_norm_plus_one", "scale_embeddings", "tie_word_embeddings")},
        "n_params": n_params, "batch": bs, "seq": seq, "chunk_size": chunk,
        "steps": n_steps, "step_ms": dt * 1e3, "tok_s": tok_s,
        "mfu": tok_s * flops_per_token / PEAK_BF16_FLOPS, "losses": losses,
        "ln_vocab": math.log(cfg.vocab_size),
        "launches": launches, "variant_launches": variant_launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "peak_mem_gib": {"fused_loss_step": peak_fused, "naive_loss_step": peak_naive},
        "fused_loss": fused_loss, "naive_loss": naive_loss,
        "fused_grad_norm": fused_grad_norm, "naive_grad_norm": naive_grad_norm,
        "fused_naive_rel": fused_naive_rel, "learnt_batch": learnt,
        "profile": profile, "checks": checks,
    }


def hub_round_trip(device="cuda", width=TINY_GEMMA):
    """A tiny model of `width`'s family (phase 17 (e): Gemma; phase 18 (f):
    Mixtral) written as a Hugging Face checkpoint (its state dict through
    the family's ``*_params_to_hf``, the port's safetensors writer and a
    config.json) and read back by ``model_from_pretrained``: its logits
    equal the source model's bit for bit."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import model_from_pretrained
    from accelerate_tpu_torch.models.hub import _FAMILIES
    from accelerate_tpu_torch.utils.other import save_safetensors

    cls, config_from_hf, _, to_hf = _FAMILIES[width["model_type"]]
    cfg = config_from_hf(width)
    module = cls(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(1), std=0.2)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64)))
    ids = ids.to(device)
    with tempfile.TemporaryDirectory() as tmp:
        save_safetensors(to_hf(cfg, module.state_dict()),
                         os.path.join(tmp, "model.safetensors"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(width, f)
        loaded = model_from_pretrained(tmp, dtype=cfg.dtype, device=device)
    with torch.no_grad():
        want, got = module(ids), loaded(ids)
    return {"config": width, "n_tensors": len(module.state_dict()),
            "bit_equal": bool(torch.equal(got, want)),
            "max_abs_diff": float((got.float() - want.float()).abs().max())}


def chassis_phase(hf, device="cuda", width=GEMMA_2B, row=GEMMA_ROW,
                  serving_row=SERVING_ROW, tiny_gemma=TINY_GEMMA):
    """Phase 17: (a) the tiny chassis card against CPU, (b) Gemma-2B's
    train step, (c) its decode row, (d) its engine, (e) the hub round
    trip. `width`, `row`, `serving_row` and `tiny_gemma` shrink it for a
    rehearsal on the CPU."""
    import torch

    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.models.hub import gemma_config_from_hf

    t0 = time.perf_counter()
    part_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t
        return out

    tiny = timed("tiny", tiny_chassis_parity, device)
    train = timed("train", gemma_train_steps, hf, device, width, row)
    cfg = dataclasses.replace(gemma_config_from_hf(width), dtype=torch.bfloat16)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    module.to(torch.bfloat16)
    decode = timed("decode", decode_row, cfg, module, width, device)
    serving = timed("serving", full_width_serving, module,
                    dict(serving_row, requests=row["requests"]))
    del module
    gc.collect()
    torch.cuda.empty_cache()
    hub = timed("hub", hub_round_trip, device, tiny_gemma)
    checks = {**{f"tiny_{k}": v["ok"] for k, v in tiny.items()},
              **{f"train_{k}": v for k, v in train["checks"].items()},
              "decode": all(v["tokens_in_vocab"] and v["logits_finite"]
                            for v in decode["variants"].values()),
              "serving": serving["ok"], "hub_bit_equal": hub["bit_equal"]}
    return {"phase": "chassis", "tiny": tiny, "gemma_2b_train": train, "gemma_2b_decode": decode,
            "gemma_2b_serving": serving, "hub_round_trip": hub,
            "phase_s": time.perf_counter() - t0, "part_s": part_s, "checks": checks,
            "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 18: the Mixtral family at Mixtral-8x7B's width, and cp_generate
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json (Hugging Face Hub), as
# mixtral_config_from_hf reads it: 8 experts, top 2, 32 query heads over 8
# KV heads of dim 128; 1,451.3M parameters a layer, 262.1M for the
# embedding and head.
MIXTRAL_8X7B = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=32768, rms_norm_eps=1e-5,
                    rope_theta=1e6, num_local_experts=8, num_experts_per_tok=2,
                    router_aux_loss_coef=0.02, hidden_act="silu", sliding_window=None,
                    tie_word_embeddings=False)
# Depth is the only cut: the train step at 2 layers (about 18 bytes a
# parameter: 57 GB at 2 layers, 83 GB at 3), decode and the engine at 8
# layers in bf16 (23.7 GB of weights). (b): batch 2 x seq 2048, 2 warm-up
# and 5 timed steps; (d): phase 8's trace cut to 16 requests.
MIXTRAL_ROW = dict(batch=2, seq=2048, warmup=2, timed=5, train_layers=2, decode_layers=8,
                   requests=16)
# (a): phase 4's tiny width with 4 experts, top 2 and capacity factor 0.5,
# so that tokens drop.
TINY_MIXTRAL = dict(MIXTRAL_8X7B, vocab_size=256, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=512, num_local_experts=4, rope_theta=10000.0)
TINY_CAPACITY_FACTOR = 0.5
# (e): cp_generate at one process on phase 7's 1.06B Llama, prompt (1, 8192).
CP_ROW = dict(prompt_len=CP_GEN_LIKE["s"], new_tokens=32)
# (e): the largest difference of the kernel prefill's last logits from the
# plain bf16 prefill's, 2.3 times the readings on an H100 (0.107; PERF.md,
# phase 18 (e)).
CP_LOGITS_DELTA = 0.25


def _tiny_moe_inputs(width=TINY_MIXTRAL):
    """The tiny bf16 Mixtral (remat "dots", capacity factor 0.5) with
    numpy-seeded weights (matrices and expert stacks of std 0.02, the router
    of std 1/sqrt(hidden) so that few tokens sit at a routing tie, norm
    weights of one) and one batch."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import MixtralForCausalLM
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf

    cfg = dataclasses.replace(mixtral_config_from_hf(width), dtype=torch.bfloat16, remat=True,
                              remat_policy="dots", capacity_factor=TINY_CAPACITY_FACTOR)
    rng = np.random.default_rng(0)
    weights = {}
    for n, p in MixtralForCausalLM(cfg, device="meta").state_dict().items():
        if p.dim() == 1:
            a = np.ones(p.shape, np.float32)
        else:
            std = 1.0 / math.sqrt(cfg.hidden_size) if n.endswith("moe.router") else 0.02
            a = (rng.standard_normal(p.shape) * std).astype(np.float32)
        weights[n] = torch.from_numpy(a)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 129)).astype(np.int64)
    return cfg, weights, {"x": ids[:, :-1], "y": ids[:, 1:]}


def _moe_step(cfg, weights, batch, cpu):
    """One bf16 step of the tiny Mixtral through a fresh Accelerator: loss,
    aux loss, grad norm, each layer's routing (experts, kept, probs) and
    the inputs its router took (the layer's input and the router weight
    in the compute dtype, from the forward)."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, adamw
    from accelerate_tpu_torch.models import MixtralForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    module = MixtralForCausalLM(cfg)
    module.load_state_dict(weights)
    acc = Accelerator(mixed_precision="bf16", cpu=cpu)
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    aux = []

    def loss_fn(m, b):
        logits, a = m(b["x"], return_aux=True)
        aux.append(a.detach())
        return cross_entropy_loss(logits, b["y"]) + a

    inputs = []

    def keep_inputs(layer, args):
        if len(inputs) < cfg.num_hidden_layers:  # the forward's, not the recompute's
            inputs.append((args[0].detach().cpu(), layer.router.detach().cpu()))

    hooks = [blk.moe.register_forward_pre_hook(keep_inputs) for blk in module.model.layers]
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    _, metrics = step(acc.train_state, batch)
    for h in hooks:
        h.remove()
    routing = [{k: blk.moe.stats[k].cpu() for k in ("experts", "kept", "probs")}
               for blk in module.model.layers]
    for r, x in zip(routing, inputs):
        r["inputs"] = x
    return ({"loss": float(metrics["loss"]), "aux": float(aux[0]),
             "grad_norm": float(metrics["grad_norm"]),
             "dropped": int(module.router_stats()["dropped"])}, routing)


def routing_agreement(ref, got, k, tie_gaps=None, chosen_only=False):
    """Tokens whose routing differs between two runs, per layer, split by
    the reference's gap between its k-th and (k+1)-th router
    probabilities: those above the layer's tie gap (``tie_gaps``, else
    ``TIE_GAP``) must be none. Routing is the chosen experts in order and
    the kept mask, or with ``chosen_only`` the set of chosen experts (the
    kept mask then differs wherever one moved choice shifts its expert's
    queue, and is counted apart). The first differing token and the
    largest gap among the differing ones are reported."""
    import torch

    out = []
    for layer, (r, g) in enumerate(zip(ref, got)):
        tie_gap = TIE_GAP if tie_gaps is None else tie_gaps[layer]
        top = torch.sort(r["probs"], dim=-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        kept_differ = (r["kept"] != g["kept"]).any(-1)
        if chosen_only:
            differ = (r["experts"].sort(-1).values != g["experts"].sort(-1).values).any(-1)
        else:
            differ = (r["experts"] != g["experts"]).any(-1) | kept_differ
        where = differ.nonzero()[:, 0].tolist()
        out.append({"differ": len(where),
                    "differ_above_gap": int((differ & (gap > tie_gap)).sum()),
                    "excluded_near_tie": int((gap <= tie_gap).sum()), "tie_gap": tie_gap,
                    "first_differing": ({"token": where[0], "gap": float(gap[where[0]])}
                                        if where else None),
                    "largest_differing_gap": max((float(gap[i]) for i in where), default=None),
                    "kept_differ": int(kept_differ.sum())})
    return out


def router_input_tie_gaps(ref, got):
    """Per layer, the tie gap the two steps' router inputs allow, and how
    far those inputs lie apart: from each step's recorded inputs (the layer's
    input and the router weight in the compute dtype) the router
    probabilities by the same fp32 product on the CPU; twice their largest
    difference, plus ``TIE_GAP`` for the order of the product's sums. A
    token's chosen experts can part between the steps only where its k-th
    and (k+1)-th probabilities are closer than that. The inputs' distance
    is the relative error in norm."""
    from accelerate_tpu_torch.models.moe import router_probs

    gaps, rel = [], []
    for r, g in zip(ref, got):
        (x_r, w_r), (x_g, w_g) = r["inputs"], g["inputs"]
        p_r, p_g = (router_probs(x.reshape(-1, x.shape[-1]), w)
                    for x, w in ((x_r, w_r), (x_g, w_g)))
        gaps.append(2 * float((p_r - p_g).abs().max()) + TIE_GAP)
        rel.append(float((x_g.float() - x_r.float()).norm() / x_r.float().norm()))
    return gaps, rel


def same_input_routing(cfg, ref, device):
    """Each layer's routing on `device` from the inputs the reference's
    router took (``_moe_step``'s): the router's fp32 product, the top-k
    choice and the capacity queue, without the earlier layers' rounding."""
    from accelerate_tpu_torch.models.moe import expert_capacity, route, router_probs, \
        top_k_experts

    out = []
    for r in ref:
        x, w = r["inputs"]
        tokens = x.reshape(-1, x.shape[-1]).to(device)
        weights, experts = top_k_experts(router_probs(tokens, w.to(device)),
                                         cfg.num_experts_per_tok)
        got = route(weights, experts, cfg.num_local_experts,
                    expert_capacity(cfg, tokens.shape[0]))
        out.append({"experts": experts.cpu(), "kept": got.kept.cpu()})
    return out


def tiny_moe_parity(device="cuda", width=TINY_MIXTRAL):
    """(a) One bf16 step of the tiny Mixtral on `device` (the kernels) and
    on the CPU (the plain versions): loss, aux loss and grad norm within
    phase 4's tolerance, equal dropped counts. Routing, two ways: each
    layer's chosen experts of the two steps equal on every token whose
    k-th and (k+1)-th router probabilities lie further apart than the tie
    gap the two steps' router inputs allow (``router_input_tie_gaps``;
    those inputs within phase 4's tolerance of each other); and each
    layer's routing on the card from the CPU step's router inputs (the
    fp32 product, the top-k choice and the capacity queue) equal to the
    CPU's, kept mask included, above ``TIE_GAP``."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    cfg, weights, batch = _tiny_moe_inputs(width)
    res, routing = {}, {}
    for label, cpu in (("card", device == "cpu"), ("cpu", True)):
        PartialState._reset_state()
        res[label], routing[label] = _moe_step(cfg, weights, batch, cpu)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    rel = {k: abs(res["card"][k] - res["cpu"][k]) / abs(res["cpu"][k])
           for k in ("loss", "aux", "grad_norm")}
    k = cfg.num_experts_per_tok
    tie_gaps, inputs_rel = router_input_tie_gaps(routing["cpu"], routing["card"])
    steps = routing_agreement(routing["cpu"], routing["card"], k, tie_gaps, chosen_only=True)
    same = routing_agreement(routing["cpu"], same_input_routing(cfg, routing["cpu"], device), k)
    checks = {"finite": all(math.isfinite(v) for r in res.values() for v in r.values()),
              "rel": max(rel.values()) <= 2e-2,
              "dropped_equal": res["card"]["dropped"] == res["cpu"]["dropped"],
              "dropped_some": res["cpu"]["dropped"] > 0,
              "router_inputs_rel": max(inputs_rel) <= 2e-2,
              "routing_equal": all(a["differ_above_gap"] == 0 for a in steps),
              "same_input_routing_equal": all(a["differ_above_gap"] == 0 for a in same)}
    return {**res, "rel": rel, "capacity_factor": cfg.capacity_factor, "routing": steps,
            "router_inputs_rel": inputs_rel, "same_input_routing": same, "checks": checks,
            "ok": all(checks.values())}


def mixtral_active_params(cfg) -> dict:
    """Parameters a token runs through, as bench.py counts a dense model's:
    attention, router, k of the E experts and norms of every layer, the
    final norm, the embedding and the head. Capacity padding (the empty
    expert slots the products also run) is not counted."""
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    attn = 2 * h * cfg.num_attention_heads * d + 2 * h * cfg.num_key_value_heads * d
    layer = attn + h * cfg.num_local_experts + cfg.num_experts_per_tok * 3 * h * f + 2 * h
    return {"per_layer": layer, "embedding_and_head": 2 * cfg.vocab_size * h,
            "total": cfg.num_hidden_layers * layer + 2 * cfg.vocab_size * h + h}


# MoE parts of a step under torch.profiler: the layer's methods wrapped in
# record_function labels (the forward and the remat recompute), and the
# backward ops their kernels run under.
MOE_LABELS = (("route", "moe_router"), ("dispatch", "moe_dispatch"),
              ("experts", "moe_expert_products"), ("combine", "moe_combine"))
MOE_BACKWARD = {"BmmBackward0": "moe_expert_products", "IndexPutBackward0": "moe_dispatch",
                "IndexBackward0": "moe_combine", "ConstantPadNdBackward0": "moe_combine"}


def moe_profile(step, state, batch, step_ms, steps=2):
    """Two steps under torch.profiler: device-busy ms and idle share per
    step, ms by kernel category, and the MoE's router, dispatch, combine
    and expert products as categories of their own (forward, recompute and
    backward kernels), with the rest of the step beside them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from accelerate_tpu_torch.models.moe import MoeLayer

    originals = []
    for name, label in MOE_LABELS:
        inner = getattr(MoeLayer, name)

        def wrapped(*a, _inner=inner, _label=label, **k):
            with record_function(_label):
                return _inner(*a, **k)

        originals.append((name, inner))
        setattr(MoeLayer, name, wrapped)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
    finally:
        for name, inner in originals:
            setattr(MoeLayer, name, inner)
    busy, by_cat, top, _ = device_times(prof, steps)
    moe = dict.fromkeys(sorted({label for _, label in MOE_LABELS}), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        label = e.name if e.name in moe else next(
            (v for op, v in MOE_BACKWARD.items() if e.name.endswith(op)), None)
        if label is not None:
            moe[label] += e.device_time_total / 1e3 / steps
    return {"steps": steps, "device_busy_ms_per_step": busy, "step_ms": step_ms,
            "idle_share": 1.0 - busy / step_ms if top else None,
            "ms_per_step_by_category": by_cat, "moe_ms_per_step": moe,
            "rest_ms_per_step": busy - sum(moe.values()), "top_kernels_ms_per_step": top}


def mixtral_train_steps(hf, device="cuda", width=MIXTRAL_8X7B, row=MIXTRAL_ROW):
    """(b) The Mixtral-8x7B train step at ``row["train_layers"]`` layers
    (seeded random weights, bf16 compute over fp32 masters, adamw,
    clipping, remat "dots", flash attention, ``moe_cross_entropy_loss``) on
    one fixed batch, counted from zero; then one profiled step. Batch 1
    where batch 2 does not fit (said so in the result)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        Model,
        adamw,
        moe_cross_entropy_loss,
    )
    from accelerate_tpu_torch.models import MixtralForCausalLM
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    seq = row["seq"]
    cfg = dataclasses.replace(mixtral_config_from_hf(width),
                              num_hidden_layers=row["train_layers"], dtype=torch.bfloat16,
                              remat=True, remat_policy="dots", attention_impl="flash")
    out = {}
    for bs in (row["batch"], 1):
        for cls in (AcceleratorState, GradientState):
            cls._reset_state()
        gc.collect()
        torch.cuda.empty_cache()
        acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(),
                          cpu=device == "cpu")
        module = MixtralForCausalLM(cfg, device=acc.device)
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(
            lambda m, b: moe_cross_entropy_loss(m, b["x"], b["y"]), max_grad_norm=1.0)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(bs, seq + 1))
        batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
                 "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
        state, n_steps = acc.train_state, row["warmup"] + row["timed"]
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hf.reset_launch_counts()
            losses, norms, dropped = [], [], []
            for i in range(n_steps):
                if i == row["warmup"]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
                norms.append(metrics["grad_norm"])
                dropped.append(module.router_stats()["dropped"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / row["timed"]
        except torch.cuda.OutOfMemoryError as exc:
            if bs == 1:
                raise
            out["batch_fallback"] = f"batch {bs} ran out of memory: {str(exc)[:200]}"
            del acc, model, module, state, step, batch
            continue
        break
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    routed = module.router_stats()["routed"]
    dropped = [int(x) for x in dropped]
    dropped_share = [x / routed for x in dropped]
    profile = moe_profile(step, state, batch, dt * 1e3, steps=1)
    active = mixtral_active_params(cfg)
    tok_s = bs * seq / dt
    flops_per_token = 6 * active["total"] + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq
    want = {hf.variant(k, torch.bfloat16, cfg.head_dim): cfg.num_hidden_layers * n_steps
            for k in KERNELS}
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        "losses_fall": losses[-1] < losses[0],
        # remat "dots" keeps the forward's outputs: one launch of each kernel
        # per layer and step, all of the bf16 head-dim-128 variant.
        "flash_launches": launches == {k: cfg.num_hidden_layers * n_steps for k in KERNELS}
        and variant_launches == want,
    }
    n_params = model.num_parameters()
    del acc, model, module, state, step, batch
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    return {
        **out, "config": {k: getattr(cfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "num_local_experts",
            "num_experts_per_tok", "capacity_factor", "rope_theta")},
        "n_params": n_params, "active_params": active, "batch": bs, "seq": seq,
        "steps": n_steps, "step_ms": dt * 1e3, "tok_s": tok_s,
        "mfu": tok_s * flops_per_token / PEAK_BF16_FLOPS,
        "mfu_formula": "tok/s * (6 * active params + 12 * layers * hidden * seq) / 989e12; "
                       "active: attention, router, k of E experts, norms, embedding and head; "
                       "capacity padding not counted",
        "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
        # Phase 24's reference: its steps start from these weights and batch.
        "first_metrics": [(l, float(n)) for l, n in zip(losses, norms)][:EP_STEPS],
        "dropped": dropped, "routed": int(routed),
        "dropped_share": dropped_share, "launches": launches,
        "variant_launches": variant_launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "peak_mem_gib": peak, "profile": profile, "checks": checks,
    }


def moe_decode_bound(cfg, ctx=0) -> dict:
    """Least time (ms) of one bf16 decode token at batch 1: the bytes of the
    attention, the router, the norms, the head and the K/V of ``ctx``
    cached positions, and of the routed experts (k of E) or of all E (what
    a dense expert layer reads)."""
    h, f, d, layers = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, \
        cfg.num_hidden_layers
    attn = 2 * h * cfg.num_attention_heads * d + 2 * h * cfg.num_key_value_heads * d
    base = layers * (attn + h * cfg.num_local_experts + 2 * h) + cfg.vocab_size * h + h
    base_bytes = base * 2 + layers * 2 * (ctx + 1) * cfg.num_key_value_heads * d * 2
    expert = 3 * h * f * 2 * layers
    routed = base_bytes + cfg.num_experts_per_tok * expert
    every = base_bytes + cfg.num_local_experts * expert
    return {"routed_ms": routed / PEAK_HBM_BYTES * 1e3, "routed_bytes": routed,
            "all_experts_ms": every / PEAK_HBM_BYTES * 1e3, "all_experts_bytes": every}


def moe_decode_row(cfg, module, device="cuda"):
    """(c) Phase 7's decode row on the bf16 Mixtral (``decode_variant``)
    beside the per-token bounds of the routed experts and of all."""
    import torch

    from accelerate_tpu_torch import Model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, res = decode_variant(cfg, Model(module), decode_prompt(cfg, device), device)
    bound = moe_decode_bound(cfg, ctx=GEN_PROMPT + GEN_NEW_TOKENS // 2)
    return {"layers": cfg.num_hidden_layers, **res, "bound": bound,
            "bound_share_routed": bound["routed_ms"] / res["decode_ms_per_token"],
            "bound_share_all_experts": bound["all_experts_ms"] / res["decode_ms_per_token"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def moe_serving_parity(cfg, row=SERVING_ROW, device="cuda"):
    """(d)'s gate, on the fp32 Mixtral of the same width and depth (TF32
    off): the engine on the row's requests (8 slots, chunked prefill)
    against generate() of each prompt alone, under the near-tie rule. In
    bf16 a random-weight Mixtral's greedy rows part within a few tokens
    wherever two paths round a router input apart (an expert's output is
    as large as the residual stream), which no tie gap on the logits
    describes; fp32 leaves the paths' own differences."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Model, ServingConfig, ServingEngine, generate
    from accelerate_tpu_torch.models import MixtralForCausalLM

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the fp32 comparison needs them off")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    module = MixtralForCausalLM(cfg, device="meta").to_empty(device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    lengths, budgets, prompts, _ = serving_trace(cfg.vocab_size, **row)
    engine = ServingEngine(Model(module), ServingConfig(
        n_slots=row["slots"], max_len=int(max(lengths + budgets)) + 8,
        max_prefill_chunk=max(16, row["prompt_len"])))
    t0 = time.perf_counter()
    rows = engine.run(prompts, max_new_tokens=[int(b) for b in budgets])
    engine_s = time.perf_counter() - t0
    divergences = []
    for p, b, got in zip(prompts, budgets, rows):
        ref = generate(module, torch.as_tensor(p[None]).long().to(device),
                       max_new_tokens=int(b))[0].cpu().numpy()
        new_ref, new_got = list(ref[len(p):]), list(np.asarray(got)[len(p):])
        if new_ref == new_got:
            divergences.append(None)
            continue
        gaps = _row_gaps(cfg, module, ref, len(p), device)
        divergences.append(first_divergence([new_ref], [new_got], [gaps])[0])
    del engine, module
    gc.collect()
    torch.cuda.empty_cache()
    return {"dtype": "float32", "requests": len(prompts), "engine_s": engine_s,
            "divergences": divergences, "equal_rows": sum(d is None for d in divergences),
            "ok": parity_ok(divergences)}


def cp_generate_row(hf, device="cuda", width=FULL_WIDTH, row=CP_ROW):
    """(e) cp_generate at one process on phase 7's 1.06B Llama (bf16,
    max_position_embeddings = prompt + new tokens), prompt (1, 8192), 32
    new tokens: greedy tokens against generate()'s under the near-tie rule,
    prefill ms, ms a token, peak memory and the forward kernel's launches,
    counted from zero. The tie gap does not go through the kernel: four
    times the largest difference of the plain bf16 and plain fp32
    prefills' last logits (each bf16 path lies within that of fp32's, so
    two of them can swap the top two only under it). The kernel prefill's
    last logits must lie within ``CP_LOGITS_DELTA`` of the plain bf16
    one's; phase 2 holds the kernel at this shape (``CP_GEN_LIKE``)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import cp_generate, generate
    from accelerate_tpu_torch.cp_generation import _prefill
    from accelerate_tpu_torch.generation import _decode_params, _llama_forward_cached, init_cache
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    s, n = row["prompt_len"], row["new_tokens"]
    cfg = LlamaConfig(**width, max_position_embeddings=s + n, dtype=torch.bfloat16)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    module.to(torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab_size, size=(1, s))).to(device)
    params = _decode_params(module)
    cp_generate(module, prompt[:, :256], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    t0 = time.perf_counter()
    got = cp_generate(module, prompt, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_cp, pk, pv = _prefill(cfg, params, prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del pk, pv
    ref = generate(module, prompt, max_new_tokens=n)
    gaps = _greedy_gaps(cfg, module, ref, s)
    logits_gen, _ = _llama_forward_cached(cfg, params, prompt,
                                          init_cache(cfg, 1, s + n, device=device))
    delta = float((logits_cp.float() - logits_gen.float()).abs().max())
    # The same (bf16-rounded) weights, every product in fp32.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    logits_32, _ = _llama_forward_cached(cfg32, _decode_params(module.float()), prompt,
                                         init_cache(cfg32, 1, s, device=device))
    plain_delta = float((logits_gen.float() - logits_32).abs().max())
    tie_gap = max(TIE_GAP, 4 * plain_delta)
    div = first_divergence(ref[:, s:].tolist(), got[:, s:].tolist(), gaps, tie_gap=tie_gap)
    del module, params, logits_32
    gc.collect()
    torch.cuda.empty_cache()
    decode_ms = (wall * 1e3 - prefill_ms) / (n - 1)
    checks = {"tokens_equal_generate": parity_ok(div),
              "prompt_kept": bool(torch.equal(got[:, :s], prompt)),
              "first_logits_delta": delta <= CP_LOGITS_DELTA,
              # The prefill runs the forward kernel once a layer; decode none.
              "flash_launches": launches == {"flash_fwd": cfg.num_hidden_layers,
                                             "flash_dq": 0, "flash_dkv": 0}}
    return {"prompt_len": s, "new_tokens": n, "layers": cfg.num_hidden_layers,
            "cp_generate_ms": wall * 1e3, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "peak_mem_gib": peak,
            "launches": launches, "variant_launches": variant_launches,
            "first_logits_delta": delta, "first_logits_delta_limit": CP_LOGITS_DELTA,
            "plain_bf16_fp32_delta": plain_delta, "tie_gap": tie_gap, "divergence": div,
            "checks": checks, "ok": all(checks.values())}


def moe_phase(hf, device="cuda", width=MIXTRAL_8X7B, row=MIXTRAL_ROW, serving_row=SERVING_ROW,
              tiny=TINY_MIXTRAL, llama_width=FULL_WIDTH, cp_row=CP_ROW):
    """Phase 18: (a) the tiny Mixtral card against CPU, (b) Mixtral-8x7B's
    train step at 2 layers, (c) its decode row and (d) its engine at 8
    layers (bf16; the engine's tokens against generate()'s on the fp32
    model), (e) cp_generate at one process, (f) the hub round trip. The
    keyword arguments shrink it for a rehearsal on the CPU."""
    import torch

    from accelerate_tpu_torch.models import MixtralForCausalLM
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf

    t0 = time.perf_counter()
    part_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t
        return out

    def allocated_gib():
        return torch.cuda.memory_allocated() / 2**30

    tiny_res = timed("tiny", tiny_moe_parity, device, tiny)
    train = timed("train", mixtral_train_steps, hf, device, width, row)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(mixtral_config_from_hf(width),
                              num_hidden_layers=row["decode_layers"], dtype=torch.bfloat16,
                              max_position_embeddings=2048)
    t = time.perf_counter()
    allocated = {"before_decode_model": allocated_gib()}
    module = MixtralForCausalLM(cfg, device="meta").to(torch.bfloat16).to_empty(device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    part_s["decode_init"] = time.perf_counter() - t
    allocated["decode_model"] = allocated_gib()
    decode = timed("decode", moe_decode_row, cfg, module, device)
    serving_row = dict(serving_row, requests=row["requests"])
    serving = timed("serving", full_width_serving, module, serving_row)
    del module
    gc.collect()
    torch.cuda.empty_cache()
    allocated["after_decode_model"] = allocated_gib()
    serving["fp32_parity"] = timed("serving_parity", moe_serving_parity, cfg, serving_row,
                                   device)
    cp = timed("cp_generate", cp_generate_row, hf, device, llama_width, cp_row)
    hub = timed("hub", hub_round_trip, device, tiny)
    checks = {**{f"tiny_{k}": v for k, v in tiny_res["checks"].items()},
              **{f"train_{k}": v for k, v in train["checks"].items()},
              "decode": decode["tokens_in_vocab"] and decode["logits_finite"],
              "serving": serving["ok"], "serving_parity": serving["fp32_parity"]["ok"],
              **{f"cp_{k}": v for k, v in cp["checks"].items()},
              "hub_bit_equal": hub["bit_equal"]}
    return {"phase": "moe", "tiny": tiny_res, "mixtral_8x7b_train": train,
            "mixtral_8x7b_decode": decode, "mixtral_8x7b_serving": serving,
            "cp_generate": cp, "hub_round_trip": hub, "allocated_gib": allocated,
            "phase_s": time.perf_counter() - t0, "part_s": part_s, "checks": checks,
            "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 19: GPT-2, GPT-NeoX, OPT, T5 and Whisper at full width
# ---------------------------------------------------------------------------

# The JAX package's presets at their published widths (GPT2Config.gpt2_xl,
# GPTNeoXConfig.pythia_1b, OPTConfig.opt_1b3, T5Config.t5_base,
# WhisperConfig.whisper_large), with seeded random weights; nothing is cut.
# (b): the train step's batch and sequence; (c): the decode rows.
FAMILY_ROWS = {
    "gpt2_xl": dict(family="gpt2", preset="gpt2_xl", batch=4, seq=1024),
    "pythia_1b": dict(family="neox", preset="pythia_1b", batch=4, seq=2048),
    "opt_1b3": dict(family="opt", preset="opt_1b3", batch=4, seq=2048),
    "t5_base": dict(family="t5", preset="t5_base", batch=8, seq=512, dec_seq=128),
    "whisper_large": dict(family="whisper", preset="whisper_large", batch=2, frames=3000,
                          dec_seq=128),
}
# (b): 2 warm-up, 3 timed and 1 profiled train step; (c): 3 profiled decode
# steps; both profiles trace the card's kernels only (the host's events,
# at 2,500 kernels a token and 18,000 a Whisper step, took most of a row's
# seconds to parse).
FAMILY_STEPS = dict(warmup=2, timed=3, profiled=1, profiled_decode=3)
# (c): T5 decodes 32 tokens from a 512-token input; Whisper from 30 s of
# features with Whisper's start-of-transcript prompt and forced language,
# task and no-timestamps tokens (multilingual Whisper's ids).
ENCDEC_DECODE = dict(t5_input=512, whisper_frames=3000, new_tokens=GEN_NEW_TOKENS,
                     whisper_prompt=(50258,), whisper_forced=((1, 50259), (2, 50359), (3, 50363)))
# (a) and (e): the tiny widths of each family (the JAX presets' ``tiny``).
TINY_FAMILY_INPUTS = dict(prompt=(2, 8), new_tokens=12, t5_input=(2, 10), whisper=(2, 40, 16),
                          beams=3, decoder_prompt=2)


def family_classes(family):
    """(config class, module class) of a family; BERT's is the masked LM."""
    from accelerate_tpu_torch import models

    return {"llama": (models.LlamaConfig, models.LlamaForCausalLM),
            "mixtral": (models.MixtralConfig, models.MixtralForCausalLM),
            "gpt2": (models.GPT2Config, models.GPT2LMHeadModel),
            "neox": (models.GPTNeoXConfig, models.GPTNeoXForCausalLM),
            "opt": (models.OPTConfig, models.OPTForCausalLM),
            "t5": (models.T5Config, models.T5ForConditionalGeneration),
            "whisper": (models.WhisperConfig, models.WhisperForConditionalGeneration),
            "bert": (models.BertConfig, models.BertForMaskedLM),
            "vit": (models.ViTConfig, models.ViTForImageClassification),
            "clip": (models.CLIPConfig, models.CLIPModel),
            "resnet": (models.ResNetConfig, models.ResNet)}[family]


def family_config(row, dtype):
    """The row's preset (CLIP's: the config's defaults) in ``dtype``, with
    the row's ``width`` overrides (a rehearsal's narrow widths) and remat
    on unless the row says ``remat=False``."""
    cfg_cls, _ = family_classes(row["family"])
    preset = getattr(cfg_cls, row["preset"]) if row["preset"] else cfg_cls
    remat = {"remat": True} if row.get("remat", True) else {}
    return dataclasses.replace(preset(), **row.get("width", {}), **remat, dtype=dtype)


def family_weights(module, seed=0):
    """numpy-seeded weights in the port's layout: matrices and kernels of
    std 1/sqrt(fan-in) (T5's q a further 1/sqrt(d_kv), as its initialiser),
    norm scales of one, zero biases; Whisper's sinusoids kept; CLIP's logit
    scale at its init; BatchNorm's running statistics of zero mean and unit
    variance."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    d_kv = getattr(module.config, "d_kv", None)
    for n, p in module.state_dict().items():
        if n == "encoder.embed_positions":
            out[n] = p.detach().clone()
            continue
        if p.dim() == 0:
            a = np.full((), module.config.logit_scale_init)
        elif p.dim() == 1:
            a = np.zeros(p.shape) if n.endswith(("bias", ".mean")) else np.ones(p.shape)
        else:
            a = rng.standard_normal(p.shape) / math.sqrt(math.prod(p.shape[1:]))
            if d_kv and n.endswith(".q.weight"):
                a = a / math.sqrt(d_kv)
        out[n] = torch.from_numpy(a.astype(np.float32))
    return out


def family_batch(family, cfg, rows, device, seed=0, **shape):
    """A train batch: ids ``x``/``y`` (causal: the sequence shifted by
    one), T5's encoder ids and labels, Whisper's (B, T, mel) features and
    decoder ids; BERT's ids with ``masked`` of the positions replaced by
    [MASK] and labelled (the rest -100); NHWC images and labels; CLIP's
    ids ending in its EOT id, and images."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def images():
        size = cfg.image_size if family != "resnet" else shape.get("image_size", 224)
        return torch.from_numpy(rng.standard_normal((rows, size, size, 3)).astype(
            np.float32)).to(device)

    if family == "bert":
        ids = rng.integers(1, cfg.vocab_size, (rows, shape["seq"]))
        hit = rng.random(ids.shape) < shape.get("masked", 0.15)
        labels = np.where(hit, ids, -100)
        ids = np.where(hit, min(BERT_MASK_ID, cfg.vocab_size - 1), ids)
        return {"ids": torch.from_numpy(ids).to(device),
                "labels": torch.from_numpy(labels).to(device)}
    if family == "clip":
        ids = rng.integers(1, cfg.eos_token_id, (rows, shape["seq"]))
        ids[:, -1] = cfg.eos_token_id
        return {"ids": torch.from_numpy(ids).to(device), "pixels": images()}
    if family in ("vit", "resnet"):
        classes = cfg.num_labels if family == "vit" else cfg.num_classes
        return {"pixels": images(),
                "labels": torch.from_numpy(rng.integers(0, classes, rows)).to(device)}
    if family == "t5":
        return {"x": torch.from_numpy(rng.integers(2, cfg.vocab_size, (rows, shape["seq"])))
                .to(device),
                "y": torch.from_numpy(rng.integers(2, cfg.vocab_size, (rows, shape["dec_seq"])))
                .to(device)}
    if family == "whisper":
        feats = rng.standard_normal((rows, shape["frames"], cfg.num_mel_bins)).astype(np.float32)
        ids = rng.integers(0, cfg.vocab_size, (rows, shape["dec_seq"] + 1))
        return {"feats": torch.from_numpy(feats).to(device),
                "x": torch.from_numpy(ids[:, :-1]).to(device),
                "y": torch.from_numpy(ids[:, 1:]).to(device)}
    ids = rng.integers(0, cfg.vocab_size, (rows, shape["seq"] + 1))
    return {"x": torch.from_numpy(ids[:, :-1]).to(device),
            "y": torch.from_numpy(ids[:, 1:]).to(device)}


def row_shape(row) -> dict:
    """A row's input shape: ``seq``, ``dec_seq``, ``frames``,
    ``image_size``, BERT's ``masked`` share."""
    return {k: row[k] for k in ("seq", "dec_seq", "frames", "image_size", "masked") if k in row}


def family_loss(family, generator=None):
    """The train step's loss: the causal LM loss; T5's teacher forcing
    (``shift_tokens_right``, ``t5_cross_entropy_loss``); Whisper's decoder
    ids against the next ids; BERT's ``masked_lm_loss`` (dropout from
    ``generator``), the image classifiers' cross entropy,
    ``clip_contrastive_loss``, and ResNet's ``resnet_loss`` with the
    running statistics (``mutable_state``)."""
    import torch

    from accelerate_tpu_torch.models import (
        clip_contrastive_loss, cross_entropy_loss, masked_lm_loss, resnet_loss,
        shift_tokens_right, t5_cross_entropy_loss)

    if family == "t5":
        return lambda m, b: t5_cross_entropy_loss(m(b["x"], shift_tokens_right(b["y"])), b["y"])
    if family == "whisper":
        return lambda m, b: cross_entropy_loss(m(b["feats"], b["x"]), b["y"])
    if family == "bert":
        return lambda m, b: masked_lm_loss(m(b["ids"], generator=generator), b["labels"])
    if family == "clip":
        return lambda m, b: clip_contrastive_loss(m, b["ids"], b["pixels"])
    if family == "resnet":
        return lambda m, e, b: resnet_loss(m, e, b["pixels"], b["labels"])
    if family == "vit":
        return lambda m, b: -torch.log_softmax(m(b["pixels"]), -1).gather(
            1, b["labels"][:, None]).mean()
    return lambda m, b: cross_entropy_loss(m(b["x"]), b["y"])


# Tables that are only looked up, never multiplied: left out of N.
LOOKUP_TABLES = ("transformer.wpe.weight", "model.embed_positions.weight",
                 "gpt_neox.embed_in.weight", "encoder.embed_positions",
                 "decoder.embed_positions.weight")


def family_flops(family, cfg, module, row, rows) -> tuple[float, str]:
    """FLOPs of one train step (forward and backward; the remat recompute
    not counted, as phase 5 counts them) and the formula. N counts the
    parameters that enter products (a tied head once, lookup-only tables
    not)."""
    if family in ENCODER_FAMILIES:
        device = next(module.parameters()).device
        return encoder_flops(family, cfg, module, rows, device, **row_shape(row))

    def n_of(prefix=""):
        return sum(p.numel() for n, p in module.named_parameters()
                   if n.startswith(prefix) and n not in LOOKUP_TABLES)

    if family in ("gpt2", "neox", "opt"):
        layers = getattr(cfg, "num_hidden_layers", None) or cfg.n_layer
        width = getattr(cfg, "hidden_size", None) or cfg.n_embd
        per_token = 6 * n_of() + 12 * layers * width * row["seq"]
        return rows * row["seq"] * per_token, "B*S*(6*N + 12*L*H*S)"
    se, sd = (row["seq"], row["dec_seq"]) if family == "t5" else (row["frames"] // 2,
                                                                 row["dec_seq"])
    inner = cfg.num_heads * cfg.d_kv if family == "t5" else cfg.d_model
    le = cfg.num_layers if family == "t5" else cfg.encoder_layers
    ld = cfg.n_dec if family == "t5" else cfg.decoder_layers
    n_enc, n_dec = n_of("encoder."), n_of("decoder.") + n_of("shared.")
    flops = 6 * n_enc * se + 6 * n_dec * sd + 12 * inner * (le * se * se + ld * (sd * sd + sd * se))
    formula = ("B*(6*N_enc*S_enc + 6*N_dec*S_dec + 12*inner*(L_enc*S_enc^2"
               " + L_dec*(S_dec^2 + S_dec*S_enc)))")
    if family == "whisper":  # conv1 runs at every frame, not at S_enc positions
        conv1 = module.encoder.conv1.weight.numel()
        flops += 6 * conv1 * (row["frames"] - se)
        formula += " + 6*P_conv1*(T - S_enc)"
    return rows * flops, formula


def family_train_steps(hf, name, device="cuda", row=None, steps=FAMILY_STEPS):
    """(b) One family's full-width train step through prepare_train_step
    (bf16 over fp32 masters, adamw(3e-4, weight_decay=0.1), clipping at
    1.0; the module's seeded initialiser, or ``family_weights`` where the
    row asks for ``numpy_weights``; remat on every block unless the row
    says otherwise; BERT's dropout
    from a seeded generator; ResNet with ``mutable_state=True``) on one
    fixed batch: the warm-up and timed steps with the flash kernels'
    launches counted from zero (none of these families reaches them), then
    the profiled steps (the encoders' by matmul/conv, elementwise, AdamW
    and ResNet's BatchNorm). The timed steps' mean loss lies below the
    first, a language model's first loss within 1 of ln(vocab), and
    ResNet's running statistics moved and its eval-mode logits read them.
    The batch halves on OOM, and the row says so. Returns (the row's
    numbers, the module with its trained fp32 masters)."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, adamw
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    row = row or {**FAMILY_ROWS, **ENCODER_ROWS}[name]
    family, encoder = row["family"], row["family"] in ENCODER_FAMILIES
    mutable = family == "resnet"
    cfg = family_config(row, torch.bfloat16)
    mod_cls = family_classes(family)[1]
    rows, halved = row["batch"], []
    while True:
        for cls in (AcceleratorState, GradientState):
            cls._reset_state()
        acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu")
        module = mod_cls(cfg, device=acc.device)
        if row.get("numpy_weights"):
            module.load_state_dict({k: v.to(acc.device) for k, v in
                                    family_weights(module).items()})
        else:
            module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        generator = torch.Generator(device=acc.device).manual_seed(0)
        step = acc.prepare_train_step(family_loss(family, generator), max_grad_norm=1.0,
                                      mutable_state=mutable)
        batch = family_batch(family, cfg, rows, acc.device, **row_shape(row))
        state = acc.train_state
        stats0 = _tree_copy(state.extra_state) if mutable else None
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hf.reset_launch_counts()
            losses = []
            for _ in range(steps["warmup"]):
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps["timed"]):
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps["timed"]
            break
        except torch.cuda.OutOfMemoryError:
            if rows == 1:
                raise
            halved.append(rows)
            del acc, model, module, step, state, batch
            gc.collect()
            torch.cuda.empty_cache()
            rows //= 2
    launches = dict(hf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    if encoder:
        profile = profile_steps(step, state, batch, dt * 1e3, steps=steps["profiled"],
                                host=mutable, categorise=_encoder_category,
                                categories=ENCODER_CATEGORIES,
                                attribution=batch_norm_attribution if mutable else None)
    else:
        profile = profile_steps(step, state, batch, dt * 1e3, steps=steps["profiled"],
                                host=False)
    flops, formula = family_flops(family, cfg, module, row, rows)
    rate, units = family_units(family, row, rows)
    n_params = model.num_parameters()
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        # The timed steps' mean: single steps may spike (T5-base's 7th step
        # rises in the JAX package's own run of this row, on the CPU).
        "losses_fall": sum(losses[steps["warmup"]:]) / steps["timed"] < losses[0],
        "no_flash_launches": all(v == 0 for v in launches.values()),
    }
    extra = {}
    if not encoder:
        checks["loss_near_ln_vocab"] = abs(losses[0] - math.log(cfg.vocab_size)) < 1.0
        extra["ln_vocab"] = math.log(cfg.vocab_size)
    if mutable:
        moved, reads = batch_stats_checks(model, state, batch, stats0)
        by_cat = profile["ms_per_step_by_category"]
        checks.update(stats_moved=moved > 1e-3, eval_reads_the_stats=reads,
                      categories_add_up=min(by_cat.values()) >= -1e-9 and math.isclose(
                          sum(by_cat.values()), profile["device_busy_ms_per_step"],
                          rel_tol=1e-9, abs_tol=1e-9))
        extra["stats_max_move"] = moved
    del acc, model, step, state, batch
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "config": {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"},
        "n_params": n_params, "batch": rows, "halved_from": halved,
        **row_shape(row),
        "steps": steps["warmup"] + steps["timed"], "step_ms": dt * 1e3,
        rate: units / dt, "units_per_step": units,
        "flops_per_step": flops, "flops_formula": formula,
        "mfu": flops / dt / PEAK_BF16_FLOPS, "peak_mem_gib": peak, "losses": losses,
        "flash_launches": launches, "profile": profile, **extra, "checks": checks,
    }, module


def family_units(family, row, rows) -> tuple[str, int]:
    """What a step of the row trains, and how many: tokens (encoder and
    decoder positions; Whisper's encoder runs at half its frames), images,
    or CLIP's pairs."""
    if family in ("vit", "resnet"):
        return "images_s", rows
    if family == "clip":
        return "pairs_s", rows
    if family == "t5":
        return "tok_s", rows * (row["seq"] + row["dec_seq"])
    if family == "whisper":
        return "tok_s", rows * (row["frames"] // 2 + row["dec_seq"])
    return "tok_s", rows * row["seq"]


def batch_stats_checks(model, state, batch, stats0) -> tuple[float, bool]:
    """ResNet after its steps: the largest move of a running statistic
    from ``stats0``, and whether the eval-mode logits of four images read
    the state's statistics (equal to those given explicitly, unlike those
    from ``stats0``)."""
    import torch

    from accelerate_tpu_torch.train_state import tree_items

    moved = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_items(state.extra_state), tree_items(stats0)))
    with torch.no_grad():
        x = batch["pixels"][:4]
        from_buffers = model(x)
        explicit = model(x, batch_stats=_tree_copy(state.extra_state)["batch_stats"])
        initial = model(x, batch_stats=stats0["batch_stats"])
    return moved, bool(torch.equal(from_buffers, explicit)
                       and not torch.equal(from_buffers, initial))


def _tree_copy(tree):
    return {k: _tree_copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def family_decode_bound(cfg, module, ctx, cross=0) -> tuple[float, float]:
    """Least time (ms) of one bf16 decode token at batch 1 and its bytes:
    the decoder's weights read once (the head's matrix once, not the
    lookup tables it does not double as: positions, NeoX's ``embed_in``,
    the encoder), the K/V of ``ctx`` cached positions read and one written,
    and ``cross`` encoder positions' cross-attention K/V read."""
    skip = {"transformer.wpe.weight", "model.embed_positions.weight",
            "gpt_neox.embed_in.weight", "decoder.embed_positions.weight"}
    params = [(n, p) for n, p in module.named_parameters()
              if n not in skip and not n.startswith("encoder.")]
    weights = sum(p.numel() for _, p in params)
    from accelerate_tpu_torch import generation as gen

    layers, heads, d, _ = gen._cache_dims(cfg)
    kv = 2 * layers * heads * d
    nbytes = 2 * weights + 2 * kv * (ctx + 1) + 2 * kv * cross
    return nbytes / PEAK_HBM_BYTES * 1e3, nbytes


def family_decode_row(cfg, module, device="cuda", steps=FAMILY_STEPS):
    """(c) A causal family's decode row: bf16 generate() of prompt (1, 64)
    and 32 new tokens (``decode_variant``) beside its per-token bound."""
    import torch

    from accelerate_tpu_torch import Model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row, res = decode_variant(cfg, Model(module), decode_prompt(cfg, device), device,
                              profiled=steps["profiled_decode"], host=False)
    bound_ms, nbytes = family_decode_bound(cfg, module, ctx=GEN_PROMPT + GEN_NEW_TOKENS // 2)
    return {**res, "bound_ms_per_token": bound_ms, "bound_bytes_per_token": nbytes,
            "bound_share": bound_ms / res["decode_ms_per_token"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def encdec_decode_row(name, cfg, module, device="cuda", spec=ENCDEC_DECODE,
                      steps=FAMILY_STEPS):
    """(c) An encoder-decoder's decode row in bf16: T5 from a 512-token
    input, Whisper from (1, 3000, 80) features with its prompt and forced
    tokens. One warm-up and one timed generate(); the encoder's ms apart
    (median of 3); the decode steps timed after a prefill, then profiled;
    the per-token bound with the cross-attention K/V's bytes."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from accelerate_tpu_torch import Model, generate
    from accelerate_tpu_torch import generation as gen

    rng = np.random.default_rng(0)
    n_new = spec["new_tokens"]
    if name.startswith("t5"):
        enc_in = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, spec["t5_input"])))
        prompt = torch.zeros((1, 1), dtype=torch.long)
        kw, cross = {}, spec["t5_input"]
    else:
        enc_in = torch.from_numpy(rng.standard_normal(
            (1, spec["whisper_frames"], cfg.num_mel_bins)).astype(np.float32))
        prompt = torch.tensor([list(spec["whisper_prompt"])])
        kw, cross = {"forced_decoder_ids": spec["whisper_forced"]}, spec["whisper_frames"] // 2
    enc_in, prompt = enc_in.to(device), prompt.to(device)
    model = Model(module)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    generate(model, enc_in, max_new_tokens=n_new, decoder_input_ids=prompt, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, enc_in, max_new_tokens=n_new, decoder_input_ids=prompt, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    encode, decode = gen.ENCDEC_GENERATION_PLANS[type(module).__name__]
    encode_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode(cfg, module, enc_in)
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
    params = gen._decode_params(module)

    def run_steps(n, profiled=False):
        cache = gen.init_cache(cfg, 1, prompt.shape[1] + n + 1, device=device)
        logits, cache = decode(cfg, params, prompt, cache, enc)
        finite = [torch.isfinite(logits).all()]
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        prof = profile(activities=profiled_activities(False)) if profiled else None
        if prof:
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(n):
            logits, cache = decode(cfg, params, tok[:, None], cache, enc)
            finite.append(torch.isfinite(logits).all())
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if prof:
            prof.__exit__(None, None, None)
        return dt, bool(torch.stack(finite).all()), prof

    decode_s, finite, _ = run_steps(n_new - 1)
    _, finite_p, prof = run_steps(steps["profiled_decode"], profiled=True)
    busy_ms, by_cat, top, n_kernels = device_times(prof, steps["profiled_decode"], n_top=8)
    decode_ms = decode_s * 1e3 / (n_new - 1)
    bound_ms, nbytes = family_decode_bound(cfg, module, ctx=prompt.shape[1] + n_new // 2,
                                           cross=cross)
    new = out[0, prompt.shape[1]:].cpu().numpy()
    forced_ok = all(int(out[0, p]) == t for p, t in kw.get("forced_decoder_ids", ()))
    return {"encoder_input": list(enc_in.shape), "decoder_prompt": prompt.tolist(),
            "generate_ms": wall * 1e3, "decode_tok_s": n_new / wall,
            "encode_ms": float(np.median(encode_ms)), "decode_ms_per_token": decode_ms,
            "device_busy_ms_per_token": busy_ms,
            "idle_share": 1.0 - busy_ms / decode_ms if top else None,
            "kernels_per_token": n_kernels, "ms_per_token_by_category": by_cat,
            "top_kernels_ms_per_token": top, "cross_positions": cross,
            "bound_ms_per_token": bound_ms, "bound_bytes_per_token": nbytes,
            "bound_share": bound_ms / decode_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tokens_in_vocab": bool(((new >= 0) & (new < cfg.vocab_size)).all()),
            "forced_tokens": forced_ok, "logits_finite": finite and finite_p}


def serving_parity_at_width(module, serving, tie_rows=2, device="cuda"):
    """(d)'s gate: each engine row against generate()'s (bf16; the prompts
    left-padded into one batch, each row cut to its budget) under the
    near-tie rule, with the tie gap ``bf16_tie_gap`` derives in this run
    from sample rows (4-token windows, the shape of a short prefill
    chunk)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import generate

    cfg = module.config
    prompts, budgets, rows = serving.pop("_prompts"), serving.pop("_budgets"), \
        serving.pop("_rows")
    s = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), s), np.int64)
    mask = np.zeros((len(prompts), s), np.int64)
    for i, p in enumerate(prompts):
        ids[i, s - len(p):], mask[i, s - len(p):] = p, 1
    batch = generate(module, torch.from_numpy(ids).to(device), max_new_tokens=int(max(budgets)),
                     attention_mask=mask).cpu().numpy()
    refs = [np.concatenate([p, batch[i, s:s + int(b)]]) for i, (p, b) in
            enumerate(zip(prompts, budgets))]
    tie_gap, delta = bf16_tie_gap(cfg, module, refs[:tie_rows],
                                  [len(p) for p in prompts[:tie_rows]], 3, device)
    divergences = []
    for p, ref, got in zip(prompts, refs, rows):
        new_ref, new_got = list(ref[len(p):]), list(np.asarray(got)[len(p):])
        if new_ref == new_got:
            divergences.append(None)
            continue
        gaps = _row_gaps(cfg, module, ref, len(p), device)
        divergences.append(first_divergence([new_ref], [new_got], [gaps], tie_gap)[0])
    return {"tie_gap": tie_gap, "delta": delta, "divergences": divergences,
            "equal_rows": sum(d is None for d in divergences), "ok": parity_ok(divergences)}


def tiny_family_module(family, dtype, device, seed=0):
    """The tiny model of a family (the JAX preset's ``tiny``) with
    numpy-seeded weights (``family_weights``) on ``device``."""
    cfg_cls, mod_cls = family_classes(family)
    cfg = cfg_cls.tiny(dtype=dtype)
    module = mod_cls(cfg)
    module.load_state_dict(family_weights(module, seed))
    return cfg, module.to(device)


def tiny_family_inputs(family, cfg, spec=TINY_FAMILY_INPUTS):
    """Encoder inputs (T5 ids, Whisper (B, T, mel) features) or a prompt."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    if family == "t5":
        return torch.from_numpy(rng.integers(2, cfg.vocab_size, spec["t5_input"]))
    if family == "whisper":
        return torch.from_numpy(rng.standard_normal(spec["whisper"]).astype(np.float32))
    return torch.from_numpy(rng.integers(1, cfg.vocab_size, spec["prompt"]))


def _encdec_gaps(module, x, rows, prompt_len):
    """(B, N) top-2 logit gaps of the greedy steps that made
    rows[:, prompt_len:], from the teacher-forced full forward."""
    import torch

    with torch.no_grad():
        logits = module(x, rows)
    top2 = torch.topk(logits[:, prompt_len - 1:-1], 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def tiny_family_parity(family, device="cuda", spec=TINY_FAMILY_INPUTS):
    """(a) One family's tiny model on `device` against the CPU: fp32 greedy
    generate() (TF32 off) under the near-tie rule; for T5 and Whisper also
    beam_search() with a decoder prompt, tokens equal; one bf16 train step
    from the same weights, loss within 2e-2."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, adamw, generate
    from accelerate_tpu_torch import generation as gen
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    if device != "cpu" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the fp32 comparison needs them off")
    encdec = family in ("t5", "whisper")
    cfg, cpu_model = tiny_family_module(family, torch.float32, "cpu")
    _, card_model = tiny_family_module(family, torch.float32, device)
    x = tiny_family_inputs(family, cfg, spec)
    n = spec["new_tokens"]
    ref = generate(cpu_model, x, max_new_tokens=n)
    got = generate(card_model, x.to(device), max_new_tokens=n).cpu()
    p = ref.shape[1] - n
    gaps = (_encdec_gaps(cpu_model, x, ref, p) if encdec
            else _greedy_gaps(cfg, cpu_model, ref, p))
    out = {"generate": first_divergence(ref[:, p:].tolist(), got[:, p:].tolist(), gaps)}
    ok = parity_ok(out["generate"])
    if encdec:
        dec = torch.zeros((x.shape[0], spec["decoder_prompt"]), dtype=torch.long)
        dec[:, 1] = 5
        beams = [gen.beam_search(m, x.to(d), n, num_beams=spec["beams"],
                                 decoder_input_ids=dec.to(d)).cpu()
                 for m, d in ((cpu_model, "cpu"), (card_model, device))]
        out["beam_equal"] = bool(torch.equal(*beams))
        ok = ok and out["beam_equal"]

    # One bf16 train step on the card and on the CPU from the same weights.
    bf16_cfg = family_classes(family)[0].tiny(dtype=torch.bfloat16)
    weights = family_weights(cpu_model)
    row = {"t5": dict(seq=10, dec_seq=6), "whisper": dict(frames=40, dec_seq=6)}.get(
        family, dict(seq=16))
    losses = {}
    for label, on_cpu in (("card", device == "cpu"), ("cpu", True)):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(mixed_precision="bf16", cpu=on_cpu)
        module = family_classes(family)[1](bf16_cfg)
        module.load_state_dict(weights)
        acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(family_loss(family), max_grad_norm=1.0)
        batch = family_batch(family, bf16_cfg, 2, acc.device, seed=3, **row)
        _, metrics = step(acc.train_state, batch)
        losses[label] = float(metrics["loss"])
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    out.update(train_loss=losses, train_loss_rel=rel)
    out["ok"] = bool(ok and math.isfinite(losses["card"]) and rel <= 2e-2)
    return out


# transformers' names and layouts of each family's tensors, from the port's
# (the inverse of hub.py's ``*_params_from_hf``), for (e)'s checkpoints:
# (pattern, replacement) rules on the port's names, and the port names
# whose tensors transformers stores transposed (GPT-2's Conv1D).
HF_LAYOUT = {
    "gpt2": ([(r"^transformer\.h\.(\d+)\.(c_fc|c_proj)\.", r"transformer.h.\1.mlp.\2.")],
             r"^transformer\.h\.\d+\.(attn\.c_attn|attn\.c_proj|c_fc|c_proj)\.weight$"),
    "opt": ([(r"^model\.", "model.decoder.")], None),
    "neox": ([(r"^gpt_neox\.layers\.(\d+)\.(dense_h_to_4h|dense_4h_to_h)\.",
               r"gpt_neox.layers.\1.mlp.\2.")], None),
    "t5": ([(r"^(encoder|decoder)\.final_ln\.", r"\1.final_layer_norm."),
            (r"^(encoder|decoder)\.block_(\d+)\.ln(\d)\.", r"\1.block.\2.layer.\3.layer_norm."),
            (r"^(encoder)\.block_(\d+)\.ffn\.", r"\1.block.\2.layer.1.DenseReluDense."),
            (r"^(decoder)\.block_(\d+)\.ffn\.", r"\1.block.\2.layer.2.DenseReluDense."),
            (r"^(encoder|decoder)\.block_(\d+)\.self_attn\.",
             r"\1.block.\2.layer.0.SelfAttention."),
            (r"^decoder\.block_(\d+)\.cross_attn\.", r"decoder.block.\1.layer.1.EncDecAttention.")],
           None),
    "whisper": ([(r"^encoder\.embed_positions$", "encoder.embed_positions.weight"),
                 (r"^", "model.")], None),
    "bert": ([(r"^bert\.(word|position|token_type)_embeddings\.",
               r"bert.embeddings.\1_embeddings."),
              (r"^bert\.embeddings_norm\.", "bert.embeddings.LayerNorm."),
              (r"^bert\.pooler\.", "bert.pooler.dense."),
              (r"^bert\.layers\.(\d+)\.attention\.(query|key|value)\.",
               r"bert.encoder.layer.\1.attention.self.\2."),
              (r"^bert\.layers\.(\d+)\.attention\.output\.",
               r"bert.encoder.layer.\1.attention.output.dense."),
              (r"^bert\.layers\.(\d+)\.attention_norm\.",
               r"bert.encoder.layer.\1.attention.output.LayerNorm."),
              (r"^bert\.layers\.(\d+)\.(intermediate|output)\.",
               r"bert.encoder.layer.\1.\2.dense."),
              (r"^bert\.layers\.(\d+)\.output_norm\.", r"bert.encoder.layer.\1.output.LayerNorm.")],
             None),
    "vit": ([(r"^vit\.(cls_token|position_embeddings)$", r"vit.embeddings.\1"),
             (r"^vit\.patch_embed\.", "vit.embeddings.patch_embeddings.projection."),
             (r"^vit\.ln_final\.", "vit.layernorm."),
             (r"^vit\.layers\.(\d+)\.ln_(before|after)\.", r"vit.encoder.layer.\1.layernorm_\2."),
             (r"^vit\.layers\.(\d+)\.attention\.(query|key|value)\.",
              r"vit.encoder.layer.\1.attention.attention.\2."),
             (r"^vit\.layers\.(\d+)\.attention\.output\.",
              r"vit.encoder.layer.\1.attention.output.dense."),
             (r"^vit\.layers\.(\d+)\.(intermediate|output)\.", r"vit.encoder.layer.\1.\2.dense.")],
            None),
    "clip": ([(r"^text\.(token|position)_embedding$", r"text_model.embeddings.\1_embedding.weight"),
              (r"^text\.final_ln\.", "text_model.final_layer_norm."),
              (r"^vision\.class_embedding$", "vision_model.embeddings.class_embedding"),
              (r"^vision\.patch_embed\.", "vision_model.embeddings.patch_embedding."),
              (r"^vision\.position_embedding$",
               "vision_model.embeddings.position_embedding.weight"),
              (r"^vision\.pre_ln\.", "vision_model.pre_layrnorm."),
              (r"^vision\.post_ln\.", "vision_model.post_layernorm."),
              (r"^(text|vision)\.layers\.(\d+)\.ln(\d)\.",
               r"\1_model.encoder.layers.\2.layer_norm\3."),
              (r"^(text|vision)\.layers\.(\d+)\.(fc\d)\.", r"\1_model.encoder.layers.\2.mlp.\3."),
              (r"^(text|vision)\.layers\.(\d+)\.", r"\1_model.encoder.layers.\2.")],
             None),
}
# The tiny checkpoints' config.json: transformers' keys of each family.
HF_TINY_CONFIGS = {
    "gpt2": dict(model_type="gpt2", vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                 n_head=4),
    "opt": dict(model_type="opt", vocab_size=128, hidden_size=64, ffn_dim=128,
                num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64),
    "neox": dict(model_type="gpt_neox", vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128, rotary_pct=0.25,
                 max_position_embeddings=64),
    "t5": dict(model_type="t5", vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_heads=4, relative_attention_num_buckets=8,
               relative_attention_max_distance=16),
    "whisper": dict(model_type="whisper", vocab_size=96, num_mel_bins=16, d_model=32,
                    encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                    max_source_positions=24, max_target_positions=32, pad_token_id=0,
                    bos_token_id=1, eos_token_id=2, decoder_start_token_id=1),
    "bert": dict(model_type="bert", vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128, max_position_embeddings=64,
                 num_labels=3, hidden_dropout_prob=0.0),
    "vit": dict(model_type="vit", image_size=32, patch_size=8, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, num_labels=5),
    "clip": dict(model_type="clip", projection_dim=24,
                 text_config=dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=16, eos_token_id=98),
                 vision_config=dict(image_size=32, patch_size=8, hidden_size=48,
                                    num_hidden_layers=2, num_attention_heads=2,
                                    intermediate_size=96)),
}


def hf_layout_state_dict(family, module) -> dict:
    """``module``'s state dict under transformers' names and layouts."""
    rules, transposed = HF_LAYOUT[family]
    out = {}
    for name, t in module.state_dict().items():
        t = t.detach().cpu()
        if transposed and re.match(transposed, name):
            t = t.t()
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        out[name] = t.contiguous()
    return out


def family_hub_round_trip(family, device="cuda"):
    """(e) A tiny checkpoint of the family in transformers' layout (its
    names and shapes, the port's safetensors writer, a config.json) read by
    ``model_from_pretrained`` from the directory: logits equal bit for bit
    to ``model_from_pretrained`` of the same tensors in memory."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import model_from_pretrained
    from accelerate_tpu_torch.models.hub import _FAMILIES
    from accelerate_tpu_torch.utils.other import save_safetensors

    hf_cfg = HF_TINY_CONFIGS[family]
    mod_cls, config_from_hf, _, _ = _FAMILIES[hf_cfg["model_type"]]
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=torch.float32)
    source = mod_cls(cfg)
    source.init_weights(torch.Generator().manual_seed(1), std=0.2)
    sd = hf_layout_state_dict(family, source)
    rng = np.random.default_rng(2)
    if family == "t5":
        args = [rng.integers(1, cfg.vocab_size, (2, 12)), rng.integers(1, cfg.vocab_size, (2, 5))]
    elif family == "whisper":
        args = [rng.standard_normal((2, 48, cfg.num_mel_bins)).astype(np.float32),
                rng.integers(1, cfg.vocab_size, (2, 5))]
    elif family in ("vit", "clip"):
        pixels = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        ids = rng.integers(1, cfg.eos_token_id, (2, 12)) if family == "clip" else None
        if ids is not None:
            ids[:, -1] = cfg.eos_token_id
        args = [pixels] if ids is None else [ids, pixels]
    else:
        args = [rng.integers(0, cfg.vocab_size, (2, 16))]
    args = [torch.from_numpy(a).to(device) for a in args]
    with tempfile.TemporaryDirectory() as tmp:
        save_safetensors(sd, os.path.join(tmp, "model.safetensors"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf_cfg, f)
        from_dir = model_from_pretrained(tmp, dtype=torch.float32, device=device)
    in_memory = model_from_pretrained((hf_cfg, sd), dtype=torch.float32, device=device)
    with torch.no_grad():
        got, want = from_dir(*args), in_memory(*args)
        source_logits = source.to(device)(*args)
    got, want, source_logits = (o if isinstance(o, tuple) else (o,)
                                for o in (got, want, source_logits))  # CLIP's four outputs
    return {"config": hf_cfg, "n_tensors": len(sd),
            "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
            "equal_to_source": all(torch.equal(w, s) for w, s in zip(want, source_logits)),
            "max_abs_diff": max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want))}


def families_phase(hf, device="cuda", rows=None, steps=FAMILY_STEPS,
                   serving_row=SERVING_ROW, tiny=TINY_FAMILY_INPUTS, decode=ENCDEC_DECODE):
    """Phase 19: (a) the tiny families card against CPU, (b) the full-width
    train steps, (c) the decode rows, (d) OPT-1.3B's engine and the
    encoder-decoders' refusal, (e) the hub round trips. The keyword
    arguments shrink it for a rehearsal on the CPU."""
    import torch

    from accelerate_tpu_torch import Model, ServingEngine

    rows = rows or FAMILY_ROWS
    t0 = time.perf_counter()
    part_s = {}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        part_s[key] = time.perf_counter() - t
        return out

    families = ("gpt2", "neox", "opt", "t5", "whisper")
    tiny_res = {f: timed(f"tiny_{f}", tiny_family_parity, f, device, tiny) for f in families}
    train, gen_rows, serving = {}, {}, None
    for name, row in rows.items():
        train[name], module = timed(f"train_{name}", family_train_steps, hf, name, device, row,
                                    steps)
        module.to(torch.bfloat16)  # the decode rows' weights (the config computes in bf16)
        cfg = module.config
        if row["family"] in ("t5", "whisper"):
            gen_rows[name] = timed(f"decode_{name}", encdec_decode_row, row["family"], cfg,
                                   module, device, decode, steps)
        else:
            gen_rows[name] = timed(f"decode_{name}", family_decode_row, cfg, module, device,
                                   steps)
        if row["family"] == "opt":
            serving = timed("serving", full_width_serving, module,
                            dict(serving_row, requests=16), keep_rows=True)
            serving["parity"] = timed("serving_parity", serving_parity_at_width, module,
                                      serving, device=device)
        del module
        gc.collect()
        torch.cuda.empty_cache()
    refused = {}
    for family in ("t5", "whisper"):
        _, module = tiny_family_module(family, torch.float32, device)
        try:
            ServingEngine(Model(module))
            refused[family] = False
        except ValueError as exc:
            refused[family] = "encoder-decoder" in str(exc)
    hub = {f: timed(f"hub_{f}", family_hub_round_trip, f, device) for f in families}
    checks = {**{f"tiny_{f}": r["ok"] for f, r in tiny_res.items()},
              **{f"train_{n}_{k}": v for n, r in train.items() for k, v in r["checks"].items()},
              **{f"decode_{n}": r["tokens_in_vocab"] and r["logits_finite"]
                 and r.get("forced_tokens", True) for n, r in gen_rows.items()},
              "serving": serving is not None and serving["ok"],
              "serving_parity": serving is not None and serving["parity"]["ok"],
              **{f"engine_refuses_{f}": v for f, v in refused.items()},
              **{f"hub_{f}_bit_equal": r["bit_equal"] and r["equal_to_source"]
                 for f, r in hub.items()}}
    return {"phase": "families", "tiny": tiny_res, "train": train, "decode": gen_rows,
            "opt_1b3_serving": serving, "engine_refuses": refused, "hub_round_trip": hub,
            "phase_s": time.perf_counter() - t0, "part_s": part_s, "checks": checks,
            "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 20: BERT, ViT, CLIP and ResNet at full width
# ---------------------------------------------------------------------------

# The JAX package's presets at their published widths (BertConfig.bert_large,
# ViTConfig.vit_base, CLIPConfig's defaults (openai/clip-vit-base-patch32),
# ResNetConfig.resnet50), with numpy-seeded weights of std 1/sqrt(fan-in)
# (``family_weights``: CLIP's loss barely falls in 7 steps from its
# initialiser's std 0.02) and the presets' own remat (off); nothing is
# cut. (b): the train step's batch:
# BERT-large's masked LM on 16 x 512 tokens with 15 % of them masked and
# the preset's dropout, ViT-B/16 and ResNet-50 on 64 images of 224^2 with
# 1000 labels, CLIP on 128 pairs of 77 text tokens and 224^2 images.
ENCODER_ROWS = {name: {**row, "remat": False, "numpy_weights": True} for name, row in {
    "bert_large": dict(family="bert", preset="bert_large", batch=16, seq=512, masked=0.15),
    "vit_b16": dict(family="vit", preset="vit_base", batch=64),
    "clip_b32": dict(family="clip", preset=None, batch=128, seq=77),
    "resnet50": dict(family="resnet", preset="resnet50", batch=64),
}.items()}
# (b): 2 warm-up, 3 timed and 1 profiled step.
ENCODER_STEPS = dict(warmup=2, timed=3, profiled=1)
ENCODER_FAMILIES = ("bert", "vit", "clip", "resnet")
# BERT's [MASK] id in its published vocabulary.
BERT_MASK_ID = 103
# (d): every family the port trains, for FSDP2's units (ROADMAP.md fault 7),
# with the blocks of its tiny config.
UNIT_FAMILIES = {"llama": 2, "mixtral": 2, "gpt2": 2, "neox": 2, "opt": 2, "t5": 4,
                 "whisper": 4, "bert": 2, "vit": 2, "clip": 4, "resnet": 2}


def conv_macs(module, image_size, device):
    """ResNet's multiply-accumulates per image, from its convolutions' and
    classifier's shapes (a forward of one image with hooks)."""
    import torch

    from accelerate_tpu_torch.models.resnet import _Conv

    macs = []

    def hook(mod, _, out):
        w = mod.weight
        macs.append(out.numel() // out.shape[0] * w[0].numel())

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (_Conv, torch.nn.Linear))]
    try:
        with torch.no_grad():
            module(torch.zeros(1, image_size, image_size, 3, device=device))
    finally:
        for h in handles:
            h.remove()
    return sum(macs)


def encoder_flops(family, cfg, module, rows, device, **shape) -> tuple[float, str]:
    """FLOPs of one train step (forward and backward) from the module's
    shapes, and the formula. Transformers: 6 x the parameters a token
    passes through (lookup-only tables not; BERT's tied head once) plus
    12 x L x H x S per token for the attention scores and their product
    with v; ResNet: 6 x its convolutions' and classifier's MACs."""
    def n_of(prefix):
        return sum(p.numel() for n, p in module.named_parameters() if n.startswith(prefix))

    if family == "resnet":
        macs = conv_macs(module, shape.get("image_size", 224), device)
        return 6.0 * macs * rows, "6*B*MACs (convolutions and classifier)"
    if family == "bert":
        s = shape["seq"]
        n = (n_of("bert.layers.") + n_of("transform") + n_of("bert.word_embeddings.")
             + n_of("decoder_bias"))
        return (rows * s * (6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size * s),
                "B*S*(6*N + 12*L*H*S)")
    if family == "vit":
        s = cfg.num_patches + 1
        blocks = (6 * n_of("vit.layers.") * s + 12 * cfg.num_hidden_layers
                  * cfg.hidden_size * s * s)
        per_image = blocks + 6 * n_of("vit.patch_embed.") * (s - 1) + 6 * n_of("classifier.")
        return rows * per_image, "B*(6*N_blocks*S + 12*L*H*S^2 + 6*P_patch*(S-1) + 6*P_head)"
    st, sv = shape["seq"], cfg.num_patches + 1
    text = (6 * n_of("text.layers.") * st
            + 12 * cfg.text_num_layers * cfg.text_hidden_size * st * st)
    vision = (6 * n_of("vision.layers.") * sv + 12 * cfg.vision_num_layers
              * cfg.vision_hidden_size * sv * sv + 6 * n_of("vision.patch_embed.") * (sv - 1))
    heads = 6 * (n_of("text_projection.") + n_of("visual_projection."))
    return (rows * (text + vision + heads) + 6 * rows * rows * cfg.projection_dim,
            "B*(6*N_text*S_t + 12*L_t*H_t*S_t^2 + 6*N_vis*S_v + 12*L_v*H_v*S_v^2"
            " + 6*P_patch*(S_v-1) + 6*P_proj) + 6*B^2*D")


# The device-time categories of phase 20's profiles.
ENCODER_CATEGORIES = ("matmul_conv", "elementwise_softmax", "batch_norm", "adamw", "copy_memset")


def _encoder_category(name):
    """matmul/conv (GEMMs, and cuDNN's convolutions by their libraries'
    names), AdamW, copy/memset, or elementwise and softmax (every other
    kernel: norms, activations, casts, masks, softmax, pooling)."""
    cat, low = _category(name), name.lower()
    if cat == "matmul" or low.startswith("cudnn") or any(
            x in low for x in ("implicit_gemm", "implicit_convolve", "wgrad", "dgrad")):
        return "matmul_conv"
    return {"optimizer (foreach)": "adamw", "copy/memset": "copy_memset"}.get(
        cat, "elementwise_softmax")


BATCH_NORM_LABEL = "flax_batch_norm"


@contextlib.contextmanager
def batch_norm_attribution():
    """Around profiled steps (``profile_steps``'s ``attribution``): each
    FlaxBatchNorm forward runs under a ``record_function`` label. Yields
    ``split(prof, steps, by_cat)``, which moves BatchNorm's kernels out of
    the categories ``_encoder_category`` put them in and into
    ``batch_norm``, kernel by kernel: those of its forwards and those of
    the backward of the ops they ran (the autograd nodes whose sequence
    numbers those ops carry)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from accelerate_tpu_torch.models.layers import FlaxBatchNorm

    inner = FlaxBatchNorm.forward

    def labelled(self, *a, **k):
        with record_function(BATCH_NORM_LABEL):
            return inner(self, *a, **k)

    def under_label(e):
        while e is not None:
            if e.name == BATCH_NORM_LABEL:
                return True
            e = e.cpu_parent
        return False

    def op(name):  # aten::_to_copy and ToCopyBackward0 name one node
        return re.sub(r"Backward\d*$", "", name.split(": ")[-1]).replace("aten::", "").replace(
            "_", "").lower()

    def kernels(e):
        yield from e.kernels
        for child in e.cpu_children:
            yield from kernels(child)

    def split(prof, steps, by_cat):
        cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        # The autograd nodes the forward made: an op's sequence number is
        # the next node's, so a node counts where its op's name matches too.
        nodes = {(e.sequence_nr, op(e.name)) for e in cpu
                 if e.sequence_nr >= 0 and under_label(e)}
        roots = [e for e in cpu if e.name == BATCH_NORM_LABEL
                 or (e.name.startswith("autograd::engine::evaluate_function")
                     and (e.sequence_nr, op(e.name)) in nodes)]
        for root in roots:
            for k in kernels(root):
                ms = k.duration / 1e3 / steps
                by_cat[_encoder_category(k.name)] -= ms
                by_cat["batch_norm"] += ms

    FlaxBatchNorm.forward = labelled
    try:
        yield split
    finally:
        FlaxBatchNorm.forward = inner


def tiny_encoder_parity(family, device="cuda"):
    """(a) One bf16 train step of the family's tiny model (the JAX preset's
    ``tiny``, dropout off) on ``device`` and on the CPU from the same
    numpy-seeded weights: loss within 2e-2."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, adamw
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    cfg_cls, mod_cls, loss, make_batch = unit_family(family)
    cfg = cfg_cls.tiny(dtype=torch.bfloat16)
    weights = family_weights(mod_cls(cfg, device="cpu"))
    losses = {}
    for label, on_cpu in (("card", device == "cpu"), ("cpu", True)):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(mixed_precision="bf16", cpu=on_cpu)
        module = mod_cls(cfg)
        module.load_state_dict(weights)
        acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(loss, max_grad_norm=1.0,
                                      mutable_state=family == "resnet")
        _, metrics = step(acc.train_state, make_batch(cfg, acc.device))
        losses[label] = float(metrics["loss"])
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    return {"train_loss": losses, "train_loss_rel": rel,
            "ok": bool(math.isfinite(losses["card"]) and rel <= 2e-2)}


def unit_family(name):
    """(config class, module class, loss, batch maker) of each family for
    (d): 4 rows of 16 tokens (T5: 10 and 6, Whisper: 40 frames and 6
    tokens), and the encoders' tiny batches."""
    from accelerate_tpu_torch import models

    if name in ("llama", "mixtral"):
        if name == "llama":
            cfg_cls, mod_cls = models.LlamaConfig, models.LlamaForCausalLM
            loss = lambda m, b: models.cross_entropy_loss(m(b["x"]), b["y"])  # noqa: E731
        else:
            cfg_cls, mod_cls = models.MixtralConfig, models.MixtralForCausalLM
            loss = lambda m, b: models.moe_cross_entropy_loss(m, b["x"], b["y"])  # noqa: E731
        return cfg_cls, mod_cls, loss, lambda cfg, device: family_batch(
            name, cfg, 4, device, seed=5, seq=16)
    cfg_cls, mod_cls = family_classes(name)
    shape = {"t5": dict(seq=10, dec_seq=6), "whisper": dict(frames=40, dec_seq=6),
             "clip": dict(seq=12), "resnet": dict(image_size=32)}.get(name, dict(seq=16))
    return cfg_cls, mod_cls, family_loss(name), lambda cfg, device: family_batch(
        name, cfg, 4, device, seed=5, **shape)


def fsdp_units_check(device="cuda"):
    """(d) FSDP2 over a process group of one (torchrun's variables in this
    process for the check: NCCL on the card, gloo on the CPU): each
    family's tiny model in bf16 gets one unit on every block and one on
    the root, and one train step through them gives a finite loss. The
    group is destroyed and the variables restored after."""
    import torch
    from torch.distributed.fsdp import FSDPModule

    from accelerate_tpu_torch import Accelerator, FullyShardedDataParallelPlugin, Model, adamw
    from accelerate_tpu_torch.parallel.fsdp import decoder_blocks
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    saved = {k: os.environ.get(k) for k in torchrun_env(0)}
    out = {}
    try:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        os.environ.update(torchrun_env(free_port()))
        for name, n in UNIT_FAMILIES.items():
            cfg_cls, mod_cls, loss, make_batch = unit_family(name)
            cfg = cfg_cls.tiny(dtype=torch.bfloat16)
            acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                              fsdp_plugin=FullyShardedDataParallelPlugin())
            module = mod_cls(cfg)
            module.load_state_dict(family_weights(module))
            model, _ = acc.prepare(Model(module), adamw(3e-4))
            blocks = decoder_blocks(model.module)
            step = acc.prepare_train_step(loss, max_grad_norm=1.0,
                                          mutable_state=name == "resnet")
            _, metrics = step(acc.train_state, make_batch(cfg, acc.device))
            out[name] = {"blocks": len(blocks), "expected": n,
                         "units": sum(isinstance(b, FSDPModule) for b in blocks),
                         "root": isinstance(model.module, FSDPModule),
                         "backend": acc.state._partial.backend, "world": acc.num_processes,
                         "loss": float(metrics["loss"])}
            del acc, model, module, step
            for cls in (AcceleratorState, GradientState):
                cls._reset_state()
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ok = all(r["blocks"] == r["units"] == r["expected"] and r["root"] and r["world"] == 1
             and math.isfinite(r["loss"]) for r in out.values())
    return {"families": out, "ok": ok}


def encoders_phase(hf, device="cuda", rows=None, steps=ENCODER_STEPS):
    """Phase 20: (a) the tiny encoders card against CPU, (b) the full-width
    train steps, (c) the hub round trips of BERT, ViT and CLIP, (d) FSDP2's
    units at world size 1 for every family. The keyword arguments shrink
    it for a rehearsal on the CPU."""
    import torch

    rows = rows or ENCODER_ROWS
    t0 = time.perf_counter()
    part_s = {}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        part_s[key] = time.perf_counter() - t
        return res

    tiny = {f: timed(f"tiny_{f}", tiny_encoder_parity, f, device) for f in ENCODER_FAMILIES}
    train = {}
    for name, row in rows.items():
        train[name] = timed(f"train_{name}", family_train_steps, hf, name, device, row,
                            steps)[0]
        gc.collect()
        torch.cuda.empty_cache()
    hub = {f: timed(f"hub_{f}", family_hub_round_trip, f, device) for f in ("bert", "vit",
                                                                           "clip")}
    units = timed("fsdp_units", fsdp_units_check, device)
    checks = {**{f"tiny_{f}": r["ok"] for f, r in tiny.items()},
              **{f"train_{n}_{k}": v for n, r in train.items() for k, v in r["checks"].items()},
              **{f"hub_{f}_bit_equal": r["bit_equal"] and r["equal_to_source"]
                 for f, r in hub.items()},
              "fsdp_units": units["ok"]}
    return {"phase": "encoders", "tiny": tiny, "train": train, "hub_round_trip": hub,
            "fsdp_units": units, "phase_s": time.perf_counter() - t0, "part_s": part_s,
            "checks": checks, "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 21: big-model inference
# ---------------------------------------------------------------------------

# meta-llama/Llama-2-7b-hf's config.json: its published widths at its full
# depth (6.74B parameters, 13.5 GB in bf16), no tied head.
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                 max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False)
# (a): budgets of about 6 GiB on the card and 6 GiB of pinned host memory, the
# rest on disk; 2 GB shards; weights of std 0.02 from seed 21; (d): 4 layers
# at TP 2 x PP 2.
BIG_MODEL = dict(prompt=(LLAMA2_7B_LIKE["b"], LLAMA2_7B_LIKE["s"]), gpu_budget=6 * 2**30,
                 cpu_budget=6 * 2**30, shard_bytes=2 * 10**9, seed=21, std=0.02,
                 megatron_layers=4, megatron_tp=2, megatron_pp=2)
# (b): the JAX package's own gates (tests/test_quantization.py:103-118):
# cosine of the logits against full precision, int8's greedy agreement,
# bytes against the fp32 weights'. They hold its test's model, the tiny
# 2-layer Llama, which (b) runs on the card; on Llama-2-7B's widths a random
# network amplifies the quantization error layer by layer (on an H100:
# int8 cosine 0.978, NF4 0.413 at 32 layers), so there (b) gates the bytes
# and the mechanism and reports the cosine and agreement at the depths of
# ``QUANT_DEPTHS``.
QUANT_GATES = {8: dict(cosine=0.999, agreement=0.8, bytes_share=0.45),
               4: dict(cosine=0.94, agreement=None, bytes_share=0.35)}
QUANT_DEPTHS = (2, 8)
# (c): the seven streamed families at their tiny widths.
# Each dispatched forward against the model resident on the card: bit for
# bit in six families. Whisper's differs in the last bits (2.3e-7-3.7e-7 on
# an H100): its convolution stem leaves the encoder's activations in
# channels-first memory, and torch.matmul folds such a 3-D input into one
# mm when the weight requires grad (the resident module's parameters) but
# runs a batched product when it does not (the streamed tensors). So the
# gate is fp32 rounding; against the port on the CPU, the fp32 parity
# tolerance.
STREAM_FAMILIES = ("llama", "mixtral", "gpt2", "opt", "neox", "t5", "whisper")
STREAM_CARD_REL = 1e-6
STREAM_REL = 1e-4


def big_model_config(width, layers=None, **kw):
    """The Llama config of ``width`` in bf16 with flash attention and the
    unrolled flax layout (a checkpoint leaf per layer, so that whole layers
    land on a tier)."""
    import torch

    from accelerate_tpu_torch.models import LlamaConfig

    width = dict(width, **({"num_hidden_layers": layers} if layers else {}))
    return LlamaConfig(**width, dtype=torch.bfloat16, attention_impl="flash",
                       scan_layers=kw.pop("scan_layers", False), **kw)


def seeded_port_params(module, device, seed, std, dtype):
    """The module's parameters in the port's layout from one
    ``torch.Generator``: normal(0, std) matrices, unit norm weights, zero
    biases, in ``dtype`` on ``device`` (name → tensor, in order)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            out[name] = (torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32)
                         * std).to(dtype)
        else:
            fill = 0.0 if name.endswith("bias") else 1.0
            out[name] = torch.full(p.shape, fill, device=device, dtype=dtype)
    return out


def write_flax_checkpoint(module, params, root, shard_bytes):
    """The JAX package's sharded safetensors checkpoint of ``params`` (the
    port's names and layouts): flax names and layouts, stacked where the
    config scans. Returns its bytes."""
    import torch

    from accelerate_tpu_torch.models.convert import flax_leaf
    from accelerate_tpu_torch.utils.other import save_sharded_safetensors

    rows: dict = {}
    for name, t in params.items():
        leaf = flax_leaf(module, name)
        rows.setdefault(leaf.name, []).append((leaf.index or 0,
                                               leaf.to_flax(t).contiguous().cpu()))
    flat = {}
    for name, values in rows.items():
        values.sort(key=lambda kv: kv[0])
        flat[name] = values[0][1] if len(values) == 1 else torch.stack([v for _, v in values])
    del rows
    save_sharded_safetensors(flat, root, max_shard_size=shard_bytes)
    return sum(t.numel() * t.element_size() for t in flat.values())


def layer_bytes(cfg, dtype_bytes=2) -> int:
    """Bytes of one decoder layer of a Llama config."""
    h, d = cfg.hidden_size, cfg.head_dim
    attn = h * cfg.num_attention_heads * d * 2 + h * cfg.num_key_value_heads * d * 2
    return (attn + 3 * h * cfg.intermediate_size + 2 * h) * dtype_bytes


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def streamed_llama(hf, cfg, ckpt, offload_dir, ids, device, budgets):
    """(a), streamed: the checkpoint dispatched over the card, the host and
    the disk by ``load_checkpoint_and_dispatch(device_map="auto")``, one
    warm forward, then the counted and timed one."""
    import torch

    from accelerate_tpu_torch import load_checkpoint_and_dispatch
    from accelerate_tpu_torch.models import LlamaForCausalLM

    dev = torch.device(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = load_checkpoint_and_dispatch(
        LlamaForCausalLM(cfg, device="meta"), ckpt, device_map="auto",
        max_memory={dev: budgets["gpu"], "cpu": budgets["cpu"]}, offload_folder=offload_dir,
        dtype=torch.bfloat16)
    load_s = time.perf_counter() - t0
    model(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    t0 = time.perf_counter()
    logits = model(ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    copied = model.last_stream_copied_bytes
    tiers = model.tier_bytes()
    entries = {k: sorted(n for n, v in model.device_map.items() if v == k)
               for k in ("cpu", "disk")}
    out = {"load_s": load_s, "tier_bytes": tiers, "device_map_entries": len(model.device_map),
           "host_entries": entries["cpu"], "disk_entries": entries["disk"],
           "forward_s": seconds, "h2d_bytes": copied, "h2d_gb_s": copied / seconds / 1e9,
           "allocated_before": base, "max_memory_allocated": peak,
           "phase_peak_bytes": peak - base,
           "last_stream_peak_bytes": model.last_stream_peak_bytes,
           "hbm_resident_bytes": model.hbm_resident_bytes(),
           "launches": launches, "variant_launches": variant_launches,
           "streamed": model.last_stream_peak_bytes is not None}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return logits, out


def resident_llama(hf, cfg, ckpt, ids, device):
    """(a), resident: the same checkpoint loaded whole on the card as fp32
    masters (the port's convention: cast to bf16 at use, the same bf16
    values), one counted and timed forward."""
    import torch

    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.utils import load_checkpoint_in_model

    t0 = time.perf_counter()
    module = LlamaForCausalLM(cfg, device="meta")
    store, _ = load_checkpoint_in_model(module, ckpt, device_map={"": torch.device(device)})
    module.load_state_dict(store, assign=True)
    del store
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = module(ids)
    torch.cuda.synchronize()
    return module, logits, {"load_s": load_s, "forward_s": time.perf_counter() - t0,
                            "max_memory_allocated": torch.cuda.max_memory_allocated(),
                            "fp32_bytes": sum(p.numel() * 4 for p in module.parameters()),
                            "launches": dict(hf.LAUNCHES),
                            "variant_launches": dict(hf.VARIANT_LAUNCHES)}


def truncated_llama(module, layers):
    """The first ``layers`` blocks of a Llama with its embedding, final norm
    and head: a module sharing the tensors of ``module``."""
    from accelerate_tpu_torch.models import LlamaForCausalLM

    cfg = dataclasses.replace(module.config, num_hidden_layers=layers)
    sub = LlamaForCausalLM(cfg, device="meta")
    sub.load_state_dict({k: v for k, v in module.state_dict().items()
                         if not k.startswith("model.layers.") or int(k.split(".")[2]) < layers},
                        assign=True)
    return sub


def dequantized_reference(qm, cfg):
    """The Llama whose weights are the quantized model's dequantized values
    (the compute dtype; its other weights shared): what the quantized
    forward must compute, weight for weight."""
    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.models.convert import llama_views_from_flax
    from accelerate_tpu_torch.utils import dequantize_params

    ref = LlamaForCausalLM(cfg, device="meta")
    views = llama_views_from_flax(cfg, dequantize_params(qm.params,
                                                         qm.quantization_config.compute_dtype))
    ref.load_state_dict({k: v.contiguous() for k, v in views.items()}, assign=True)
    return ref


def quantized_llama(module, ref, ids, bits, gates, depths=QUANT_DEPTHS):
    """(b): ``load_and_quantize_model`` at ``bits`` on the resident model:
    its bytes against the fp32 masters', forward ms and peak; its logits
    equal bit for bit to the model of its dequantized weights (the
    mechanism); cosine and greedy agreement against the bf16 logits, at
    full depth and at the first ``depths`` layers (reported: a random deep
    network amplifies the quantization error layer by layer)."""
    import torch

    from accelerate_tpu_torch import Model
    from accelerate_tpu_torch.utils import (
        QuantizationConfig,
        load_and_quantize_model,
        quantized_nbytes,
    )

    qcfg = QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4,
                              compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    qm = load_and_quantize_model(Model(module), qcfg)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    qm(ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = qm(ids)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    nbytes = quantized_nbytes(qm.params)
    full = sum(p.numel() * 4 for p in module.parameters())
    with torch.no_grad():
        mechanism = dequantized_reference(qm, module.config)(ids)
    by_depth = {}
    for n in (d for d in depths if d < module.config.num_hidden_layers):
        sub = truncated_llama(module, n)
        with torch.no_grad():
            want = sub(ids)
        got = load_and_quantize_model(Model(sub), qcfg)(ids)
        by_depth[n] = {"cosine": _cosine(got.float(), want.float()),
                       "agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean())}
        del sub, got, want
    checks = {"mechanism_bit_equal": bool(torch.equal(logits, mechanism)),
              "bytes": nbytes < gates["bytes_share"] * full,
              "finite": bool(torch.isfinite(logits).all())}
    res = {"bits": bits, "quantize_s": quantize_s, "bytes": nbytes, "fp32_bytes": full,
           "bytes_share": nbytes / full, "forward_ms": ms, "max_memory_allocated": peak,
           "cosine": _cosine(logits.float(), ref.float()),
           "agreement": float((logits.argmax(-1) == ref.argmax(-1)).float().mean()),
           "mechanism_rel": rel_err(logits, mechanism), "by_depth": by_depth,
           "checks": checks}
    del qm, mechanism
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tiny_quantized_parity(bits, gates, device="cuda"):
    """(b) The JAX package's own quantization test on the card: its tiny
    fp32 Llama (``LlamaConfig.tiny``, weights of std 1/sqrt(fan-in), as
    its initialisers draw them), fp32 compute, ids (2, 16): cosine against
    full precision, int8's greedy agreement, bytes against the fp32
    weights'."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Model
    from accelerate_tpu_torch.utils import (
        QuantizationConfig,
        load_and_quantize_model,
        quantized_nbytes,
    )

    cfg, module = stream_family_module("llama", device)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    ids = ids.to(device)
    with torch.no_grad():
        ref = module(ids).float()
    qm = load_and_quantize_model(Model(module), QuantizationConfig(
        load_in_8bit=bits == 8, load_in_4bit=bits == 4, compute_dtype=torch.float32))
    got = qm(ids).float()
    cosine = _cosine(got, ref)
    agreement = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    share = quantized_nbytes(qm.params) / sum(p.numel() * 4 for p in module.parameters())
    checks = {"cosine": cosine > gates["cosine"], "bytes": share < gates["bytes_share"]}
    if gates["agreement"] is not None:
        checks["agreement"] = agreement >= gates["agreement"]
    return {"bits": bits, "cosine": cosine, "agreement": agreement, "bytes_share": share,
            "gates": gates, "checks": checks}


def stream_family_module(family, device, seed=0):
    """A family's tiny fp32 model (its config's ``tiny``) with numpy-seeded
    weights (``family_weights``) on ``device``."""
    import torch

    cfg_cls, mod_cls = family_classes(family)
    cfg = cfg_cls.tiny(dtype=torch.float32)
    module = mod_cls(cfg)
    module.load_state_dict(family_weights(module, seed))
    return cfg, module.to(device)


def stream_family_inputs(family, cfg, device):
    """The forward's inputs: ids; T5's encoder and decoder ids; Whisper's
    (B, T, mel) features and decoder ids."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 12))).to(device)
    if family == "t5":
        return torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 10))).to(device), ids[:, :8]
    if family == "whisper":
        feats = rng.standard_normal((2, 40, cfg.num_mel_bins)).astype(np.float32)
        return torch.from_numpy(feats).to(device), ids[:, :6]
    return (ids,)


def tiny_stream_parity(family, device="cuda", scratch=None):
    """(c) One family's tiny model: ``dispatch_model`` over the card, the
    host and the disk, ``cpu_offload``, ``disk_offload`` and
    ``cpu_offload_with_hook`` chained to a second model of the family; each
    forward within ``STREAM_CARD_REL`` of the model resident on the card
    (and whether bit for bit) and ``STREAM_REL`` of the port on the CPU;
    every dispatched call streamed (a fallback to materialising fails)."""
    import torch

    from accelerate_tpu_torch import (
        Model,
        cpu_offload,
        cpu_offload_with_hook,
        disk_offload,
        dispatch_model,
    )
    from accelerate_tpu_torch.utils import (
        compute_abstract_params,
        compute_module_sizes,
        infer_auto_device_map,
    )

    dev = torch.device(device)
    cfg, host = stream_family_module(family, "cpu")
    _, host2 = stream_family_module(family, "cpu", seed=1)
    x_cpu = stream_family_inputs(family, cfg, "cpu")
    x = tuple(t.to(dev) for t in x_cpu)
    with torch.no_grad():
        cpu_ref, cpu_ref2 = host(*x_cpu), host2(*x_cpu)
        card = stream_family_module(family, dev)[1]
        card2 = stream_family_module(family, dev, seed=1)[1]
        ref, ref2 = card(*x), card2(*x)
    del card, card2
    abstract = compute_abstract_params(host)
    sizes = compute_module_sizes(abstract)
    device_map = infer_auto_device_map(abstract, {dev: sizes[""] // 3, "cpu": sizes[""] // 3})
    runs = {"dispatch_model": dispatch_model(host, device_map, offload_dir=os.path.join(
                scratch, f"{family}_mixed")),
            "cpu_offload": cpu_offload(host, execution_device=dev),
            "disk_offload": disk_offload(host, os.path.join(scratch, f"{family}_disk"),
                                         execution_device=dev)}
    res, checks = {}, {}
    for name, model in runs.items():
        got = model(*x)
        res[name] = {"bit_equal": bool(torch.equal(got, ref)), "rel_to_card": rel_err(got, ref),
                     "rel_to_cpu": rel_err(got.cpu(), cpu_ref),
                     "streamed": model.last_stream_peak_bytes is not None,
                     "tier_bytes": model.tier_bytes()}
        checks[name] = (res[name]["rel_to_card"] <= STREAM_CARD_REL and res[name]["streamed"]
                        and res[name]["rel_to_cpu"] <= STREAM_REL)
    hooked1, hook1 = cpu_offload_with_hook(Model(host), execution_device=dev)
    hooked2, _ = cpu_offload_with_hook(Model(host2), execution_device=dev,
                                       prev_module_hook=hook1)
    with torch.no_grad():
        a = hooked1(*x)
        b = hooked2(*x)
    chained = (not hooked1._on_device and hooked2._on_device
               and next(host.parameters()).device.type == "cpu"
               and next(host2.parameters()).device.type == dev.type)
    hook = {"bit_equal": bool(torch.equal(a, ref) and torch.equal(b, ref2)),
            "rel_to_card": max(rel_err(a, ref), rel_err(b, ref2)),
            "rel_to_cpu": max(rel_err(a.cpu(), cpu_ref), rel_err(b.cpu(), cpu_ref2)),
            "chained": chained}
    res["cpu_offload_with_hook"] = hook
    checks["cpu_offload_with_hook"] = (hook["rel_to_card"] <= STREAM_CARD_REL and chained
                                       and hook["rel_to_cpu"] <= STREAM_REL)
    return {"family": family, "placements": sorted({str(v) for v in device_map.values()}),
            **res, "checks": checks, "ok": all(checks.values())}


def _numpy_tree(tree):
    """A tree of tensors as fp32 numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.float().cpu().numpy()


def megatron_tp_pp_split(sd, tp, pp, layers):
    """Megatron's (tp, pp) rank dicts of a megatron-core flat dict: column-
    parallel weights split on dim 0 (SwiGLU's fc1 by its gate and up halves
    per rank), row-parallel on dim 1, the rest replicated; layers split
    into ``pp`` stages with stage-local numbers, the embedding on the first
    stage, the final norm and output layer on the last."""
    import numpy as np

    per_stage = layers // pp
    ranks = {}
    for t in range(tp):
        for p in range(pp):
            ranks[(t, p)] = {}
    for name, arr in sd.items():
        if name.endswith("linear_fc1.weight"):
            gate, up = np.split(arr, 2, axis=0)
            parts = [np.concatenate([g, u]) for g, u in zip(np.split(gate, tp), np.split(up, tp))]
        elif name.endswith(("linear_qkv.weight", "word_embeddings.weight", "output_layer.weight")):
            parts = np.split(arr, tp, axis=0)
        elif name.endswith(("linear_proj.weight", "linear_fc2.weight")):
            parts = np.split(arr, tp, axis=1)
        else:
            parts = [arr] * tp
        m = re.match(r"(decoder\.layers\.)(\d+)(\..+)", name)
        for t, part in enumerate(parts):
            if m:
                i = int(m.group(2))
                ranks[(t, i // per_stage)][f"{m.group(1)}{i % per_stage}{m.group(3)}"] = part
            elif name.startswith("embedding."):
                ranks[(t, 0)][name] = part
            else:
                ranks[(t, pp - 1)][name] = part
    return ranks


def megatron_import(root, device="cuda", width=LLAMA2_7B, spec=BIG_MODEL):
    """(d): a megatron-core checkpoint of Llama-2-7B's widths at
    ``megatron_layers`` layers, TP x PP ``mp_rank_0T_00P`` dirs written by
    ``llama_params_to_megatron_core`` and ``torch.save`` (bf16 tensors, the
    checkpoint's args), loaded onto the card by ``load_megatron_model``;
    its logits equal bit for bit to the port's model built from the same
    flax tree directly."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.models.convert import llama_params_from_flax, llama_params_to_flax
    from accelerate_tpu_torch.models.megatron import (
        llama_params_to_megatron_core,
        load_megatron_model,
    )

    t0 = time.perf_counter()
    cfg = big_model_config(width, spec["megatron_layers"], scan_layers=True)
    params = seeded_port_params(LlamaForCausalLM(cfg, device="meta"), device, spec["seed"] + 1,
                                spec["std"], torch.bfloat16)
    tree = _numpy_tree(llama_params_to_flax(cfg, params))
    del params
    sd = llama_params_to_megatron_core(cfg, tree)
    args = {"padded_vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "ffn_hidden_size": cfg.intermediate_size, "num_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_query_groups": cfg.num_key_value_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "norm_epsilon": cfg.rms_norm_eps, "rotary_base": cfg.rope_theta,
            "untie_embeddings_and_output_weights": True}
    it = Path(root) / "iter_0000001"
    ranks = megatron_tp_pp_split(sd, spec["megatron_tp"], spec["megatron_pp"],
                                 cfg.num_hidden_layers)
    del sd
    nbytes = 0
    for (t, p), part in ranks.items():
        d = it / f"mp_rank_{t:02d}_{p:03d}"
        d.mkdir(parents=True)
        model = {k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
                 for k, v in part.items()}
        nbytes += sum(v.numel() * 2 for v in model.values())
        torch.save({"model": model, "args": args, "checkpoint_version": 3.0},
                   d / "model_optim_rng.pt")
    del ranks
    (Path(root) / "latest_checkpointed_iteration.txt").write_text("1")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_megatron_model(str(root), device=device)
    load_s = time.perf_counter() - t0
    direct = LlamaForCausalLM(model.config, device="meta")
    direct.load_state_dict(llama_params_from_flax(model.config, tree), assign=True)
    direct = direct.to(device)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 256))).to(device)
    with torch.no_grad():
        got, want = model(ids), direct(ids)
    bit_equal = bool(torch.equal(got, want))
    del model, direct
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_hidden_layers, "tp": spec["megatron_tp"], "pp": spec["megatron_pp"],
            "checkpoint_bytes": nbytes, "write_s": write_s, "load_s": load_s,
            "bit_equal": bit_equal, "finite": bool(torch.isfinite(got).all()),
            "ok": bit_equal and bool(torch.isfinite(got).all())}


def big_model_phase(hf, device="cuda", width=LLAMA2_7B, spec=BIG_MODEL,
                    families=STREAM_FAMILIES, megatron_width=None, smi=None):
    """Phase 21: (a) Llama-2-7B streamed past a budget on the card and the
    same checkpoint resident, (b) weight-only int8 and NF4 on the resident
    model, (c) the seven families' tiny models dispatched, offloaded and
    hooked, (d) a Megatron-core TP x PP checkpoint imported. The keyword
    arguments shrink it for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.utils.modeling import placement_key

    t0 = time.perf_counter()
    part_s = {}
    cfg = big_model_config(width)
    bf16_bytes = 2 * llama_n_params(width)
    megatron_bytes = 2 * llama_n_params(dict(megatron_width or width,
                                             num_hidden_layers=spec["megatron_layers"]))
    # Host: the checkpoint's copy before it is written, the pinned tier and
    # the megatron conversion's fp32 copies, each at most the model's bytes.
    need_host = 3 * bf16_bytes
    mem = mem_available_bytes()
    root, disk = checkpoint_root(bf16_bytes + spec["cpu_budget"] + megatron_bytes)
    room = {"mem_available_bytes": mem, "need_host_bytes": need_host, **disk}
    if mem is not None and mem < need_host:
        shutil.rmtree(root, ignore_errors=True)
        return {"phase": "big_model", "room": room, "checks": {"host_memory": False},
                "ok": False}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        part_s[key] = time.perf_counter() - t
        return res

    try:
        ckpt = os.path.join(root, "llama2_7b")
        meta = LlamaForCausalLM(cfg, device="meta")
        params = seeded_port_params(meta, device, spec["seed"], spec["std"], torch.bfloat16)
        ckpt_bytes = timed("write_checkpoint", write_flax_checkpoint, meta, params, ckpt,
                           spec["shard_bytes"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        ids = torch.from_numpy(np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab_size, spec["prompt"])).to(device)
        budgets = {"gpu": spec["gpu_budget"], "cpu": spec["cpu_budget"]}
        streamed_logits, stream = timed("stream", streamed_llama, hf, cfg, ckpt,
                                        os.path.join(root, "offload"), ids, device, budgets)
        module, resident_logits, resident = timed("resident", resident_llama, hf, cfg, ckpt,
                                                  ids, device)
        bit_equal = bool(torch.equal(streamed_logits, resident_logits))
        logits_rel = rel_err(streamed_logits, resident_logits)
        quant = {bits: timed(f"quantize_{bits}", quantized_llama, module, resident_logits, ids,
                             bits, QUANT_GATES[bits]) for bits in (8, 4)}
        tiny_quant = {bits: tiny_quantized_parity(bits, QUANT_GATES[bits], device)
                      for bits in (8, 4)}
        finite = bool(torch.isfinite(resident_logits).all())
        del module, streamed_logits, resident_logits
        gc.collect()
        torch.cuda.empty_cache()
        tiny = {f: timed(f"tiny_{f}", tiny_stream_parity, f, device, root) for f in families}
        megatron = timed("megatron", megatron_import, os.path.join(root, "megatron"), device,
                         megatron_width or width, spec)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    block = layer_bytes(cfg)
    bound = spec["gpu_budget"] + 2 * block
    label = {8: "int8", 4: "nf4"}
    checks = {"streamed": stream["streamed"],
              "three_tiers": all(stream["tier_bytes"].get(k, 0) > 0 for k in (
                  placement_key(torch.device(device)), "cpu", "disk")),
              "peak_within_budget_plus_two_blocks": stream["phase_peak_bytes"] <= bound,
              "logits_bit_equal": bit_equal, "finite": finite,
              "stream_launches": stream["launches"]["flash_fwd"] == cfg.num_hidden_layers,
              "resident_launches": resident["launches"]["flash_fwd"] == cfg.num_hidden_layers,
              **{f"{label[b]}_{k}": v for b, q in quant.items() for k, v in q["checks"].items()},
              **{f"tiny_{label[b]}_{k}": v for b, q in tiny_quant.items()
                 for k, v in q["checks"].items()},
              **{f"tiny_{f}_{k}": v for f, r in tiny.items() for k, v in r["checks"].items()},
              "megatron_bit_equal": megatron["ok"]}
    return {"phase": "big_model", "nvidia_smi": smi, "model": "Llama-2-7B widths",
            "layers": cfg.num_hidden_layers, "prompt": list(spec["prompt"]),
            "params_bf16_bytes": bf16_bytes, "checkpoint_bytes": ckpt_bytes,
            "room": room,
            "budgets": {"gpu": spec["gpu_budget"], "cpu": spec["cpu_budget"]},
            "block_bytes": block, "budget_plus_two_blocks": bound, "stream": stream,
            "resident": resident, "logits_bit_equal": bit_equal, "logits_rel": logits_rel,
            "stream_over_resident_s": stream["forward_s"] / resident["forward_s"],
            "quantized": {label[b]: q for b, q in quant.items()},
            "tiny_quantized": {label[b]: q for b, q in tiny_quant.items()}, "tiny": tiny,
            "megatron": megatron, "phase_s": time.perf_counter() - t0, "part_s": part_s,
            "checks": checks, "ok": all(checks.values())}


# Phase 22: tensor parallelism at tp=2. NCCL refuses two ranks on one card,
# so the two ranks are two processes on cuda:0 joined by gloo, which stages
# every all-reduce through the host: a step's ms is gloo's, not NCCL's.
TP_STEPS = 3
# The tp=2 step's loss and grad norm against phase 5's tp=1 ones (bf16: the
# row-parallel products sum their halves in another order).
TP_REL_TOL = 2e-2
# Phase 22 (b)'s tie gap and the bound on its tp=2 logits against phase 7's:
# this many times phase 7's bf16 logits' largest difference from the same
# weights' fp32 ones, as phase 18 (e) sets its tie gap. Either bf16 run lies
# about that far from fp32, so the two lie within about twice it of each
# other; the rest covers the row-parallel sums' other order.
TP_PLAIN_FACTOR = 4


def teacher_forced_logits(cfg, model, row, prompt_len, device="cuda", fp32=False):
    """fp32 logits (new tokens, V) of one prefill over ``row`` (1, T), at
    the positions that predicted row[prompt_len:]: the greedy steps' own,
    through the decode plan (its cache sized for this rank's kv heads).
    ``fp32``: the same weights cast to fp32 and every product in fp32."""
    import torch

    from accelerate_tpu_torch import generation as gen

    ids = torch.as_tensor(row).long().reshape(1, -1).to(device)
    fwd = plan_of(model)
    params = gen._decode_params(model)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = {k: v.float() for k, v in params.items()}
    cache = gen.init_cache(cfg, 1, ids.shape[1], device=device,
                           kv_heads=gen._tp_kv_heads(cfg, params))
    with torch.no_grad():
        logits, _ = fwd(cfg, params, ids, cache, return_all=True)
    return logits[0, prompt_len - 1:-1].float().cpu().numpy()


def tp_reference(cfg, module, row, ms_per_token=None, device="cuda"):
    """Phase 22 (b)'s reference from phase 7's tp=1 bf16 model: its greedy
    ``row`` (prompt included), the row's teacher-forced logits, and the
    largest difference of those logits from the same weights' in fp32,
    which sets the tie gap and the bound on the tp=2 logits without
    reading the TP code."""
    import numpy as np

    logits = teacher_forced_logits(cfg, module, row, GEN_PROMPT, device)
    fp32 = teacher_forced_logits(cfg, module, row, GEN_PROMPT, device, fp32=True)
    return {"row": list(row), "ms_per_token": ms_per_token, "logits": logits,
            "plain_delta": float(np.abs(logits - fp32).max())}


def tp_step_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
                 steps=TP_STEPS, profile=True):
    """Phase 22 (a), one rank: phase 5's 1.06B Llama (same weights, batch
    and optimizer) under ``ParallelismConfig(tp_size=2)`` with
    ``llama_tp_rules``: ``steps`` steps counted from zero (metrics, launches
    per step, the all-reduces and their bytes), the last of them under
    torch.profiler's tracing of the card's kernels for the device-busy ms
    by category (gloo's staging copies under ``copy/memset``)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, adamw
    from accelerate_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        cross_entropy_loss,
        llama_tp_rules,
    )
    from accelerate_tpu_torch.parallel.tp import is_split
    from accelerate_tpu_torch.utils.operations import collective_counters

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(tp_size=TP_RANKS))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module, tp_rules=llama_tp_rules()),
                           adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch_size, seq + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    state = acc.train_state
    collective_counters.reset()
    collective_counters.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    metrics, times, prof = [], [], None
    for i in range(steps):
        traced = profile and i == steps - 1
        with (torch.profiler.profile(activities=profiled_activities(host=False)) if traced
              else contextlib.nullcontext()) as prof_i:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        prof = prof_i if traced else prof
        metrics.append(m)
    launches = dict(hf.LAUNCHES)
    variant_launches = dict(hf.VARIANT_LAUNCHES)
    collectives = collective_counters.snapshot()
    collective_counters.enabled = False
    metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    step_ms = float(np.mean(times[1:]))
    busy, by_cat = device_times(prof, 1)[:2] if profile else (None, None)
    split = sum(is_split(p) for p in module.parameters())
    local_params = sum((p.to_local() if is_split(p) else p).numel() for p in module.parameters())
    out = {
        "metrics": metrics, "step_ms": step_ms, "step_ms_each": times,
        "device_busy_ms": busy, "idle_share": None if busy is None else 1 - busy / step_ms,
        "busy_ms_by_category": by_cat, "traced_step": steps if profile else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "variant_launches": variant_launches, "n_layers": cfg.num_hidden_layers,
        "all_reduces_per_step": {op: {"count": c["count"] / steps, "bytes": c["bytes"] / steps}
                                 for op, c in collectives.items()},
        "split_params": split, "local_params": local_params,
        "tp_rank": acc.tensor_parallel_rank,
    }
    del state, step, model, module, acc
    return out


def tp_generate_rank(hf, device="cuda", row=None, width=FULL_WIDTH, prompt_len=GEN_PROMPT,
                     new_tokens=GEN_NEW_TOKENS):
    """Phase 22 (b), one rank: phase 7's bf16 model and prompt at tp=2,
    greedy ``generate`` (a two-token warm-up, then the timed call, its
    kernel launches counted from zero), and the teacher-forced logits of
    phase 7's row (``row``)."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_tp_rules
    from accelerate_tpu_torch.utils.operations import collective_counters

    cfg = LlamaConfig(**width, max_position_embeddings=2048, dtype=torch.bfloat16)
    acc = Accelerator(cpu=device == "cpu", parallelism_config=ParallelismConfig(tp_size=TP_RANKS))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    module.to(torch.bfloat16)
    model = acc.prepare_model(Model(module, tp_rules=llama_tp_rules()))
    prompt = decode_prompt(cfg, acc.device)[:, :prompt_len]
    generate(model, prompt, max_new_tokens=2)  # warm-up
    collective_counters.reset()
    collective_counters.enabled = True
    torch.cuda.synchronize()
    hf.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    variant_launches = dict(hf.VARIANT_LAUNCHES)
    collectives = collective_counters.snapshot()
    collective_counters.enabled = False
    logits = None if row is None else teacher_forced_logits(cfg, model, row, prompt_len,
                                                            acc.device)
    return {"row": out[0, prompt_len:].tolist(), "ms_per_token": wall * 1e3 / new_tokens,
            "variant_launches": variant_launches,
            "all_reduces_per_token": {op: {k: v / new_tokens for k, v in c.items()}
                                      for op, c in collectives.items()}}, logits


def tp_child_main(args: dict) -> int:
    """One rank of phases 22-25: joins the gloo group of
    ``args["world"]`` ranks at ``args["init"]`` itself (``PartialState``
    adopts it; ``LOCAL_RANK`` from the parent puts every rank on cuda:0),
    runs phase 22's (a) and (b), writes (b)'s logits on rank 0 to
    ``args["logits"]`` and prints its line, then runs phase 23
    (``pipeline_child``; on the CPU only with a narrowing ``kw["pp"]``) and
    prints a second line (``{"pp": ...}``), then phases 24 (``ep_child``)
    and 25 (``rest_child``, its checkpoints under ``args["ckpt"]``) alike;
    the parent judges them (``tp_gate``, ``pp_gate``, ``ep_gate``,
    ``rest_gate``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    device = args.get("device", "cuda")
    if device == "cpu":
        _stub_cuda_for_cpu()
    dist.init_process_group("gloo", init_method=args["init"], rank=args["rank"],
                            world_size=args["world"])
    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    kw = args.get("kw", {})
    t0 = time.perf_counter()
    res = {"rank": args["rank"], "backend": dist.get_backend(),
           "device": str(torch.device(device, 0) if device == "cuda" else device),
           "step": tp_step_rank(hf, device=device, **kw.get("step", {}))}
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    res["generate"], logits = tp_generate_rank(hf, device=device, row=args.get("row"),
                                               **kw.get("generate", {}))
    if args["rank"] == 0 and logits is not None:
        np.save(args["logits"], logits)
    res["ok"] = all(math.isfinite(x) for m in res["step"]["metrics"] for x in m)
    res["phase_s"] = time.perf_counter() - t0
    emit(res)
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    # On the CPU phases 23-25 run only when narrowed (a rehearsal passes
    # "pp", "ep" or "rest").
    if device == "cuda" or "pp" in kw:
        emit({"rank": args["rank"], "pp": pipeline_child(hf, device, kw.get("pp"))})
    if device == "cuda" or "ep" in kw:
        gc.collect()
        torch.cuda.empty_cache()
        emit({"rank": args["rank"], "ep": ep_child(hf, device, kw.get("ep"))})
    if device == "cuda" or "rest" in kw:
        gc.collect()
        torch.cuda.empty_cache()
        emit({"rank": args["rank"], "rest": rest_child(
            hf, device, dict(kw.get("rest") or {}, ckpt_dir=args["ckpt"]))})
    if device == "cuda" or "ft" in kw:
        # Phase 26 (e), then (c); (c)'s sticky run last: rank 1 exits 79.
        ft_kw = kw.get("ft") or {}
        emit({"rank": args["rank"], "pp_families": {
            name: pp_family_rank(hf, name, device, row=(ft_kw.get("rows") or {}).get(name))
            for name in PP_FAMILY_RUNS}})
        sdc_res, ctx = sdc_child(hf, device, dict(ft_kw.get("sdc") or {},
                                                  project=args["sdc_project"]))
        emit({"rank": args["rank"], "sdc": sdc_res})
        emit({"rank": args["rank"], "sdc_sticky": sdc_sticky_child(*ctx)})
        # Rank 1 exited in the sticky conviction: no collective after it.
        sys.stdout.flush()
        os._exit(0 if res["ok"] else 1)
    PartialState._reset_state()
    dist.destroy_process_group()
    return 0 if res["ok"] else 1


def run_tp_children(args: dict, timeout: float, ranks=TP_RANKS):
    """``chip_smoke.py --tp-child`` once per rank, all started together and
    all waited for (killed at ``timeout``): by rank, the exit code, the
    JSON lines and the end of standard error."""
    port = free_port()
    env = {**os.environ, "LOCAL_RANK": "0"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-child",
         json.dumps({**args, "rank": r, "world": ranks, "init": f"tcp://127.0.0.1:{port}"})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent) for r in range(ranks)]
    deadline, out = time.perf_counter() + timeout, []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
            out.append((proc.returncode, lines, stderr[-4000:]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def tensor_parallel_phase(hf, phase5, phase7, device="cuda", kw=None, timeout=720,
                          ckpt_dir=None, sdc_project=None):
    """Phase 22: tp=2 as two processes on the card over gloo
    (``run_tp_children``), judged by ``tp_gate``. The children's lines and
    rank 0's logits stay under ``_children`` and ``_logits`` (not printed);
    phase 25 writes its checkpoints under ``ckpt_dir``, phase 26 (c) its
    checkpoint and quarantine record under ``sdc_project``. Rank 1 exits
    SDC_EXIT_CODE after phase 26 (c)'s sticky conviction: its exit code is
    kept under ``_sdc_exit`` and read as 0 by the gates of phases 22-25
    when the quarantine record names it."""
    import numpy as np

    logits_path = tempfile.mktemp(suffix=".npy")
    t0 = time.perf_counter()
    children = run_tp_children({"device": device, "row": phase7["row"],
                                "logits": logits_path, "kw": kw or {}, "ckpt": ckpt_dir,
                                "sdc_project": sdc_project}, timeout)
    seconds = time.perf_counter() - t0
    children, sdc_exit = sticky_exits(children, sdc_project)
    logits = np.load(logits_path) if os.path.exists(logits_path) else None
    if logits is not None:
        os.remove(logits_path)
    return {**tp_gate(children, phase5, phase7, logits), "children_s": seconds,
            "_children": children, "_logits": logits, "_sdc_exit": sdc_exit}


def sticky_exits(children, sdc_project):
    """The children with rank 1's SDC_EXIT_CODE read as 0 where the
    quarantine record under ``sdc_project`` names rank 1 (phase 26 (c)'s
    sticky conviction), and what phase 26's gate reads: the exit codes, the
    quarantined ranks, whether rank 0 was told."""
    from accelerate_tpu_torch.sdc import load_quarantine
    from accelerate_tpu_torch.utils.constants import SDC_EXIT_CODE

    hosts = load_quarantine(sdc_project)["hosts"] if sdc_project else []
    quarantined = [h.get("process_index") for h in hosts]
    told = [next((line["sdc_sticky"] for line in lines if "sdc_sticky" in line), None)
            for _, lines, _ in children]
    out = [(0 if r == 1 and rc == SDC_EXIT_CODE and quarantined == [1] else rc, lines, err)
           for r, (rc, lines, err) in enumerate(children)]
    return out, {"exit_codes": [rc for rc, _, _ in children], "quarantined": quarantined,
                 "peer_quarantined": bool(told[0] and told[0]["peer_quarantined"]),
                 "records": hosts}


def tp_gate(children, phase5, phase7, logits) -> dict:
    """Phase 22's checks on its children's lines: (a) 3 steps' loss and grad
    norm within TP_REL_TOL of phase 5's on every rank, the ranks equal, each
    flash kernel launched once a layer a step on each rank; (b) phase 7's
    greedy tokens at tp=2 equal phase 7's off near-ties and the tp=2
    teacher-forced logits of phase 7's row within a bound of phase 7's.
    Both the tie gap and the bound are TP_PLAIN_FACTOR times phase 7's
    bf16-against-fp32 difference (``tp_reference``; at least TIE_GAP),
    which no TP code enters."""
    import numpy as np

    ranks = [next((line for line in lines if "step" in line), {}) for _, lines, _ in children]
    checks = {"children": all(rc == 0 and r.get("ok") for (rc, _, _), r in zip(children, ranks)),
              "gloo": all(r.get("backend") == "gloo" for r in ranks)}
    res = {"phase": "tensor_parallel", "ranks": TP_RANKS, "backend": ranks[0].get("backend"),
           "devices": [r.get("device") for r in ranks],
           "note": "two processes on one card joined by gloo, which stages each all-reduce "
                   "through the host: step ms are gloo's, not NCCL's"}
    res["seconds"] = max((r.get("phase_s", 0.0) for r in ranks), default=None)
    if not checks["children"] or logits is None:
        checks["children"] = False
        return {**res, "checks": checks, "ok": False,
                "child_exit": [rc for rc, _, _ in children],
                "child_stderr": [err for _, _, err in children]}
    steps = [r["step"] for r in ranks]
    rel = [max(_rel(g, w) for g, w in zip(got, want))
           for m in steps for got, want in zip(m["metrics"], phase5["first_metrics"])]
    checks["metrics_vs_phase5"] = max(rel) <= TP_REL_TOL
    checks["ranks_agree"] = all(s["metrics"] == steps[0]["metrics"] for s in steps)
    checks["launches_per_layer"] = all(
        s["launches_per_step"][k] == s["n_layers"] for s in steps for k in KERNELS)
    ref_row, ref_logits = phase7["row"][GEN_PROMPT:], phase7["logits"]
    delta = float(np.abs(logits - ref_logits).max())
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    tie_gap = max(TIE_GAP, TP_PLAIN_FACTOR * phase7["plain_delta"])
    div = [first_divergence([ref_row], [r["generate"]["row"]], [gaps], tie_gap)[0]
           for r in ranks]
    checks["logits_vs_phase7"] = delta <= tie_gap
    checks["tokens_vs_phase7"] = all(d is None or d["near_tie"] for d in div)
    return {**res,
            "a_step": {"rank_metrics": [s["metrics"] for s in steps],
                       "phase5_metrics": phase5["first_metrics"], "max_rel": max(rel),
                       "step_ms": [s["step_ms"] for s in steps],
                       "step_ms_each": [s["step_ms_each"] for s in steps],
                       "phase5_step_ms": phase5["step_ms"],
                       "device_busy_ms": [s["device_busy_ms"] for s in steps],
                       "busy_ms_by_category": [s["busy_ms_by_category"] for s in steps],
                       "idle_share": [s["idle_share"] for s in steps],
                       "peak_mem_gib": [s["peak_mem_gib"] for s in steps],
                       "launches_per_step": [s["launches_per_step"] for s in steps],
                       "all_reduces_per_step": steps[0]["all_reduces_per_step"],
                       "split_params": steps[0]["split_params"],
                       "local_params": [s["local_params"] for s in steps]},
            "b_generate": {"rows": [r["generate"]["row"] for r in ranks], "phase7_row": ref_row,
                           "first_divergence": div, "logit_delta": delta, "tie_gap": tie_gap,
                           "phase7_bf16_fp32_delta": phase7["plain_delta"],
                           "ms_per_token": [r["generate"]["ms_per_token"] for r in ranks],
                           "all_reduces_per_token": ranks[0]["generate"]["all_reduces_per_token"],
                           "phase7_ms_per_token": phase7.get("ms_per_token")},
            "variant_launches": steps[0]["variant_launches"],
            "generate_variant_launches": ranks[0]["generate"]["variant_launches"],
            "checks": checks, "ok": all(checks.values())}


# Phase 23: pipeline parallelism, the comm hooks and LocalSGD, in phase 22's
# two processes. Gloo stages every send and all-reduce through the host.
PP_STAGES = 2
PP_STEPS = 3
# The interleaved schedule: 3 chunks of 3 layers a rank, as many
# microbatches as stages (the JAX package's rule), of 2 rows each.
PP_VIRTUAL_STAGES = 3
# The pp=2 steps' loss and grad norm against phase 5's (bf16: the
# microbatches' products run at other shapes).
PP_REL_TOL = 2e-2
# The pipelined logits against the same model resident on the card
# (relative L2; bf16 products at another batch shape), and a tiny fp32
# GPT-2's on the card against the CPU's.
PIPPY_REL_TOL = 1e-2
PIPPY_TINY_REL_TOL = 1e-4
# The comm hooks: phase 5's widths at 2 layers (gloo's all-reduce of the
# 18 layers' 4.2 GB of fp32 gradients takes seconds a step).
HOOKS = ("no", "fp16", "bf16", "powersgd")
HOOK_LAYERS = 2
HOOK_STEPS = 3
POWERSGD_RANK = 8
# The wire hooks' losses against "no"'s (absolute), and PowerSGD's reduced
# gradients against the plain version of its algorithm (relative L2).
HOOK_LOSS_TOL = 1e-2
POWERSGD_PLAIN_TOL = 1e-3
LOCAL_SGD = dict(local_sgd_steps=2, steps=4)


def _phase5_batch(cfg, batch_size, seq, device, seed=0):
    import numpy as np
    import torch

    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(batch_size, seq + 1))
    return {"x": torch.from_numpy(ids[:, :-1]).to(device),
            "y": torch.from_numpy(ids[:, 1:]).to(device)}


def _reset_port_state():
    import torch

    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    gc.collect()
    torch.cuda.empty_cache()


def pp_step_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
                 steps=PP_STEPS, virtual_stages=1, n_microbatches=PP_MICROBATCHES,
                 profile=True):
    """Phase 23 (a) and (b), one rank: phase 5's 1.06B Llama (same weights,
    batch and optimizer) under ``ParallelismConfig(pp_size=2,
    pp_virtual_stages=...)``, its loss ``cross_entropy_loss`` of
    ``llama_pipeline_forward``: ``steps`` steps counted from zero (metrics,
    launches, the sends and their bytes), then one more under
    torch.profiler."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        Model,
        ParallelismConfig,
        adamw,
        llama_pipeline_forward,
    )
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.parallel.pp import p2p_counters

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(pp_size=PP_STAGES,
                                                           pp_virtual_stages=virtual_stages))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(
            llama_pipeline_forward(m, b["x"], n_microbatches=n_microbatches), b["y"]),
        max_grad_norm=1.0)
    batch = _phase5_batch(cfg, batch_size, seq, acc.device)
    state = acc.train_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    p2p_counters.reset()
    metrics, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = dict(hf.LAUNCHES)
    variant_launches = dict(hf.VARIANT_LAUNCHES)
    p2p = p2p_counters.snapshot()
    metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    step_ms = float(np.mean(times[1:]))
    prof = profile_steps(step, state, batch, step_ms, steps=1, host=False) if profile else {}
    busy = prof.get("device_busy_ms_per_step")
    out = {
        "metrics": metrics, "step_ms": step_ms, "step_ms_each": times,
        "device_busy_ms": busy, "idle_share": None if busy is None else 1 - busy / step_ms,
        "busy_ms_by_category": prof.get("ms_per_step_by_category"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "variant_launches": variant_launches, "local_layers": sum(
            not isinstance(layer, torch.nn.Identity) for layer in module.model.layers),
        "microbatches": n_microbatches, "virtual_stages": virtual_stages,
        "p2p_per_step": {k: v / steps for k, v in p2p.items()},
        "local_params": sum(p.numel() for p in module.parameters()),
        "pp_rank": acc.pipeline_parallel_rank,
    }
    del state, step, model, module, acc
    return out


def pippy_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
               tiny=None):
    """Phase 23 (c), one rank: ``prepare_pippy`` of phase 5's model (the
    whole weights on each rank, each running its own layers) on phase 5's
    batch, its launches counted from zero, against the same model's
    resident forward on the last stage; then a tiny fp32 GPT-2 pipelined on
    the card against its forward on the CPU."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, prepare_pippy
    from accelerate_tpu_torch.models import GPT2Config, GPT2LMHeadModel, LlamaConfig
    from accelerate_tpu_torch.models import LlamaForCausalLM

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(pp_size=PP_STAGES))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model = Model(module)
    piped = prepare_pippy(model, num_chunks=PP_MICROBATCHES)
    batch = _phase5_batch(cfg, batch_size, seq, acc.device)
    last = acc.pipeline_parallel_rank == PP_STAGES - 1
    with torch.no_grad():
        torch.cuda.synchronize()
        hf.reset_launch_counts()
        t0 = time.perf_counter()
        logits = piped(batch["x"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        variant_launches = dict(hf.VARIANT_LAUNCHES)
        out = {"ms": ms, "variant_launches": variant_launches,
               "launches": dict(hf.LAUNCHES), "last_stage": last,
               "returned": None if logits is None else list(logits.shape)}
        if last:
            ref = model(batch["x"])
            diff = (logits.float() - ref.float()).abs()
            delta = float(diff.max())
            top2 = ref.float().topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > delta
            agree = logits.argmax(-1) == ref.argmax(-1)
            out.update(rel_l2=rel_err(logits, ref), max_abs=delta,
                       clear_positions=int(clear.sum()),
                       argmax_disagree_clear=int((clear & ~agree).sum()),
                       argmax_agree_share=float(agree.float().mean()))
            del ref, diff, top2
        del logits, piped, model, module
        gc.collect()
        torch.cuda.empty_cache()
        # A tiny GPT-2 on the card against its forward on the CPU.
        gcfg = GPT2Config.tiny(dtype=torch.float32, n_layer=4, **(tiny or {}))
        cpu_gpt2 = GPT2LMHeadModel(gcfg)
        cpu_gpt2.init_weights(torch.Generator().manual_seed(0))
        ids = torch.randint(0, gcfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
        ref = cpu_gpt2(ids)
        card = GPT2LMHeadModel(gcfg, device=acc.device)
        card.load_state_dict(cpu_gpt2.state_dict())
        got = prepare_pippy(Model(card), num_chunks=PP_MICROBATCHES, gather_output=True)(
            ids.to(acc.device))
        out["gpt2_rel_l2"] = rel_err(got.cpu(), ref)
    del acc
    return out


def _fingerprint(module):
    """Two int64 sums of the parameters' bit patterns (plain, and weighted
    by position): equal on two ranks when their parameters are bit-equal."""
    import torch

    total = torch.zeros(2, dtype=torch.int64)
    for p in module.parameters():
        bits = p.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        total += torch.stack([bits.sum(), (bits * w).sum()]).cpu()
    return total.tolist()


def _all_ranks(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def powersgd_plain_check(acc, model, loss_fn, batch):
    """PowerSGD's reduction of one fresh backward's gradients (the hook's
    live state, Q and error feedback) against the plain version of the
    algorithm: both ranks' matrices exchanged, P = mean(M Q) orthonormalised
    (QR), Q' = mean(Mᵀ P), M̂ = P Q'ᵀ in fp64 on the gradients' device;
    plain leaves against the fp64 mean. The largest relative L2 by leaf."""
    import torch

    from accelerate_tpu_torch.parallel.comm_hooks import flax_gradients, make_comm_hook_reducer
    from accelerate_tpu_torch.utils import operations

    module = model.module
    named = [(n, p) for n, p in module.named_parameters()]
    for _, p in named:
        p.grad = None
    with model.compute_params(acc._mp_policy.cast_for_compute(acc._cast_params(model))):
        loss_fn(model, batch).float().backward()
    grads, _ = flax_gradients(module, named)
    state = acc._comm_hook_states[0]
    world, rank = acc.num_processes, acc.process_index
    reduced, _ = make_comm_hook_reducer("powersgd", None, world, rank=POWERSGD_RANK)(
        grads, state)
    rel = {}
    for name, g in grads.items():
        st = state.get(name)
        mat = (g.reshape(g.shape[0], -1).float() + st["e"]) if st else g.float()
        both = torch.zeros((world, *mat.shape), dtype=torch.float32, device=mat.device)
        both[rank] = mat
        operations.all_reduce(both)
        mats = both.double()
        if st:
            q = st["q"].double()
            p_, _ = torch.linalg.qr(torch.stack([m @ q for m in mats]).mean(0))
            q2 = torch.stack([m.T @ p_ for m in mats]).mean(0)
            want = (p_ @ q2.T).reshape(g.shape)
        else:
            want = mats.mean(0)
        got = reduced[name].detach().double()
        rel[name] = float(torch.linalg.vector_norm(got - want)
                          / max(float(torch.linalg.vector_norm(want)), 1e-30))
    for _, p in named:
        p.grad = None
    return rel


def hooks_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
               layers=HOOK_LAYERS, steps=HOOK_STEPS, hooks=HOOKS):
    """Phase 23 (d), one rank: phase 5's widths at ``layers`` layers under
    ``dp_replicate=2`` with each comm hook, this rank on its half of phase
    5's batch, ``steps`` steps each (metrics, ms, the all-reduces' bytes);
    then PowerSGD's reduction against its plain version
    (``powersgd_plain_check``)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        DistributedDataParallelKwargs,
        Model,
        ParallelismConfig,
        adamw,
    )
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.utils.operations import collective_counters

    cfg = LlamaConfig(**dict(width, num_hidden_layers=layers), max_position_embeddings=seq,
                      dtype=torch.bfloat16, remat=True, remat_policy="dots",
                      attention_impl="flash")

    def loss_fn(m, b):
        return cross_entropy_loss(m(b["x"]), b["y"])

    out = {}
    for hook in hooks:
        _reset_port_state()
        acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                          parallelism_config=ParallelismConfig(dp_replicate_size=2),
                          kwargs_handlers=[DistributedDataParallelKwargs(
                              comm_hook=hook, powersgd_rank=POWERSGD_RANK)])
        module = LlamaForCausalLM(cfg, device=acc.device)
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
        full = _phase5_batch(cfg, batch_size, seq, acc.device)
        rows = batch_size // acc.num_processes
        batch = {k: v[acc.process_index * rows:(acc.process_index + 1) * rows]
                 for k, v in full.items()}
        state = acc.train_state
        collective_counters.reset()
        collective_counters.enabled = True
        metrics, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        collective_counters.enabled = False
        wire = collective_counters.snapshot().get("all_reduce", {"bytes": 0})["bytes"] / steps
        if hook == "no":  # DDP's reducer all-reduces every fp32 gradient, uncounted
            wire += sum(p.numel() * p.element_size() for p in module.parameters())
        out[hook] = {"metrics": [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                     "step_ms": float(np.mean(times[1:])), "step_ms_each": times,
                     "wire_bytes_per_step": wire}
        if hook == "powersgd":
            out[hook]["plain_rel"] = powersgd_plain_check(acc, model, loss_fn, batch)
        del state, step, model, module, acc
    return out


def local_sgd_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], rows=2,
                   layers=HOOK_LAYERS, spec=LOCAL_SGD):
    """Phase 23 (e), one rank: (d)'s model under DDP at ``dp_replicate=2``,
    each rank on its own batch, ``spec["steps"]`` steps inside
    ``LocalSGD(local_sgd_steps=...)``: every rank's parameter fingerprint
    after each step and after each ``lsgd.step()``."""
    import torch

    from accelerate_tpu_torch import Accelerator, LocalSGD, Model, ParallelismConfig, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss

    _reset_port_state()
    cfg = LlamaConfig(**dict(width, num_hidden_layers=layers), max_position_embeddings=seq,
                      dtype=torch.bfloat16, remat=True, remat_policy="dots",
                      attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(dp_replicate_size=2))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                                  max_grad_norm=1.0)
    batch = _phase5_batch(cfg, rows, seq, acc.device, seed=100 + acc.process_index)
    state, before, after, losses = acc.train_state, [], [], []
    t0 = time.perf_counter()
    with LocalSGD(acc, model, local_sgd_steps=spec["local_sgd_steps"]) as lsgd:
        for _ in range(spec["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            before.append(_all_ranks(_fingerprint(module)))
            state = lsgd.step(state)
            after.append(_all_ranks(_fingerprint(module)))
    seconds = time.perf_counter() - t0
    del state, step, model, module, acc
    return {"losses": losses, "before": before, "after": after, "seconds": seconds,
            "local_sgd_steps": spec["local_sgd_steps"], "enabled": lsgd.enabled}


def pipeline_child(hf, device="cuda", kw=None) -> dict:
    """Phase 23 in one of phase 22's processes: (a)-(e), each part's state
    set up afresh; ``kw`` may narrow each part (the CPU rehearsal)."""
    kw = kw or {}
    t0 = time.perf_counter()
    parts, seconds = {}, {}
    runs = (("gpipe", lambda: pp_step_rank(hf, device=device, **kw.get("step", {}))),
            ("interleaved", lambda: pp_step_rank(
                hf, device=device, virtual_stages=PP_VIRTUAL_STAGES,
                n_microbatches=PP_STAGES, **kw.get("step", {}))),
            ("pippy", lambda: pippy_rank(hf, device=device, **kw.get("pippy", {}))),
            ("hooks", lambda: hooks_rank(hf, device=device, **kw.get("hooks", {}))),
            ("local_sgd", lambda: local_sgd_rank(hf, device=device, **kw.get("local_sgd", {}))))
    for name, run in runs:
        _reset_port_state()
        t = time.perf_counter()
        parts[name] = run()
        seconds[name] = time.perf_counter() - t
    _reset_port_state()
    return {**parts, "part_s": seconds, "seconds": time.perf_counter() - t0}


def pp_gate(children, phase5) -> dict:
    """Phase 23's checks on the children's phase-23 lines: (a) and (b) the
    3 steps' loss and grad norm within PP_REL_TOL of phase 5's on every
    rank, the ranks equal, each flash kernel launched layers × microbatches
    times a step on each rank (36 and 18); (c) the pipelined logits within
    PIPPY_REL_TOL of the resident ones with the argmax equal wherever the
    top-2 gap exceeds their largest difference, only the last stage holding
    them, the tiny GPT-2 within PIPPY_TINY_REL_TOL of the CPU's; (d) the
    wire hooks' losses within HOOK_LOSS_TOL of "no"'s, PowerSGD's first
    loss equal to "no"'s and the rest finite, its reduction within
    POWERSGD_PLAIN_TOL of the plain version; (e) the ranks' parameters
    different before each LocalSGD boundary and bit-equal after it."""
    ranks = [next((line["pp"] for line in reversed(lines) if "pp" in line), None)
             for _, lines, _ in children]
    res = {"phase": "pipeline_parallel", "ranks": PP_STAGES,
           "note": "two processes on one card joined by gloo, which stages every send and "
                   "all-reduce through the host: step ms are gloo's; NCCL point-to-point "
                   "(which refuses two ranks on one device) is not measured",
           "reduced": f"(d) and (e) at {HOOK_LAYERS} of phase 5's 18 layers: gloo's "
                      "all-reduce of the whole model's 4.2 GB of fp32 gradients takes "
                      "seconds a step"}
    checks = {"children": all(rc == 0 for rc, _, _ in children) and all(ranks)}
    if not checks["children"]:
        return {**res, "checks": checks, "ok": False,
                "child_exit": [rc for rc, _, _ in children],
                "child_stderr": [err for _, _, err in children]}

    def rel_to_phase5(metrics):
        return max(_rel(g, w) for got, want in zip(metrics, phase5["first_metrics"])
                   for g, w in zip(got, want))

    out = {}
    for name in ("gpipe", "interleaved"):
        runs = [r[name] for r in ranks]
        rel = [rel_to_phase5(r["metrics"]) for r in runs]
        want = [r["local_layers"] * r["microbatches"] for r in runs]
        checks[f"{name}_vs_phase5"] = len(runs[0]["metrics"]) == PP_STEPS and max(rel) <= PP_REL_TOL
        checks[f"{name}_ranks_agree"] = all(r["metrics"] == runs[0]["metrics"] for r in runs)
        checks[f"{name}_launches"] = all(
            r["launches_per_step"].get(k) == w for r, w in zip(runs, want) for k in KERNELS)
        out[name] = {"rank_metrics": [r["metrics"] for r in runs],
                     "phase5_metrics": phase5["first_metrics"], "max_rel": max(rel),
                     "step_ms": [r["step_ms"] for r in runs],
                     "step_ms_each": [r["step_ms_each"] for r in runs],
                     "phase5_step_ms": phase5["step_ms"],
                     "device_busy_ms": [r["device_busy_ms"] for r in runs],
                     "busy_ms_by_category": [r["busy_ms_by_category"] for r in runs],
                     "idle_share": [r["idle_share"] for r in runs],
                     "peak_mem_gib": [r["peak_mem_gib"] for r in runs],
                     "launches_per_step": [r["launches_per_step"] for r in runs],
                     "launches_wanted": want,
                     "p2p_per_step": [r["p2p_per_step"] for r in runs],
                     "local_layers": [r["local_layers"] for r in runs],
                     "microbatches": runs[0]["microbatches"],
                     "virtual_stages": runs[0]["virtual_stages"]}
    pippy = [r["pippy"] for r in ranks]
    last = pippy[-1]
    checks["pippy_only_last_stage"] = [p["returned"] is not None for p in pippy] == [
        i == PP_STAGES - 1 for i in range(PP_STAGES)]
    checks["pippy_vs_resident"] = (last.get("rel_l2", math.inf) <= PIPPY_REL_TOL
                                   and last.get("argmax_disagree_clear", 1) == 0)
    checks["pippy_gpt2_vs_cpu"] = all(p["gpt2_rel_l2"] <= PIPPY_TINY_REL_TOL for p in pippy)
    out["pippy"] = {**{k: last.get(k) for k in ("rel_l2", "max_abs", "clear_positions",
                                                "argmax_disagree_clear", "argmax_agree_share",
                                                "returned")},
                    "ms": [p["ms"] for p in pippy],
                    "launches": [p["launches"] for p in pippy],
                    "gpt2_rel_l2": [p["gpt2_rel_l2"] for p in pippy]}
    hooks = [r["hooks"] for r in ranks]
    base = hooks[0]["no"]["metrics"]
    wire_dev = {h: max(abs(a[0] - b[0]) for a, b in zip(hooks[0][h]["metrics"], base))
                for h in ("fp16", "bf16")}
    psgd = [h["powersgd"] for h in hooks]
    checks["hooks_ranks_agree"] = all(
        h[k]["metrics"] == hooks[0][k]["metrics"] for h in hooks for k in HOOKS)
    checks["wire_hooks_track_no"] = max(wire_dev.values()) <= HOOK_LOSS_TOL
    checks["powersgd_first_loss"] = psgd[0]["metrics"][0][0] == base[0][0]
    checks["powersgd_finite"] = all(math.isfinite(x) for m in psgd[0]["metrics"] for x in m)
    plain = max(v for p in psgd for v in p["plain_rel"].values())
    checks["powersgd_vs_plain"] = plain <= POWERSGD_PLAIN_TOL
    out["hooks"] = {h: {"metrics": hooks[0][h]["metrics"],
                        "step_ms": [x[h]["step_ms"] for x in hooks],
                        "wire_bytes_per_step": [x[h]["wire_bytes_per_step"] for x in hooks]}
                    for h in HOOKS}
    out["hooks"]["wire_loss_deviation"] = wire_dev
    out["hooks"]["powersgd_plain_rel"] = psgd[0]["plain_rel"]
    out["hooks"]["powersgd_plain_rel_max"] = plain
    lsgd = ranks[0]["local_sgd"]
    k = lsgd["local_sgd_steps"]
    differ = [len({tuple(fp) for fp in step}) > 1 for step in lsgd["before"]]
    equal = [len({tuple(fp) for fp in step}) == 1 for step in lsgd["after"]]
    checks["local_sgd_enabled"] = lsgd["enabled"]
    checks["local_sgd_diverge_between"] = all(differ)
    checks["local_sgd_equal_after_boundary"] = all(
        eq for i, eq in enumerate(equal) if (i + 1) % k == 0)
    out["local_sgd"] = {"losses": [r["local_sgd"]["losses"] for r in ranks],
                        "differ_before": differ, "equal_after": equal,
                        "seconds": lsgd["seconds"]}
    seconds = [r["seconds"] for r in ranks]
    return {**res, **out, "part_s": [r["part_s"] for r in ranks], "seconds": max(seconds),
            "variant_launches": {p: ranks[0][part]["variant_launches"] for p, part in
                                 (("pp_step", "gpipe"), ("pp_interleaved_step", "interleaved"),
                                  ("pippy_forward", "pippy"))},
            "checks": checks, "ok": all(checks.values())}


# Phase 24: expert parallelism, in phase 22's two processes after phase 23.
# Mixtral-8x7B's widths at phase 18 (b)'s 2 layers and batch (2 x 2048), its
# weights (the same seed) and optimizer: (a) ep=2 over dp_shard=2, one row a
# rank, FSDP2 on the rest; (b) sp=2 with ep=2 (ep over sp): Ulysses
# attention and the routing's slot order over the processes' chunks.
EP_STEPS = 3
EP_RUNS = {"ep_step": dict(pc=dict(dp_shard_size=2, ep_size=2), attention_impl="flash"),
           "sp_ep_step": dict(pc=dict(sp_size=2, ep_size=2), attention_impl="ulysses")}
# Against phase 18 (b)'s first steps (bf16: the products run on other row
# counts, and the gloo sums in another order). Step 1 runs on the same
# weights: its dropped choices equal, its loss within EP_STEP1_LOSS_TOL and
# its grad norm within EP_STEP1_NORM_TOL. The bf16 rounding of N gradient
# entries moves their norm by about 2^-9/sqrt(N): an H100 gave losses
# bit-equal and grad norms 3.2e-6 (ep over dp_shard) and 9.8e-6 (ep over
# sp) apart at full width, the CPU 1.5e-7 and 5.0e-5 at the tests' narrow
# width; a misplaced row moves the loss itself. From step 2 the weights are the first update's,
# and step 1's rounding has grown through it: loss and grad norm within
# EP_REL_TOL, dropped choices within EP_DROP_SHARE of the routed ones (a
# near-tie may move) plus EP_REL_TOL of phase 18's drops (phase 24 (a) on
# an H100: 778 against 760 at step 3, 1.10e-3 of the 16,384 routed).
# ``drop_shift_witness`` measures that growth without ep (PERF.md).
EP_STEP1_LOSS_TOL = 1e-5
EP_STEP1_NORM_TOL = 1e-4
EP_REL_TOL = 2e-2
EP_DROP_SHARE = 1e-3
# The witness: step 1's gradients given seeded Gaussian noise before the
# update, of a share of their norm in all ("norm": 3e-6, the size of step
# 1's grad-norm difference at ep over dp_shard) or of a share of each entry
# ("entry": 2^-9, about the rounding of a bf16 value), from each seed.
DROP_WITNESS_NOISE = (("norm", 3e-6), ("entry", 2.0**-9))
DROP_WITNESS_SEEDS = (0, 1, 2)
# utils/estimate_memory.estimate_per_chip (the JAX package's rows: exact
# tensor state, a closed-form activation model) against each rank's
# measured peak, which also holds the bf16 copies of its expert stacks and
# FSDP2's gathered parameters: within this share of the peak.
EP_ESTIMATE_SHARE = 0.2
# Greedy decode with the experts where they lie: phase 7's (1, 64) prompt.
EP_DECODE_TOKENS = 8


def ep_step_rank(hf, name, device="cuda", width=MIXTRAL_8X7B, row=MIXTRAL_ROW, steps=EP_STEPS,
                 profile=True, decode=True):
    """Phase 24 (a) or (b) (``EP_RUNS[name]``), one rank: phase 18 (b)'s
    Mixtral step under expert parallelism, ``steps`` steps counted from
    zero (metrics, dropped choices, launches, the token exchange's calls
    and bytes, staged included), the last of them under torch.profiler's
    tracing of the card's kernels (device-busy ms by category; ``step_ms``
    the steps' mean after the first), the peak against
    ``estimate_per_chip``;
    then greedy ``generate`` of ``EP_DECODE_TOKENS`` tokens from phase 7's
    prompt with the experts where they lie (FSDP2's shards gathered once),
    the greedy steps' top-2 gaps and ms a token, and its reference on this
    rank: the same weights with each expert stack gathered whole in bf16,
    decoded by the plain dropless plan (no ep branch), that row's top-2
    gaps, the ep decode's teacher-forced logits over it against the plain
    ones, and the plain bf16 logits' largest difference from fp32."""
    import types

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        Model,
        ParallelismConfig,
        adamw,
        generate,
        moe_cross_entropy_loss,
    )
    from accelerate_tpu_torch import generation as gen
    from accelerate_tpu_torch.models import MixtralForCausalLM, mixtral_tp_rules
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf
    from accelerate_tpu_torch.parallel.ep import exchange_counters
    from accelerate_tpu_torch.utils.operations import gather_shards
    from accelerate_tpu_torch.parallel.sharding import local_batch
    from accelerate_tpu_torch.utils.estimate_memory import estimate_per_chip

    run = EP_RUNS[name]
    pc = ParallelismConfig(**run["pc"])
    cfg = dataclasses.replace(mixtral_config_from_hf(width),
                              num_hidden_layers=row["train_layers"], dtype=torch.bfloat16,
                              remat=True, remat_policy="dots",
                              attention_impl=run["attention_impl"])
    plugin = FullyShardedDataParallelPlugin()
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu", parallelism_config=pc,
                      fsdp_plugin=plugin)
    module = MixtralForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    rules = mixtral_tp_rules(cfg.scan_layers, ep_axes=pc.ep_axes)
    model, opt = acc.prepare(Model(module, tp_rules=rules), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(
        lambda m, b: moe_cross_entropy_loss(m, b["x"], b["y"]), max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            size=(row["batch"], row["seq"] + 1))
    mine = local_batch({"x": ids[:, :-1], "y": ids[:, 1:]}, acc.parallelism_config,
                       acc.process_index)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(acc.device) for k, v in mine.items()}
    state = acc.train_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    exchange_counters.reset()
    metrics, dropped, times, prof = [], [], [], None
    for i in range(steps):
        # The last counted step runs under torch.profiler, which traces the
        # card's kernels only (no host events to slow the step).
        traced = profile and i == steps - 1
        with (torch.profiler.profile(activities=profiled_activities(host=False)) if traced
              else contextlib.nullcontext()) as prof_i:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        prof = prof_i if traced else prof
        metrics.append(m)
        dropped.append(module.router_stats()["dropped"])
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    exchanges = exchange_counters.snapshot()
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    step_ms = float(np.mean(times[1:]))
    est, _, _ = estimate_per_chip(MixtralForCausalLM(cfg, device="meta"), cfg,
                                  acc.parallelism_config, seq=row["seq"],
                                  per_chip_batch=batch["x"].shape[0], fsdp_plugin=plugin,
                                  tp_rules=rules)
    out = {"metrics": metrics, "dropped": [int(x) for x in dropped],
           "routed": int(module.router_stats()["routed"]), "step_ms": step_ms,
           "step_ms_each": times, "peak_mem_gib": peak, "estimate_gib": est.total_gib,
           "estimate_rows": est.rows(), "local_batch": list(batch["x"].shape),
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "variant_launches": variant_launches, "n_layers": cfg.num_hidden_layers,
           "exchange_per_step": {k: v / steps for k, v in exchanges.items()},
           "ep_axes": list(acc.parallelism_config.ep_axes),
           "local_experts": int(module.model.layers[0].moe.w_gate.to_local().shape[0])}
    if profile:
        busy, by_cat, top, _ = device_times(prof, 1, n_top=6)
        out.update(device_busy_ms=busy, idle_share=1 - busy / step_ms,
                   busy_ms_by_category=by_cat, top_kernels_ms=top, traced_step=steps)
    if decode:
        del state, opt
        acc.free_memory()
        gc.collect()
        torch.cuda.empty_cache()
        decoder = types.SimpleNamespace(module=module, params=gen._decode_params(model))
        prompt = decode_prompt(cfg, acc.device)
        generate(decoder, prompt, max_new_tokens=1)  # warm-up
        torch.cuda.synchronize()
        hf.reset_launch_counts()
        exchange_counters.reset()
        t0 = time.perf_counter()
        rows = generate(decoder, prompt, max_new_tokens=EP_DECODE_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(hf.VARIANT_LAUNCHES)
        n0 = prompt.shape[1]
        gaps = _greedy_gaps(cfg, decoder, rows, n0)
        t0 = time.perf_counter()
        # Gathered in the compute dtype: the products read bf16 either way.
        plain = types.SimpleNamespace(module=module, params={
            n: gather_shards(p.to(cfg.dtype)) if isinstance(p, DTensor) else p
            for n, p in decoder.params.items()})
        plain_row = generate(plain, prompt, max_new_tokens=EP_DECODE_TOKENS)[0].tolist()
        ref = teacher_forced_logits(cfg, plain, plain_row, n0, acc.device)
        ref32 = teacher_forced_logits(cfg, plain, plain_row, n0, acc.device, fp32=True)
        got = teacher_forced_logits(cfg, decoder, plain_row, n0, acc.device)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        out["decode"] = {"row": rows[0, n0:].tolist(),
                         "min_top2_gap": float(gaps.min()), "top2_gaps": gaps[0].tolist(),
                         "ms_per_token": wall * 1e3 / EP_DECODE_TOKENS,
                         "variant_launches": launched, "plain_row": plain_row[n0:],
                         "plain_gaps": (top2[:, 1] - top2[:, 0]).tolist(),
                         "logit_delta": float(np.abs(got - ref).max()),
                         "plain_delta": float(np.abs(ref - ref32).max()),
                         "reference_s": time.perf_counter() - t0}
        del decoder, plain
    del step, model, module, acc
    return out


def ep_child(hf, device="cuda", kw=None) -> dict:
    """Phase 24 in one of phase 22's processes: (a) and (b), each set up
    afresh; ``kw`` may narrow each (the CPU rehearsal)."""
    kw = kw or {}
    t0 = time.perf_counter()
    parts, seconds = {}, {}
    for name in EP_RUNS:
        _reset_port_state()
        t = time.perf_counter()
        parts[name] = ep_step_rank(hf, name, device=device, **kw.get(name, kw.get("step", {})))
        seconds[name] = time.perf_counter() - t
    _reset_port_state()
    return {**parts, "part_s": seconds, "seconds": time.perf_counter() - t0}


def ep_gate(children, phase18) -> dict:
    """Phase 24's checks on the children's phase-24 lines, for (a) and (b)
    against phase 18 (b)'s first three steps (``phase18["first_metrics"]``:
    the same weights, batch and optimizer on one process), the metrics
    equal on both ranks: step 1's loss within EP_STEP1_LOSS_TOL, its grad
    norm within EP_STEP1_NORM_TOL and its dropped choices equal; steps 2-3 within
    EP_REL_TOL, their drops within EP_DROP_SHARE of the routed count plus
    EP_REL_TOL of phase 18's; each flash kernel launched once a layer a
    step on each rank, ``estimate_per_chip`` within EP_ESTIMATE_SHARE of
    each rank's peak; the greedy tokens equal on both ranks and, on each,
    equal to the plain dropless decode's off near-ties, its teacher-forced
    logits within the tie gap of the plain ones: TP_PLAIN_FACTOR times the
    plain bf16 logits' difference from fp32 (at least TIE_GAP), as phase
    22 (b) bounds its tp=2 logits."""
    ranks = [next((line["ep"] for line in reversed(lines) if "ep" in line), None)
             for _, lines, _ in children]
    res = {"phase": "expert_parallel", "ranks": EP_RANKS,
           "note": "two processes on one card joined by gloo, which stages every collective "
                   "and the token exchange through the host: step ms are gloo's"}
    checks = {"children": all(rc == 0 for rc, _, _ in children) and all(ranks)}
    if not checks["children"]:
        return {**res, "checks": checks, "ok": False,
                "child_exit": [rc for rc, _, _ in children],
                "child_stderr": [err for _, _, err in children]}
    out = {}
    for name in EP_RUNS:
        runs = [r[name] for r in ranks]
        rel = [max(_rel(g, w) for got, want in zip(r["metrics"], phase18["first_metrics"])
                   for g, w in zip(got, want)) for r in runs]
        rel1 = [[_rel(g, w) for g, w in zip(r["metrics"][0], phase18["first_metrics"][0])]
                for r in runs]
        drop_room = [EP_DROP_SHARE * phase18["routed"] + EP_REL_TOL * w if i else 0.0
                     for i, w in enumerate(phase18["dropped"][:EP_STEPS])]
        drop_dev = [max(abs(d - w) / phase18["routed"]
                        for d, w in zip(r["dropped"], phase18["dropped"])) for r in runs]
        drop_over = [max(abs(d - w) - room for d, w, room in
                         zip(r["dropped"], phase18["dropped"], drop_room)) for r in runs]
        checks[f"{name}_vs_phase18"] = (len(runs[0]["metrics"]) == EP_STEPS
                                        and max(rel) <= EP_REL_TOL)
        checks[f"{name}_step1_vs_phase18"] = all(
            loss <= EP_STEP1_LOSS_TOL and norm <= EP_STEP1_NORM_TOL for loss, norm in rel1)
        checks[f"{name}_ranks_agree"] = all(r["metrics"] == runs[0]["metrics"] for r in runs)
        checks[f"{name}_dropped"] = max(drop_over) <= 0
        checks[f"{name}_launches"] = all(r["launches_per_step"].get(k) == r["n_layers"]
                                         for r in runs for k in KERNELS)
        checks[f"{name}_estimate"] = all(
            abs(r["peak_mem_gib"] - r["estimate_gib"]) <= EP_ESTIMATE_SHARE * r["peak_mem_gib"]
            for r in runs)
        part = {"rank_metrics": [r["metrics"] for r in runs],
                "phase18_metrics": phase18["first_metrics"], "max_rel": max(rel),
                "dropped": [r["dropped"] for r in runs], "phase18_dropped": phase18["dropped"],
                "routed": runs[0]["routed"], "max_drop_share_dev": max(drop_dev),
                "step1_rel": rel1,
                "drop_room": drop_room,
                **{k: [r.get(k) for r in runs] for k in (
                    "step_ms", "step_ms_each", "device_busy_ms", "idle_share",
                    "busy_ms_by_category", "top_kernels_ms", "peak_mem_gib", "estimate_gib",
                    "launches_per_step", "exchange_per_step", "local_batch", "local_experts")},
                "ep_axes": runs[0]["ep_axes"], "estimate_rows": runs[0]["estimate_rows"],
                "phase18_step_ms": phase18["step_ms"],
                "phase18_peak_mem_gib": phase18["peak_mem_gib"]}
        decodes = [r.get("decode") for r in runs]
        if all(decodes):
            checks[f"{name}_decode_ranks_agree"] = all(d["row"] == decodes[0]["row"]
                                                       for d in decodes)
            tie_gap = [max(TIE_GAP, TP_PLAIN_FACTOR * d["plain_delta"]) for d in decodes]
            div = [first_divergence([d["plain_row"]], [d["row"]], [d["plain_gaps"]], g)[0]
                   for d, g in zip(decodes, tie_gap)]
            checks[f"{name}_decode_logits_vs_plain"] = all(
                d["logit_delta"] <= g for d, g in zip(decodes, tie_gap))
            checks[f"{name}_decode_tokens_vs_plain"] = parity_ok(div)
            part["decode"] = {"row": decodes[0]["row"],
                              "plain_rows": [d["plain_row"] for d in decodes],
                              "first_divergence": div, "tie_gap": tie_gap,
                              "logit_delta": [d["logit_delta"] for d in decodes],
                              "plain_bf16_fp32_delta": [d["plain_delta"] for d in decodes],
                              "reference_s": [d["reference_s"] for d in decodes],
                              "min_top2_gap": [d["min_top2_gap"] for d in decodes],
                              "ms_per_token": [d["ms_per_token"] for d in decodes]}
        out[name] = part
    seconds = [r["seconds"] for r in ranks]
    return {**res, **out, "part_s": [r["part_s"] for r in ranks], "seconds": max(seconds),
            "variant_launches": {
                "ep_step": ranks[0]["ep_step"]["variant_launches"],
                "sp_ep_step": ranks[0]["sp_ep_step"]["variant_launches"],
                "ep_generate": (ranks[0]["ep_step"].get("decode") or {}).get(
                    "variant_launches", {})},
            "checks": checks, "ok": all(checks.values())}


def drop_shift_witness(hf, device="cuda", width=MIXTRAL_8X7B, row=MIXTRAL_ROW, steps=EP_STEPS,
                       noise=DROP_WITNESS_NOISE, seeds=DROP_WITNESS_SEEDS) -> dict:
    """Why phase 24's gate widens after step 1, without ep: phase 18 (b)'s
    Mixtral step (its weights, batch and optimizer, one process) for
    ``steps`` steps, once as it is and once for each ``noise`` entry and
    seed with step 1's gradients, after the clip and before AdamW's
    update, given seeded Gaussian noise: ``("norm", s)`` of ``s`` times
    their norm in all, ``("entry", s)`` of ``s`` times each entry. Each
    run's losses, grad norms and dropped choices; for each noisy run, the
    relative change the noise made to the gradients' norm, the largest
    relative difference of its loss and grad norm from the plain run's and
    its drop shift per step, and its routers' largest difference after
    step 1."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        Model,
        adamw,
        moe_cross_entropy_loss,
    )
    from accelerate_tpu_torch.models import MixtralForCausalLM
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def norm_of(grads):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))

    cfg = dataclasses.replace(mixtral_config_from_hf(width),
                              num_hidden_layers=row["train_layers"], dtype=torch.bfloat16,
                              remat=True, remat_policy="dots", attention_impl="flash")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            size=(row["batch"], row["seq"] + 1))
    t0 = time.perf_counter()
    runs = {}
    for key in ["plain"] + [f"{kind}:{scale}:{seed}" for kind, scale in noise for seed in seeds]:
        _reset_port_state()
        acc = Accelerator(mixed_precision="bf16", fsdp_plugin=FullyShardedDataParallelPlugin(),
                          cpu=device == "cpu")
        module = MixtralForCausalLM(cfg, device=acc.device)
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(
            lambda m, b: moe_cross_entropy_loss(m, b["x"], b["y"]), max_grad_norm=1.0)
        batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
                 "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
        state = acc.train_state
        run = {"updates": 0}

        def perturb(opt, args, kwargs, key=key, run=run):
            if run["updates"] == 0 and key != "plain":
                kind, scale, seed = key.split(":")
                gen = torch.Generator(device=acc.device).manual_seed(int(seed))
                grads = [local(p.grad) for g in opt.param_groups for p in g["params"]
                         if p.grad is not None]
                before = norm_of(grads)
                sigma = float(scale) * (before / math.sqrt(sum(g.numel() for g in grads))
                                        if kind == "norm" else 1.0)
                for g in grads:
                    z = torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype)
                    g.add_(z * sigma if kind == "norm" else z * sigma * g)
                run["norm_change"] = float((norm_of(grads) - before).abs() / before)
            run["updates"] += 1

        hook = state.optimizer.register_step_pre_hook(perturb)
        metrics, dropped, routers = [], [], None
        for i in range(steps):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            dropped.append(int(module.router_stats()["dropped"]))
            if i == 0:
                routers = [local(layer.moe.router).detach().float().cpu()
                           for layer in module.model.layers]
        hook.remove()
        runs[key] = {"metrics": metrics, "dropped": dropped, "routers": routers,
                     "norm_change": run.get("norm_change")}
        del acc, module, state, step, batch, hook
        _reset_port_state()
        gc.collect()
        torch.cuda.empty_cache()
    plain = runs["plain"]
    shifts = {
        key: {"norm_change": r["norm_change"],
              "max_rel": [max(_rel(g, w) for g, w in zip(got, want))
                          for got, want in zip(r["metrics"], plain["metrics"])],
              "drop_shift": [d - w for d, w in zip(r["dropped"], plain["dropped"])],
              "router_max_abs_after_step1": max(float((a - b).abs().max())
                                                for a, b in zip(r["routers"], plain["routers"]))}
        for key, r in runs.items() if key != "plain"}
    checks = {"finite": all(math.isfinite(x) for r in runs.values()
                            for m in r["metrics"] for x in m),
              "step1_untouched": all(r["metrics"][0] == plain["metrics"][0]
                                     and r["dropped"][0] == plain["dropped"][0]
                                     for r in runs.values())}
    return {"phase": "drop_witness", "steps": steps, "noise": [list(n) for n in noise],
            "seeds": list(seeds),
            "runs": {k: {"metrics": v["metrics"], "dropped": v["dropped"]}
                     for k, v in runs.items()},
            "routed": row["batch"] * row["seq"] * cfg.num_experts_per_tok,
            "shifts": shifts, "seconds": time.perf_counter() - t0,
            "checks": checks, "ok": all(checks.values())}


def drop_witness_main() -> int:
    """``chip_smoke.py --drop-witness``: the card's name and power limit,
    the kernels built, then ``drop_shift_witness`` as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import hopper_flash as hf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = drop_shift_witness(hf)
    emit(dict(res, nvidia_smi=smi))
    return 0 if res["ok"] else 1


# ---------------------------------------------------------------------------
# Phase 25: the rest of item 6, in phase 22's two processes after phase 24.
# (a) phase 14 (b)'s fp8 step at tp=2; (b) fp8 over the batch at
# dp_replicate=2 (fault 10), then one step under the "fp16" comm hook; (c)
# generate over tp=2 of GPT-2 XL and T5-base; (d) Mixtral at pp=2 (one layer
# a stage, GPipe over two one-row microbatches); (e) a DISTRIBUTED_STATE_DICT
# round trip at pp=2 and a SHARDED_STATE_DICT save of FSDP2's shards through
# the shared gather, resumed by the parent on one process.
# ---------------------------------------------------------------------------

# (b) and (e): phase 23 (d)'s model, phase 5's widths at 2 layers.
REST_LAYERS = HOOK_LAYERS
# (c): phase 19's decode rows (GPT-2 XL's (1, 64) prompt, T5's 512-token
# input), 8 greedy tokens each.
REST_DECODE = ("gpt2_xl", "t5_base")
REST_DECODE_TOKENS = 8
# (d): phase 18 (b)'s Mixtral step at pp=2: GPipe over its two rows.
REST_PP_MICROBATCHES = MIXTRAL_ROW["batch"]


def _timed_amax(fp8_ops):
    """``fp8_ops._global_amax`` with each call's host wall time recorded (a
    gloo all-reduce of a CUDA scalar stages it through the host, so the
    call waits for the amax): (the list of seconds, a restore function)."""
    inner, seconds = fp8_ops._global_amax, []

    def timed(amax, groups):
        t0 = time.perf_counter()
        try:
            return inner(amax, groups)
        finally:
            if groups:
                seconds.append(time.perf_counter() - t0)

    fp8_ops._global_amax = timed
    return seconds, lambda: setattr(fp8_ops, "_global_amax", inner)


def _scale_tap(fp8_ops):
    """``fp8_ops._quant`` recording each scale and whether it quantized a
    cotangent (e5m2): (the list, a restore function)."""
    import torch

    inner, scales = fp8_ops._quant, []

    def tap(x, fp8_dtype, *args, **kwargs):
        q, scale = inner(x, fp8_dtype, *args, **kwargs)
        scales.append((float(scale), fp8_dtype == torch.float8_e5m2))
        return q, scale

    fp8_ops._quant = tap
    return scales, lambda: setattr(fp8_ops, "_quant", inner)


def fp8_tp_rank(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"], batch_size=SLICE["b"],
                steps=TP_STEPS, profile=True):
    """(a), one rank: phase 14 (b)'s fp8 step (phase 5's weights, batch and
    optimizer, HYBRID projections) at ``tp_size=2`` with
    ``llama_tp_rules``: ``steps`` steps counted from zero (metrics, the fp8
    products' paths, launches, the amax all-reduces and their host seconds),
    the last under torch.profiler (device-busy ms by category)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.models import llama_tp_rules
    from accelerate_tpu_torch.ops import fp8 as fp8_ops

    cfg = LlamaConfig(**width, max_position_embeddings=seq, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots", attention_impl="flash", fp8=True,
                      fp8_format="HYBRID")
    acc = Accelerator(mixed_precision="fp8", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(tp_size=TP_RANKS))
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    acc.prepare(Model(module, tp_rules=llama_tp_rules()), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                                  max_grad_norm=1.0)
    batch = _phase5_batch(cfg, batch_size, seq, acc.device)
    state = acc.train_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    fp8_ops.reset_paths()
    amax_s, restore = _timed_amax(fp8_ops)
    metrics, times, prof = [], [], None
    try:
        for i in range(steps):
            traced = profile and i == steps - 1
            with (torch.profiler.profile(activities=profiled_activities(host=False)) if traced
                  else contextlib.nullcontext()) as prof_i:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            prof = prof_i if traced else prof
            metrics.append(m)
    finally:
        restore()
    step_ms = float(np.mean(times[1:]))
    reduces = fp8_ops.AMAX_REDUCES["all_reduce"] / steps
    out = {"metrics": [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
           "step_ms": step_ms, "step_ms_each": times, "paths": dict(fp8_ops.PATHS),
           "amax_all_reduces_per_step": reduces,
           "amax_ms_per_step": sum(amax_s) * 1e3 / steps,
           "amax_share": sum(amax_s) * 1e3 / steps / step_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": {k: v / steps for k, v in hf.LAUNCHES.items()},
           "variant_launches": dict(hf.VARIANT_LAUNCHES), "n_layers": cfg.num_hidden_layers}
    if profile:
        busy, by_cat, top, _ = device_times(prof, 1, n_top=6)
        out.update(device_busy_ms=busy, idle_share=1 - busy / step_ms,
                   busy_ms_by_category=by_cat, top_kernels_ms=top)
    del state, step, module, acc
    return out


def _rest_model(width, seq, device, layers=REST_LAYERS, **cfg_kw):
    """Phase 23 (d)'s model (phase 5's widths at ``layers`` layers, seed 0)
    and its config."""
    import torch

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**dict(width, num_hidden_layers=layers), max_position_embeddings=seq,
                      dtype=torch.bfloat16, remat=True, remat_policy="dots",
                      attention_impl="flash", **cfg_kw)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    return cfg, module


def fp8_batch_steps(hf, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
                    batch_size=SLICE["b"], steps=HOOK_STEPS, pc=None, hook=None, rows=None):
    """(b)'s fp8 steps of phase 23 (d)'s model (HYBRID projections) on
    ``rows`` of phase 5's batch (default all), under ``pc`` and ``hook``
    (None: one process): metrics, step 1's scales in the order taken (with
    whether each quantized a cotangent), the amax all-reduces a step."""
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        DistributedDataParallelKwargs,
        Model,
        ParallelismConfig,
        adamw,
    )
    from accelerate_tpu_torch.models import cross_entropy_loss
    from accelerate_tpu_torch.ops import fp8 as fp8_ops

    _reset_port_state()
    handlers = [DistributedDataParallelKwargs(comm_hook=hook)] if hook else []
    acc = Accelerator(mixed_precision="fp8", cpu=device == "cpu", kwargs_handlers=handlers,
                      parallelism_config=None if pc is None else ParallelismConfig(**pc))
    cfg, module = _rest_model(width, seq, acc.device, fp8=True, fp8_format="HYBRID")
    acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                                  max_grad_norm=1.0)
    full = _phase5_batch(cfg, batch_size, seq, acc.device)
    batch = {k: v[rows[0]:rows[1]] for k, v in full.items()} if rows else full
    state, metrics = acc.train_state, []
    fp8_ops.reset_paths()
    scales, restore = _scale_tap(fp8_ops)
    try:
        state, m = step(state, batch)
        metrics.append(m)
    finally:
        restore()
    for _ in range(steps - 1):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    out = {"metrics": [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
           "scales": scales, "amax_all_reduces_per_step":
           fp8_ops.AMAX_REDUCES["all_reduce"] / steps}
    del state, step, module, acc
    _reset_port_state()
    return out


def fp8_batch_rank(hf, device="cuda", **kw):
    """(b), one rank: at ``dp_replicate=2`` (DDP, no hook) on this rank's
    half of the batch, 3 steps; then one step under the "fp16" comm hook,
    where each rank scales its own tensors."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    rows = kw.get("batch_size", SLICE["b"]) // world
    half = (rank * rows, (rank + 1) * rows)
    pc = dict(dp_replicate_size=world)
    return {"dp": fp8_batch_steps(hf, device, pc=pc, rows=half, **kw),
            "hook": fp8_batch_steps(hf, device, pc=pc, rows=half, hook="fp16",
                                    **dict(kw, steps=1))}


def _encdec_teacher_forced(cfg, model, enc_in, row, prompt_len, device, fp32=False):
    """T5's teacher-forced fp32 logits over ``row`` (1, T) of decoder ids
    from ``enc_in``, at the positions that predicted row[prompt_len:]."""
    import copy

    import torch

    from accelerate_tpu_torch import generation as gen

    module = getattr(model, "module", model)
    if fp32:
        module = copy.deepcopy(module).float()
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        module.config = cfg
        model = module
    encode, decode = gen.ENCDEC_GENERATION_PLANS[type(module).__name__]
    ids = torch.as_tensor(row).long().reshape(1, -1).to(device)
    params = gen._decode_params(model)
    with torch.no_grad():
        enc = encode(cfg, model, enc_in)
        cache = gen.init_cache(cfg, 1, ids.shape[1], device=device,
                               kv_heads=gen._tp_kv_heads(cfg, params))
        logits, _ = decode(cfg, params, ids, cache, enc, return_all=True)
    return logits[0, prompt_len - 1:-1].float().cpu().numpy()


def tp_family_decode_rank(hf, device="cuda", names=REST_DECODE, new_tokens=REST_DECODE_TOKENS,
                          rows=None):
    """(c), one rank: each family's bf16 model from phase 19's seed, greedy
    ``new_tokens`` from phase 19's decode input on this process with the
    whole weights (the reference: its row, top-2 gaps, teacher-forced
    logits and their largest difference from fp32), then the same weights
    split over ``tp_size=2``: the timed greedy row, its all-reduces a token,
    and its teacher-forced logits over the reference row."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, generate
    from accelerate_tpu_torch import models as M
    from accelerate_tpu_torch.utils.operations import collective_counters

    out = {}
    for name in names:
        _reset_port_state()
        row = (rows or FAMILY_ROWS)[name]
        family = row["family"]
        cfg = dataclasses.replace(family_config(row, torch.bfloat16), remat=False)
        acc = Accelerator(cpu=device == "cpu",
                          parallelism_config=ParallelismConfig(tp_size=TP_RANKS))
        module = family_classes(family)[1](cfg, device=acc.device)
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
        module.to(torch.bfloat16)
        rng = np.random.default_rng(0)
        if family == "t5":
            enc_in = torch.from_numpy(rng.integers(
                2, cfg.vocab_size, (1, ENCDEC_DECODE["t5_input"]))).to(acc.device)
            prompt = torch.zeros((1, 1), dtype=torch.long, device=acc.device)
            kw = {"decoder_input_ids": prompt}
            args = (enc_in,)
        else:
            prompt = decode_prompt(cfg, acc.device)
            kw, args = {}, (prompt,)
        n0 = prompt.shape[1]
        with torch.no_grad():
            ref_row = generate(module, *args, max_new_tokens=new_tokens, **kw)
            if family == "t5":
                ref = _encdec_teacher_forced(cfg, module, enc_in, ref_row[0].tolist(), n0,
                                             acc.device)
                ref32 = _encdec_teacher_forced(cfg, module, enc_in, ref_row[0].tolist(), n0,
                                               acc.device, fp32=True)
            else:
                ref = teacher_forced_logits(cfg, module, ref_row[0].tolist(), n0, acc.device)
                ref32 = teacher_forced_logits(cfg, module, ref_row[0].tolist(), n0,
                                              acc.device, fp32=True)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        model = acc.prepare_model(Model(module, tp_rules=getattr(M, f"{family}_tp_rules")()))
        generate(model, *args, max_new_tokens=2, **kw)  # warm-up
        collective_counters.reset()
        collective_counters.enabled = True
        torch.cuda.synchronize()
        hf.reset_launch_counts()
        t0 = time.perf_counter()
        got_row = generate(model, *args, max_new_tokens=new_tokens, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        collectives = collective_counters.snapshot()
        collective_counters.enabled = False
        if family == "t5":
            got = _encdec_teacher_forced(cfg, model, enc_in, ref_row[0].tolist(), n0, acc.device)
        else:
            got = teacher_forced_logits(cfg, model, ref_row[0].tolist(), n0, acc.device)
        out[name] = {"row": got_row[0, n0:].tolist(), "plain_row": ref_row[0, n0:].tolist(),
                     "plain_gaps": (top2[:, 1] - top2[:, 0]).tolist(),
                     "plain_delta": float(np.abs(ref - ref32).max()),
                     "logit_delta": float(np.abs(got - ref).max()),
                     "ms_per_token": wall * 1e3 / new_tokens,
                     "all_reduces_per_token": {op: {k: v / new_tokens for k, v in c.items()}
                                               for op, c in collectives.items()},
                     "flash_launches": dict(hf.LAUNCHES),
                     "split_params": sum(isinstance(p, torch.distributed.tensor.DTensor)
                                         for p in module.parameters())}
        del model, module, acc
    _reset_port_state()
    return out


def pp_mixtral_rank(hf, device="cuda", width=MIXTRAL_8X7B, row=MIXTRAL_ROW, steps=EP_STEPS,
                    n_microbatches=REST_PP_MICROBATCHES):
    """(d), one rank: phase 18 (b)'s Mixtral step (its weights, batch and
    optimizer, one layer a stage) at ``pp_size=2``, GPipe over
    ``n_microbatches`` microbatches: metrics, dropped choices and the aux
    loss (summed over the stages) a step, launches, sends and bytes, the
    peak."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, adamw
    from accelerate_tpu_torch.models import MixtralForCausalLM, cross_entropy_loss
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf
    from accelerate_tpu_torch.parallel.pp import p2p_counters

    cfg = dataclasses.replace(mixtral_config_from_hf(width),
                              num_hidden_layers=row["train_layers"], dtype=torch.bfloat16,
                              remat=True, remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(pp_size=PP_STAGES))
    module = MixtralForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    aux_seen = []

    def loss_fn(m, b):
        from accelerate_tpu_torch.parallel.pp import pipeline_forward

        logits, aux = pipeline_forward(m, b["x"], n_microbatches=n_microbatches,
                                       return_aux=True)
        aux_seen.append(float(aux.detach()))
        return cross_entropy_loss(logits, b["y"]) + aux

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(row["batch"], row["seq"] + 1))
    batch = {"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
             "y": torch.from_numpy(ids[:, 1:]).to(acc.device)}
    state = acc.train_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launch_counts()
    p2p_counters.reset()
    metrics, dropped, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        n = torch.as_tensor(module.router_stats()["dropped"], device=acc.device).reshape(1)
        dist.all_reduce(n, group=acc.state.pipeline_mesh.get_group())
        dropped.append(int(n))
    out = {"metrics": [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
           "dropped": dropped, "aux": aux_seen, "step_ms": float(np.mean(times[1:])),
           "step_ms_each": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": {k: v / steps for k, v in hf.LAUNCHES.items()},
           "variant_launches": dict(hf.VARIANT_LAUNCHES),
           "p2p_per_step": {k: v / steps for k, v in p2p_counters.snapshot().items()},
           "local_params": sum(p.numel() for p in module.parameters()),
           "microbatches": n_microbatches, "pp_rank": acc.pipeline_parallel_rank}
    del state, step, module, acc
    return out


def _fingerprint_tensors(tensors):
    """``_fingerprint`` of a sequence of tensors."""
    import torch

    total = torch.zeros(2, dtype=torch.int64)
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        total += torch.stack([bits.sum(), (bits * w).sum()]).cpu()
    return total.tolist()


def checkpoint_rank(hf, ckpt_dir, device="cuda", width=FULL_WIDTH, seq=SLICE["s"],
                    batch_size=SLICE["b"]):
    """(e), one rank. Phase 23 (d)'s model at ``pp_size=2`` (GPipe over
    PP_MICROBATCHES) under DISTRIBUTED_STATE_DICT: one step, a save, a
    fresh prepare that loads it and takes the second step, against the
    same two steps without the round trip (metrics and the parameters'
    fingerprint over the stages). Then the same model under FSDP2 at
    ``dp_shard=2``: one step and a SHARDED_STATE_DICT save (whole tensors
    through ``gather_shards`` over gloo on the card), with the gathered
    parameters' fingerprint for the parent's one-process resume."""
    import torch

    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        Model,
        ParallelismConfig,
        adamw,
        llama_pipeline_forward,
    )
    from accelerate_tpu_torch.models import cross_entropy_loss
    from accelerate_tpu_torch.parallel.sharding import local_batch
    from accelerate_tpu_torch.utils.operations import gather_shards

    def pp_loss(m, b):
        return cross_entropy_loss(llama_pipeline_forward(m, b["x"],
                                                         n_microbatches=PP_MICROBATCHES), b["y"])

    def run(pc, state_dict_type, loss_fn):
        _reset_port_state()
        acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                          parallelism_config=ParallelismConfig(**pc),
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              state_dict_type=state_dict_type))
        cfg, module = _rest_model(width, seq, acc.device)
        model, _ = acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
        step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
        full = _phase5_batch(cfg, batch_size, seq, "cpu")
        mine = local_batch({k: v.numpy() for k, v in full.items()}, acc.parallelism_config,
                           acc.process_index)
        batch = {k: torch.from_numpy(v).to(acc.device) for k, v in mine.items()}
        return acc, module, step, batch

    out, dcp_dir = {}, os.path.join(ckpt_dir, "dcp")
    rounds = {}
    for trip in (False, True):
        acc, module, step, batch = run(dict(pp_size=PP_STAGES), "DISTRIBUTED_STATE_DICT", pp_loss)
        hf.reset_launch_counts()
        _, m1 = step(acc.train_state, batch)
        if trip:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc.save_state(dcp_dir)
            save_s = time.perf_counter() - t0
            del acc, module, step
            acc, module, step, batch = run(dict(pp_size=PP_STAGES), "DISTRIBUTED_STATE_DICT",
                                           pp_loss)
            t0 = time.perf_counter()
            acc.load_state(dcp_dir)
            torch.cuda.synchronize()
            out["dcp"] = {"save_s": save_s, "load_s": time.perf_counter() - t0,
                          "bytes": dir_bytes(dcp_dir)}
        _, m2 = step(acc.train_state, batch)
        torch.cuda.synchronize()
        rounds[trip] = {"metrics": [(float(m["loss"]), float(m["grad_norm"])) for m in (m1, m2)],
                        "fingerprint": _fingerprint(module)}
        if trip:
            out["variant_launches"] = dict(hf.VARIANT_LAUNCHES)
        del acc, module, step
    out["dcp"].update(plain=rounds[False], round_trip=rounds[True])
    sharded_dir = os.path.join(ckpt_dir, "sharded")
    acc, module, step, batch = run(dict(dp_shard_size=2), "SHARDED_STATE_DICT",
                                   lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]))
    _, m1 = step(acc.train_state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc.save_state(sharded_dir)
    save_s = time.perf_counter() - t0
    gathered = _fingerprint_tensors(gather_shards(p) for p in module.parameters())
    out["sharded"] = {"save_s": save_s, "bytes": dir_bytes(sharded_dir),
                      "loss": float(m1["loss"]), "fingerprint": gathered,
                      "dtensors": sum(hasattr(p, "full_tensor") for p in module.parameters())}
    del acc, module, step
    _reset_port_state()
    return out


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def sharded_resume(ckpt_dir, device="cuda", width=FULL_WIDTH, seq=SLICE["s"]) -> dict:
    """(e)'s resume on one process (the parent): the SHARDED_STATE_DICT
    checkpoint the FSDP2 ranks saved, loaded into the same model; its
    parameters' fingerprint, and the load's seconds."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, adamw

    _reset_port_state()
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu")
    _, module = _rest_model(width, seq, acc.device)
    acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    t0 = time.perf_counter()
    acc.load_state(os.path.join(ckpt_dir, "sharded"))
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0, "fingerprint": _fingerprint(module)}
    del acc, module
    _reset_port_state()
    return out


def rest_child(hf, device="cuda", kw=None) -> dict:
    """Phase 25 in one of phase 22's processes: (a)-(e), each set up
    afresh; ``kw`` may narrow each part (the CPU rehearsal) and names the
    checkpoint directory (``kw["ckpt_dir"]``)."""
    kw = kw or {}
    t0 = time.perf_counter()
    parts, seconds = {}, {}
    runs = (("fp8_tp", lambda: fp8_tp_rank(hf, device=device, **kw.get("fp8_tp", {}))),
            ("fp8_batch", lambda: fp8_batch_rank(hf, device=device, **kw.get("fp8_batch", {}))),
            ("decode", lambda: tp_family_decode_rank(hf, device=device, **kw.get("decode", {}))),
            ("pp_mixtral", lambda: pp_mixtral_rank(hf, device=device,
                                                   **kw.get("pp_mixtral", {}))),
            ("checkpoints", lambda: checkpoint_rank(hf, kw["ckpt_dir"], device=device,
                                                    **kw.get("checkpoints", {}))))
    for name, run in runs:
        _reset_port_state()
        t = time.perf_counter()
        parts[name] = run()
        seconds[name] = time.perf_counter() - t
    _reset_port_state()
    return {**parts, "part_s": seconds, "seconds": time.perf_counter() - t0}


def rest_gate(children, fp8_first, fp8_ref, phase18, resume) -> dict:
    """Phase 25's checks on the children's phase-25 lines.

    (a) 3 steps within TP_REL_TOL of phase 14 (b)'s first three (``fp8_first``),
    equal on both ranks; every fp8 product on ``_scaled_mm`` (none
    dequantized); each flash kernel launched once a layer a step.
    (b) step 1's scales, every input and cotangent, equal on the two ranks;
    3 steps within TP_REL_TOL of the one-process steps (``fp8_ref``); under
    the "fp16" hook the ranks' scales their own (some differ) and no amax
    collective, its loss within HOOK_LOSS_TOL of the one-process step 1.
    (c) each family's greedy tokens equal the whole-weights reference's off
    near-ties, its teacher-forced logits within the tie gap (TP_PLAIN_FACTOR
    times the reference's bf16-against-fp32 difference, at least TIE_GAP).
    (d) phase 24's gates against phase 18 (b)'s first three steps, each
    flash kernel launched twice a step on each rank (one layer, two
    microbatches). (e) the DCP round trip's second step bit-equal (metrics
    and parameters) to the plain one; the one-process resume of the
    SHARDED_STATE_DICT save bit-equal to the gathered parameters."""
    ranks = [next((line["rest"] for line in reversed(lines) if "rest" in line), None)
             for _, lines, _ in children]
    res = {"phase": "parallel_rest", "ranks": TP_RANKS,
           "note": "two processes on one card joined by gloo, which stages every collective "
                   "through the host: step ms are gloo's"}
    checks = {"children": all(rc == 0 for rc, _, _ in children) and all(ranks)}
    if not checks["children"]:
        return {**res, "checks": checks, "ok": False,
                "child_exit": [rc for rc, _, _ in children],
                "child_stderr": [err for _, _, err in children]}
    out = {}
    # (a)
    runs = [r["fp8_tp"] for r in ranks]
    rel = max(_rel(g, w) for r in runs for got, want in zip(r["metrics"], fp8_first)
              for g, w in zip(got, want))
    checks["fp8_tp_vs_phase14"] = len(runs[0]["metrics"]) == TP_STEPS and rel <= TP_REL_TOL
    checks["fp8_tp_ranks_agree"] = all(r["metrics"] == runs[0]["metrics"] for r in runs)
    checks["fp8_tp_scaled_mm"] = all(r["paths"]["dequantized"] == 0 and r["paths"]["scaled_mm"]
                                     for r in runs)
    checks["fp8_tp_launches"] = all(r["launches_per_step"].get(k) == r["n_layers"]
                                    for r in runs for k in KERNELS)
    out["fp8_tp"] = {"rank_metrics": [r["metrics"] for r in runs], "phase14_metrics": fp8_first,
                     "max_rel": rel, **{k: [r.get(k) for r in runs] for k in (
                         "step_ms", "step_ms_each", "amax_all_reduces_per_step",
                         "amax_ms_per_step", "amax_share", "peak_mem_gib", "device_busy_ms",
                         "idle_share", "busy_ms_by_category", "top_kernels_ms",
                         "launches_per_step", "paths")}}
    # (b)
    dp = [r["fp8_batch"]["dp"] for r in ranks]
    hook = [r["fp8_batch"]["hook"] for r in ranks]
    rel = max(_rel(g, w) for r in dp for got, want in zip(r["metrics"], fp8_ref["metrics"])
              for g, w in zip(got, want))
    checks["fp8_batch_scales_agree"] = bool(dp[0]["scales"]) and all(
        r["scales"] == dp[0]["scales"] for r in dp)
    checks["fp8_batch_vs_one_process"] = rel <= TP_REL_TOL
    checks["fp8_hook_scales_own"] = any(a != b for a, b in zip(hook[0]["scales"],
                                                               hook[1]["scales"]))
    checks["fp8_hook_no_amax_collective"] = all(r["amax_all_reduces_per_step"] == 0
                                                for r in hook)
    checks["fp8_hook_loss"] = all(abs(r["metrics"][0][0] - fp8_ref["metrics"][0][0])
                                  <= HOOK_LOSS_TOL for r in hook)
    out["fp8_batch"] = {
        "rank_metrics": [r["metrics"] for r in dp], "one_process_metrics": fp8_ref["metrics"],
        "max_rel": rel, "amax_all_reduces_per_step": [r["amax_all_reduces_per_step"] for r in dp],
        "scales_step1": len(dp[0]["scales"]),
        "scale_rel_to_one_process": max(
            abs(g - (w * TP_RANKS if bwd else w)) / (w * TP_RANKS if bwd else w)
            for (g, bwd), (w, _) in zip(dp[0]["scales"], fp8_ref["scales"])),
        "hook_losses": [r["metrics"][0][0] for r in hook],
        "hook_scales_differing": sum(a != b for a, b in zip(hook[0]["scales"],
                                                            hook[1]["scales"]))}
    # (c)
    out["decode"] = {}
    for name in ranks[0]["decode"]:
        decodes = [r["decode"][name] for r in ranks]
        tie_gap = [max(TIE_GAP, TP_PLAIN_FACTOR * d["plain_delta"]) for d in decodes]
        div = [first_divergence([d["plain_row"]], [d["row"]], [d["plain_gaps"]], g)[0]
               for d, g in zip(decodes, tie_gap)]
        checks[f"decode_{name}_tokens"] = parity_ok(div)
        checks[f"decode_{name}_logits"] = all(d["logit_delta"] <= g
                                              for d, g in zip(decodes, tie_gap))
        checks[f"decode_{name}_split"] = all(d["split_params"] > 0 for d in decodes)
        out["decode"][name] = {"row": decodes[0]["row"], "plain_row": decodes[0]["plain_row"],
                               "first_divergence": div, "tie_gap": tie_gap,
                               **{k: [d[k] for d in decodes] for k in (
                                   "logit_delta", "plain_delta", "ms_per_token",
                                   "all_reduces_per_token", "split_params")}}
    # (d)
    runs = [r["pp_mixtral"] for r in ranks]
    want = phase18["first_metrics"]
    rel = max(_rel(g, w) for r in runs for got, w_ in zip(r["metrics"], want)
              for g, w in zip(got, w_))
    rel1 = [[_rel(g, w) for g, w in zip(r["metrics"][0], want[0])] for r in runs]
    drop_room = [EP_DROP_SHARE * phase18["routed"] + EP_REL_TOL * w if i else 0.0
                 for i, w in enumerate(phase18["dropped"][:EP_STEPS])]
    drop_over = [max(abs(d - w) - room for d, w, room in
                     zip(r["dropped"], phase18["dropped"], drop_room)) for r in runs]
    checks["pp_mixtral_vs_phase18"] = len(runs[0]["metrics"]) == EP_STEPS and rel <= EP_REL_TOL
    checks["pp_mixtral_step1"] = all(loss <= EP_STEP1_LOSS_TOL and norm <= EP_STEP1_NORM_TOL
                                     for loss, norm in rel1)
    checks["pp_mixtral_ranks_agree"] = all(r["metrics"] == runs[0]["metrics"] for r in runs)
    checks["pp_mixtral_dropped"] = max(drop_over) <= 0
    checks["pp_mixtral_launches"] = all(
        r["launches_per_step"].get(k) == r["microbatches"] for r in runs for k in KERNELS)
    out["pp_mixtral"] = {"rank_metrics": [r["metrics"] for r in runs], "phase18_metrics": want,
                         "max_rel": rel, "step1_rel": rel1,
                         "dropped": [r["dropped"] for r in runs],
                         "phase18_dropped": phase18["dropped"][:EP_STEPS], "drop_room": drop_room,
                         "phase18_step_ms": phase18["step_ms"],
                         **{k: [r.get(k) for r in runs] for k in (
                             "aux", "step_ms", "step_ms_each", "peak_mem_gib",
                             "launches_per_step", "p2p_per_step", "local_params")}}
    # (e)
    ck = [r["checkpoints"] for r in ranks]
    checks["dcp_round_trip_bit_equal"] = all(
        c["dcp"]["plain"] == c["dcp"]["round_trip"] for c in ck)
    checks["sharded_resume_bit_equal"] = (resume is not None and all(
        c["sharded"]["fingerprint"] == resume["fingerprint"] for c in ck))
    checks["sharded_saved_dtensors"] = all(c["sharded"]["dtensors"] > 0 for c in ck)
    out["checkpoints"] = {
        "dcp": [{k: c["dcp"][k] for k in ("save_s", "load_s", "bytes")} for c in ck],
        "dcp_metrics": ck[0]["dcp"]["plain"]["metrics"],
        "sharded": [{k: c["sharded"][k] for k in ("save_s", "bytes", "loss")} for c in ck],
        "resume": resume}
    return {**res, **out, "part_s": [r["part_s"] for r in ranks],
            "seconds": max(r["seconds"] for r in ranks),
            "variant_launches": {"fp8_tp_step": ranks[0]["fp8_tp"]["variant_launches"],
                                 "pp_mixtral_step": ranks[0]["pp_mixtral"]["variant_launches"],
                                 "pp_dcp_step": ranks[0]["checkpoints"]["variant_launches"]},
            "checks": checks, "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 26: fault tolerance, chaos and SDC (ROADMAP.md Queue A item 12.1)
# ---------------------------------------------------------------------------

# (a), (b): phase 5's Llama at full width with 4 of its 18 layers, batch 4 x
# 2048, bf16 over fp32 masters, flash; 8 steps saving after steps 2 (its
# manifest checksum "size") and 4 ("sha256"); chaos: the first attempt of
# the second save torn, a slow step at tick 2, a nonfinite_grad at tick 5;
# sentinel "rollback" over a window of 1. (b): the first child sends itself
# SIGTERM after step 3, the second resumes and takes steps 4-6.
FT_ROW = dict(layers=4, batch=SLICE["b"], seq=SLICE["s"], steps=8, saves=(2, 4), timed=3,
              slow_s=0.05, preempt_after=3, resume_to=6, lr=3e-4)
FT_SCHEDULE = ({"point": "checkpoint_save", "kind": "torn_write", "tick": 1, "unit": 0},
               {"point": "train_step", "kind": "slow_step", "tick": 2},
               {"point": "train_step", "kind": "nonfinite_grad", "tick": 5})
# (c): phase 22's two processes at dp_replicate=2 (DDP over gloo), phase 5's
# widths at 2 layers, one row each; the SDC sentinel votes every step,
# rolls back to the checkpoint after step 1. Transient flip on rank 1 at
# tick 1; then a sticky one at the next tick.
SDC_ROW = dict(layers=2, batch=1, seq=SLICE["s"], steps=3, flip_tick=1)
# (d): phase 8's 8-slot engine on phase 7's model: 8 requests of 64-token
# prompts and 16 new tokens; the canary every 16 ticks with 4 new tokens.
FT_ENGINE = dict(requests=8, prompt_len=64, new_tokens=16, slots=8, poison_tick=6,
                 canary_every=16, canary_ticks=40, drain_after=3)
# (e): phase 20 (b)'s BERT-large and phase 19 (b)'s T5-base at pp=2, two
# steps; step 1's loss against phase 20's and 19's step 1.
PP_FAMILY_RUNS = ("bert_large", "t5_base")
PP_FAMILY_REL_TOL = 2e-2


def ft_llama(device="cuda", width=FULL_WIDTH, row=FT_ROW, project_dir=None, handler=None,
             automatic_resume=False, checksum=None):
    """Phase 26's Llama (phase 5's widths at ``row["layers"]`` layers, its
    seeded init), its Accelerator (bf16; ``handler`` a FaultToleranceKwargs),
    step and fixed batches (one per step, numpy-seeded)."""
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ProjectConfiguration, adamw
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss

    _reset_port_state()
    cfg = LlamaConfig(**dict(width, num_hidden_layers=row["layers"]),
                      max_position_embeddings=row["seq"], dtype=torch.bfloat16, remat=True,
                      remat_policy="dots", attention_impl="flash")
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      project_config=ProjectConfiguration(
                          project_dir=project_dir, automatic_checkpoint_naming=True,
                          automatic_resume=automatic_resume),
                      kwargs_handlers=[handler] if handler is not None else None)
    module = LlamaForCausalLM(cfg, device=acc.device)
    module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    acc.prepare(Model(module), adamw(row["lr"], weight_decay=0.1))
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]),
                                  max_grad_norm=1.0)
    rng = np.random.default_rng(26)
    batches = []
    for _ in range(row["steps"] + 1):
        ids = rng.integers(0, cfg.vocab_size, size=(row["batch"], row["seq"] + 1))
        batches.append({"x": torch.from_numpy(ids[:, :-1]).to(acc.device),
                        "y": torch.from_numpy(ids[:, 1:]).to(acc.device)})
    return acc, step, batches


def ft_loop(acc, step, batches, until, saves=(), checksums=None, max_ticks=None):
    """Steps on the batch of the state's step until step ``until`` (a
    rollback replays from the restored step), saving after the steps in
    ``saves`` once each (with the manifest checksum ``checksums[step]``).
    Returns [(step before, loss tensor)] and each save's seconds."""
    state, out, saved, save_s = acc.train_state, [], {}, {}
    for _ in range(max_ticks or 4 * until):
        if int(state.step) >= until:
            break
        s0 = int(state.step)
        state, m = step(state, batches[s0])
        out.append((s0, m["loss"]))
        s = int(state.step)
        if s in saves and s not in saved:
            ft = acc.fault_tolerance
            if ft is not None and checksums:
                ft.handler = dataclasses.replace(ft.handler, checksum=checksums[s])
            t0 = time.perf_counter()
            saved[s] = acc.save_state()
            save_s[s] = {"seconds": time.perf_counter() - t0, **acc.checkpoint_stats}
    return out, save_s


def _timed_steps(acc, step, batches, n):
    """Mean host ms of ``n`` steps between two synchronisations."""
    import torch

    state = acc.train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, _ = step(state, batches[int(state.step) % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _profiled_syncs(acc, step, batches, n=2):
    """SYNC_CALLS and device-to-host copies a step over ``n`` steps."""
    import torch

    state = acc.train_state
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=profiled_activities(True)) as prof:
        for _ in range(n):
            state, _ = step(state, batches[int(state.step) % len(batches)])
        torch.cuda.synchronize()
    return sync_counts(prof, n)


def ft_rollback_part(hf, device="cuda", width=FULL_WIDTH, row=FT_ROW, root=None,
                     before_clean=None) -> dict:
    """(a) in this process: the chaos run (torn save retried, slow step,
    nonfinite metrics rolled back to the step-4 checkpoint) against the
    fault-free run, bit for bit; host syncs a step with the manager on and
    off; seconds of the saves (sha256 and size), of the verification on
    load and of the rollback; a truncated newest checkpoint skipped."""
    import torch

    from accelerate_tpu_torch import FaultToleranceKwargs
    from accelerate_tpu_torch import fault_tolerance as ftmod

    t_start = time.perf_counter()
    schedule = [dict(e, seconds=row["slow_s"]) if e["kind"] == "slow_step" else dict(e)
                for e in FT_SCHEDULE]
    handler = FaultToleranceKwargs(sentinel="rollback", sentinel_window=1, retry_backoff_s=0.0,
                                   chaos=dict(seed=0, schedule=schedule))
    project = os.path.join(root, "a")
    acc, step, batches = ft_llama(device, width, row, project_dir=project, handler=handler)
    ft = acc.fault_tolerance
    # The path's launches: counted from zero just before, read just after.
    hf.reset_launch_counts()
    run, saves = ft_loop(acc, step, batches, row["steps"], saves=row["saves"],
                         checksums={row["saves"][0]: "size", row["saves"][1]: "sha256"})
    launches, variant_launches = dict(hf.LAUNCHES), dict(hf.VARIANT_LAUNCHES)
    run = [(s, float(loss)) for s, loss in run]
    base = os.path.join(project, "checkpoints")
    listing = sorted(os.listdir(base))
    # The manager on and off on this model, alternating (every hook is a
    # None check without it), so that both sides see the same host state.
    on_ms, off_ms = [], []
    for _ in range(2):
        on_ms.append(_timed_steps(acc, step, batches, row["timed"]))
        acc.fault_tolerance = None
        off_ms.append(_timed_steps(acc, step, batches, row["timed"]))
        acc.fault_tolerance = ft
    on_syncs = _profiled_syncs(acc, step, batches)
    acc.fault_tolerance = None
    off_syncs = _profiled_syncs(acc, step, batches)
    acc.fault_tolerance = ft
    # The rollback's verification of the step-4 checkpoint (sha256 of every
    # byte) is the verification on load.
    verify = ft.last_verify
    # A truncated newest checkpoint: the resolver takes the older one (sizes
    # checked only: the truncation shows there).
    newest = os.path.join(base, listing[-1])
    victim = max((os.path.join(dp, f) for dp, _, fs in os.walk(newest) for f in fs
                  if f != "manifest.json"), key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    ft.handler = dataclasses.replace(ft.handler, checksum="size")
    resolved = ft.resolve_verified(base, listing)
    summary = {"rollbacks": ft.rollbacks_done, "save_retries": ft.save_retries_total,
               "injected": list(ft.chaos.injected),
               "rollback_s": getattr(ft, "last_rollback_s", None),
               "lagged_reads": {"fetches": ftmod.HostFetch.fetches,
                                "waited": ftmod.HostFetch.waits}}
    acc.end_training()
    del acc, step, ft
    gc.collect()
    torch.cuda.empty_cache()
    # The fault-free run, the manager off. It measures no time: (b)'s first
    # child starts beside it (``before_clean``).
    if before_clean is not None:
        before_clean()
    acc, step, batches = ft_llama(device, width, row, project_dir=os.path.join(root, "clean"))
    clean, _ = ft_loop(acc, step, batches, row["steps"])
    clean = [(s, float(loss)) for s, loss in clean]
    del acc, step
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(clean)
    sync_on = sum(on_syncs[k] for k in SYNC_CALLS)
    sync_off = sum(off_syncs[k] for k in SYNC_CALLS)
    checks = {
        "torn_save_retried_clean": summary["save_retries"] == 1
        and [e["point"] for e in summary["injected"]].count("checkpoint_save") == 1,
        "rollback_restores_step_4": summary["rollbacks"] == 1
        and [s for s, _ in run] == [0, 1, 2, 3, 4, 5, 6, 4, 5, 6, 7],
        "replay_bit_equal": all(loss == want[s] for s, loss in run),
        "no_tmp_left": listing == ["checkpoint_0", "checkpoint_1"],
        "verified_sha256": verify["dir"] == os.path.join(base, listing[-1])
        and verify["ok"] and verify["hashed"],
        "truncated_newest_skipped": resolved == listing[0],
        "host_syncs_equal": sync_on == sync_off,
        "losses_finite": all(math.isfinite(x) for _, x in clean),
        "flash_launched": all(launches.get(k, 0) > 0 for k in KERNELS),
    }
    return {"run": run, "fault_free": clean, **summary,
            "step_ms": {"manager_on": sum(on_ms) / len(on_ms),
                        "manager_off": sum(off_ms) / len(off_ms),
                        "windows": {"manager_on": on_ms, "manager_off": off_ms}},
            "syncs_per_step": {"manager_on": on_syncs, "manager_off": off_syncs},
            "save": {"size": saves.get(row["saves"][0]), "sha256": saves.get(row["saves"][1])},
            "verify_on_load_s": verify["seconds"], "checkpoint_bytes": saves.get(row["saves"][1], {}).get(
                "bytes"), "launches": launches, "variant_launches": variant_launches,
            "seconds": time.perf_counter() - t_start, "checks": checks}


def ft_child_main(args: dict) -> int:
    """(b): one training process of phase 26. With ``preempt_after`` it
    sends itself SIGTERM after that step, saves (the preemption save) and
    exits ``preemption_exit_code``; relaunched (``ACCELERATE_RESTART_ATTEMPT``
    in its environment) it resumes from the newest checkpoint and steps to
    ``resume_to``. Prints its losses by step."""
    import signal

    import torch

    from accelerate_tpu_torch import FaultToleranceKwargs

    device = args.get("device", "cuda")
    if device == "cpu":
        _stub_cuda_for_cpu()
    else:
        torch.empty(1, device=device)  # the CUDA context, before the wait
    row = {**FT_ROW, **args.get("row", {})}
    width = {**FULL_WIDTH, **args.get("width", {})}
    # Seconds since the script started: imported, told to go, model built
    # (and resumed), first step. The parent starts the child early and
    # creates ``args["go"]`` when its turn comes.
    timeline = {"ready_s": time.perf_counter() - RUN_START}
    while args.get("go") and not os.path.exists(args["go"]):
        time.sleep(0.05)
    timeline["go_s"] = time.perf_counter() - RUN_START
    acc, step, batches = ft_llama(device, width, row, project_dir=args["project"],
                                  handler=FaultToleranceKwargs(sentinel="off", checksum="size"),
                                  automatic_resume=True)
    timeline["prepared_s"] = time.perf_counter() - RUN_START
    state, losses = acc.train_state, {}
    resumed_at = int(state.step)
    while int(state.step) < row["resume_to"]:
        s0 = int(state.step)
        state, m = step(state, batches[s0])
        losses[s0 + 1] = m["loss"]
        timeline.setdefault("first_step_s", time.perf_counter() - RUN_START)
        if args.get("preempt_after") == int(state.step):
            os.kill(os.getpid(), signal.SIGTERM)
        if acc.check_preemption():
            t0 = time.perf_counter()
            acc.save_state()
            emit({"ft_child": {"losses": {k: float(v) for k, v in losses.items()},
                               "resumed_at": resumed_at, "save_s": time.perf_counter() - t0,
                               "signal": acc.fault_tolerance.preemption_signal,
                               "timeline": timeline}})
            acc.end_training()
            return acc.preemption_exit_code
    emit({"ft_child": {"losses": {k: float(v) for k, v in losses.items()},
                       "resumed_at": resumed_at, "timeline": timeline,
                       "load_s": (acc.checkpoint_stats or {}).get("seconds")}})
    acc.end_training()
    return 0


class FtChild:
    """(b): one ``chip_smoke.py --ft-child`` process, started now (it
    imports and makes its CUDA context, then waits for the file ``go``) and
    read by ``result()``: its exit code, its line, its wall seconds."""

    def __init__(self, device, row, width, project, attempt, preempt_after, go):
        args = {"device": device, "project": project, "preempt_after": preempt_after,
                "row": row, "width": width or {}, "go": go}
        env = {**os.environ, "ACCELERATE_RESTART_ATTEMPT": str(attempt)}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ft-child", json.dumps(args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=Path(__file__).resolve().parent)

    def result(self) -> dict:
        try:
            stdout, stderr = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            stdout, stderr = self.proc.communicate()
        lines = [json.loads(x) for x in stdout.splitlines() if x.startswith('{"ft_child"')]
        rc = self.proc.returncode
        return {"exit": rc, **(lines[-1]["ft_child"] if lines else {}),
                "wall_s": time.perf_counter() - self.t0,
                "elapsed_s": lines[-1]["elapsed_s"] if lines else None,
                "stderr": stderr[-2000:] if rc not in (0, 75) else ""}


def ft_resume_gate(first, second, row=FT_ROW, fault_free=None) -> dict:
    """(b)'s checks on the two children's results: the first preempted
    (exit 75), the second resumed at its save with steps 4-6 bit-equal to
    (a)'s fault-free run."""
    want = dict(fault_free or [])
    resumed = {int(k): v for k, v in second.get("losses", {}).items()}
    checks = {
        "preempted_exit_75": first["exit"] == 75 and first.get("signal") == "SIGTERM",
        "resumed_exit_0": second["exit"] == 0 and second.get("resumed_at") == row["preempt_after"],
        "resumed_steps_bit_equal": sorted(resumed) == list(range(row["preempt_after"] + 1,
                                                                  row["resume_to"] + 1))
        and all(resumed[s] == want.get(s - 1) for s in resumed),
    }
    return {"children": [first, second], "checks": checks}


def ft_engine_part(device="cuda", width=FULL_WIDTH, spec=FT_ENGINE) -> dict:
    """(d): phase 8's engine on phase 7's model: a decode_tick poison fails
    exactly its request (no retry), the others' tokens the fault-free
    run's; DecodeCanary(every=16) reads no mismatch fault-free and one or
    more under a decode_tick bit flip of its own slot; SIGTERM drains the
    engine (the queue shed, the requests in flight finished) and its exit
    code is 75."""
    import signal

    import numpy as np
    import torch

    from accelerate_tpu_torch import (Accelerator, DecodeCanary, FaultInjector,
                                      FaultToleranceKwargs, Model, ServingConfig, ServingEngine)
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    _reset_port_state()
    cfg = LlamaConfig(**width, max_position_embeddings=2048, dtype=torch.bfloat16)
    module = LlamaForCausalLM(cfg, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(0))
    module.to(torch.bfloat16)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, (spec["prompt_len"],)) for _ in
               range(spec["requests"])]
    scfg = dict(n_slots=spec["slots"], max_len=spec["prompt_len"] + spec["new_tokens"] + 8,
                min_prefill_chunk=min(16, spec["prompt_len"]),
                max_prefill_chunk=spec["prompt_len"], max_retries=0)

    def run(engine, n=len(prompts)):
        ids = [engine.submit(p, max_new_tokens=spec["new_tokens"]) for p in prompts[:n]]
        rows = {}
        while engine.pending:
            engine.tick()
            rows.update({r["id"]: r for r in engine.poll()})
        return [rows[i] for i in ids]

    clean = run(ServingEngine(Model(module), ServingConfig(**scfg)))
    poisoned = ServingEngine(Model(module), ServingConfig(**scfg), chaos=FaultInjector(
        schedule=[{"point": "decode_tick", "kind": "poison", "tick": spec["poison_tick"]}]))
    got = run(poisoned)
    failed = [i for i, r in enumerate(got) if r["status"] != "ok"]
    others_equal = all(np.array_equal(g["tokens"], c["tokens"])
                       for i, (g, c) in enumerate(zip(got, clean)) if i not in failed)
    # The canary: fault-free under traffic, then under a bit flip at every
    # decode tick with only its probe in flight.
    engine = ServingEngine(Model(module), ServingConfig(**scfg))
    canary = DecodeCanary(engine, every=spec["canary_every"], max_new_tokens=4)
    canary.warmup()
    run(engine)
    for _ in range(spec["canary_ticks"]):
        engine.tick()
        engine.poll()
    fault_free = engine.sdc_stats()
    engine.chaos = FaultInjector(rates={"decode_tick": {"bit_flip": 1.0}})
    for _ in range(spec["canary_ticks"]):
        engine.tick()
        engine.poll()
    flipped = engine.sdc_stats()
    # SIGTERM: the preemption drain.
    acc = Accelerator(cpu=device == "cpu", kwargs_handlers=[FaultToleranceKwargs(sentinel="off")])
    ft = acc.fault_tolerance
    ft.install_signal_handlers()
    engine = ServingEngine(Model(module), ServingConfig(**dict(scfg, n_slots=2)),
                           fault_tolerance=ft)
    ids = [engine.submit(p, max_new_tokens=spec["new_tokens"]) for p in prompts]
    for _ in range(spec["drain_after"]):
        engine.tick()
    os.kill(os.getpid(), signal.SIGTERM)
    rows = {}
    while engine.pending:
        engine.tick()
        rows.update({r["id"]: r for r in engine.poll()})
    ft.close()
    statuses = [rows[i]["status"] for i in ids]
    drained_equal = all(np.array_equal(rows[i]["tokens"], clean[k]["tokens"])
                        for k, i in enumerate(ids) if statuses[k] == "ok")
    checks = {
        "poison_fails_one_request": len(failed) == 1 and poisoned.fault_stats()["failed"] == 1,
        "others_equal_fault_free": others_equal,
        "canary_clean": fault_free["probes"] >= 1 and fault_free["mismatches"] == 0,
        "canary_sees_bit_flip": flipped["mismatches"] >= 1,
        "drain_sheds_queue_finishes_in_flight": statuses[:2] == ["ok", "ok"]
        and set(statuses[2:]) == {"shed"} and drained_equal,
        "drain_exit_code_75": engine.preempted and engine.preemption_exit_code == 75,
    }
    del module, engine, poisoned
    _reset_port_state()
    return {"poisoned": {"failed_requests": failed, "statuses": [r["status"] for r in got]},
            "canary": {"fault_free": fault_free, "bit_flip": flipped},
            "drain": {"statuses": statuses}, "seconds": time.perf_counter() - t0,
            "checks": checks}


def sdc_child(hf, device="cuda", kw=None) -> dict:
    """(c) in one of phase 22's processes: the 2-layer Llama at
    dp_replicate=2 (DDP over gloo), each rank on the same row, the SDC
    sentinel voting every step. A transient flip of rank 1's observed
    digest repaired (no majority, the probe, which reruns the golden step,
    clean: its digest the golden one; rollback to step 1) and the replay's
    losses and digests equal to the first pass's; the digest's and the
    vote's ms.
    The sticky run comes last (``sdc_sticky_child``)."""
    import torch

    from accelerate_tpu_torch import FaultInjector, FaultToleranceKwargs, ParallelismConfig
    from accelerate_tpu_torch.sdc import integrity_digest

    kw = kw or {}
    row = {**SDC_ROW, **kw.get("row", {})}
    width = {**FULL_WIDTH, **kw.get("width", {})}
    t0 = time.perf_counter()
    flip = {"point": "train_step", "kind": "bit_flip", "tick": row["flip_tick"], "unit": 1,
            "mode": "transient"}
    handler = FaultToleranceKwargs(sentinel="off", checksum="size",
                                   sdc=dict(vote_every=1, repair="rollback"),
                                   chaos=dict(seed=0, schedule=[flip]))
    project = kw["project"]
    acc, step, batches = ft_llama(device, width, dict(FT_ROW, **row), project_dir=project,
                                  handler=handler)
    assert isinstance(acc.parallelism_config, ParallelismConfig)
    sentinel = acc.fault_tolerance.sdc
    state, run, saved = acc.train_state, [], False
    for _ in range(3 * row["steps"]):
        if int(state.step) >= row["steps"]:
            break
        s0 = int(state.step)
        state, m = step(state, batches[s0])
        run.append((s0, m["loss"], m["sdc_digest"]))
        if not saved:
            acc.save_state()
            saved = True
    run = [(s, float(loss), float(d)) for s, loss, d in run]
    golden = sentinel._golden["digest"]
    # The digest alone, on the card.
    plan = sentinel._plans[id(acc.train_state.model)]
    gnorm = torch.ones((), device=acc.device)
    digest_ms = cuda_ms(lambda: integrity_digest(plan, gnorm), 10) if device == "cuda" \
        else None
    summary = sentinel.summary()
    out = {"run": run, "golden": golden, "summary": summary,
           "digest_ms": digest_ms,
           "vote_ms": sentinel.timings["vote_s"] / max(1, sentinel.timings["votes"]) * 1e3,
           "seconds": time.perf_counter() - t0}
    # The sticky run continues this Accelerator: its golden is captured.
    sticky = {"point": "train_step", "kind": "bit_flip", "unit": 1, "mode": "sticky",
              "tick": acc.fault_tolerance._step_ticks}
    acc.fault_tolerance.chaos = FaultInjector(schedule=[sticky])
    return out, (acc, step, batches)


def sdc_sticky_child(acc, step, batches) -> dict:
    """The sticky flip on rank 1: the probe reproduces it, rank 1 writes the
    quarantine record and exits SDC_EXIT_CODE (79) for real; rank 0 is told
    its peer was convicted and leaves the loop (no collective after)."""
    state = acc.train_state
    for _ in range(4):
        s0 = int(state.step)
        state, _ = step(state, batches[s0 % len(batches)])
        if acc.fault_tolerance.sdc.peer_quarantined:
            break
    return {"peer_quarantined": acc.fault_tolerance.sdc.peer_quarantined,
            "summary": acc.fault_tolerance.sdc.summary()}


def pp_family_rank(hf, name, device="cuda", row=None, steps=2) -> dict:
    """(e) in one of phase 22's processes: a family's full-width train step
    (phase 19/20 (b)'s row, weights, batch and loss) at pp=2."""
    import torch

    from accelerate_tpu_torch import Accelerator, Model, ParallelismConfig, adamw

    row = row or {**FAMILY_ROWS, **ENCODER_ROWS}[name]
    family = row["family"]
    _reset_port_state()
    cfg = family_config(row, torch.bfloat16)
    acc = Accelerator(mixed_precision="bf16", cpu=device == "cpu",
                      parallelism_config=ParallelismConfig(pp_size=2))
    module = family_classes(family)[1](cfg, device=acc.device)
    if row.get("numpy_weights"):
        module.load_state_dict({k: v.to(acc.device) for k, v in family_weights(module).items()})
    else:
        module.init_weights(torch.Generator(device=acc.device).manual_seed(0))
    acc.prepare(Model(module), adamw(3e-4, weight_decay=0.1))
    generator = torch.Generator(device=acc.device).manual_seed(0)
    step = acc.prepare_train_step(family_loss(family, generator), max_grad_norm=1.0)
    batch = family_batch(family, cfg, row["batch"], acc.device, **row_shape(row))
    state, metrics, ms = acc.train_state, [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ms.append((time.perf_counter() - t0) * 1e3)
    pipelined = getattr(module, "_pp_pipelined", False)
    out = {"metrics": metrics, "step_ms": ms, "pipelined": pipelined,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "batch": row["batch"]}
    del acc, module, step, state, batch
    _reset_port_state()
    return out


def ft_gate(children, parts, phase19, phase20, sdc_exit) -> dict:
    """Phase 26's checks: (a), (b), (d) from the parent's parts; (c) and (e)
    from the children's lines (``{"sdc": ...}``, ``{"pp_families": ...}``)
    and the sticky conviction's exit code and quarantine record
    (``sdc_exit``)."""
    ranks = [next((line for line in reversed(lines) if "sdc" in line), None)
             for _, lines, _ in children]
    fam = [next((line["pp_families"] for line in reversed(lines) if "pp_families" in line),
                None) for _, lines, _ in children]
    checks = {f"a_{k}": v for k, v in parts["a"]["checks"].items()}
    checks.update({f"b_{k}": v for k, v in parts["b"]["checks"].items()})
    checks.update({f"d_{k}": v for k, v in parts["d"]["checks"].items()})
    checks["c_children"] = all(ranks) and all(fam)
    out = {"phase": "fault_tolerance", "parts": parts, "sticky": sdc_exit,
           "note": "(c) and (e) in phase 22's two processes on one card joined by gloo"}
    if not checks["c_children"]:
        return {**out, "checks": checks, "ok": False,
                "child_exit": [rc for rc, _, _ in children],
                "child_stderr": [err for _, _, err in children]}
    sdc = [r["sdc"] for r in ranks]
    out["sdc"] = sdc
    flip = SDC_ROW["flip_tick"]
    for r, res in enumerate(sdc):
        first = {s: (loss, d) for s, loss, d in res["run"][:flip + 2]}
        replay = res["run"][flip + 2:]
        # The transient repair's probe reran the golden step: a clean probe
        # is its digest equal to the golden one bit for bit.
        checks[f"c_golden_twice_equal_{r}"] = (res["summary"]["probes"] == 1
                                               and res["summary"]["probes_failed"] == 0)
        checks[f"c_transient_repaired_{r}"] = (
            res["summary"]["repairs"] == 1 and res["summary"]["probes_failed"] == 0
            and [s for s, _, _ in res["run"]] == list(range(flip + 2)) + list(
                range(1, SDC_ROW["steps"])))
        checks[f"c_replay_bit_equal_{r}"] = all(first.get(s) == (loss, d)
                                                for s, loss, d in replay)
    checks["c_ranks_equal"] = sdc[0]["run"] == sdc[1]["run"]
    checks["c_sticky_exit_79"] = sdc_exit["exit_codes"] == [0, 79]
    checks["c_sticky_quarantined"] = sdc_exit["quarantined"] == [1]
    checks["c_peer_told"] = bool(sdc_exit.get("peer_quarantined"))
    out["pp_families"] = fam
    for name, ref in (("bert_large", phase20["train"]["bert_large"]["losses"][0]),
                      ("t5_base", phase19["train"]["t5_base"]["losses"][0])):
        got = [f[name]["metrics"][0][0] for f in fam]
        checks[f"e_{name}_step1_within_tol"] = all(
            abs(g - ref) <= PP_FAMILY_REL_TOL * abs(ref) for g in got)
        checks[f"e_{name}_ranks_equal"] = fam[0][name]["metrics"] == fam[1][name]["metrics"]
        out.setdefault("pp_reference_loss", {})[name] = ref
    return {**out, "checks": checks, "ok": all(checks.values())}


def ft_phase(hf, children, phase19, phase20, sdc_exit, device="cuda", width=FULL_WIDTH,
             row=FT_ROW, engine=FT_ENGINE) -> dict:
    """Phase 26 in the parent: (a), (b) and (d), then the gate with the
    children's (c) and (e). (b)'s children start with the phase and wait
    (imported, their CUDA contexts made) for their turns: the first runs
    beside (a)'s fault-free run, the second beside (d), which measure no
    time; ``b["seconds"]`` runs from the end of (a) to the second's end."""
    t0 = time.perf_counter()
    root, room = checkpoint_root(4 * llama_n_params(dict(width,
                                                         num_hidden_layers=row["layers"])) * 12)
    narrow = {k: v for k, v in width.items() if width[k] != FULL_WIDTH.get(k)}
    go = [os.path.join(root, f"go{i}") for i in (1, 2)]

    def turn(path):
        open(path, "w").close()

    # (b)'s children start now and wait for their turns: the first after
    # (a)'s timed part, beside its fault-free run; the second after the
    # first exits, beside (d). Those two measure no time.
    children_b = [FtChild(device, row, narrow, os.path.join(root, "b"), 0,
                          row["preempt_after"], go[0]),
                  FtChild(device, row, narrow, os.path.join(root, "b"), 1, None, go[1])]
    try:
        a = ft_rollback_part(hf, device, width, row, root=root,
                             before_clean=lambda: turn(go[0]))
        t = time.perf_counter()
        first = children_b[0].result()
        turn(go[1])
        d = ft_engine_part(device, width, engine)
        b = ft_resume_gate(first, children_b[1].result(), row, a["fault_free"])
        b["seconds"] = time.perf_counter() - t
    finally:
        for c in children_b:
            if c.proc.poll() is None:
                c.proc.kill()
        shutil.rmtree(root, ignore_errors=True)
    res = ft_gate(children, {"a": a, "b": b, "d": d}, phase19, phase20, sdc_exit)
    res["checkpoint_root"] = room
    res["phase_s"] = time.perf_counter() - t0
    return res


def _stub_cuda_for_cpu():
    """The CUDA calls of the phases as no-ops, for a rehearsal on the CPU."""
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        setattr(torch.cuda, name, lambda *a, **k: 0)


def child_main(args: dict) -> int:
    """The child of phase 10. ``args["device"] == "cpu"`` rehearses it on
    the CPU over gloo (``args["kw"]`` may shrink it); the card run passes
    only the parent's numbers."""
    if args.get("device", "cuda") == "cpu":
        _stub_cuda_for_cpu()
    from accelerate_tpu_torch.ops import hopper_flash as hf

    res = data_parallel_phase(hf, args, device=args.get("device", "cuda"), **args.get("kw", {}))
    emit(res)
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()  # destroys the group it created
    return 0 if res["ok"] else 1




def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from accelerate_tpu_torch.ops import _build
        from accelerate_tpu_torch.ops import hopper_flash as hf
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 3

    # 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in rep.splitlines()
                    if any(x in line for x in ("registers", "spill", "warning"))]
             for name, rep in reports.items()}
    sass = sass_counts(_build.KERNEL_SOURCES)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas, "sass": sass})
    if not sass_ok(sass):
        print("chip_smoke: a kernel library lacks wgmma or TMA loads, or has mma.sync",
              file=sys.stderr)
        return 1

    # 2. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    cases = [
        check_kernels(hf, "slice", **SLICE),
        check_kernels(hf, "gqa_ragged", 2, 160, 4, 2, 32, seed=1),
        check_kernels(hf, "visible_offsets", 2, 128, 4, 2, 64, q_offset=128, k_offset=0, seed=2),
        check_kernels(hf, "fully_masked", 2, 128, 4, 2, 64, q_offset=0, k_offset=128, seed=3),
        # Rows 0-31 see no key, inside key blocks that do run.
        check_kernels(hf, "partly_masked", 2, 160, 4, 2, 128, q_offset=0, k_offset=32, seed=4),
        check_kernels(hf, "noncausal_gqa_ragged", 2, 200, 4, 2, 128, seed=5, causal=False),
        check_kernels(hf, "fused_qkv_views", 2, 256, 4, 2, 128, seed=6, fused_qkv=True),
        # dK/dV loops over a group of 4 heads on ragged 64-query tiles.
        check_kernels(hf, "gqa4_ragged", 2, 300, 8, 2, 64, seed=8),
        # Head dim 256 (Gemma's), GQA 8:1, ragged tails, both 16-bit types.
        *(check_kernels(hf, f"{dt}_d256_gqa8_{'causal' if c else 'full'}", 2, 300, 8, 1, 256,
                        seed=10 + i, causal=c, dtype=dt)
          for i, (dt, c) in enumerate((d, c) for d in ("bfloat16", "float16")
                                      for c in (True, False))),
        check_kernels(hf, "float16_d256_partly_masked", 1, 160, 4, 2, 256, q_offset=0,
                      k_offset=32, seed=14, dtype="float16"),
        check_kernels(hf, "float16_d128", 2, 256, 4, 2, 128, seed=15, dtype="float16"),
        check_kernels(hf, "float16_d64_ragged", 2, 160, 4, 2, 64, seed=16, dtype="float16"),
        check_kernels(hf, "float32_d64", 2, 200, 4, 2, 64, seed=17, dtype="float32"),
        check_kernels(hf, "float32_d128", 2, 200, 4, 2, 128, seed=18, dtype="float32"),
        check_kernels(hf, "float32_d128_noncausal_offsets", 2, 160, 4, 2, 128, q_offset=0,
                      k_offset=32, seed=19, causal=False, dtype="float32"),
        check_kernels(hf, "float32_d256_gqa8", 1, 130, 8, 1, 256, seed=20, dtype="float32"),
        check_kernels(hf, "float32_fully_masked", 2, 128, 4, 2, 64, q_offset=0, k_offset=128,
                      seed=21, dtype="float32"),
        # Head dims the wrappers pad to 128.
        check_kernels(hf, "bfloat16_d80_padded", 2, 160, 4, 2, 80, seed=22),
        check_kernels(hf, "bfloat16_d96_padded_noncausal", 2, 160, 4, 2, 96, seed=23,
                      causal=False),
        # Phase 17's Gemma-2B step: its attention at the step's own shape.
        check_kernels(hf, "gemma_2b", **GEMMA_LIKE, seed=24),
        # Phase 18's Mixtral-8x7B step: GQA 4:1 at head dim 128.
        check_kernels(hf, "mixtral_8x7b", **MIXTRAL_LIKE, seed=25),
        # Phase 18's cp_generate prefill: seq 8192, the forward kernel.
        check_kernels(hf, "cp_generate_8192", **CP_GEN_LIKE, seed=26),
        # Phase 21's Llama-2-7B forward, streamed and resident.
        check_kernels(hf, "llama2_7b_stream", **LLAMA2_7B_LIKE, seed=27),
        # Phase 22's step at tp=2: each rank's 8 of the 16 heads.
        check_kernels(hf, "tp2_heads8", **TP_LIKE, seed=28),
        # Phase 23's GPipe step at pp=2: microbatches of one row.
        check_kernels(hf, "pp_microbatch", **PP_LIKE, seed=29),
        # Phase 24's ranks: (a) one row of Mixtral's step, (b) after the
        # Ulysses exchange.
        check_kernels(hf, "ep_row", **EP_LIKE, seed=30),
        check_kernels(hf, "sp_ep_ulysses", **SP_EP_LIKE, seed=31),
    ]
    for case in cases:
        emit({"phase": "kernels", **case})
    if not all(case["ok"] for case in cases):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1

    # 3. timings: the main path's variant at the training shapes, then every
    # other variant
    timed = [dict(time_variant(hf, dtype, shape), name=name, paths=paths)
             for name, dtype, shape, paths in TIMED]
    for t in timed:
        emit({"phase": "timings", **t,
              "bound_ms": {k: v[0] for k, v in t["bound"].items()},
              "backward_ms": {"flash_dq+flash_dkv": t["ms"]["flash_dq"] + t["ms"]["flash_dkv"],
                              "bound": t["bound"]["flash_dq"][0] + t["bound"]["flash_dkv"][0]},
              "library": "scaled_dot_product_attention: its forward, and its backward "
                         "(dq, dk and dv in one call)"})

    # 4. tiny Llama, one step on the card and on the CPU
    results, rel = tiny_step_parity()
    tiny_ok = all(math.isfinite(results[d][k]) for d in results for k in results[d]) and \
        max(rel.values()) <= 2e-2
    emit({"phase": "tiny_step", **results, "rel": rel, "ok": tiny_ok})
    if not tiny_ok:
        print("chip_smoke: tiny step on the card disagrees with the CPU", file=sys.stderr)
        return 1

    # 5. the main path at full width
    main_path = full_width_steps(hf)
    per_step = main_path["launches_per_step"]
    # Random weights of std 0.02 start near the uniform loss ln(vocab); every
    # layer launches each kernel once per step (dots keeps the forward's
    # outputs, so the backward's recompute does not run it again).
    path_ok = (all(math.isfinite(x) for x in main_path["losses"])
               and abs(main_path["losses"][0] - main_path["ln_vocab"]) < 1.0
               and all(n == main_path["n_layers"] for n in per_step.values()))
    main_path.pop("_acc")
    main_path.pop("_module")
    emit({**{k: v for k, v in main_path.items() if k != "_step"}, "ok": path_ok})
    if not path_ok:
        print("chip_smoke: main path failed (loss or launch counts)", file=sys.stderr)
        return 1

    # 6. where the device time of a step goes (after the counted run)
    emit(profile_steps(*main_path.pop("_step"), main_path["step_ms"], steps=1))
    # The train step's model, optimizer state and activations go before the
    # generation phases.
    gc.collect()
    torch.cuda.empty_cache()
    allocated_gib = torch.cuda.memory_allocated() / 2**30

    # 7. generate: tiny card against CPU, then bench.py's decode row
    gen_res = {"tiny": tiny_generate_parity()}
    full_gen, gen_module = full_width_generate()
    gen_res["full_width"] = full_gen["variants"]
    gen_ok = generate_gate(gen_res)
    phase7_ms = full_gen["variants"]["bf16"]["decode_ms_per_token"]
    # Phase 22's reference: the bf16 row and its teacher-forced logits.
    prompt = decode_prompt(gen_module.config)[0].tolist()
    phase7_tp = tp_reference(gen_module.config, gen_module, prompt + full_gen["rows"]["bf16"],
                             phase7_ms)
    emit({"phase": "generate", "tiny_divergence": gen_res["tiny"],
          "allocated_gib_at_start": allocated_gib, **full_gen, "ok": gen_ok})
    if not gen_ok:
        print("chip_smoke: generate failed (card/CPU tokens, token range or finite logits)",
              file=sys.stderr)
        return 1

    # 8. serving: tiny engine against generate on the card, then full width
    tiny_serving = tiny_serving_parity()
    serving = full_width_serving(gen_module, keep_rows=True)
    # Phase 16 (b) takes this replay as its speculate_k=0 run on the trace.
    phase8 = {"rows": serving.pop("_rows"), "stats": serving["stats"],
              **{k: serving[k] for k in ("wall_s", "tok_s", "peak_mem_gib", "decode_ticks",
                                         "max_len", "kv_cache_bytes")}}
    del serving["_prompts"], serving["_budgets"]
    serving_ok = serving["ok"] and parity_ok(tiny_serving)
    emit({"phase": "serving", "tiny_divergence": tiny_serving, **serving, "ok": serving_ok})
    if not serving_ok:
        print("chip_smoke: serving failed (engine/generate tokens or a request)",
              file=sys.stderr)
        return 1
    # The serving engine and its model go before the training loop.
    serving_tok_s = serving["tok_s"]
    del gen_module, serving
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the training loop: loader, schedule, save_state, resume in a fresh
    # Accelerator
    loop = loop_phase(hf, main_path["step_ms"])
    emit(loop)
    if not loop["ok"]:
        print(f"chip_smoke: training loop failed: {loop['checks']}", file=sys.stderr)
        return 1
    gc.collect()
    torch.cuda.empty_cache()

    # 10. FSDP2 (and DDP) over a process group of one, in a child process
    rc, lines, err = run_child({"phase5": {k: main_path[k] for k in (
        "first_metrics", "step_ms", "peak_mem_gib")}, "tiny_step": results["cuda"]}, timeout=720)
    dp = lines[-1] if lines else {}
    dp_ok = rc == 0 and bool(dp.get("ok"))
    emit({"phase": "data_parallel", **dp, "child_exit": rc, "ok": dp_ok,
          **({} if dp_ok else {"child_stderr": err})})
    if not dp_ok:
        print(f"chip_smoke: data-parallel phase failed: {dp.get('checks')}", file=sys.stderr)
        return 1

    # 11. ring attention and Ulysses: every rank's share in this process
    seq = sequence_parallel_phase(hf)
    emit(seq)
    if not seq["ok"]:
        print(f"chip_smoke: sequence-parallel phase failed: {seq['checks']}", file=sys.stderr)
        return 1
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the imperative loop against the fused step, the batch-size search,
    # and (from phase 10's child) the loop under FSDP2
    imp = imperative_phase(hf, dp.get("imperative"))
    emit(imp)
    if not imp["ok"]:
        print(f"chip_smoke: imperative-loop phase failed: {imp['checks']}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 13. the loop and the engine with trackers, telemetry and the profiler
    obs = observed_phase(hf, phase8_tok_s=serving_tok_s, phase9=loop)
    emit(obs)
    if not obs["ok"]:
        print(f"chip_smoke: observability phase failed: {obs['checks']}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 14. reduced precision: the fp16 step with loss scaling, the fp8 step,
    # the fp8 linear against its plain version
    precision = precision_phase(hf, main_path, obs["telemetry_cost"]["blocks"][0]["syncs"],
                                dp.get("fp16"))
    emit(precision)
    if not precision["ok"]:
        print(f"chip_smoke: reduced-precision phase failed: {precision['checks']}",
              file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 15. DISTRIBUTED_STATE_DICT checkpoints: phase 9's loop saved blocking
    # and in the background, and the strategies phase 10's child ran
    dcp = distributed_checkpoint_phase(hf, loop, dp)
    emit(dcp)
    if not dcp["ok"]:
        print(f"chip_smoke: distributed-checkpoint phase failed: {dcp['checks']}",
              file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 16. serving, the rest: speculation, int8 KV pages, admission and
    # faults, speculative_generate and beam_search
    rest = serving_rest_phase(hf, phase7_ms, phase8=phase8)
    emit(rest)
    if not rest["ok"]:
        failed = sorted(k for k, v in rest["checks"].items() if not v)
        print(f"chip_smoke: serving phase 16 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 17. the Llama chassis: tiny knob sets card against CPU, Gemma-2B's
    # train step, decode row and engine, and the hub round trip
    chassis = chassis_phase(hf)
    emit(chassis)
    if not chassis["ok"]:
        failed = sorted(k for k, v in chassis["checks"].items() if not v)
        print(f"chip_smoke: chassis phase 17 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 18. the Mixtral family: the tiny step card against CPU, Mixtral-8x7B's
    # train step, decode row and engine, cp_generate, the hub round trip
    moe = moe_phase(hf)
    emit(moe)
    if not moe["ok"]:
        failed = sorted(k for k, v in moe["checks"].items() if not v)
        print(f"chip_smoke: Mixtral phase 18 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 19. GPT-2, GPT-NeoX, OPT, T5 and Whisper: the tiny models card against
    # CPU, the full-width train steps and decode rows, OPT-1.3B's engine, the
    # hub round trips
    families = families_phase(hf)
    emit(families)
    if not families["ok"]:
        failed = sorted(k for k, v in families["checks"].items() if not v)
        print(f"chip_smoke: families phase 19 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 20. BERT, ViT, CLIP and ResNet: the tiny encoders card against CPU, the
    # full-width train steps (ResNet-50's with mutable_state), the hub round
    # trips, FSDP2's units on every family's blocks at world size 1
    encoders = encoders_phase(hf)
    emit(encoders)
    if not encoders["ok"]:
        failed = sorted(k for k, v in encoders["checks"].items() if not v)
        print(f"chip_smoke: encoders phase 20 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 21. big-model inference: Llama-2-7B streamed past a budget on the card,
    # weight-only int8 and NF4, the seven families dispatched and offloaded,
    # a Megatron-core TP x PP checkpoint
    big = big_model_phase(hf, smi=smi)
    emit(big)
    if not big["ok"]:
        failed = sorted(k for k, v in big["checks"].items() if not v)
        print(f"chip_smoke: big-model phase 21 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 25's one-process reference: phase 23 (d)'s model with fp8 projections
    # on phase 5's whole batch
    fp8_ref = fp8_batch_steps(hf)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    sdc_dir = tempfile.mkdtemp(prefix="chip_smoke_sdc_")

    # 22. tensor parallelism: phase 5's step and phase 7's generate at tp=2,
    # two processes on the card over gloo, which then run phases 23-25 and
    # phase 26 (c) and (e)
    tpar = tensor_parallel_phase(hf, main_path, phase7_tp, ckpt_dir=ckpt_dir,
                                 sdc_project=sdc_dir)
    children = tpar.pop("_children")
    sdc_exit = tpar.pop("_sdc_exit")
    shutil.rmtree(sdc_dir, ignore_errors=True)
    tpar.pop("_logits")
    emit(tpar)
    if not tpar["ok"]:
        failed = sorted(k for k, v in tpar["checks"].items() if not v)
        print(f"chip_smoke: tensor-parallel phase 22 failed: {failed}", file=sys.stderr)
        return 1

    # 23. pipeline parallelism (GPipe, interleaved, prepare_pippy), the comm
    # hooks and LocalSGD, in phase 22's two processes
    pipe = pp_gate(children, main_path)
    emit(pipe)
    if not pipe["ok"]:
        failed = sorted(k for k, v in pipe["checks"].items() if not v)
        print(f"chip_smoke: pipeline phase 23 failed: {failed}", file=sys.stderr)
        return 1

    # 24. expert parallelism: Mixtral-8x7B's step at ep=2 over dp_shard and
    # at sp=2 with ep=2, and decode with the experts split, in phase 22's two
    # processes after phase 23
    ep = ep_gate(children, moe["mixtral_8x7b_train"])
    emit(ep)
    if not ep["ok"]:
        failed = sorted(k for k, v in ep["checks"].items() if not v)
        print(f"chip_smoke: expert-parallel phase 24 failed: {failed}", file=sys.stderr)
        return 1

    # 25. the rest of item 6: fp8 at tp=2 and over the batch, generate over
    # tp=2 for GPT-2 XL and T5-base, Mixtral at pp=2, the DCP round trip at
    # pp=2 and FSDP2's whole-tensor save, in phase 22's two processes
    try:
        resume = sharded_resume(ckpt_dir)
    except Exception as exc:  # judged as a failed check below
        print(f"chip_smoke: phase 25's one-process resume failed: {exc!r}", file=sys.stderr)
        resume = None
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rest = rest_gate(children, precision["fp8"]["first_metrics"], fp8_ref,
                     moe["mixtral_8x7b_train"], resume)
    emit(rest)
    if not rest["ok"]:
        failed = sorted(k for k, v in rest["checks"].items() if not v)
        print(f"chip_smoke: parallel-rest phase 25 failed: {failed}", file=sys.stderr)
        return 1

    gc.collect()
    torch.cuda.empty_cache()

    # 26. fault tolerance, chaos and SDC: (a) rollback and save retries, (b)
    # preemption and automatic_resume in two children, (d) the engine's
    # chaos, canary and drain here; (c) SDC and (e) pp for BERT-large and
    # T5-base from phase 22's processes
    ftp = ft_phase(hf, children, families, encoders, sdc_exit)
    ft_launches = ftp["parts"]["a"].pop("variant_launches")
    emit(ftp)
    if not ftp["ok"]:
        failed = sorted(k for k, v in ftp["checks"].items() if not v)
        print(f"chip_smoke: fault-tolerance phase 26 failed: {failed}", file=sys.stderr)
        return 1

    emit({"kernels": kernel_summary(timed, cases, main_path, {
        "gemma_2b_step": chassis["gemma_2b_train"]["variant_launches"],
        "mixtral_8x7b_step": moe["mixtral_8x7b_train"]["variant_launches"],
        "cp_generate": moe["cp_generate"]["variant_launches"],
        "imperative_loop": imp["loop"]["variant_launches"],
        "observed_loop": obs["variant_launches"],
        "observed_imperative": obs["imperative"]["variant_launches"],
        "observed_serving": obs["serving"]["variant_launches"],
        "fp16_step": precision["fp16"]["variant_launches"],
        "fp8_step": precision["fp8"]["variant_launches"],
        "dcp_loop": dcp["blocking"]["variant_launches"],
        "dcp_async_loop": dcp["background"]["variant_launches"],
        "serving_rest": rest["variant_launches"],
        "big_model_stream": big["stream"]["variant_launches"],
        "big_model_resident": big["resident"]["variant_launches"],
        "tp_step": tpar["variant_launches"],
        "tp_generate": tpar["generate_variant_launches"],
        **pipe["variant_launches"], **ep["variant_launches"], **rest["variant_launches"],
        "ft_loop": ft_launches})})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_summary(timed, cases, main_path, other_paths=None):
    """One entry per kernel of every timed variant (phase 3): its source,
    the TPU kernel it replaces, its launches in the main paths' runs
    (``MAIN_PATHS``, each counted from zero) among the entry's paths, and by
    path: phase 5's ``train_step`` and each of ``other_paths`` (a path's
    name → its variant launch counts) that the entry lists; its largest
    error in the check case (phase 2) at the timed shape where there is
    one, else in the first that ran it, its ms beside its plain version's,
    its bound and SDPA's forward (the backward kernels have no one-call
    library counterpart)."""
    out = []
    for t in timed:
        for name in KERNELS:
            variant = t["variants"][name]
            label = (variant if t["padded_to"] is None else
                     f"{name}.{variant.split('.')[1]}.d{t['shape']['d']}")
            ran = [c for c in cases if c["variants"][name] == variant
                   and (c["padded_to"] is None) == (t["padded_to"] is None)]
            at_shape = [c for c in ran if c.get("shape") == list(t["shape"].values())
                        and c.get("dtype") == t["dtype"] and c.get("causal")]
            case = (at_shape or ran or [None])[0]
            ms, (bound_ms, bound_by) = t["ms"][name], t["bound"][name]
            counts = {"train_step": main_path["variant_launches"], **(other_paths or {})}
            by_path = {path: counts[path].get(label, 0) for path in t["paths"] if path in counts}
            out.append({
                "name": f"{label}.{t['name']}" if t["name"] else label, "runs": variant,
                "route": "cuda",
                "source": SOURCES["flash_f32" if t["dtype"] == "float32" else name],
                "replaces": REPLACES[name], "dtype": t["dtype"], "shape": t["shape"],
                "launches": sum(by_path.get(path, 0) for path in MAIN_PATHS),
                "launches_by_path": by_path,
                "max_abs_err": case["max_abs"][name] if case else None,
                "ms": ms, "plain_ms": t["plain_ms"][name], "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": bound_ms / ms,
                "library_ms": t["library_ms"].get(name)})
    return out


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        sys.exit(child_main(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-child":
        sys.exit(tp_child_main(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--ft-child":
        sys.exit(ft_child_main(json.loads(sys.argv[2])))
    if len(sys.argv) == 2 and sys.argv[1] == "--drop-witness":
        sys.exit(drop_witness_main())
    sys.exit(main())
