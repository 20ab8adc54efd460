"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printed as it runs; every run makes all of them:

1. device  — the card's name and power limit (nvidia-smi), then the kernels'
             build from ``framefusion_tpu_torch/csrc`` and its time.
2. kernels — each hand-written kernel against its plain PyTorch version on
             the card, at the main path's shapes (and, for kernels F and G,
             at small odd shapes covering their edge cases), with the stated
             bound; kernel, plain version and one PyTorch call computing the
             same function (the yardstick, where one exists) timed with CUDA
             events (the short ones, B, C, D and G, over CUDA-graph replays,
             so the host's launch overhead does not hide them), beside the
             least time the card could take (bound_ms). Kernels C and D also
             at the batched decode's B = 2, 4, 8 rows and the speculative
             verify's 5 and 20; kernel E at the Qwen2-VL-7B tower's (32, 884,
             16, 80) and kernel B at Qwen2-VL's 4 capture rows at phase 11's
             phase-layer length (decided here from that prompt's layer-0
             merge), each an entry of its kernel's ``shapes``.
2b. kernel_check — ``framefusion_tpu_torch.kernel_bench.check_kernels()``:
             the JAX package's on-chip check matrix (every attention regime,
             the importance epilogues, E, F, G, the matvecs at Qwen2-7B
             shapes, and decode_step / decode_step_batch / verify_step /
             verify_step_batch against each other), each row within its bound;
             then ``check_batch_parity()``: the lockstep-batched planned
             prefill's decisions equal the solo prefills' (three 16-frame
             prompts, Qwen2-7B width, 8 layers), with no failure.
3. cross   — a tiny bf16 model, its weights drawn with numpy from a seed,
             through the compressed prefill (fused, planned and segmented)
             and greedy decode twice: plain versions and the decode step
             run eagerly on the CPU, kernels and the captured decode graph
             on the card. Events, cache lengths and tokens must be equal,
             generate_device and generate_stream must give generate's
             tokens, the tokens must vary, and the prefill logits must agree
             within a stated bf16 bound. Then three prompts through
             prefill_planned_batch and generate_batch (the batched step eagerly
             on the CPU, its captured graph on the card): modes, events, cache
             lengths and tokens equal, logits within the bound.
3b. cross_moe — a tiny bf16 Qwen2-MoE model (6 layers, hidden 512, 4 / 2
             heads, 8 experts top-2 of width 256, a shared expert of 512, the
             capacity factor 1.25; ``moe_cross_params``: its router reads a
             signature in each row, so routing holds under bf16 rounding)
             through the fused, planned and segmented prefill and 8 greedy
             tokens: plain versions on the CPU, kernels on the card (the
             routed experts of each decode step on C and D with a stack
             index a row, inside the captured decode graph). Events, cache
             lengths, each MLP call's capacity and dropped choices (some
             must drop) and tokens equal; logits within LOGIT_RTOL.
3c. cross_train — ``parallel/train.py``'s step on ``tiny_llm_config(num_layers
             =2)`` in fp32 (weights drawn with numpy, TF32 off): three AdamW
             steps (lr 1e-3) on the CPU and on the card from the same weights
             and ids; per-step losses within TRAIN_LOSS_RTOL, every final
             parameter within TRAIN_PARAM_TOL.
4. full    — random Qwen2-7B weights (bf16 on the card) and the 64-frame
             LLaVA-Video prompt: apply_framefusion + generate (fused; the
             decode is a CUDA graph of the step, captured in this run), the
             planned prefill + generate, the segmented prefill and the dense
             prefill, each timed. Kernel launch counts are read around the
             fused run: the wrappers count eager launches (the decode graph's
             warm-up step among them) and the calls recorded at its capture
             apart, and the graph counts its replays and what they launch.
4b. decode — the decode step with the ragged decode-attention kernel G on
             phase 4's int8 model and FrameFusion prefill: "ragged" against
             "flash" under teacher forcing (both fed the same token for 8
             steps; the logits agree within the stated bound; G's launches
             counted around the "ragged" steps, one per layer), then
             ``kernel_bench.bench_decodestep`` over 16 steps: ms/step of
             "einsum", "flash" and "ragged" on a uniform pool and on the prefill's own caches,
             with and without the tail split, eager and as a captured graph,
             the weight-stream floor and the launches per step.
4c. graph  — the engine's decode graph on phase 4's int8 model and
             FrameFusion prefill: its capture time and the launches it holds;
             teacher-forced replays against eager "ragged" steps (logits within
             the stated bound); generate_device / generate_stream(chunk=4)
             against generate; generate(8) wall time, the earlier eager decode
             against the graph; ms/step over 32 replays (two readings), the
             plain-attention graph once, the floor, the device idle share and
             the device time of C, D and G a step (torch.profiler); then kernel
             G with its length read from the device against its plain
             version: one captured launch per view the decode graphs launch
             it on (and the 11,776-row view), replayed at the live lengths
             the decodes reach and at the edges.
5. cross_vision — a tiny SigLIP tower (head dim 72) and projector with the
             tiny LLM of phase 3, weights drawn with numpy, through
             TextPipeline.ask on uint8 frames: plain versions on the CPU,
             kernels on the card. The frontend features agree within a
             stated bf16 bound; events, cache lengths and tokens are equal
             and the tokens vary.
5b. cross_qwen2vl — a tiny Qwen2-VL tower of head dim 80 (embed 160, 2
             heads, depth 2) and a 6-layer mRoPE LLM (``readout_params``),
             weights drawn with numpy, through TextPipeline.ask on uint8
             frames: plain versions on the CPU, kernels on the card. Tower
             features and prefill logits within the bf16 bounds; events,
             cache lengths, the decode base and tokens equal; the tokens
             vary; E and B launched on the card only.
5c. cross_internvl — a tiny InternViT of head dim 64 (hidden 128, 2 heads,
             depth 2; N 65, one past a key tile) and a 6-layer LLM with
             InternLM2's attention (no qkv bias, groups of 4: 8 / 2 heads;
             ``readout_params``), weights drawn with numpy, through
             TextPipeline.ask on uint8 frames (the interleaved ``FrameN:
             <image>`` prompt): plain versions on the CPU, kernels on the
             card. Features, prefill logits and layer 0's cached keys (the
             merge's keep set) within the bf16 bounds; events, cache lengths
             and tokens equal; the tokens vary; E and B launched on the card
             only.
5d. cross_families — a 6-layer Qwen2 LLM (``readout_params``, hidden
             512, 4 / 2 heads) and phase 5's SigLIP of head dim 72 (weights
             drawn with numpy) through NVILA's connector (TextPipeline.ask on uint8
             frames; and 8 block images as a multi-image prompt, patch_num
             1, through ``generate``), MiniCPM-V's resampler (TextPipeline.ask
             on frames that repeat or change whole; 8 + 2 separator rows a
             frame) and LLaVA-NeXT-Video's own adapter (2 x 2-pooled tower
             features, patch_num 16, through ``generate``): plain
             versions on the CPU, kernels on the card. Features, prefill
             logits and layer 0's cached keys within the bf16 bounds; events,
             cache lengths and tokens equal; E (and B where it prunes)
             launched on the card only.
5e. cross_qwen25vl — a tiny Qwen2.5-VL tower of head dim 80 (hidden 160,
             2 heads, depth 3, block 1 full attention, the published patch
             14 and window 112: on 12 frames of 112 x 140, grid (6, 8, 10),
             a full and a ragged window a frame) and phase 5b's 6-layer
             mRoPE LLM (``readout_params``), weights drawn with numpy,
             through TextPipeline.ask on uint8 frames: plain versions on the
             CPU, kernels on the card. Tower features, prefill logits and
             layer 0's cached keys within the bf16 bounds of 5b / 5c;
             events, cache lengths, the decode base and tokens equal; E
             (once a full-attention block an encode) and B launched on the
             card only.
6. pixels  — pixels to answer at full width: random SigLIP-so400m tower,
             projector and Qwen2-7B (bf16), 64 uint8 frames at 360x480
             through the native preprocessing, the tower (kernel E), the
             LLaVA frontend, the compressed prefill and 8 greedy tokens;
             FrameFusion and dense, encode and pixels-to-answer times, kernel
             launch counts read around the FrameFusion run, then the W8A8
             tower once.
6b. checkpoint — the checkpoint entry point at full size: phase 6's seeded
             model (drawn again on the card) written as a
             LLaVA-Video-7B-Qwen2 hub directory (``config.json`` with
             ``LlavaQwenForCausalLM`` and a SigLIP ``vision_config``, bf16
             shards of at most 5 GB, ``model.safetensors.index.json``; HF's
             names and layouts) into the temporary directory, then, in a
             process of its own, ``TextPipeline.from_checkpoint(dir,
             cost=0.3, quantize="int8")`` under ``runtime.profiling.trace``:
             the seconds of the loader's stages (its spans in the trace),
             of the copies to the card, the host's peak RSS (VmHWM) and the
             card's memory; every loaded leaf bit for bit against an
             in-memory twin of the same seeded tensors (the whole decoder
             quantized by ``quantize_params_int8``); ``ask`` on phase 6's frames
             through both: events, every layer's cache, the first-token
             logits and 8 tokens equal; launches counted around the loaded
             pipeline's ask; its pixels to answer timed. The directory is
             deleted at the end, whatever the checks found.
7. cross_baselines — the tiny model of phase 3 through every baseline
             method (FastV, StreamingLLM with kernel F, fixed-schedule merging,
             merge->FastV, FastV->merge, the sink-cache decode) via
             replace_forward + generate: plain versions on the CPU, kernels on
             the card. Events, cache lengths and tokens are equal; the
             prefill logits, and the sink-cache decode's last-step logits,
             agree within the bf16 bound. The weights give every token one
             clear successor, so the tokens hold by construction (they do not
             depend on the method either): the logits bounds are what can fail.
8. baselines — the paper's method comparison at full width: random Qwen2-7B
             weights (bf16) and the 64-frame prompt through dense,
             FrameFusion and the six baseline settings of
             scripts/example_baselines.py: prefill times, tokens kept, 8 greedy
             tokens each; kernel launch counts read around the whole
             comparison, kernel F's around each StreamingLLM prefill; then F
             against its plain version on that prefill's layer-0 q, k, v.
9. batch   — the batched main path at full width: random Qwen2-7B weights
             (bf16) and 8 distinct 64-frame prompts (seeds 0..7, coherence
             0.35 / 0.45 / 0.55). prefill_planned_batch at B = 1, 2, 4, 8
             against the solo prefill_planned at PlanHistory's buckets (events
             and lengths equal, logits within the bound), both timed; then
             generate_batch on the int8 model as one captured CUDA graph of
             decode_step_batch (kernels C and D at B rows) per B: its capture,
             the launches it holds and ran, 3 teacher-forced replays against
             each row's solo eager "ragged" steps (logits within the bound),
             greedy agreement with the solo decodes (reported), ms/step over 32
             replays (two readings), tokens/s, the plain attention's time of a
             step alone, and at B = 1 and 8 the profiler's idle share and device time
             by kernel. Launches of A and B are counted around the B = 8 batched
             prefill, of C and D around the B = 8 generate_batch (eager, captured,
             replayed: ``batch_launches``).
10. spec_serve — speculative decoding and the serving loop on phase 9's
             int8 model (phase 4's weights) and prompts: the device-form
             verify_step at K = 5 against 5 eager decode_step "flash" and
             "ragged" steps (teacher forced, LOGIT_RTOL) and the
             device-form verify_step_batch at B = 4 bitwise its host form;
             generate_spec(64, draft_len 4) on phase 9's first fused prefill
             against generate(64), generate_spec_batch at B = 4 against
             generate_batch (token agreement reported: bf16 ties); each
             captured macro step (solo, batched, the serving chunk) bitwise
             its eager body; ms a macro step; then ServingLoop over the 8
             prompts in a staggered order (4 slots, chunks of 8,
             max_new_cap 32, tail_pool (2, 3456)) at draft_len 0 and 4,
             every request ended, agreement with its solo generate_greedy
             reported, chunk and admission ms, captures, compactions,
             requests/s and tokens/s. C's and D's launches on these paths
             (eager, captured, replayed: ``spec_launches``).
10b. eval  — ``evaluation.run_offline_eval`` on a full-width Qwen2-7B built
             for the phase (bf16, random weights drawn on the card from seed
             0) over 3 main-path prompts (``build_video_prompt`` seeds 0-2,
             11,697 tokens), dense against FrameFusion at cost 0.3, S_th 0.6,
             r_min 0.1, 16 greedy tokens each: the report strict-parses
             (``allow_nan=False``), each prompt's final_tokens and reduction
             are its own fused prefill's, A, B, C, D and G launched; the wall
             time, each prompt's ``evaluate_pair`` ms and the first-token KL.
10c. scripts — each of ``framefusion_tpu_torch.scripts``' ``main(argv)`` in
             process on the card, its output contract checked (table columns,
             tokens kept, strict JSON, the demo's streams): at full width
             ``example_llava --full-size``, ``example_baselines --full``,
             ``example_longvideo`` (128 frames, int8: a 23,345-token dense
             prefill), ``example_batched --int8`` (B = 4, 16 frames) and
             ``example_serving --int8 --speculative`` (8 requests, 4 slots,
             16 frames); at their defaults the four family examples and
             ``demo_compare --selftest`` (two replicas streaming at once on
             two CUDA streams). Each script's table, wall time and launches;
             then kernel A at the long video's dense shape (S 23,345, 28 / 4
             heads, no mask) against its plain version, an A regime with
             ``"path": "scripts"`` and the launches of the script's run.
10d. train — the training step at Qwen2-7B's widths (hidden 3,584, 28 / 4
             heads of 128, intermediate 18,944, vocab 152,064, untied head,
             bf16), its depth cut from 28 to 4 layers (28 take 61 GB of
             params, gradients and AdamW state before activations): five
             AdamW steps (lr 1e-4) on one seeded batch of B = 2, T = 2,048.
             Every loss and gradient norm finite, the first loss within
             TRAIN_FIRST_LOSS_TOL of ln 152,064, the loss falling, the first
             step's bf16 loss within TRAIN_BF16_LOSS_TOL of an fp32 forward
             of the same weights on the card; ms a step (CUDA events, the
             median of steps 2-5), tokens/s, the peak memory, the GEMMs'
             share of the bf16 peak, and one more step under torch.profiler
             (its device time by kind: bf16 and fp32 GEMMs, AdamW, softmax).
10e. probes — ``scripts.accuracy_probe.main`` and ``scripts.spec_probe.main``
             on the card at 300 training steps (eval 16 / 8): the training
             loss falls, every speculative row keeps greedy_match, every
             serving row's agreement is n/n, both records strict-parse.
10f. bench_modes — ``kernel_bench``'s modes attn, quant, decode, engine and
             ledger once each at few repetitions (engine and ledger on one
             random Qwen2-7B at vocabulary 8,192, built here: phase 4's model
             is int8 by then): each row's time finite beside its bound;
             every row that launches a kernel held against its reference
             first (A against SDPA's output, C and D against their plain
             versions on the same stacks, each compressed prefill against
             the fused one's events and logits); each mode's kernels
             launched in its own run.
11. qwen2vl — the Qwen2-VL family at full width: a random Qwen2-VL tower of
             the published geometry (depth 32, embed 1280, 16 heads of 80,
             patch 14, temporal patch 2, merge 2, MLP ratio 4, out 3584) and
             phase 4's Qwen2-7B weights with mRoPE (16, 24, 24); 64 uint8
             frames at 360x480 (smart_resize 364x476, grid (32, 26, 34),
             7,072 video tokens) through TextPipeline.ask at cost 0.3, S_th
             0.5, r_min 0.1: launches of A-G around it (E once a tower
             layer), the decode base max(positions) + 1; encode, fused /
             planned / dense prefill and pixels-to-answer ms. Then the LLM
             alone on a coherent synthetic video of the same 32 x 221 layout
             (spliced by the Qwen2-VL adapter), which must prune with kernel
             B at 4 capture rows at phase 2's length, and 8 tokens through
             the int8 decode graph from its mRoPE base.
12. internvl — the InternVL2.5-8B family at full width: random
             InternLM2.5-7B weights (32 layers, hidden 4096, 32 / 8 heads,
             intermediate 14336, vocab 92553, no qkv bias) made on the card,
             an InternViT-300M tower of the published geometry (image 448,
             patch 14, 24 layers, 16 heads of 64, qkv bias) and the
             4096 -> 4096 -> 4096 mlp1 projector; 64 uint8 frames at 360x480
             through TextPipeline.ask (448 x 448, InternViT, pixel shuffle,
             mlp1, one ``FrameN: <image>`` line a frame: 16,384 image tokens
             in a span that holds the labels) at cost 0.3, S_th 0.5, r_min
             0.1 and 8 greedy tokens: launches of A-G around it (E once a
             tower layer), encode, fused / planned / dense prefill and
             pixels-to-answer ms, the device idle share. Then the LLM on a
             coherent synthetic video spliced into the same prompt, which must
             prune (B at one capture row, 32 / 8 heads), its events equal
             through the planned and segmented executors: tokens after the
             layer -1 merge and after the prune; the int8 decode graph's
             ms/step over 32 replays beside its weight-stream floor. Last,
             each kernel against its plain version at the shapes these runs
             gave it (A at every (S, mask) its prefills launched, B at the
             phase length, E at (64, 1025, 16, 64) with its last row and
             column held on their own, C and D bf16 and int8 at InternLM2's
             decode widths, G at 8 KV heads over the decode's first length),
             each timed beside its bound, plain and library ms, with the
             launches phase 12 counted. The pixels-to-answer prefill's events
             must equal a direct fused prefill's on the same inputs.
13. nvila  — NVILA-8B at full width, as phase 12 runs its family: phase 4's
             Qwen2-7B weights, SigLIP-so400m at 448 px (32 x 32 patches, run
             to layer -2: E at (16, 1024, 16, 72), 26 x 4 launches) and the
             mlp_downsample connector (2 x 2 space-to-channel, 4608 -> 3584
             -> 3584, fp32); 64 uint8 frames at 360x480 -> 16,384 video
             tokens, a 16,464-token prompt (A's blocked regime dense) at cost
             0.3, S_th 0.7, r_min 0.1; then the coherent prompt (B at 28 / 4),
             the int8 decode graph and the kernel rows (``"path": "nvila"``).
14. minicpmv — MiniCPM-V 2.6 at full width, likewise: SigLIP at its
             checkpoint's 980 px (70 x 70 patches, all 27 layers: E at (16,
             4900, 16, 72), 27 x 4 launches) and the resampler (64 queries,
             28 heads of 128, fp32); 64 frames -> a 4,224-row span (64
             resampled + 2 separator rows a frame, patch_num 66, the
             separators' ids 64 and 65); the rows ``"path": "minicpmv"``.
15. qwen25vl — Qwen2.5-VL-7B at full size, as phases 12-14 run their
             families: the published tower (depth 32, hidden 1280, 16 heads
             of 80, intermediate 3420, patch 14, temporal patch 2, merge 2,
             window 112, full attention at 7 / 15 / 23 / 31, out 3584) and
             phase 4's Qwen2-7B weights with mRoPE (16, 24, 24); 64 uint8
             frames at 360x480 (grid (32, 26, 34), 7,072 video tokens, the
             temporal stream at 4 a frame) through TextPipeline.ask at cost
             0.3, S_th 0.5, r_min 0.1 (E at (32, 884, 16, 80), 4 launches);
             the coherent prompt (B at 4 capture rows, 28 / 4), the int8
             decode graph, the kernel rows (``"path": "qwen25vl"``), then
             the encode split into E's launches, the 28 window blocks'
             attention (timed alone on the tower's window layout) and the
             rest.
16. qwen25vl_72b — Qwen2.5-VL-72B's widths on 256 frames, likewise: the LLM
             at ``qwen25_vl_72b_config(num_layers=16)`` (hidden 8192, 64 / 8
             heads of 128, intermediate 29,568, vocab 152,064; the depth
             cut from 80 to fit one card: 16 layers take 28.1 GB in bf16,
             the embedding and head 5.0 GB), the same tower with out 8192;
             256 frames (grid (128, 26, 34): 113,152 tower tokens, 28,288
             video tokens; E at (128, 884, 16, 80)); the dense prefill in
             A's blocked regime at the longest prompt of the run, B at 64 /
             8 heads (groups of 8), C and D at K 8192 and 29,568, G at
             groups of 8; the rows ``"path": "qwen25vl_72b"``.

17. moe_57b — Qwen2-57B-A14B at full size (all 28 layers, hidden 3,584, 28 /
             4 heads, 64 experts top-8 of width 2,560, a shared expert of
             20,480, vocab 151,936) on one card, weight-only int8 with the
             int8 LM head, built on the card a layer at a time from a seeded
             generator (``moe_57b_params``), through FrameFusionModel +
             apply_framefusion on the main path's 64-frame prompt (11,697
             tokens; cost 0.3, S_th 0.6, r_min 0.1): generate(8) (the fused
             prefill, the int8 decode graph) with the launches of A-D and G
             and of the routed calls counted around it and every MLP call's
             capacity drops; the planned and dense prefills; fused / planned
             / dense ms, the fused prefill's device idle share; the decode
             graph's ms/step beside its bytes floor; generate_batch at B = 1,
             4, 8 (ms/step, tokens/s); a K = 5 speculative macro step; a
             2-slot ServingLoop over 2 requests; peak memory. Last, the rows
             ``"path": "moe_57b"``: D and C over routed rows (8 and 64, the
             indices of random top-8 routings at layers 27, 24, ..., 6 of
             the model's whole 28-layer stacks) against their plain
             versions beside their bound over the distinct experts read and
             ``torch.bmm`` on the routed matrices gathered beforehand; C as
             the 151,936-wide int8 head beside ``torch.matmul`` on the head
             cast beforehand; D and C at the shared expert's widths (3,584
             -> 2 x 20,480 and 20,480 -> 3,584, int8, one row).
18. cross_parallel — serving across ranks (``parallel/launch.spawn``: 4
             processes, one spawn a device) on tiny bf16 models, the ranks on
             the CPU over gloo (the kernels' plain versions) and on the card
             over gloo (every rank on cuda:0, the kernels at the sharded
             shapes, the collectives staged through the host): tensor
             parallel at 2 and 4 ranks (6 layers, hidden 512, 8 / 4 heads of
             128; ``readout_params``), the sequence-sharded prefill at 2
             ranks (gather and ring) and expert parallelism at 2 ranks
             (phase 3b's MoE model, 8 experts). Each held against the one-
             process run on its own device: events equal on every rank,
             first-token logits within LOGIT_RTOL, greedy tokens equal.
19. parallel — the same at full width on the card. (a) Qwen2-7B, 8 of
             its 28 layers (PAR_LAYERS: the run's time limit), bf16 random weights drawn a (leaf, layer) at a time
             from a seed (``sharding.init_sharded_params``), the main-path
             prompt (11,697 tokens): the fused prefill at TP = 4 and TP = 2
             (gloo ranks on the one card) against the one-process run:
             events equal, this rank's KV heads of layer 0's and the prune
             layer's cached keys (the merges' keep set) within LOGIT_RTOL,
             first-token logits within LOGIT_RTOL; then the int8 decode of
             16 tokens (the ranks decode eagerly: gloo's reduces cannot be
             captured); prefill ms and decode ms / step per rank, with the
             share in collectives (host-staged gloo: not a multi-card
             speed), the kernel calls per rank by shape. (b) The sequence-
             sharded prefill at 2 ranks, gather and ring, against the one-
             process segmented executor: events equal, logits within
             LOGIT_RTOL. (c) Qwen2-57B-A14B's widths at 14 of 28 layers,
             int8, experts over 2 ranks (32 each; attention and the shared
             expert whole on both): the fused prefill and a 16-token int8
             decode against the one-process run at that depth. (d) NCCL as
             a world of one: the decode graph captures the all-reduce; its
             tokens and logits are bitwise the engine's without a mesh.
             NCCL across ranks runs only with two cards or more. Last, the
             kernel rows ``"path": "tp2"``, ``"tp4"`` and ``"ep2"`` at the
             shapes the ranks launched, timed here, with the ranks'
             launches.
20. cross_train_ranks — training across ranks on tiny fp32 stacks, three
             ways from the same weights and batches: the one-process step on
             the CPU, 4 gloo ranks on the CPU and 4 gloo ranks on cuda:0:
             ``make_train_step(mesh=)`` at TP 2 x DP 2 and TP 4 (2 layers,
             8 / 4 heads), the GPipe step at 2 stages x 2 data ranks and 2
             microbatches (4 layers) and the tiny Qwen2-MoE stack at TP 2 x
             DP 2. Losses of 3 AdamW steps within TRAIN_LOSS_RTOL, every
             rank's parameters within TRAIN_PARAM_TOL of its shard of the
             one-process step's, the replicated leaves bitwise equal on
             every rank. Then a world of one over NCCL: the step with a mesh
             bitwise the step without. NCCL across ranks runs only with two
             cards or more.
21. train_ranks — training across ranks at full width on the card, one
             spawn for (a)-(c) and one for (d) (gloo ranks sharing cuda:0, the collectives staged through
             the host: not a multi-card speed), each run's ms / step (median
             of steps 2+), tokens/s, peak GB a rank and collective calls,
             host seconds and share; the depths of (a)-(c) are cut for the
             run's time limit: (a) Qwen2-7B, 8 of its 28 layers, TP 4, B 1
             x T 2,048, 3 AdamW steps (AdamW fused on the card: no
             whole-list temporaries):
             the first loss within TRAIN_BF16_LOSS_TOL of a one-process
             no-grad forward of the same weights, the loss falls; (b) 2
             layers, TP 2 x DP 2, B 2 x T 2,048: the replicated leaves
             bitwise equal on the four ranks; (c) the pipeline, 4 layers, 4
             stages, 4 microbatches, B 4 x T 1,024: the first loss against
             the one-process ``lm_loss``, the bubble share (the stages' time
             in receives) beside GPipe's (S - 1) / (M + S - 1), the
             embedding, final norm and head bitwise equal on every stage;
             (d) Qwen2-57B-A14B's widths at 2 of 28 layers, bf16, one
             process then TP 2 (the experts in the tensor slot), B 1 x T
             1,024: each layer's ``load_balancing_loss`` and capacity
             drops, the first losses within TRAIN_BF16_LOSS_TOL, the loss
             falls over the 3 steps on both.

The line before the last is a JSON object with one entry per kernel, built
from ``framefusion_tpu_torch.ops.kernels`` (the TPU functions each stands
for, its source): error, kernel / plain / library ms, bound_ms and what sets
it, and the launches that ran on its path (phase 4 for A-D and G, 6 for
E, 8 for F). For C, D and G, which the decode graph holds, ``launches`` is
``eager_launches`` (the wrapper's count: the graph's warm-up step) plus
``graph_launches`` (the replays' count times the launches the graph holds,
both counted in this run), and ``captured_calls`` are the wrapper calls
recorded at the capture, which ran only at the replays; G's
``device_length_ms`` is its time with the length read from the device.
A-D also carry ``batch_launches`` from phase 9 (A and B around the B = 8
batched prefill, C and D around the B = 8 batched decode: eager, captured,
replayed), and C's and D's ``shapes`` their rows at B = 2, 4, 8 (the
int8 ones with phase 9's launches at that B; phase 9 decodes int8) and at
the verify's 5 and 20 rows (the int8 ones with phase 10's launches); C
and D also carry ``spec_launches`` from phase 10. E's and B's ``shapes``
hold the Qwen2-VL regimes with phase 11's launches (E around its pixels to
answer, B around its coherent prompt's prefill). Entries with ``"path":
"internvl"`` (A's regimes, B's, C's, D's, E's and G's shapes) are phase
12's rows, with its launches: A's from its prefills by (S, mask), C's and
D's bf16 from the pixels-to-answer decode and int8 from the int8 decode
graph; ``"path": "nvila"``, ``"minicpmv"``, ``"qwen25vl"`` and
``"qwen25vl_72b"`` are phases 13's to 16's, alike; A's regime with
``"path": "scripts"`` is phase 10c's long video; ``"path": "moe_57b"``
(C's and D's routed rows and C's head row) are phase 17's, with the
launches of its decode graph (8 routed rows, the head) and of its B = 8
generate_batch (64 routed rows). The last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. The script never runs on the CPU: without a CUDA device
it exits at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, with their reasons:
# * Kernel A writes bf16 outputs and feeds bf16-rounded probabilities to the
#   P.V product (the plain version keeps fp32 throughout): a bf16 ulp is
#   2^-8 to 2^-7 relative, so each (row, head) output agrees to ATTN_ROW_RTOL
#   (a few ulps) relative to that row's own largest output. The bound is per
#   row because late rows average thousands of keys and are 100x smaller
#   than the first rows: a bound on the whole tensor would let a P.V error in
#   the late tiles pass. The fp32 row statistics, untouched by bf16
#   rounding, agree to STAT_RTOL.
ATTN_ROW_RTOL = 2e-2
STAT_RTOL = 1e-3
# * Kernel B sums the same fp32 terms as its plain version in another order:
#   fp32 rounding only, relative to the largest importance.
IMP_RTOL = 1e-4
# * Kernels C/D accumulate bf16 x bf16/int8 products in fp32 in another order
#   than cuBLAS: fp32 rounding over K <= 29568 terms (Qwen2.5-VL-72B's MLP;
#   20480 at Qwen2-57B-A14B's shared expert), relative to the output's
#   largest magnitude.
GEMV_RTOL = 1e-4
# * Kernel E (bidirectional attention) rounds its probabilities and outputs
#   to bf16 like kernel A, and is held per (row, head) to ATTN_ROW_RTOL too;
#   so is kernel F (StreamingLLM sink + window attention), which computes
#   like A over fewer keys.
# * The cross-device vision run: the tiny tower's bf16 frontend features
#   differ from its fp32 run by 6.7e-3 of the largest feature on the CPU
#   (same numpy weights and frames); the card's bf16 run rounds elsewhere
#   (kernel E's bf16 probabilities, other summation orders), so it may
#   differ from the CPU's by up to about twice that.
FEATURE_RTOL = 1.5e-2
# * The cross-device run: the tiny model's bf16 prefill logits differ from
#   its fp32 run by 2.85e-2 of the largest logit on the CPU (same numpy
#   weights and prompt); two bf16 runs with other roundings (kernel A's bf16
#   probabilities, other summation orders) may differ by up to about twice
#   that.
LOGIT_RTOL = 6e-2
# * Phase 10 holds the K = 5 verify program against 5 decode steps ("flash"
#   and "ragged") at full width to LOGIT_RTOL too: kernels C and D at 5 rows
#   split their sums otherwise than at 1 row, and over 28 int8 layers two
#   such roundings of one model spread 3-4.5e-2 (the batched step against
#   the solo one in phase 9); kernel_bench's 3e-2 verify bound is a 2-layer
#   bound.
# * Phase 4b holds "ragged" decode against "flash" at full width: the two
#   differ only in where the attention rounds (kernel G's fp32 split-K sums
#   against the plain fp32 einsum, both rounded to bf16), two bf16 runs as
#   above, so LOGIT_RTOL holds them too. Phase 4c holds the captured graph
#   against eager "ragged" steps to it as well: they differ in kernel G's
#   split plan (planned for the view's rows, not the length), so in the
#   order of its fp32 sums.


# Kernel A's regimes on the main path (phase 4, which counts their
# launches): the lengths it is launched at, and whether a key_valid mask
# comes with them. The phase layers pass one; the fused prefill's tail
# (qwen2.run_layers, its bucket of 3,328) and the dense prefill (the whole
# 11,697-token prompt) do not.
REGIMES_A = {6528: "phase layers: S 6,528, key_valid with 45% dead keys",
             3328: "fused prefill's tail: S 3,328, no mask",
             11697: "dense prefill: S 11,697, no mask"}
# Kernel C's shapes on the decode path: (K, the stacks' widths) -> name.
SHAPES_C = {(3584, (3584, 512, 512)): "qkv", (3584, (3584,)): "wo", (18944, (3584,)): "w_down"}
# The batched decode's rows beside the solo decode's one (kernels C and D, phases 2 and 9).
BATCH_ROWS = (2, 4, 8)
# The batch sizes of phase 9.
BATCH_SIZES = (1,) + BATCH_ROWS
# The speculative verify's rows (kernels C and D, phases 2 and 10): K = 5
# (draft_len 4) solo, B * K = 20 at B = 4.
SPEC_DRAFT, SPEC_B = 4, 4
VERIFY_ROWS = (SPEC_DRAFT + 1, SPEC_B * (SPEC_DRAFT + 1))
# Kernels C and D's times before the rows shared each weight tile (ms, one
# H100 80GB HBM3 at 700 W; PERF.md section 6's kernel table, rows 8-10,
# 8b-10e, 8s and 10j), printed beside this run's as "was": (name, weights,
# rows) -> ms; routed rows as ("routed down" / "routed gateup", "int8",
# rows).
WAS_MS = {
    **{(n, "bf16", 1): t for n, t in zip(("qkv", "wo", "w_down", "gateup"), (0.0160, 0.0138, 0.0485, 0.0984))},
    **{(n, "int8", 1): t for n, t in zip(("qkv", "wo", "w_down", "gateup"), (0.0123, 0.0115, 0.0291, 0.0570))},
    **{(n, "bf16", b): t for n, ts in (("qkv", (0.0217, 0.0435, 0.0843, 0.0646, 0.1860)),
                                       ("wo", (0.0178, 0.0338, 0.0632, 0.0445, 0.1562)),
                                       ("w_down", (0.0917, 0.1427, 0.2831, 0.1878, 0.8546)),
                                       ("gateup", (0.1932, 0.3549, 0.6932, 0.4625, 1.7668)))
       for b, t in zip((2, 4, 8, 5, 20), ts)},
    **{(n, "int8", b): t for n, ts in (("qkv", (0.0169, 0.0272, 0.0557, 0.0361, 0.1232)),
                                       ("wo", (0.0147, 0.0227, 0.0429, 0.0274, 0.1086)),
                                       ("w_down", (0.0510, 0.0973, 0.1830, 0.1178, 0.4491)),
                                       ("gateup", (0.1090, 0.1941, 0.3650, 0.2385, 0.9049)))
       for b, t in zip((2, 4, 8, 5, 20), ts)},
    ("routed down", "int8", 8): 0.0330, ("routed down", "int8", 64): 0.2139,
    ("routed gateup", "int8", 8): 0.0586, ("routed gateup", "int8", 64): 0.3969,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` eager calls, by CUDA events."""
    from framefusion_tpu_torch.kernel_bench import events_time_ms

    return events_time_ms(fn, iters, warmup)


class Checks:
    def __init__(self):
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)


def phase_device(chk: Checks) -> None:
    from framefusion_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    lib_path, seconds = _build.build()
    log(f"kernel build: {seconds:.1f} s -> {lib_path.name}")
    build_log = lib_path.with_suffix(".log").read_text()
    for name, usage in ptxas_usage(build_log):
        log(f"  ptxas: {name}: {usage}")
        if name.startswith(("attn_importance_rows_kernel", "bidir_attn_kernel", "decode_attn_kernel",
                            "flash_attn_fwd_kernel", "gemv_kernel", "rows_kernel", "sink_attn_fwd_kernel")):
            # the kernels redesigned for Hopper
            chk.expect("0 bytes spill stores, 0 bytes spill loads" in usage, f"{name}: no register spills")
    # ptxas's advisories that a kernel's wgmma instructions run one after
    # another (a branch or a register copy inside a wgmma pipeline stage):
    # kernels A and F (one pipeline, csrc/flash_fwd.cuh) must have none; any
    # other kernel's are reported.
    serialised = sorted({_kernel_name(m.group(1)) for m in
                         re.finditer(r"wgmma\.mma_async instructions are serialized.*?function '(\w+)'", build_log)})
    log(f"  ptxas: wgmma serialised in: {serialised or 'no kernel'}")
    for kernel in ("flash_attn_fwd_kernel", "sink_attn_fwd_kernel"):
        chk.expect(not any(n.startswith(kernel) for n in serialised), f"{kernel}: no serialised wgmma")
    _build.load_library()


def _kernel_name(mangled: str) -> str:
    """Short name of a mangled ``namespace::kernel<args>``: the last name of
    the nested-name, with its template arguments (ints, or the uint16_t /
    int8_t element type of the bf16 / int8 instantiations)."""
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I((?:Li\d+E|[ta])+)E", mangled[i:])
    if args is None:
        return name
    parts = re.findall(r"Li(\d+)E|([ta])", args.group(1))
    return f"{name}<{', '.join(d or {'t': 'bf16', 'a': 'int8'}[c] for d, c in parts)}>"


def ptxas_usage(log_text: str) -> list:
    """(kernel, "registers, shared memory, spills") per kernel of nvcc's
    ``-Xptxas -v`` output."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name is not None:
            usage = line.split(":", 1)[1].strip() if ":" in line else line.strip()
            out.append((name, f"{usage}; {spills}"))
            name = None
    return out


def _max_err(entry: dict, err: float) -> None:
    entry["max_abs_err"] = err if entry["max_abs_err"] is None else max(entry["max_abs_err"], err)


def _bound(entry: dict, nbytes: float, ops: float) -> float:
    """Set ``entry``'s bound_ms and bound_by (``kernel_bench.bound_ms``: the
    bytes to move over the memory rate or the operations over the bf16 rate,
    whichever is larger) and return bound_ms."""
    from framefusion_tpu_torch.kernel_bench import bound_ms

    entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, ops)
    return entry["bound_ms"]


def _rand(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def _row_rel(out, ref):
    """(max abs error, max of each (row, head)'s error over that row's
    largest plain output) of an attention output against its plain version;
    rows whose every key is masked (0 / 0) give 0."""
    err = (out.float() - ref.float()).abs().amax(-1)
    return err.max().item(), (err / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()


def _a_regime(chk, kernels, gen, s: int, hq: int, hk: int, dead: float, label: str):
    """Kernel A at S keys, Hq / Hk heads of 128 against its plain version
    (with ``dead`` > 0: a key_valid mask with that share of dead keys, rows
    0..15 seeing none), timed beside its bound and SDPA. Appends the regime
    (``label``) to A's entry; returns it and (q, k, kv, m, l) for kernel B."""
    from framefusion_tpu_torch.kernel_bench import sdpa
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp

    d = 128
    q, k, v = _rand(gen, (s, hq, d)), _rand(gen, (s, hk, d)), _rand(gen, (s, hk, d))
    kv = None
    if dead:
        kv = torch.rand((s,), generator=gen, device="cuda") >= dead
        kv[:16] = False  # rows 0..15 see no valid key at all
        kv[-1] = True
    out, m, l = fp.flash_attn_fwd(q, k, v, kv)
    out_p, m_p, l_p = fp.flash_attn_fwd_plain(q, k, v, kv)
    torch.cuda.synchronize()
    err, rel = _row_rel(out, out_p)
    _, rel_late = _row_rel(out[1024:], out_p[1024:])
    fin = torch.isfinite(m_p)
    m_err = (m - m_p)[fin].abs().max().item()
    l_rel = ((l - l_p).abs() / l_p.clamp(min=1e-30))[fin].max().item()
    tag = f"A S={s} Hq={hq} Hk={hk} dead={dead:.2f}"
    chk.expect(rel <= ATTN_ROW_RTOL, f"{tag}: max_abs_err {err:.3e}; per (row, head) error / its largest output: "
                                     f"max {rel:.3e}, rows >= 1024 {rel_late:.3e}; <= {ATTN_ROW_RTOL}")
    chk.expect(m_err <= STAT_RTOL and l_rel <= STAT_RTOL,
               f"{tag}: row max err {m_err:.3e}, row sum rel err {l_rel:.3e} <= {STAT_RTOL}")
    if dead:
        chk.expect(bool((out[:16] == 0).all()) and bool((l[:, :16] == 0).all()),
                   f"{tag}: rows with every key masked give 0")
    del out_p, m_p, l_p
    t_k = cuda_time_ms(lambda: fp.flash_attn_fwd(q, k, v, kv), iters=10)
    t_p = cuda_time_ms(lambda: fp.flash_attn_fwd_plain(q, k, v, kv), iters=2, warmup=1)
    _max_err(kernels["flash_attn_fwd"], err)
    # The data decides the work: the (row, key) pairs at or below the
    # diagonal whose key is live.
    pairs = float(torch.cumsum(kv.to(torch.int64), 0).sum()) if dead else s * (s + 1) / 2
    regime = {"regime": label, "launches": None}
    t_b = _bound(regime, (2 * s * hq * d + 2 * s * hk * d) * 2 + (s if dead else 0) + 2 * hq * s * 4,
                 4 * hq * d * pairs)
    if dead:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device="cuda")) & kv[None, :]
        t_l = cuda_time_ms(lambda: sdpa(q, k, v, mask), iters=2, warmup=1)
        del mask
    else:
        t_l = cuda_time_ms(lambda: sdpa(q, k, v, is_causal=True), iters=10)
    log(f"  {tag}: kernel {t_k:.4f} ms ({4 * hq * d * pairs / (t_k * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{t_b / t_k:.3f} of the bound {t_b:.4f} ms, {regime['bound_by']}), plain {t_p:.3f} ms, "
        f"scaled_dot_product_attention ({'GQA, bool mask' if dead else 'GQA, causal'}) {t_l:.4f} ms, "
        f"kernel / library {t_k / t_l:.3f}")
    regime.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
    kernels["flash_attn_fwd"]["regimes"].append(regime)
    return regime, (q, k, kv, m, l)


def _b_row(chk, kernels, gen, s: int, n_live: int, num: int, hq: int, hk: int, trailing: int, path: str) -> dict:
    """Kernel B at ``num`` capture rows over S keys, the first ``n_live``
    of them the live prefix (20% of it dead, its last ``trailing`` text rows
    live), on kernel A's statistics, against its plain version, timed from
    graph replays beside its bound: an entry of B's ``shapes`` for
    ``path``."""
    from framefusion_tpu_torch.kernel_bench import graph_time_ms
    from framefusion_tpu_torch.ops.attention import capture_rows
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp

    d = 128
    q, k = _rand(gen, (s, hq, d)), _rand(gen, (s, hk, d))
    kv = (torch.arange(s, device="cuda") < n_live) & (torch.rand((s,), generator=gen, device="cuda") >= 0.2)
    kv[n_live - trailing:n_live] = True
    _, m, l = fp.flash_attn_fwd(q, k, k, kv)
    rows = capture_rows(s, num, None, kv)
    imp = fp.attn_importance_rows(q, k, rows, m, l, kv)
    imp_p = fp.attn_importance_rows_plain(q, k, rows, m, l, kv)
    torch.cuda.synchronize()
    err = (imp - imp_p).abs().max().item()
    entry = {"path": path, "shape": f"num={num} S={s} Hq={hq} Hk={hk}", "S": s, "launches": None, "max_abs_err": err,
             "library_ms": None}
    chk.expect(err <= IMP_RTOL * imp_p.abs().max().item(),
               f"B {entry['shape']} ({path}): max_abs_err {err:.3e} (rel {err / imp_p.abs().max().item():.3e}) "
               f"<= {IMP_RTOL}")
    _max_err(kernels["attn_importance_rows"], err)
    t_k = graph_time_ms(lambda: fp.attn_importance_rows(q, k, rows, m, l, kv), iters=20)
    t_p = graph_time_ms(lambda: fp.attn_importance_rows_plain(q, k, rows, m, l, kv), iters=5)
    seen = float(torch.cumsum(kv.to(torch.int64), 0)[rows].sum())  # live keys at or before each row
    t_b = _bound(entry, num * hq * d * 2 + s * hk * d * 2 + s + num * 8 + 2 * num * hq * 4 + s * 4,
                 2 * hq * d * seen)
    entry.update(ms=t_k, plain_ms=t_p)
    kernels["attn_importance_rows"]["shapes"].append(entry)
    log(f"  B {entry['shape']}: kernel {t_k * 1e3:.2f} us ({t_b / t_k:.3f} of the bound {t_b * 1e3:.2f} us, "
        f"{entry['bound_by']}), plain {t_p:.3f} ms; no single PyTorch call computes it")
    return entry


def _e_row(chk, kernels, gen, shape: tuple, path: str) -> dict:
    """Kernel E at (B, N, H, hd) against its plain version, per (row, head),
    then its last query row and, with V one-hot on the last key (the output
    is then that key's probability), its last key's column on their own;
    timed beside its bound and non-causal SDPA: an entry of E's ``shapes``."""
    from framefusion_tpu_torch.kernel_bench import sdpa
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba

    b, n, h, hd = shape
    q, k, v = (_rand(gen, (b, n, h, hd)) for _ in range(3))
    out = ba.flash_bidir_attention(q, k, v)
    ref = ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5)
    v_last = torch.zeros_like(v)
    v_last[:, -1] = 1
    p_last = ba.flash_bidir_attention(q, k, v_last)[..., 0].float()
    p_ref = ba.bidir_attn_fwd_plain(q, k, v_last, hd ** -0.5)[..., 0].float()
    torch.cuda.synchronize()
    err, rel = _row_rel(out, ref)
    _, rel_last = _row_rel(out[:, -1], ref[:, -1])
    rel_col = ((p_last - p_ref).abs().max() / p_ref.abs().max()).item()
    entry = {"path": path, "shape": f"({b}, {n}, {h}, {hd})", "launches": None, "max_abs_err": err}
    chk.expect(rel <= ATTN_ROW_RTOL and rel_last <= ATTN_ROW_RTOL and rel_col <= ATTN_ROW_RTOL,
               f"E {entry['shape']} ({path}): max_abs_err {err:.3e}; per (row, head) error / its largest output: max "
               f"{rel:.3e}, last row {rel_last:.3e}; last key's probability {rel_col:.3e} of its largest; "
               f"<= {ATTN_ROW_RTOL}")
    _max_err(kernels["bidir_attn_fwd"], err)
    del out, ref, v_last, p_last, p_ref
    t_k = cuda_time_ms(lambda: ba.flash_bidir_attention(q, k, v), iters=20)
    t_p = cuda_time_ms(lambda: ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5), iters=3, warmup=1)
    t_l = cuda_time_ms(lambda: sdpa(q, k, v), iters=20)
    t_b = _bound(entry, 4 * b * n * h * hd * 2, 4 * b * h * n * n * hd)
    entry.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
    kernels["bidir_attn_fwd"]["shapes"].append(entry)
    log(f"  E {entry['shape']}: kernel {t_k:.4f} ms ({t_b / t_k:.3f} of the bound {t_b:.4f} ms, "
        f"{entry['bound_by']}), plain {t_p:.4f} ms, scaled_dot_product_attention (non-causal) {t_l:.4f} ms, "
        f"kernel / library {t_k / t_l:.3f}")
    return entry


def _cd_rows(chk, kernels, gen, name: str, wdtype: str, kdim: int, ns: list, rows_list, path=None) -> list:
    """Kernel C (``name`` qkv / wo / w_down: one to three stacks of widths
    ``ns``) or D (``gateup``) at K = ``kdim``, bf16 or int8 weights, at each
    count of activation rows in ``rows_list``, against its plain version;
    timed from graph replays over layer stacks cycled past the 50 MB L2
    (as a decode step finds each layer cold), beside its bound and, for
    bf16 C, one ``torch.matmul`` against the stacks side by side, and the
    time before this design (``WAS_MS``) where Qwen2-7B's widths have one.
    Returns one entry a row count (shape ``"{name} {wdtype}[ B=rows]"``;
    with ``path``, that key and the K and N too)."""
    from framefusion_tpu_torch.kernel_bench import graph_time_ms
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_weight

    key = "gemv_gateup" if name == "gateup" else "gemv_stacked"
    per_layer = kdim * sum(ns) * (1 if wdtype == "int8" else 2)
    n_layers = max(2, math.ceil(150e6 / per_layer))
    stacks, scales = [], []
    for n in ns:
        w = _rand(gen, (n_layers, kdim, n), scale=0.02)
        if wdtype == "int8":
            wq = quantize_weight(w)
            stacks.append(wq["q8"])
            scales.append(wq["scale"])
        else:
            stacks.append(w)
            scales.append(None)
        del w
    w_cat = None
    if wdtype == "bf16" and name != "gateup":  # the yardstick's operand: gate-up and int8 have no single call
        w_cat = torch.cat(stacks, dim=2) if len(stacks) > 1 else stacks[0]
    layer = [0]

    def next_layer():
        layer[0] = (layer[0] + 1) % n_layers
        return layer[0]

    n_out = sum(ns) // (2 if name == "gateup" else 1)
    entries = []
    for rows in rows_list:
        x = _rand(gen, (rows, kdim))
        if name == "gateup":
            outs = [mv.gemv_gateup(x, stacks[0], stacks[1], scales[0], scales[1], 1)]
            refs = [mv.gemv_gateup_plain(x, stacks[0], stacks[1], scales[0], scales[1], 1)]
            run_k = lambda: mv.gemv_gateup(x, stacks[0], stacks[1], scales[0], scales[1], next_layer())
            run_p = lambda: mv.gemv_gateup_plain(x, stacks[0], stacks[1], scales[0], scales[1], next_layer())
        else:
            outs, refs = mv.gemv_stacked(x, stacks, 1), mv.gemv_stacked_plain(x, stacks, 1)
            run_k = lambda: mv.gemv_stacked(x, stacks, next_layer())
            run_p = lambda: mv.gemv_stacked_plain(x, stacks, next_layer())
        torch.cuda.synchronize()
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        rel = err / max(r.abs().max().item() for r in refs)
        shape = f"{name} {wdtype}" + (f" B={rows}" if rows > 1 else "")
        tag = f"{key} {shape} K={kdim} N={ns}"
        chk.expect(rel <= GEMV_RTOL, f"{tag}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {GEMV_RTOL}")
        _max_err(kernels[key], err)
        t_k = graph_time_ms(run_k, iters=20)
        t_p = graph_time_ms(run_p, iters=10)
        entry = {"shape": shape, "launches": None}
        if path:
            entry.update(path=path, shape=f"{shape} K={kdim} N={'+'.join(map(str, ns))}")
        t_b = _bound(entry, per_layer + sum(ns) * 4 * (wdtype == "int8" and name == "gateup")
                     + rows * (kdim * 2 + n_out * 4), 2 * rows * kdim * sum(ns))
        t_l = None if w_cat is None else graph_time_ms(lambda: torch.matmul(x, w_cat[next_layer()]), iters=20)
        entry.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
        entries.append(entry)
        vs_one = f", {t_k / entries[0]['ms']:.2f}x its 1-row time" if rows > 1 else ""
        was = WAS_MS.get((name, wdtype, rows)) if path is None else None
        log(f"  {tag}: kernel {t_k:.4f} ms ({per_layer / (t_k * 1e-3) / 1e9:.0f} GB/s of weights{vs_one}, "
            f"{t_b / t_k:.3f} of the bound {t_b:.4f} ms, {entry['bound_by']}"
            f"{'' if was is None else f'; was {was:.4f} ms'}), plain {t_p:.4f} ms, torch.matmul "
            f"{'none' if t_l is None else f'{t_l:.4f} ms (kernel / library {t_k / t_l:.3f})'}")
    return entries


def _g_row(chk, kernels, gen, length: int, s_view: int, hq: int, hk: int, path: str) -> dict:
    """Kernel G over ``length`` keys of an S_view-row cache view against its
    plain version, timed from graph replays over views cycled past the L2
    (host length, and the length read from the device), beside its bound
    and SDPA on the live rows: an entry of G's ``shapes``."""
    from framefusion_tpu_torch.kernel_bench import graph_time_ms, sdpa
    from framefusion_tpu_torch.ops.kernels import decode_attention as da

    d = 128
    n_views = max(2, math.ceil(150e6 / (2 * s_view * hk * d * 2)))
    kpool, vpool = _rand(gen, (n_views, s_view, hk, d)), _rand(gen, (n_views, s_view, hk, d))
    q = _rand(gen, (hq, d))
    out = da.ragged_decode_attn(q, kpool[0], vpool[0], length)
    ref = da.ragged_decode_attn_plain(q, kpool[0], vpool[0], length)
    torch.cuda.synchronize()
    err, rel = _row_rel(out, ref)
    entry = {"path": path, "shape": f"length {length} of S_view {s_view}, Hq={hq} Hk={hk}", "launches": None,
             "max_abs_err": err}
    chk.expect(rel <= ATTN_ROW_RTOL, f"G {entry['shape']} ({path}): max_abs_err {err:.3e}; per head error / its "
                                     f"largest output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
    _max_err(kernels["ragged_decode_attn"], err)
    view = [0]

    def kv_view():
        view[0] = (view[0] + 1) % n_views
        return kpool[view[0]], vpool[view[0]]

    len_dev = torch.tensor(length, device="cuda")
    t_k = graph_time_ms(lambda: da.ragged_decode_attn(q, *kv_view(), length), iters=50)
    t_dev = graph_time_ms(lambda: da.ragged_decode_attn(q, *kv_view(), len_dev), iters=50)
    t_p = graph_time_ms(lambda: da.ragged_decode_attn_plain(q, *kv_view(), length), iters=10)
    t_l = graph_time_ms(lambda: sdpa(q[None], *(t[:length] for t in kv_view())), iters=20)
    t_b = _bound(entry, 2 * length * hk * d * 2 + 2 * hq * d * 2, 4 * hq * d * length)
    entry.update(ms=t_k, plain_ms=t_p, library_ms=t_l, device_length_ms=t_dev)
    kernels["ragged_decode_attn"]["shapes"].append(entry)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  G {entry['shape']}: kernel {t_k * 1e3:.2f} us ({t_b / t_k:.3f} of the bound {t_b * 1e3:.2f} us, "
        f"{entry['bound_by']}; the length read from the device {t_dev * 1e3:.2f} us; split plan (keys per CTA, "
        f"splits) {da.split_plan(length, hk, sm)}), plain {t_p * 1e3:.2f} us, scaled_dot_product_attention on the "
        f"live rows (GQA) {t_l * 1e3:.2f} us (kernel / library {t_k / t_l:.3f})")
    return entry


def phase_kernels(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch.core import descending_rank
    from framefusion_tpu_torch.kernel_bench import graph_time_ms, kernel_device_us, sdpa
    from framefusion_tpu_torch.ops.attention import capture_rows
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp

    gen = torch.Generator(device="cuda").manual_seed(1234)
    hq, hk, d = 28, 4, 128

    # -- kernel A (and the statistics kernel B reads) at the main path's
    # regimes (REGIMES_A) ---------------------------------------------------
    cases = {}
    for s, dead in ((11697, 0.0), (6528, 0.45), (3328, 0.0)):
        regime, cases[s] = _a_regime(chk, kernels, gen, s, hq, hk, dead, REGIMES_A[s])
        if s == 6528:  # the phase layers' regime heads the entry, as in earlier runs
            kernels["flash_attn_fwd"].update({f: regime[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                     "bound_by")})

    # -- kernel B -------------------------------------------------------
    q, k, kv, m, l = cases[6528]
    s = q.shape[0]
    live_rows = torch.nonzero(kv).flatten()
    row_sets = {
        "num=1": capture_rows(s, 1, None, kv),
        "num=4": capture_rows(s, 4, None, kv),
        "num=4 sentinel": torch.cat([torch.full((2,), -1, device="cuda"), live_rows[-2:]]),
    }
    for tag, rows in row_sets.items():
        imp = fp.attn_importance_rows(q, k, rows, m, l, kv)
        imp_p = fp.attn_importance_rows_plain(q, k, rows, m, l, kv)
        torch.cuda.synchronize()
        err = (imp - imp_p).abs().max().item()
        rel = err / imp_p.abs().max().item()
        chk.expect(rel <= IMP_RTOL, f"B {tag} S={s}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {IMP_RTOL}")
        n_keep = int(0.3 * int(kv.sum()))
        ninf = torch.full_like(imp, float("-inf"))
        keep = descending_rank(torch.where(kv, imp, ninf)) < n_keep
        keep_p = descending_rank(torch.where(kv, imp_p, ninf)) < n_keep
        chk.expect(bool((keep == keep_p).all()), f"B {tag}: top-{n_keep} keep set equals the plain one")
        _max_err(kernels["attn_importance_rows"], err)
        if tag == "num=1":
            t_k = graph_time_ms(lambda: fp.attn_importance_rows(q, k, rows, m, l, kv), iters=20)
            t_p = graph_time_ms(lambda: fp.attn_importance_rows_plain(q, k, rows, m, l, kv), iters=5)
            n = rows.shape[0]
            seen = float(torch.cumsum(kv.to(torch.int64), 0)[rows].sum())  # live keys at or before each row
            t_b = _bound(kernels["attn_importance_rows"],
                         n * hq * d * 2 + s * hk * d * 2 + s + n * 8 + 2 * n * hq * 4 + s * 4, 2 * hq * d * seen)
            log(f"  B {tag} S={s}: kernel {t_k * 1e3:.2f} us ({t_b / t_k:.3f} of the bound {t_b * 1e3:.2f} us, "
                f"{kernels['attn_importance_rows']['bound_by']}), plain {t_p:.3f} ms; no single PyTorch call "
                f"computes it")
            kernels["attn_importance_rows"].update(ms=t_k, plain_ms=t_p)
    del cases, q, k, m, l

    # -- kernels C and D at the decode shapes, one row and the batched
    # decode's and the verify's rows (phases 9 and 10: B rows in one launch,
    # one pass over the weights for all of them, on the tensor cores; the
    # split plan does not depend on the rows) -----------------------------------
    hid, inter = 3584, 18944
    shapes = {"qkv": (hid, [hid, 512, 512]), "wo": (hid, [hid]), "w_down": (inter, [hid]),
              "gateup": (hid, [inter, inter])}
    for wdtype in ("bf16", "int8"):
        for name, (kdim, ns) in shapes.items():
            key = "gemv_gateup" if name == "gateup" else "gemv_stacked"
            one, *batched = _cd_rows(chk, kernels, gen, name, wdtype, kdim, ns, (1,) + BATCH_ROWS + VERIFY_ROWS)
            kernels[key]["shapes"] += ([one] if key == "gemv_stacked" else []) + batched
            if wdtype == "bf16" and name in ("qkv", "gateup"):  # bf16 qkv heads C's entry, as in earlier runs
                kernels[key].update({f: one[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
                if one["library_ms"] is not None:
                    kernels[key]["library_ms"] = one["library_ms"]

    # matvec_q8 / matvec_bf16 (the JAX package's plain (K, N) matvec): kernel
    # C with the weight as a one-layer stack.
    x = _rand(gen, (1, hid))
    w8 = torch.randint(-127, 128, (hid, 4608), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((4608,), generator=gen, device="cuda") * 0.01 + 0.005
    wbf = (w8.to(torch.bfloat16) * sc).to(torch.bfloat16)
    for tag, got, ref in (("matvec_q8", mv.matvec_q8(x, w8, sc), mv.gemv_stacked_plain(x, [w8[None]], 0)[0] * sc),
                          ("matvec_bf16", mv.matvec_bf16(x, wbf), mv.gemv_stacked_plain(x, [wbf[None]], 0)[0])):
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        chk.expect(rel <= GEMV_RTOL, f"{tag} 1x{hid} . {hid}x4608 on kernel C: max_abs_err {err:.3e} (rel {rel:.3e}) "
                                     f"<= {GEMV_RTOL}")
        _max_err(kernels["gemv_stacked"], err)
    del w8, wbf

    # -- kernel E at the tower's shapes (so400m: 16 frames, N 729, 16 heads,
    # head dim 72), and head dims 64 / 80 of the later towers ---------------
    for b, n, h, hd in ((16, 729, 16, 72), (4, 1025, 16, 64), (4, 1296, 16, 80)):
        q, k, v = (_rand(gen, (b, n, h, hd)) for _ in range(3))
        out = ba.flash_bidir_attention(q, k, v)
        ref = ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5)
        torch.cuda.synchronize()
        err_rh = (out.float() - ref.float()).abs().amax(-1)  # (B, N, H)
        rel = (err_rh / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()
        err = err_rh.max().item()
        tag = f"E B={b} N={n} H={h} hd={hd}"
        chk.expect(rel <= ATTN_ROW_RTOL, f"{tag}: max_abs_err {err:.3e}; per (row, head) error / its largest "
                                         f"output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
        _max_err(kernels["bidir_attn_fwd"], err)
        t_k = cuda_time_ms(lambda: ba.flash_bidir_attention(q, k, v), iters=20)
        t_p = cuda_time_ms(lambda: ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5), iters=3, warmup=1)
        tflops = 4 * b * h * n * n * hd / (t_k * 1e-3) / 1e12
        log(f"  {tag}: kernel {t_k:.4f} ms ({tflops:.1f} TFLOP/s), plain {t_p:.4f} ms")
        if hd == 72:
            t_l = cuda_time_ms(lambda: sdpa(q, k, v), iters=20)
            t_b = _bound(kernels["bidir_attn_fwd"], 4 * b * n * h * hd * 2, 4 * b * h * n * n * hd)
            log(f"  {tag}: bound {t_b:.4f} ms ({kernels['bidir_attn_fwd']['bound_by']}), kernel at "
                f"{t_b / t_k:.3f} of it; scaled_dot_product_attention {t_l:.4f} ms, kernel / library "
                f"{t_k / t_l:.3f}")
            kernels["bidir_attn_fwd"].update(ms=t_k, plain_ms=t_p, library_ms=t_l)
        del q, k, v, out, ref

    # -- kernel E at the Qwen2-VL-7B tower's shape (phase 11: 32 temporal
    # frames of 26 x 34 patches, 16 heads of 80; N off the key tile), and
    # kernel B at Qwen2-VL's 4 capture rows at phase 11's phase-layer length
    # (its last 14 text rows live)
    _e_row(chk, kernels, gen, QWEN2VL_E_SHAPE, "qwen2vl")
    _b_row(chk, kernels, gen, QWEN2VL_PHASE_S, QWEN2VL_PHASE_LIVE, 4, hq, hk, 14, "qwen2vl")

    # -- kernel F at the StreamingLLM prefill's full-width shapes (S 11,697,
    # init 8, window int(0.3 S) - 8; S 11,776, the bucket-padded length the
    # prefill launches F at) and at small odd shapes ------------------------
    for s, hq_, hk_, init_num, window in (
            (11697, hq, hk, 8, int(0.3 * 11697) - 8),
            (11776, hq, hk, 8, int(0.3 * 11697) - 8),
            (200, 4, 4, 8, 24),  # G = 1
            (333, hq, hk, 8, 1),  # the diagonal and the sinks only
            (301, 14, 2, 0, 50),  # no sink keys
            (517, hq, hk, 100, 30),  # init_num > window: sink and window tiles overlap
            (190, hq, hk, 8, 4096),  # window >= S: causal attention, as kernel A
            (700, hq, hk, 8, 127), (700, hq, hk, 8, 128), (700, hq, hk, 8, 129),  # the 128-key tile's edges
            (645, hq, hk, 128, 200), (645, hq, hk, 129, 200),  # sinks filling a tile, and one past it
            (300, hq, hk, 400, 10),  # init_num >= S: causal attention
            (1000, hq, hk, 8, 1000)):  # window == S off the tile: as kernel A
        q, k, v = _rand(gen, (s, hq_, d)), _rand(gen, (s, hk_, d)), _rand(gen, (s, hk_, d))
        out = sp.sink_attn_fwd(q, k, v, init_num, window)
        refs = {"plain": sp.sink_attn_fwd_plain(q, k, v, init_num, window)}
        if window >= s:
            refs["kernel A"] = fp.flash_attn_fwd(q, k, v)[0]
        torch.cuda.synchronize()
        tag = f"F S={s} Hq={hq_} Hk={hk_} init={init_num} window={window}"
        for name, ref in refs.items():
            err_rh = (out.float() - ref.float()).abs().amax(-1)  # (S, Hq)
            rel = (err_rh / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()
            chk.expect(rel <= ATTN_ROW_RTOL, f"{tag} vs {name}: max_abs_err {err_rh.max().item():.3e}; per (row, "
                                             f"head) error / its largest output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
        _max_err(kernels["sink_attn_fwd"], (out.float() - refs["plain"].float()).abs().max().item())
        if s in (11697, 11776):  # the dense prompt's length (the kernels line's row) and the bucket's
            t_k = cuda_time_ms(lambda: sp.sink_attn_fwd(q, k, v, init_num, window), iters=10)
            t_p = cuda_time_ms(lambda: sp.sink_attn_fwd_plain(q, k, v, init_num, window), iters=2, warmup=1)
            t_a = cuda_time_ms(lambda: fp.flash_attn_fwd(q, k, v), iters=10)
            rows = np.arange(s)
            keys = np.minimum(rows + 1, window) + np.minimum(init_num, np.maximum(rows - window + 1, 0))
            tflops = 4 * hq_ * d * float(keys.sum()) / (t_k * 1e-3) / 1e12
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & ((pos[None, :] < init_num) | (pos[None, :] > pos[:, None] - window))
            t_l = cuda_time_ms(lambda: sdpa(q, k, v, mask), iters=2, warmup=1)
            del mask
            entry = kernels["sink_attn_fwd"] if s == 11697 else {}
            t_b = _bound(entry, (2 * s * hq_ * d + 2 * s * hk_ * d) * 2, 4 * hq_ * d * float(keys.sum()))
            log(f"  {tag}: kernel {t_k:.4f} ms ({tflops:.1f} TFLOP/s, {t_b / t_k:.3f} of the bound {t_b:.4f} ms, "
                f"{entry['bound_by']}), plain {t_p:.3f} ms; kernel A (causal) at this S {t_a:.4f} ms, F / A "
                f"{t_k / t_a:.3f}; scaled_dot_product_attention (GQA, bool mask) {t_l:.3f} ms, kernel / library "
                f"{t_k / t_l:.3f}")
            if s == 11697:
                kernels["sink_attn_fwd"].update(ms=t_k, plain_ms=t_p, library_ms=t_l)
        del q, k, v, out, refs

    # -- kernel G at the decode step's shapes: the phase layers' ~11,697 keys
    # (+1) in the 11,776-row pool and the tail layers' ~3,292 (+1) in a
    # 3,328-row tail view; then edge cases: one key, every row of the view,
    # lengths off the 64-key tile, G = 1 (Hq = Hk = 4) and G = 16 (the most
    # the kernel takes). Timed over views cycled past the 50 MB L2, as a
    # decode step finds each layer's cache cold.
    for length, s_view, hq_, hk_ in ((11698, 11776, hq, hk), (3293, 3328, hq, hk), (1, 11776, hq, hk),
                                     (3328, 3328, hq, hk), (65, 200, hq, hk), (517, 600, 4, 4), (777, 800, 16, 1)):
        main_shape = length in (11698, 3293)
        view_bytes = 2 * s_view * hk_ * d * 2
        n_views = max(2, math.ceil(150e6 / view_bytes)) if main_shape else 1
        kpool, vpool = _rand(gen, (n_views, s_view, hk_, d)), _rand(gen, (n_views, s_view, hk_, d))
        q = _rand(gen, (hq_, d))
        out = da.ragged_decode_attn(q, kpool[0], vpool[0], length)
        ref = da.ragged_decode_attn_plain(q, kpool[0], vpool[0], length)
        torch.cuda.synchronize()
        err_h = (out.float() - ref.float()).abs().amax(-1)
        rel = (err_h / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()
        tag = f"G length {length} of S_view {s_view}, Hq={hq_} Hk={hk_}"
        chk.expect(rel <= ATTN_ROW_RTOL, f"{tag}: max_abs_err {err_h.max().item():.3e}; per head error / its largest "
                                         f"output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
        _max_err(kernels["ragged_decode_attn"], err_h.max().item())
        if main_shape:
            view = [0]

            def kv_view():
                view[0] = (view[0] + 1) % n_views
                return kpool[view[0]], vpool[view[0]]

            t_k = graph_time_ms(lambda: da.ragged_decode_attn(q, *kv_view(), length), iters=50)
            # The captured decode's form: the length read from the device,
            # the launch planned for the view's rows (S_view).
            len_dev = torch.tensor(length, device="cuda")
            t_dev = graph_time_ms(lambda: da.ragged_decode_attn(q, *kv_view(), len_dev), iters=50)
            t_eager = cuda_time_ms(lambda: da.ragged_decode_attn(q, *kv_view(), length), iters=50)
            t_p = graph_time_ms(lambda: da.ragged_decode_attn_plain(q, *kv_view(), length), iters=10)
            # The yardstick attends the live rows as a view: no mask, so
            # the library may take its fused decode path.
            t_l = graph_time_ms(lambda: sdpa(q[None], *(t[:length] for t in kv_view())), iters=20)
            parts = kernel_device_us(lambda: da.ragged_decode_attn(q, *kv_view(), length), ("decode_attn_kernel",))
            log(f"  {tag}: profiler, per call: decode_attn_kernel (splits and their merge, one launch) "
                f"{parts['decode_attn_kernel']:.2f} us")
            entry = {} if length != 11698 else kernels["ragged_decode_attn"]
            t_b = _bound(entry, 2 * length * hk_ * d * 2 + 2 * hq_ * d * 2, 4 * hq_ * d * length)
            gbs = 2 * length * hk_ * d * 2 / (t_k * 1e-3) / 1e9
            log(f"  {tag}: kernel {t_k * 1e3:.2f} us ({gbs:.0f} GB/s of live K/V; eager launches {t_eager * 1e3:.2f} "
                f"us per call; the length read from the device, planned for S_view {s_view}: {t_dev * 1e3:.2f} us, "
                f"split plan {da.split_plan(s_view, hk_, torch.cuda.get_device_properties(0).multi_processor_count)}), "
                f"plain {t_p * 1e3:.2f} us, scaled_dot_product_attention on the live rows (GQA) "
                f"{t_l * 1e3:.2f} us (kernel / library {t_k / t_l:.3f}), bound {t_b * 1e3:.2f} us "
                f"({entry['bound_by']}; kernel at {t_b / t_k:.3f} of it); split plan (keys per CTA, splits) "
                f"{da.split_plan(length, hk_, torch.cuda.get_device_properties(0).multi_processor_count)}")
            if length == 11698:
                kernels["ragged_decode_attn"].update(ms=t_k, plain_ms=t_p, library_ms=t_l, device_length_ms=t_dev)
        del kpool, vpool, q, out, ref


def phase_cross(chk: Checks) -> None:
    from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4,
                          num_kv_heads=2, dtype=torch.bfloat16)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1,
                           schedule_num_layers=6, bucket=32)
    tree = numpy_params(cfg, seed=0, scale=0.05)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5)
    pos = np.arange(len(pt))
    results = {}
    modes = ("fused", "planned", "segmented")
    for dev in ("cpu", "cuda"):
        params = _cast_floats(qwen2.params_from_numpy(tree, dev), cfg.dtype)
        eng = CompressionEngine(params, cfg, ff, attn_impl="flash")
        for mode in modes:
            res = eng.prefill(h, pt, pos, 8, img_start, n_img, mode=mode)
            toks = eng.generate(res, 8)
            results[(dev, mode)] = ([(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
                                    [c[2] for c in res.layer_caches], toks, res.mode, res.logits.float().cpu())
            # the decode graph's other entry points (replays on the card, its step eagerly on the CPU)
            dev_toks = eng.generate_device(res, 8).tolist()
            stream = list(eng.generate_stream(res, 8, chunk=4))
            chk.expect(dev_toks == toks and stream == [toks[:1], toks[:5], toks],
                       f"cross {mode} on {dev}: generate_device and generate_stream(chunk=4) give generate's tokens")
    for mode in modes:
        cpu, gpu = results[("cpu", mode)], results[("cuda", mode)]
        rel = float((cpu[4] - gpu[4]).abs().max() / cpu[4].abs().max())
        log(f"  {mode}: cpu events {cpu[0]} tokens {cpu[2]}; cuda events {gpu[0]} tokens {gpu[2]} ({gpu[3]})")
        chk.expect(cpu[0] == gpu[0] and cpu[1] == gpu[1], f"cross {mode}: events and cache lengths equal")
        chk.expect(cpu[2] == gpu[2], f"cross {mode}: greedy tokens equal")
        chk.expect(len(set(gpu[2])) >= 3, f"cross {mode}: the tokens vary ({len(set(gpu[2]))} distinct of 8)")
        chk.expect(rel <= LOGIT_RTOL, f"cross {mode}: prefill logits differ by {rel:.3e} of their largest "
                                      f"<= {LOGIT_RTOL}")
        chk.expect(len(cpu[0]) > 1, f"cross {mode}: the scenario compresses ({len(cpu[0])} events)")

    # The batched main path on this geometry: three prompts through one
    # lockstep-batched planned prefill, then one batched decode (its step
    # eagerly on the CPU, the captured batched graph on the card). The
    # weights are ``readout_params`` and each prompt ends in a vocabulary
    # token, so that 8 greedy tokens in each of three rows survive bf16
    # rounding (with ``numpy_params`` a row's 6th token flips between fp32
    # and bf16 on the CPU); the compression decisions and the logits bound
    # are what can fail (fp32 against bf16 on the CPU: 2.3e-2 at most).
    tree = readout_params(cfg, seed=0, resid_scale=0.03)
    batch = batch_prompts(cfg.hidden_size, 3, seed0=5, n_frames=12, patch_num=8, n_pre=6, n_post=5)
    for i, prompt in enumerate(batch):
        prompt[0][-1] = tree["embed"][7 + i]
    got = {}
    for dev in ("cpu", "cuda"):
        eng = CompressionEngine(_cast_floats(qwen2.params_from_numpy(tree, dev), cfg.dtype), cfg, ff)
        res = eng.prefill_planned_batch(batch, patch_num=8)
        got[dev] = ([[(e.layer, e.kind, e.tokens_removed) for e in r.telemetry.events] for r in res],
                    [r.mode for r in res], [[c[2] for c in r.layer_caches] for r in res], eng.generate_batch(res, 8),
                    torch.stack([r.logits.float().cpu() for r in res]))
    cpu, gpu = got["cpu"], got["cuda"]
    rel = float(((cpu[4] - gpu[4]).abs().amax(-1) / cpu[4].abs().amax(-1)).max())
    log(f"  planned_batch: modes {gpu[1]}, events {gpu[0]}; tokens cpu {cpu[3]}, cuda {gpu[3]}")
    chk.expect(cpu[:3] == gpu[:3] and gpu[1] == ["planned_batch"] * 3,
               "cross planned_batch: modes, events and cache lengths equal on both devices, every prompt planned")
    chk.expect(cpu[3] == gpu[3], "cross generate_batch: greedy tokens equal (the batched graph on the card)")
    chk.expect(all(len(set(t)) >= 3 for t in gpu[3]) and len({tuple(t) for t in gpu[3]}) == 3,
               "cross generate_batch: the tokens vary within and across the rows")
    chk.expect(rel <= LOGIT_RTOL, f"cross planned_batch: prefill logits differ by {rel:.3e} of their row's largest "
                                  f"<= {LOGIT_RTOL}")


def batch_prompts(hidden: int, n: int, seed0: int = 0, **kw) -> list:
    """``n`` distinct video prompts for ``prefill_planned_batch``: seeds
    ``seed0``.., coherence cycling 0.35 / 0.45 / 0.55 (numpy embeddings,
    ``build_video_prompt``'s other arguments from ``kw``)."""
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt

    out = []
    for i in range(n):
        h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(seed0 + i), hidden,
                                                     coherent=(0.35, 0.45, 0.55)[i % 3], **kw)
        out.append((h, pt, np.arange(len(pt)), img_start, n_img))
    return out


def numpy_params(cfg, seed: int, scale: float) -> dict:
    """Random Qwen2 weights in the JAX package's pytree layout, drawn with
    numpy so that every machine and torch version gets the same model."""
    rng = np.random.default_rng(seed)
    n_l, d, i, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    nq, nk = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1": np.ones((n_l, d), np.float32), "ln2": np.ones((n_l, d), np.float32),
              "wq": norm(n_l, d, nq), "wk": norm(n_l, d, nk), "wv": norm(n_l, d, nk), "wo": norm(n_l, nq, d),
              "w_gate": norm(n_l, d, i), "w_up": norm(n_l, d, i), "w_down": norm(n_l, i, d)}
    if cfg.qkv_bias:
        layers.update(bq=norm(n_l, nq), bk=norm(n_l, nk), bv=norm(n_l, nk))
    return {"embed": norm(cfg.vocab_size, d), "layers": layers, "final_norm": np.ones(d, np.float32),
            "lm_head": norm(d, cfg.vocab_size)}


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def phase_kernel_check(chk: Checks) -> None:
    from framefusion_tpu_torch import kernel_bench

    n_fail = kernel_bench.check_kernels(log=log)
    chk.expect(n_fail == 0, f"kernel_check: {n_fail} failed rows")
    n_fail = kernel_bench.check_batch_parity(log=log)
    chk.expect(n_fail == 0, f"batch_parity: {n_fail} failed checks")


def _set_launches(entry: dict, n: int) -> None:
    entry.update(launches=n, main_path_launches=n)


def _zero_counts(wrappers: dict) -> None:
    """Set the wrappers' counts and the decode graphs' replay counts to 0."""
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph

    DecodeGraph.reset_counts()
    for w in wrappers.values():
        w.launches = w.captured = 0


def _ran(wrappers: dict) -> dict:
    """Kernel launches that ran on the card since ``_zero_counts``, by kernel:
    the wrappers' own (eager) launches plus those the decode graphs' replays
    ran (calls recorded while capturing ran only at the replays)."""
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph

    return {name: w.launches + DecodeGraph.replayed[name] for name, w in wrappers.items()}


def _cd_log(mv):
    """Kernels C's and D's calls from the model, by (kernel, rows, K, the
    stacks' widths)."""
    from framefusion_tpu_torch.parallel.workers import CallLog

    return CallLog(mv, {
        "matvec_stacked": lambda x, w, layer: ("gemv_stacked", x.shape[0], x.shape[1], (w.shape[2],)),
        "matvec_stacked_qkv": lambda x, wq, wk, wv, layer: (
            "gemv_stacked", x.shape[0], x.shape[1], (wq.shape[2], wk.shape[2], wv.shape[2])),
        "matvec_stacked_gateup": lambda x, wg, wu, sg, su, layer: ("gemv_gateup", x.shape[0], x.shape[1], None)})


def _a_log(fp):
    """Kernel A's calls from the model, by (S, whether a key_valid mask came)."""
    from framefusion_tpu_torch.parallel.workers import CallLog

    return CallLog(fp, {
        "flash_causal_attention": lambda q, k, v, key_valid=None: (q.shape[0], key_valid is not None),
        "flash_causal_attention_importance":
            lambda q, k, v, valid_len, num, key_valid=None: (q.shape[0], key_valid is not None)})


def _c_log(mv):
    """Kernel C's calls from the model, by (K, the stacks' widths)."""
    from framefusion_tpu_torch.parallel.workers import CallLog

    return CallLog(mv, {
        "matvec_stacked": lambda x, w, layer: (x.shape[1], (w.shape[2],)),
        "matvec_stacked_qkv": lambda x, wq, wk, wv, layer: (x.shape[1], (wq.shape[2], wk.shape[2], wv.shape[2]))})


def phase_full(chk: Checks, kernels: dict, ctx: dict) -> None:
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = qwen2_7b_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + params["embed"].numel() + params["lm_head"].numel()
    log(f"  random Qwen2-7B weights: {n_params / 1e9:.2f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    log(f"  prompt: {len(pt)} tokens, {n_img} image tokens at {img_start}")
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to("cuda", torch.bfloat16), patch_type=pt,
                           position_ids=np.arange(len(pt)), patch_num=182, image_token_start=img_start,
                           image_token_length=n_img)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), 0.3, 0.6, 0.1)
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup,
                "ragged_decode_attn": da.ragged_decode_attn}

    _zero_counts(wrappers)
    with _a_log(fp) as a_log, _c_log(mv) as c_log:
        toks, res = model.generate(inputs, max_new_tokens=8)
        torch.cuda.synchronize()
    # The decode is a CUDA graph captured in this run: the wrappers count the
    # warm-up step's launches, and the calls recorded at the capture apart;
    # the graph counts its replays and the launches they ran.
    ran, replays = _ran(wrappers), DecodeGraph.replays
    captured = {name: w.captured for name, w in wrappers.items() if w.captured}
    for name, w in wrappers.items():
        _set_launches(kernels[name], ran[name])
        if name in captured:
            kernels[name].update(eager_launches=w.launches, graph_launches=DecodeGraph.replayed[name],
                                 captured_calls=w.captured)
    a_counts, c_counts = a_log.counts(replays), c_log.counts(replays)
    log(f"  fused: kernel launches that ran {ran}: eager {({n: w.launches for n, w in wrappers.items()})}, "
        f"{replays} decode-graph replays ran {dict(DecodeGraph.replayed)}; calls recorded at the capture {captured}")
    log(f"  fused: kernel A launches by (S, key_valid given): {a_counts}; kernel C by (K, widths): {c_counts}")
    chk.expect(sum(a_counts.values()) == kernels["flash_attn_fwd"]["launches"]
               and sum(c_counts.values()) == kernels["gemv_stacked"]["launches"],
               "fused: every kernel A and C launch was recorded with its regime")
    for regime in kernels["flash_attn_fwd"]["regimes"]:
        if regime["regime"] != REGIMES_A[11697]:  # the phase layers take a mask, the tail does not
            masked = regime["regime"] == REGIMES_A[6528]
            regime["launches"] = sum(n for (_, m), n in a_counts.items() if m == masked)
    for shape in kernels["gemv_stacked"]["shapes"]:
        name, wdtype, *rows = shape["shape"].split()  # the B-row shapes are phase 9's
        if wdtype == "bf16" and not rows:
            shape["launches"] = sum(n for (kd, ns), n in c_counts.items() if SHAPES_C.get((kd, ns)) == name)
    for name in wrappers:
        chk.expect(kernels[name]["launches"] > 0, f"{name}: {kernels[name]['launches']} launches in the fused run")
    chk.expect(replays == 7 and captured == {"gemv_stacked": 3 * cfg.num_layers, "gemv_gateup": cfg.num_layers,
                                             "ragged_decode_attn": cfg.num_layers}
               and all(DecodeGraph.replayed[k] == replays * n for k, n in captured.items()),
               f"fused: one decode graph, captured once with C, D and G once a layer ({captured}), replayed for "
               f"the 7 tokens after the prefill's ({replays} replays)")

    ev = [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]
    log(f"  fused: events {ev}")
    log(f"  fused: final length {res.valid_len} of {len(pt)}, tail from layer {res.telemetry.tail_start_layer}, "
        f"vision-token reduction {res.telemetry.vision_token_reduction:.4f}, tokens {toks}")
    chk.expect(bool(torch.isfinite(res.logits).all()) and res.logits.shape == (cfg.vocab_size,),
               "fused: last-token logits finite, shape (vocab,)")
    chk.expect(len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks), "fused: 8 tokens in the vocabulary")
    chk.expect(res.valid_len < len(pt) and any(e.kind == "prune" or e.kind == "merge_capped" for e in res.telemetry.events),
               "fused: the prompt was compressed to the cost budget")

    eng = model.engine()
    args = (inputs.input_embeds, pt, inputs.position_ids, 182, img_start, n_img)
    res_p = eng.prefill(*args, mode="planned")
    toks_p = eng.generate(res_p, 8)
    ev_p = [(e.layer, e.kind, e.tokens_removed) for e in res_p.telemetry.events]
    log(f"  planned: mode {res_p.mode} ({res_p.plan_source}), events {ev_p}, final length {res_p.valid_len}, tokens {toks_p}")
    chk.expect(res_p.mode == "planned", "planned: mode == 'planned'")
    chk.expect(ev_p == ev and res_p.valid_len == res.valid_len, "planned: same events and final length as fused")
    chk.expect(bool(torch.isfinite(res_p.logits).all()), "planned: logits finite")

    with _a_log(fp) as d_log:
        res_d = eng.dense_prefill(inputs.input_embeds, inputs.position_ids)
        torch.cuda.synchronize()
    d_counts = d_log.counts()
    log(f"  dense: kernel A launches by (S, key_valid given): {d_counts}")
    for regime in kernels["flash_attn_fwd"]["regimes"]:
        if regime["regime"] == REGIMES_A[11697]:
            regime["launches"] = sum(n for (_, m), n in d_counts.items() if not m)
    toks_d = eng.generate(res_d, 8)
    log(f"  dense: tokens {toks_d}")
    chk.expect(bool(torch.isfinite(res_d.logits).all()), "dense: logits finite")
    del res_d

    res_s = eng.prefill(*args, mode="segmented")
    ev_s = [(e.layer, e.kind, e.tokens_removed) for e in res_s.telemetry.events]
    log(f"  segmented: events {ev_s}, final length {res_s.valid_len}, buckets "
        f"{[e.bucket for e in res_s.telemetry.events]} (the same events as fused: {ev_s == ev})")
    chk.expect(bool(torch.isfinite(res_s.logits).all()) and res_s.valid_len < len(pt),
               "segmented: logits finite, the prompt compressed")
    del res_s

    t_dense = cuda_time_ms(lambda: eng.dense_prefill(inputs.input_embeds, inputs.position_ids), iters=3, warmup=1)
    t_fused = cuda_time_ms(lambda: eng.prefill(*args, mode="fused"), iters=3, warmup=1)
    t_plan = cuda_time_ms(lambda: eng.prefill(*args, mode="planned"), iters=3, warmup=1)
    t_seg = cuda_time_ms(lambda: eng.prefill(*args, mode="segmented"), iters=3, warmup=1)
    t_gen = cuda_time_ms(lambda: eng.generate(res_p, 8), iters=3, warmup=1)
    log(f"  prefill ms (CUDA events, mean of 3): dense {t_dense:.2f}, fused {t_fused:.2f}, planned {t_plan:.2f}, "
        f"segmented {t_seg:.2f}")
    log(f"  decode: generate(8) {t_gen:.2f} ms = {t_gen / 7:.2f} ms per decode step (7 graph replays after the "
        f"prefill token, bf16)")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Weight-only int8 decode (the JAX bench's decode configuration): the
    # layer weights become int8 pairs in place, so this runs last.
    params_q = quantize_params_int8(params)
    eng_q = CompressionEngine(params_q, cfg, eng.ff)
    launches, replays = (mv.gemv_stacked.launches, mv.gemv_gateup.launches), DecodeGraph.replays
    with _c_log(mv) as q_log:
        toks_q = eng_q.generate(res_p, 8)  # a new engine: its own graph, captured here
        torch.cuda.synchronize()
    q_counts = q_log.counts(DecodeGraph.replays - replays)
    log(f"  int8 decode: kernel C launches by (K, widths): {q_counts}")
    for shape in kernels["gemv_stacked"]["shapes"]:
        name, wdtype, *rows = shape["shape"].split()
        if wdtype == "int8" and not rows:
            shape["launches"] = sum(n for (kd, ns), n in q_counts.items() if SHAPES_C.get((kd, ns)) == name)
    chk.expect(mv.gemv_stacked.launches > launches[0] and mv.gemv_gateup.launches > launches[1]
               and len(toks_q) == 8 and all(0 <= t < cfg.vocab_size for t in toks_q),
               f"int8 decode through the int8 gemv kernels: tokens {toks_q}")
    t_gen_q = cuda_time_ms(lambda: eng_q.generate(res_p, 8), iters=3, warmup=1)
    log(f"  int8 decode: generate(8) {t_gen_q:.2f} ms = {t_gen_q / 7:.2f} ms per decode step")
    ctx.update(cfg=cfg, params_q=params_q, eng_q=eng_q, res=res)  # for phase 4b


def phase_decode(chk: Checks, kernels: dict, ctx: dict) -> None:
    """The decode step with kernel G at full width, on phase 4's int8 model
    and FrameFusion prefill."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.runtime.engine import best_tail_split

    cfg, params, eng, res = ctx["cfg"], ctx["params_q"], ctx["eng_q"], ctx["res"]
    n = 8
    states = {impl: list(eng.make_decode_state(res, n)) for impl in ("flash", "ragged")}
    lens0 = states["flash"][2]
    split = best_tail_split(lens0, int(states["flash"][0].shape[1]), n, eng.ff.bucket)
    log(f"  pool {tuple(states['flash'][0].shape)}, per-layer lengths {lens0}, tail split {split}")
    # Teacher forcing: both variants take the "flash" variant's greedy token.
    tok = torch.argmax(res.logits)
    worst, toks, finite = 0.0, [], True
    da.ragged_decode_attn.launches = 0
    for step in range(n):
        logits = {}
        for impl, st in states.items():
            logits[impl], st[0], st[1], st[2] = qwen2.decode_step(
                params, qwen2.embed(params, tok), res.decode_pos_base + step, st[0], st[1], st[2], cfg,
                attn_impl=impl, tail_split=split)
        ref = logits["flash"]
        finite = finite and bool(torch.isfinite(logits["ragged"]).all())
        worst = max(worst, float((logits["ragged"] - ref).abs().max() / ref.abs().max()))
        tok = torch.argmax(ref)
        toks.append(int(tok))
    torch.cuda.synchronize()
    log(f"  teacher-forced tokens {toks}")
    chk.expect(finite, "decode: ragged logits finite at every step")
    chk.expect(worst <= LOGIT_RTOL, f"decode ragged vs flash, {n} teacher-forced int8 steps at full width: logits "
                                    f"differ by {worst:.3e} of their largest <= {LOGIT_RTOL}")
    chk.expect(da.ragged_decode_attn.launches == n * cfg.num_layers,
               f"ragged_decode_attn: {da.ragged_decode_attn.launches} launches in {n} ragged steps "
               f"(one per layer: {n * cfg.num_layers})")
    del states
    # 16 steps a reading (the benchmark's own default is 32): the eager rows are
    # host-bound and the longest part of the run; phase 4c times the graph over 32.
    out = kernel_bench.bench_decodestep(params, cfg, res, steps=16, log=log)
    chk.expect(all(math.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0 for r in out["rows"]),
               f"decodestep: {len(out['rows'])} timings measured")


def phase_graph(chk: Checks, kernels: dict, ctx: dict) -> None:
    """The decode as one captured CUDA graph of the step (the engine's
    ``generate_device`` / ``generate`` / ``generate_stream``), on phase 4's
    int8 model and FrameFusion prefill."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.sampling import SamplerConfig
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph, capture_graph, slots_for

    cfg, params, eng, res = ctx["cfg"], ctx["params_q"], ctx["eng_q"], ctx["res"]
    n, steps = 8, 32
    floor_ms = kernel_bench.weight_stream_bytes(params) / kernel_bench.H100_BYTES_PER_S * 1e3
    eng._graphs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = eng.decode_graph(res, n)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    log(f"  graph: pool {tuple(graph.k_pool.shape)}, tail split {graph.tail_split}, decode attention "
        f"{graph.attn_impl!r}; warm-up step + capture {t_capture * 1e3:.1f} ms; kernel launches a captured step "
        f"{graph.launches_per_step}")
    chk.expect(graph.graph is not None and graph.launches_per_step.get("ragged_decode_attn") == cfg.num_layers,
               "graph: the step was captured, with kernel G once a layer")
    lens0 = [int(c[2]) for c in res.layer_caches]
    views: dict = {}  # G's views in this phase's decode graphs -> the lengths it attends there

    def note_views(g, n_steps):
        """The (S_view -> live lengths) G attends over ``n_steps`` steps of ``g``."""
        s_pool = int(g.k_pool.shape[1])
        split = g.tail_split if g.tail_split is not None and g.tail_split[1] < s_pool else None
        for l, n0 in enumerate(lens0):
            s_view = split[1] if split is not None and l >= split[0] else s_pool
            views.setdefault(s_view, set()).update({n0 + 1, n0 + n_steps})

    note_views(graph, n - 1)

    # Teacher forcing: graph replays against eager "ragged" steps (host-int
    # form), both fed the eager step's greedy token.
    k_pool, v_pool, lens = eng.make_decode_state(res, n)
    eng.make_decode_state(res, n, pools=(graph.k_pool, graph.v_pool))
    graph.start(lens, res.decode_pos_base, res.logits)
    tok, worst, finite = torch.argmax(res.logits), 0.0, True
    launches = da.ragged_decode_attn.launches
    for step in range(n - 1):
        logits, k_pool, v_pool, lens = qwen2.decode_step(params, qwen2.embed(params, tok), res.decode_pos_base + step,
                                                         k_pool, v_pool, lens, cfg, attn_impl="ragged",
                                                         tail_split=graph.tail_split)
        graph.tok.copy_(tok)
        graph.run(1)
        finite = finite and bool(torch.isfinite(graph.logits).all())
        worst = max(worst, float((graph.logits - logits).abs().max() / logits.abs().max()))
        tok = torch.argmax(logits)
    torch.cuda.synchronize()
    chk.expect(finite and worst <= LOGIT_RTOL,
               f"graph vs eager ragged, {n - 1} teacher-forced int8 steps at full width: logits differ by "
               f"{worst:.3e} of their largest <= {LOGIT_RTOL}")
    chk.expect(da.ragged_decode_attn.launches - launches == (n - 1) * cfg.num_layers,
               "graph: replays call no wrapper (G's count moved by the eager steps only)")
    del k_pool, v_pool

    toks = eng.generate(res, n)
    dev_toks = eng.generate_device(res, n).tolist()
    stream = list(eng.generate_stream(res, n, chunk=4))
    log(f"  graph: generate {toks}; generate_device {dev_toks}; generate_stream(chunk=4) {stream}")
    chk.expect(dev_toks == toks and stream == [toks[:1], toks[:5], toks],
               "graph: generate_device and generate_stream(chunk=4) give generate's tokens")
    chk.expect(all(0 <= t < cfg.vocab_size for t in toks), "graph: tokens in the vocabulary")
    # A sampled decode captures its own graph (top-k inverse CDF inside the step).
    sampler = SamplerConfig(temperature=0.8, top_k=50)
    sampled = [eng.generate(res, n, sampler=sampler, generator=torch.Generator().manual_seed(s)) for s in (0, 0)]
    log(f"  graph: sampled (temperature 0.8, top-k 50, seed 0) {sampled[0]}")
    chk.expect(sampled[0] == sampled[1] and all(0 <= t < cfg.vocab_size for t in sampled[0]),
               "graph: a sampled decode is the generator's (one seed, one sequence)")

    # generate(8) after the prefill, wall time: the eager decode of earlier
    # PRs (kernel_bench.generate_eager) against the graph, in turns.
    walls = {"eager": [], "graph": []}
    for kind in ("eager", "graph", "graph", "eager"):
        fn = (lambda: kernel_bench.generate_eager(eng, res, n)) if kind == "eager" else (lambda: eng.generate(res, n))
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
    log(f"  generate({n}) wall ms after the prefill: eager {walls['eager']}, graph {walls['graph']} "
        f"(eager / graph {sum(walls['eager']) / sum(walls['graph']):.2f}x); eager (\"flash\") tokens "
        f"{kernel_bench.generate_eager(eng, res, n)}")

    # 32 replays between CUDA events, two readings; the plain-attention
    # ("flash") graph once on the same geometry; the floor beside them.
    g32 = eng.decode_graph(res, steps + 1)
    note_views(g32, steps)
    _, _, lens = eng.make_decode_state(res, steps + 1, pools=(g32.k_pool, g32.v_pool))
    flash = DecodeGraph(params, cfg, int(g32.k_pool.shape[1]), attn_impl="flash", tail_split=g32.tail_split,
                        sampler=SamplerConfig(), n_slots=slots_for(steps + 1))
    flash.k_pool.copy_(g32.k_pool)
    flash.v_pool.copy_(g32.v_pool)

    def replay_ms(g) -> float:
        g.start(lens, res.decode_pos_base, res.logits)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.run(steps)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / steps

    readings = [replay_ms(g32), replay_ms(g32)]
    t_flash = replay_ms(flash)
    g32.start(lens, res.decode_pos_base, res.logits)
    prof = kernel_bench.device_profile(lambda: g32.run(8))
    per_step = {k: v / 8 for k, v in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])}

    def part(name):
        return sum(v for k, v in per_step.items() if name in k) / 1e3

    log(f"  graph ragged: {sum(readings) / 2:.3f} ms/step over {steps} replays ({readings[0]:.3f}, {readings[1]:.3f}); "
        f"graph flash (plain attention) {t_flash:.3f} ms/step; weight-stream floor {floor_ms:.3f} ms/step "
        f"(ragged at {floor_ms / (sum(readings) / 2):.3f} of it)")
    if prof["launches"]:
        log(f"  graph ragged, profiler over 8 replays: device idle share {prof['idle_share']:.4f} of the "
            f"{prof['window_us'] / 8e3:.3f} ms a step; {prof['launches'] / 8:.0f} device operations a step; device ms a "
            f"step: C+D pass (gemv_kernel, rows_kernel) {part('gemv_kernel') + part('rows_kernel'):.3f}, D epilogue "
            f"{part('gateup_reduce'):.3f}, "
            f"G {part('decode_attn_kernel'):.3f}, all {prof['busy_us'] / 8e3:.3f}")
        log(f"  graph ragged, top device kernels a step (us): "
            f"{ {k[:60]: round(v, 2) for k, v in list(per_step.items())[:8]} }")
    chk.expect(prof["launches"] > 0, "graph: the profiler saw the replays' device operations")
    chk.expect(all(math.isfinite(t) and t > 0 for t in readings + [t_flash]), "graph: replay times measured")
    del flash, g32

    # Kernel G with its length read from the device, held against its plain
    # version on the views the decode graphs of this phase launch it on
    # (the pool's rows for the phase layers, the tail split's for the rest),
    # at the live lengths the decodes reach and at the edges, and on the
    # JAX bench's 11,776-row view: per view one captured launch, planned
    # for the view's rows, replayed at every length without recapture.
    gen = torch.Generator(device="cuda").manual_seed(77)
    q = _rand(gen, (cfg.num_heads, cfg.head_dim_))
    kv = _rand(gen, (2, 11776, cfg.num_kv_heads, cfg.head_dim_))
    views.setdefault(11776, set()).update({3293, 11698})
    length = torch.ones((), dtype=torch.int64, device="cuda")
    worst, repeatable, held = 0.0, True, {}
    for s_view, reached in sorted(views.items()):
        lengths = sorted({1, 63, 64, 65, s_view} | reached)
        g_graph = capture_graph(lambda: held.update(out=da.ragged_decode_attn(q, kv[0, :s_view], kv[1, :s_view],
                                                                               length)), "cuda")
        for n_keys in lengths:
            length.fill_(n_keys)
            g_graph.replay()
            first = held["out"].clone()
            g_graph.replay()
            torch.cuda.synchronize()
            repeatable = repeatable and torch.equal(held["out"], first)
            ref = da.ragged_decode_attn_plain(q, kv[0, :s_view], kv[1, :s_view], n_keys)
            err_h = (first.float() - ref.float()).abs().amax(-1)
            worst = max(worst, float((err_h / ref.float().abs().amax(-1).clamp(min=1e-30)).max()))
            _max_err(kernels["ragged_decode_attn"], float(err_h.max()))
        log(f"  G with a device length, one graph on the {s_view}-row view replayed at {lengths}")
        del g_graph
    chk.expect(worst <= ATTN_ROW_RTOL and repeatable,
               f"G with a device length on views {sorted(views)}: per head error / its largest output "
               f"{worst:.3e} <= {ATTN_ROW_RTOL}; bits equal over two replays")
    del held, kv
    ctx.clear()


class StubTokenizer:
    """Character-level ids below 101: prompts without a tokenizer file."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 101 for c in text][:40]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


QUESTION = "What happens in the video?"


def numpy_vit_params(vcfg, seed: int, scale: float, resid_scale: float) -> dict:
    """Random SigLIP weights in the JAX package's pytree layout, drawn with
    numpy; the blocks write to the residual stream at ``resid_scale``."""
    rng = np.random.default_rng(seed)
    n_l, d, i = vcfg.num_layers, vcfg.hidden_size, vcfg.intermediate_size

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": np.ones((n_l, d), np.float32), "ln1_b": norm(n_l, d),
              "ln2_w": np.ones((n_l, d), np.float32), "ln2_b": norm(n_l, d),
              "wq": norm(n_l, d, d), "bq": norm(n_l, d), "wk": norm(n_l, d, d), "bk": norm(n_l, d),
              "wv": norm(n_l, d, d), "bv": norm(n_l, d), "wo": norm(n_l, d, d), "bo": norm(n_l, d),
              "w_fc1": norm(n_l, d, i), "b_fc1": norm(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": norm(n_l, d)}
    for name in ("wo", "bo", "w_fc2", "b_fc2"):
        layers[name] *= np.float32(resid_scale / scale)
    return {"patch_kernel": norm(vcfg.patch_size, vcfg.patch_size, 3, d), "patch_bias": norm(d),
            "pos_embed": norm(vcfg.num_patches, d), "layers": layers,
            "post_ln_w": np.ones(d, np.float32), "post_ln_b": np.zeros(d, np.float32)}


def numpy_projector(vision_dim: int, llm_dim: int, seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((vision_dim, llm_dim), dtype=np.float32) * np.float32(scale),
            "b1": np.zeros(llm_dim, np.float32),
            "w2": rng.standard_normal((llm_dim, llm_dim), dtype=np.float32) * np.float32(scale),
            "b2": np.zeros(llm_dim, np.float32),
            "image_newline": rng.standard_normal(llm_dim, dtype=np.float32) * np.float32(scale)}


def coherent_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """uint8 (n, h, w, 3) video: each frame drifts from the last
    (``bench.py``'s coherent synthetic pixels, mapped to 8 bits)."""
    fr = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    for f in range(1, n):
        fr[f] = fr[f - 1] * 0.98 + 0.2 * rng.standard_normal((h, w, 3), dtype=np.float32)
    return np.clip(128 + 40 * fr, 0, 255).astype(np.uint8)


def half_static_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """uint8 (n, h, w, 3) video whose left half stands still and whose right
    half is new in every frame: with a tower that mixes patches little,
    adjacent-frame similarities fall far from the threshold on either side,
    so bf16 roundings do not flip a merge."""
    frames = np.repeat(rng.integers(0, 256, (1, h, w, 3)), n, axis=0)
    frames[:, :, w // 2 :] = rng.integers(0, 256, (n, h, w - w // 2, 3))
    return frames.astype(np.uint8)


def tiny_vision_run(device: str, dtype: torch.dtype):
    """The tiny pixels-to-answer run of phase 5 on one device: (frontend
    features fp32 on the CPU, events, cache lengths, tokens, E launches)."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import llava_frontend, siglip
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.pipeline import TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=dtype)
    vcfg = siglip.ViTConfig(image_size=56, patch_size=7, hidden_size=288, intermediate_size=576, num_layers=3,
                            num_heads=4, dtype=dtype)  # head dim 72, as so400m's
    params = _cast_floats(qwen2.params_from_numpy(numpy_params(cfg, seed=0, scale=0.05), device), dtype)
    vit = _cast_floats(siglip.params_from_numpy(numpy_vit_params(vcfg, seed=1, scale=0.05, resid_scale=0.005),
                                                device), dtype)
    proj = _cast_floats(llava_frontend.params_from_numpy(
        numpy_projector(vcfg.hidden_size, cfg.hidden_size, seed=2, scale=0.05), device), dtype)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params, attn_impl="flash"),
                              0.3, 0.95, 0.1)
    model.ff = model.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    frames = half_static_frames(np.random.default_rng(6), 12, 45, 61)
    launches = ba.bidir_attn_fwd.launches
    feats = llava_frontend.encode_video(vit, vcfg, proj, pipe._prepare_frames(frames))
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    res = pipe.last_result
    return (feats.float().cpu(), [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
            [c[2] for c in res.layer_caches], toks, ba.bidir_attn_fwd.launches - launches)


def phase_cross_vision(chk: Checks) -> None:
    cpu = tiny_vision_run("cpu", torch.bfloat16)
    gpu = tiny_vision_run("cuda", torch.bfloat16)
    rel = float((cpu[0] - gpu[0]).abs().max() / cpu[0].abs().max())
    log(f"  cpu events {cpu[1]} tokens {cpu[3]}; cuda events {gpu[1]} tokens {gpu[3]}")
    chk.expect(rel <= FEATURE_RTOL, f"cross vision: frontend features differ by {rel:.3e} of their largest "
                                    f"<= {FEATURE_RTOL}")
    chk.expect(cpu[1] == gpu[1] and cpu[2] == gpu[2], "cross vision: events and cache lengths equal")
    chk.expect(cpu[3] == gpu[3], "cross vision: greedy tokens equal")
    chk.expect(len(set(gpu[3])) >= 3, f"cross vision: the tokens vary ({len(set(gpu[3]))} distinct of 8)")
    chk.expect(len(cpu[1]) > 1, f"cross vision: the scenario compresses ({len(cpu[1])} events)")
    chk.expect(cpu[4] == 0 and gpu[4] > 0, f"cross vision: kernel E launched on the card only ({gpu[4]} launches)")


def phase_pixels(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch import native, preprocess
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import llava_frontend, siglip
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.pipeline import TextPipeline

    t0 = time.perf_counter()
    native.load(required=True)
    log(f"  native preprocessing built and loaded in {time.perf_counter() - t0:.1f} s")
    cfg = qwen2_7b_config()
    vcfg = siglip.ViTConfig(dtype=torch.bfloat16)  # so400m@384/14: 27 layers, 1152 wide, 16 heads
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    vit = siglip.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    proj = llava_frontend.init_projector(torch.Generator(device="cuda").manual_seed(2), vcfg.hidden_size,
                                         cfg.hidden_size, dtype=torch.bfloat16)
    frames = coherent_frames(np.random.default_rng(0), 64, 360, 480)
    pre = preprocess.preprocess_frames(frames[:2], "llava_video", target=(384, 384), impl="native")
    pre_np = preprocess.preprocess_frames(frames[:2], "llava_video", target=(384, 384), impl="numpy")
    perr = float(np.abs(pre - pre_np).max())
    chk.expect(pre.shape == (2, 384, 384, 3) and perr <= 1e-4,
               f"native preprocessing 360x480 -> 384x384 equals numpy's within 1e-4 ({perr:.2e})")

    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params,
                             vision={"kind": "siglip", "cfg": vcfg, "params": vit, "projector": proj})
    pipes = {"framefusion": apply_framefusion(model, 0.3, 0.6, 0.1), "dense": model}
    pipes = {k: TextPipeline(model=m, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
             for k, m in pipes.items()}
    inputs = pipes["framefusion"].build_inputs(QUESTION, frames=frames)
    chk.expect(inputs.image_token_length == 64 * 182 and inputs.patch_num == 182,
               f"prompt: {inputs.image_token_length} vision tokens (64 x 182) of {inputs.input_embeds.shape[0]}")
    chk.expect(bool(torch.isfinite(inputs.input_embeds).all()), "prompt embeddings finite")
    del inputs

    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "bidir_attn_fwd": ba.bidir_attn_fwd}
    _zero_counts(wrappers)
    answer = pipes["framefusion"].ask(QUESTION, frames=frames, max_new_tokens=8)
    torch.cuda.synchronize()
    counts = _ran(wrappers)
    _set_launches(kernels["bidir_attn_fwd"], counts["bidir_attn_fwd"])
    log(f"  framefusion ask: launches {counts}")
    n_enc = (vcfg.num_layers - 1) * 4  # feature layer -2 runs 26 blocks, 4 batches of 16 frames
    chk.expect(counts["bidir_attn_fwd"] == n_enc, f"bidir_attn_fwd: {counts['bidir_attn_fwd']} launches in the "
                                                 f"pixels-to-answer run (26 layers x 4 batches = {n_enc})")
    res = pipes["framefusion"].last_result
    toks = [int(t) for t in answer.split()]
    ev = [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]
    for name, n in counts.items():
        if name == "bidir_attn_fwd":
            continue  # held to its exact count above
        if name == "attn_importance_rows" and not any(e[1] == "prune" for e in ev):
            log(f"  attn_importance_rows: {n} launches (no prune event in this run: kernel B is not on its path)")
            continue
        chk.expect(n > 0, f"{name}: {n} launches in the pixels-to-answer run")
    log(f"  framefusion: events {ev}, final length {res.valid_len}, vision-token reduction "
        f"{res.telemetry.vision_token_reduction:.4f}, tokens {toks}")
    chk.expect(bool(torch.isfinite(res.logits).all()) and len(toks) == 8
               and all(0 <= t < cfg.vocab_size for t in toks), "framefusion: logits finite, 8 tokens in the vocabulary")
    chk.expect(len(ev) > 0 and res.valid_len < 11648, "framefusion: the prompt was compressed")
    answer_d = pipes["dense"].ask(QUESTION, frames=frames, max_new_tokens=8)
    toks_d = [int(t) for t in answer_d.split()]
    log(f"  dense: tokens {toks_d}")
    chk.expect(bool(torch.isfinite(pipes["dense"].last_result.logits).all()) and len(toks_d) == 8,
               "dense: logits finite, 8 tokens")

    pre_all = pipes["framefusion"]._prepare_frames(frames)
    feats = llava_frontend.encode_video(vit, vcfg, proj, pre_all)
    t_enc = cuda_time_ms(lambda: llava_frontend.encode_video(vit, vcfg, proj, pre_all), iters=3, warmup=1)
    t_ff = cuda_time_ms(lambda: pipes["framefusion"].ask(QUESTION, frames=frames, max_new_tokens=8), iters=3, warmup=1)
    t_dense = cuda_time_ms(lambda: pipes["dense"].ask(QUESTION, frames=frames, max_new_tokens=8), iters=3, warmup=1)
    log(f"  encode ms (64 frames, preprocessed; CUDA events, mean of 3): {t_enc:.2f}")
    log(f"  pixels-to-answer ms (64 uint8 frames -> 8 tokens; CUDA events, mean of 3): framefusion {t_ff:.2f}, "
        f"dense {t_dense:.2f}, dense / framefusion {t_dense / t_ff:.3f}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The W8A8 tower: the tower's stacks become int8 pairs in place, so this runs last.
    siglip.quantize_tower_int8(vit)
    feats_q = llava_frontend.encode_video(vit, vcfg, proj, pre_all, w8a8=True)
    cos = torch.nn.functional.cosine_similarity(feats_q.float().flatten(), feats.float().flatten(), dim=0).item()
    t_enc_q = cuda_time_ms(lambda: llava_frontend.encode_video(vit, vcfg, proj, pre_all, w8a8=True),
                           iters=3, warmup=1)
    log(f"  W8A8 tower: encode {t_enc_q:.2f} ms (bf16 {t_enc:.2f}), cosine to the bf16 features {cos:.5f}")
    chk.expect(feats_q.shape == feats.shape and bool(torch.isfinite(feats_q).all()),
               "W8A8 tower: features finite, same shape")


# ---------------------------------------------------------------------------
# Phase 6b: the checkpoint entry point

# The hub's shard size (``max_shard_size="5GB"``).
CKPT_SHARD_BYTES = 5 * 10**9


def ckpt_model(cfg, vcfg, device):
    """Phase 6's seeded model: the decoder (seed 0), the SigLIP tower (seed
    1) and the projector (seed 2, bf16), drawn on ``device``."""
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import llava_frontend, siglip

    params = qwen2.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    vit = siglip.init_params(vcfg, torch.Generator(device=device).manual_seed(1))
    proj = llava_frontend.init_projector(torch.Generator(device=device).manual_seed(2), vcfg.hidden_size,
                                         cfg.hidden_size, dtype=torch.bfloat16)
    return params, vit, proj


def hub_tensors(cfg, vcfg, params, vit, proj) -> list:
    """``(HF name, view)`` of every tensor of a LLaVA-Video-7B-Qwen2
    (``LlavaQwenForCausalLM``) hub checkpoint holding ``params``, ``vit``
    and ``proj``, in HF's names and ``(out, in)`` layouts: the inverse of
    ``weights.params_from_state_dict``, ``siglip.params_from_hf`` and the
    ``mm_projector.{0,2}`` import, written out here on their own."""
    ly, out = params["layers"], [("model.embed_tokens.weight", params["embed"])]
    for l in range(cfg.num_layers):
        p = f"model.layers.{l}."
        out += [(p + "input_layernorm.weight", ly["ln1"][l]), (p + "post_attention_layernorm.weight", ly["ln2"][l])]
        for hf, ours in (("q", "q"), ("k", "k"), ("v", "v")):
            out += [(p + f"self_attn.{hf}_proj.weight", ly[f"w{ours}"][l].T),
                    (p + f"self_attn.{hf}_proj.bias", ly[f"b{ours}"][l])]
        out += [(p + "self_attn.o_proj.weight", ly["wo"][l].T), (p + "mlp.gate_proj.weight", ly["w_gate"][l].T),
                (p + "mlp.up_proj.weight", ly["w_up"][l].T), (p + "mlp.down_proj.weight", ly["w_down"][l].T)]
    out += [("model.norm.weight", params["final_norm"]), ("lm_head.weight", params["lm_head"].T)]
    vl, t = vit["layers"], "model.vision_tower.vision_tower.vision_model."
    out += [(t + "embeddings.patch_embedding.weight", vit["patch_kernel"].permute(3, 2, 0, 1)),
            (t + "embeddings.patch_embedding.bias", vit["patch_bias"]),
            (t + "embeddings.position_embedding.weight", vit["pos_embed"]),
            (t + "post_layernorm.weight", vit["post_ln_w"]), (t + "post_layernorm.bias", vit["post_ln_b"])]
    for l in range(vcfg.num_layers):
        p = f"{t}encoder.layers.{l}."
        out += [(p + "layer_norm1.weight", vl["ln1_w"][l]), (p + "layer_norm1.bias", vl["ln1_b"][l]),
                (p + "layer_norm2.weight", vl["ln2_w"][l]), (p + "layer_norm2.bias", vl["ln2_b"][l])]
        for hf, ours in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            out += [(p + f"self_attn.{hf}.weight", vl[f"w{ours}"][l].T), (p + f"self_attn.{hf}.bias", vl[f"b{ours}"][l])]
        out += [(p + "mlp.fc1.weight", vl["w_fc1"][l].T), (p + "mlp.fc1.bias", vl["b_fc1"][l]),
                (p + "mlp.fc2.weight", vl["w_fc2"][l].T), (p + "mlp.fc2.bias", vl["b_fc2"][l])]
    out += [("model.mm_projector.0.weight", proj["w1"].T), ("model.mm_projector.0.bias", proj["b1"]),
            ("model.mm_projector.2.weight", proj["w2"].T), ("model.mm_projector.2.bias", proj["b2"]),
            ("model.image_newline", proj["image_newline"])]
    return out


def hub_config(cfg, vcfg) -> dict:
    """config.json of a LLaVA-Video-7B-Qwen2 hub directory at ``cfg`` and
    ``vcfg``'s geometry, with a SigLIP ``vision_config``."""
    return {"architectures": ["LlavaQwenForCausalLM"], "model_type": "llava_qwen", "torch_dtype": "bfloat16",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": False,
            "vision_config": {"model_type": "siglip_vision_model", "image_size": vcfg.image_size,
                              "patch_size": vcfg.patch_size, "hidden_size": vcfg.hidden_size,
                              "intermediate_size": vcfg.intermediate_size,
                              "num_hidden_layers": vcfg.num_layers, "num_attention_heads": vcfg.num_heads}}


def write_hub_dir(path: str, config: dict, tensors: list, shard_bytes: int = CKPT_SHARD_BYTES) -> int:
    """Write ``tensors`` (``(name, tensor)``, any device) as bf16 safetensors
    shards of at most ``shard_bytes`` (a tensor larger than that gets a
    shard of its own), ``model.safetensors.index.json`` and ``config.json``
    into ``path``: the hub layout, with the safetensors format written out
    by hand (8-byte little-endian header length, the JSON header padded with
    spaces to 8 bytes, the raw bytes). One tensor at a time is on the host.
    Returns the tensors' bytes."""
    groups, size = [[]], 0
    for name, t in tensors:
        n = t.numel() * 2
        if groups[-1] and size + n > shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append((name, t))
        size += n
    weight_map, total = {}, 0
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name, t in group:
            header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [offset, offset + t.numel() * 2]}
            offset += t.numel() * 2
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            for name, t in group:
                f.write(t.to(torch.bfloat16).contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
                weight_map[name] = fname
        total += offset
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return total


def _proc_status_kib(field: str):
    """A ``/proc/self/status`` field in KiB (``VmHWM``, ``VmRSS``), or None
    where the file lacks it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def _leaf_checks(got, want, prefix: str = "") -> list:
    """``(name, equal)`` for each leaf of ``want``: ``got``'s leaf has its
    keys, dtype, shape and every bit."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [(f"{prefix} (keys {sorted(got) if isinstance(got, dict) else type(got)} vs {sorted(want)})",
                     False)]
        return [c for k in want for c in _leaf_checks(got[k], want[k], f"{prefix}/{k}")]
    same = (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)))
    return [(f"{prefix} ({got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})", same)]


def checkpoint_run(ckpt_dir: str, cfg, vcfg, n_frames: int = 64, device: str = "cuda") -> dict:
    """Phase 6b's measured half, run in a process of its own (so the load
    starts cold and ``VmHWM`` is its own): ``TextPipeline.from_checkpoint``
    of ``ckpt_dir`` in int8 under ``profiling.trace``, each loaded leaf against an in-memory twin of
    phase 6's seeded model (its decoder quantized on ``device`` by
    ``quantize_params_int8``, its projector in fp32), then ``ask`` on phase
    6's coherent frames through both (launches counted around the loaded
    pipeline's), then the loaded pipeline's pixels to answer timed.
    Returns what the parent checks and logs."""
    import shutil
    import tempfile

    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.interface import FAMILIES, FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.pipeline import TextPipeline
    from framefusion_tpu_torch.runtime import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.load(required=True)
    on_card = device == "cuda"
    out = {"rss_before_kib": _proc_status_kib("VmRSS")}
    trace_dir = tempfile.mkdtemp(prefix="ff_load_trace_")
    try:
        with profiling.trace(trace_dir):  # the trace is written out after the block, outside load_s
            t0 = time.perf_counter()
            pipe = TextPipeline.from_checkpoint(ckpt_dir, cost=0.3, quantize="int8", tokenizer=StubTokenizer(),
                                                device=device)
            if on_card:
                torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
        (trace_file,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # The load's stages are weights.load_checkpoint's framefusion.weights.*
    # spans; the host-to-card copies are the trace's device memcpy events.
    stages: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("framefusion.weights."):
            stages[e["name"]] = stages.get(e["name"], 0.0) + e["dur"] / 1e6
    upload_us = sum(e["dur"] for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    out.update(stages={k: round(v, 3) for k, v in stages.items()}, upload_s=upload_us / 1e6 if on_card else None,
               vm_hwm_kib=_proc_status_kib("VmHWM"), card_bytes=torch.cuda.memory_allocated() if on_card else None)
    import resource

    out["ru_maxrss_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    model = pipe.model
    out["family"], out["cfg_equal"] = model.family, (model.cfg == cfg, pipe.vit_cfg == vcfg)

    params, vit, proj = ckpt_model(cfg, vcfg, device)
    params = quantize_params_int8(params)
    proj = {k: v.float() for k, v in proj.items()}
    leaves = (_leaf_checks(model.params, params, "llm") + _leaf_checks(pipe.vit_params, vit, "tower")
              + _leaf_checks(pipe.projector, proj, "projector"))
    out["leaves"], out["leaf_diffs"] = len(leaves), [name for name, same in leaves if not same]

    twin = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params),
                             0.3, FAMILIES["llava_video"].default_similarity_lower_bound, 0.1)
    twin_pipe = TextPipeline(model=twin, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    frames = coherent_frames(np.random.default_rng(0), n_frames, 360, 480)
    wrappers = _all_wrappers()
    runs = {}
    for tag, p in (("loaded", pipe), ("twin", twin_pipe)):
        _zero_counts(wrappers)
        toks = [int(t) for t in p.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
        if on_card:
            torch.cuda.synchronize()
        res = p.last_result
        runs[tag] = dict(tokens=toks, events=_events(res), logits=res.logits.float().cpu(),
                         caches=[(k.cpu(), v.cpu(), n) for k, v, n in res.layer_caches],
                         mode=res.mode, valid_len=res.valid_len, launches=_ran(wrappers))
    a, b = runs["loaded"], runs["twin"]
    out.update(tokens=a["tokens"], twin_tokens=b["tokens"], events=a["events"], twin_events=b["events"],
               mode=a["mode"], valid_len=a["valid_len"], launches=a["launches"], twin_launches=b["launches"],
               logits_equal=torch.equal(a["logits"], b["logits"]),
               logits_finite=bool(torch.isfinite(a["logits"]).all()),
               logits_max_diff=float((a["logits"] - b["logits"]).abs().max()),
               caches_equal=len(a["caches"]) == len(b["caches"]) and all(
                   x[2] == y[2] and torch.equal(x[0][:x[2]], y[0][:y[2]]) and torch.equal(x[1][:x[2]], y[1][:y[2]])
                   for x, y in zip(a["caches"], b["caches"])),
               cache_lens=[c[2] for c in a["caches"]])
    del runs, twin_pipe, twin, params, vit
    if on_card:
        out["pixels_to_answer_ms"] = cuda_time_ms(lambda: pipe.ask(QUESTION, frames=frames, max_new_tokens=8),
                                                  iters=3, warmup=1)
        out["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_checkpoint(chk: Checks, kernels: dict, cfg=None, vcfg=None, n_frames: int = 64,
                     device: str = "cuda") -> None:
    """Phase 6b (module docstring): write phase 6's seeded model as a hub
    directory, then load it and answer in a process of its own."""
    import multiprocessing
    import shutil
    import tempfile

    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.models.vision import siglip

    cfg = cfg or qwen2_7b_config()
    vcfg = vcfg or siglip.ViTConfig(dtype=torch.bfloat16)
    room = shutil.disk_usage(tempfile.gettempdir()).free
    t0 = time.perf_counter()
    params, vit, proj = ckpt_model(cfg, vcfg, device)
    tensors = hub_tensors(cfg, vcfg, params, vit, proj)
    need = sum(t.numel() * 2 for _, t in tensors)
    log(f"  hub dir: {len(tensors)} tensors, {need / 1e9:.3f} GB in bf16; {room / 1e9:.1f} GB free under "
        f"{tempfile.gettempdir()}")
    chk.expect(room > need + 2 * 10**9, "checkpoint: the temporary directory's disk has room for the hub dir")
    if room <= need + 2 * 10**9:
        return
    ckpt_dir = tempfile.mkdtemp(prefix="ff_hub_")
    try:
        written = write_hub_dir(ckpt_dir, hub_config(cfg, vcfg), tensors)
        if device == "cuda":
            torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
        del params, vit, proj, tensors
        if device == "cuda":
            torch.cuda.empty_cache()
        shards = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
        log(f"  wrote {written / 1e9:.3f} GB in {len(shards)} shards in {t_write:.1f} s "
            f"({written / t_write / 1e9:.2f} GB/s; the seeded model drawn on the card first)")
        # A pool's exit terminates its worker without waiting for it, so a
        # load past its time limit cannot hold the hub dir's removal back.
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            r = pool.apply_async(checkpoint_run, (ckpt_dir, cfg, vcfg, n_frames, device)).get(timeout=900)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    chk.expect(not os.path.exists(ckpt_dir), "checkpoint: the hub dir is deleted")
    st = r["stages"]
    gib = 2**20
    read_s, llm_s, tower_s, up_s = (st.get("framefusion.weights.load_state"),
                                    st.get("framefusion.weights.import_decoder"),
                                    st.get("framefusion.weights.load_vision"), r["upload_s"])
    chk.expect(None not in (read_s, llm_s, tower_s), f"checkpoint: the trace of the load holds its three stages {st}")
    if None in (read_s, llm_s, tower_s):
        return
    host_s = None if up_s is None else llm_s + tower_s - up_s
    log(f"  from_checkpoint(int8): {r['load_s']:.2f} s: read (load_state) {read_s:.3f} s, decoder import, upload "
        f"and quantize on the card {llm_s:.2f} s, tower + projector {tower_s:.2f} s; host-to-card copies "
        f"{up_s if up_s is None else round(up_s, 3)} s (the trace's device time), so the rest (the host's reads "
        f"of the mapped pages, the card's casts and quantize) {host_s if host_s is None else round(host_s, 2)} s")
    peak, source = ((r["vm_hwm_kib"], "VmHWM") if r["vm_hwm_kib"] is not None
                    else (r["ru_maxrss_kib"], "ru_maxrss; /proc/self/status has no VmHWM here"))
    log(f"  host peak RSS of the loading process {peak / gib:.2f} GiB ({source}); RSS before the load "
        f"{r['rss_before_kib'] / gib:.2f} GiB; the checkpoint's mapped pages count once read")
    if r["card_bytes"] is not None:
        log(f"  card memory after the load {r['card_bytes'] / 2**30:.3f} GiB allocated; peak of the process "
            f"{r['card_peak_bytes'] / 2**30:.2f} GiB")
    chk.expect(r["family"] == "llava_video" and all(r["cfg_equal"]),
               f"checkpoint: family {r['family']}, LLM and tower configs equal the written ones {r['cfg_equal']}")
    chk.expect(not r["leaf_diffs"], f"checkpoint: all {r['leaves']} loaded leaves equal the in-memory twin's bit for "
                                    f"bit (the int8 decoder quantized a layer at a time on load vs by "
                                    f"quantize_params_int8; differ: {r['leaf_diffs'][:8]})")
    log(f"  ask: mode {r['mode']}, events {r['events']}, final length {r['valid_len']}, tokens {r['tokens']}")
    chk.expect(r["events"] == r["twin_events"] and r["caches_equal"],
               "checkpoint: merge events, each layer's cached keys and values (the keep sets) and the prune's "
               "size equal the twin's")
    chk.expect(r["logits_equal"], f"checkpoint: first-token logits equal the twin's bit for bit "
                                  f"(max diff {r['logits_max_diff']:.3e})")
    chk.expect(r["tokens"] == r["twin_tokens"], f"checkpoint: greedy tokens equal the twin's ({r['twin_tokens']})")
    chk.expect(r["logits_finite"] and len(r["tokens"]) == 8 and len(r["events"]) > 0,
               "checkpoint: logits finite, 8 tokens, the prompt compressed")
    pruned = any(e[1] == "prune" for e in r["events"])
    log(f"  launches on the loaded pipeline's ask: {r['launches']} (the twin's: {r['twin_launches']}); "
        f"the prompt {'prunes' if pruned else 'does not prune: kernel B is not on this path'}")
    for name, n in r["launches"].items():
        if name == "sink_attn_fwd" or (name == "attn_importance_rows" and not pruned):
            continue
        chk.expect(n > 0, f"checkpoint: {name}: {n} launches on the loaded pipeline's ask")
        if name in kernels:
            kernels[name]["checkpoint_launches"] = n
    if "pixels_to_answer_ms" in r:
        log(f"  pixels-to-answer ms through the loaded int8 pipeline (64 uint8 frames -> 8 tokens; CUDA events, "
            f"mean of 3): {r['pixels_to_answer_ms']:.2f}")


def baseline_methods(n_layers: int) -> dict:
    """The paper's comparison methods with ``scripts/example_baselines.py``'s
    settings: name -> (replace_forward mode, its keyword arguments)."""
    return {
        "fastv": ("fastv", dict(fastv_k=3, fastv_r=0.5)),
        "streamingllm": ("streamingllm", dict(init_num=8, length_rate=0.3)),
        "prefill_merge": ("prefill_merge", dict(sparsity=[0.1] * n_layers)),
        "merge_then_fastv": ("merge_then_fastv", dict(sparsity=[0.1] * n_layers, fastv_k=3, fastv_r=0.5)),
        "fastv_then_merge": ("fastv_then_merge", dict(fastv_k=2, fastv_r=0.75, merging_sparsity=0.3)),
        "streamingllm_sink_decode": ("streamingllm", dict(init_num=8, length_rate=0.3, sink_cache_decode=True)),
    }


def readout_params(cfg, seed: int, resid_scale: float) -> dict:
    """``numpy_params`` with a decisive readout: embeddings of unit scale, an
    LM head whose column j is embedding perm[j] (so a token's successor is
    fixed, by a logit margin of over half the largest logit), and blocks
    that write to the residual stream at ``resid_scale``. Greedy tokens then
    survive any bf16 rounding, while attention and compression still move
    the logits by far more than the bf16 bound."""
    tree = numpy_params(cfg, seed=seed, scale=0.05)
    tree["embed"] *= np.float32(20.0)
    perm = np.random.default_rng(seed + 1).permutation(cfg.vocab_size)
    tree["lm_head"] = np.ascontiguousarray(tree["embed"][perm].T) / np.float32(20.0)
    for name in ("wo", "w_down"):
        tree["layers"][name] *= np.float32(resid_scale / 0.05)
    return tree


def tiny_baselines_run(device: str, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every baseline method through replace_forward + generate(8) on the
    tiny geometry of phase 3 with ``readout_params`` weights, on a 331-token
    prompt (40 frames x 8 patches, ending in a vocabulary token) whose merges
    and prunes cross bucket bounds. Returns name -> (events, cache lengths,
    tokens, prefill logits fp32 on the CPU, the sink-cache decode's last
    logits fp32 on the CPU or None), and the number of kernel F launches
    under "F"."""
    from framefusion_tpu_torch.baselines import replace_forward
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=dtype)
    tree = readout_params(cfg, seed=0, resid_scale=0.03)
    params = _cast_floats(qwen2.params_from_numpy(tree, device), dtype)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=40,
                                                 patch_num=8, n_pre=6, n_post=5)
    h[-1] = tree["embed"][7]
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h), patch_type=pt, position_ids=np.arange(len(pt)),
                           patch_num=8, image_token_start=img_start, image_token_length=n_img)
    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params, attn_impl="flash")
    launches = sp.sink_attn_fwd.launches
    out = {}
    for name, (mode, kw) in baseline_methods(cfg.num_layers).items():
        m = replace_forward(model, mode, **kw)
        toks, res = m.generate(inputs, max_new_tokens=8)
        decode_logits = m.engine().sink_cache_decode(res, 8)[1].float().cpu() if kw.get("sink_cache_decode") else None
        out[name] = ([(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
                     [c[2] for c in res.layer_caches], toks, res.logits.float().cpu(), decode_logits)
    out["F"] = sp.sink_attn_fwd.launches - launches
    return out


# -- Qwen2-VL (phases 5b and 11) ---------------------------------------------------------

# Qwen2-VL-7B's video geometry at 64 frames of 360 x 480: smart_resize (factor
# 28) gives 364 x 476, a grid of (32, 26, 34) patches, 221 merged patches a
# temporal frame and 7,072 video tokens; kernel E runs B = 32, N = 884.
QWEN2VL_GRID = (32, 26, 34)
QWEN2VL_E_SHAPE = (32, 884, 16, 80)
# The published FrameFusion knobs for Qwen2-VL: cost 0.3, S_th 0.5, r_min 0.1.
QWEN2VL_KNOBS = (0.3, 0.5, 0.1)
# Phase 11's coherent prompt (7,121 tokens) keeps 4,025 live tokens after its
# layer -1 merge, in the 4,096 bucket: the length kernel B prunes at, which
# phase 2 times and phase 11 checks against the launches it logs.
QWEN2VL_PHASE_S, QWEN2VL_PHASE_LIVE = 4096, 4025


def numpy_qwen2vl_vit_params(vcfg, seed: int, scale: float, resid_scale: float) -> dict:
    """Random Qwen2-VL tower weights in the JAX package's pytree layout, drawn
    with numpy; the blocks write to the residual stream at ``resid_scale``."""
    rng = np.random.default_rng(seed)
    n_l, d, i, mu = vcfg.depth, vcfg.embed_dim, vcfg.mlp_hidden, vcfg.merge_unit

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": np.ones((n_l, d), np.float32), "ln1_b": norm(n_l, d),
              "ln2_w": np.ones((n_l, d), np.float32), "ln2_b": norm(n_l, d),
              "w_qkv": norm(n_l, d, 3 * d), "b_qkv": norm(n_l, 3 * d), "wo": norm(n_l, d, d), "bo": norm(n_l, d),
              "w_fc1": norm(n_l, d, i), "b_fc1": norm(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": norm(n_l, d)}
    for name in ("wo", "bo", "w_fc2", "b_fc2"):
        layers[name] *= np.float32(resid_scale / scale)
    return {"patch_proj": norm(vcfg.patch_dim, d), "layers": layers,
            "merger_ln_w": np.ones(d, np.float32), "merger_ln_b": np.zeros(d, np.float32),
            "merger_w0": norm(mu * d, mu * d), "merger_b0": np.zeros(mu * d, np.float32),
            "merger_w1": norm(mu * d, vcfg.hidden_size), "merger_b1": np.zeros(vcfg.hidden_size, np.float32)}


def tiny_qwen2vl_run(device: str, dtype: torch.dtype):
    """The tiny Qwen2-VL pixels-to-answer run of phase 5b on one device: a
    tower of head dim 80 (embed 160, 2 heads, depth 2) and a 6-layer mRoPE
    LLM, weights drawn with numpy (``readout_params``: each token has one
    clear successor, so the tokens survive bf16 rounding and the logits
    bound is the check that can fail), through TextPipeline.ask on uint8
    frames. Returns (tower features fp32 on the CPU, events, cache lengths,
    decode base, tokens, E launches, B launches, prefill logits fp32 on the
    CPU)."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import qwen2_vl_vit
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.pipeline import TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          mrope_section=(16, 24, 24), dtype=dtype)
    vcfg = qwen2_vl_vit.Qwen2VLViTConfig(embed_dim=160, depth=2, num_heads=2, mlp_ratio=2.0,
                                         hidden_size=cfg.hidden_size, dtype=dtype)  # head dim 80, as 7B's
    params = _cast_floats(qwen2.params_from_numpy(readout_params(cfg, seed=0, resid_scale=0.03), device), dtype)
    vit = _cast_floats(qwen2.params_from_numpy(numpy_qwen2vl_vit_params(vcfg, seed=1, scale=0.05,
                                                                        resid_scale=0.005), device), dtype)
    model = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params, attn_impl="flash"),
                              0.3, 0.95, 0.1)
    model.ff = model.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    frames = half_static_frames(np.random.default_rng(7), 12, 112, 140)
    patches, grid = qwen2_vl_vit.pixels_to_patches(pipe._prepare_frames(frames), vcfg)
    launches = ba.bidir_attn_fwd.launches, fp.attn_importance_rows.launches
    feats = qwen2_vl_vit.encode_video(vit, patches, *grid, vcfg)
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    res = pipe.last_result
    return (feats.float().cpu(), [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
            [c[2] for c in res.layer_caches], res.decode_pos_base, toks,
            ba.bidir_attn_fwd.launches - launches[0], fp.attn_importance_rows.launches - launches[1],
            res.logits.float().cpu())


def phase_cross_qwen2vl(chk: Checks) -> None:
    cpu = tiny_qwen2vl_run("cpu", torch.bfloat16)
    gpu = tiny_qwen2vl_run("cuda", torch.bfloat16)
    rel = float((cpu[0] - gpu[0]).abs().max() / cpu[0].abs().max())
    log(f"  cpu events {cpu[1]} decode base {cpu[3]} tokens {cpu[4]}; cuda events {gpu[1]} decode base {gpu[3]} "
        f"tokens {gpu[4]}")
    chk.expect(rel <= FEATURE_RTOL, f"cross qwen2vl: tower features (head dim 80) differ by {rel:.3e} of their "
                                    f"largest <= {FEATURE_RTOL}")
    rel = float((cpu[7] - gpu[7]).abs().max() / cpu[7].abs().max())
    chk.expect(rel <= LOGIT_RTOL, f"cross qwen2vl: prefill logits differ by {rel:.3e} of their largest <= {LOGIT_RTOL}")
    chk.expect(cpu[1:4] == gpu[1:4], "cross qwen2vl: events, cache lengths and decode base equal")
    chk.expect(cpu[4] == gpu[4], "cross qwen2vl: greedy tokens equal")
    chk.expect(len(set(gpu[4])) >= 3, f"cross qwen2vl: the tokens vary ({len(set(gpu[4]))} distinct of 8)")
    chk.expect(any(e[1] == "prune" for e in cpu[1]), f"cross qwen2vl: the scenario merges and prunes ({cpu[1]})")
    chk.expect(cpu[5] == cpu[6] == 0 and gpu[5] > 0 and gpu[6] > 0,
               f"cross qwen2vl: kernels E and B launched on the card only (E {gpu[5]}, B {gpu[6]} launches)")


def qwen2vl_coherent_prompt(embed_rows: np.ndarray):
    """The LLM-only Qwen2-VL prompt of phase 11: ``build_video_prompt``'s
    coherent synthetic video (0.45 of the patches resemble the previous
    frame's) at the 32 x 221 layout, spliced by the port's Qwen2-VL adapter
    between 35 and 14 text rows (``embed_rows``: (50, hidden), the last one
    the placeholder). Returns PrefillInputs with (3, S) mRoPE positions."""
    from framefusion_tpu_torch.models.adapters import qwen2_vl
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt

    grid_t, grid_h, grid_w = QWEN2VL_GRID
    patch_num = grid_h * grid_w // 4
    h, _, n_pre, n_img = build_video_prompt(np.random.default_rng(11), embed_rows.shape[1], n_frames=grid_t,
                                            patch_num=patch_num, n_pre=35, n_post=14, coherent=0.45)
    text = np.concatenate([embed_rows[:35], embed_rows[-1:], embed_rows[35:49]])
    return qwen2_vl.build_prefill_inputs(text, h[n_pre:n_pre + n_img], n_pre, grid_t, grid_h, grid_w)


def phase_qwen2vl(chk: Checks, kernels: dict, ctx: dict) -> None:
    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.config import qwen2_vl_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import qwen2_vl_vit
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.parallel.workers import CallLog
    from framefusion_tpu_torch.pipeline import TextPipeline
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    ctx.clear()  # phase 10's model and pools
    torch.cuda.empty_cache()
    native.load(required=True)
    cfg = qwen2_vl_7b_config()  # Qwen2-7B's decoder with mRoPE t16 / h24 / w24
    vcfg = qwen2_vl_vit.Qwen2VLViTConfig(dtype=torch.bfloat16)  # depth 32, embed 1280, 16 heads of 80
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))  # phase 4's weights
    vit = qwen2_vl_vit.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    log(f"  random Qwen2-VL-7B: LLM (phase 4's weights) and tower "
        f"({sum(t.numel() for t in vit['layers'].values()) / 1e6:.0f} M tower block params) in "
        f"{time.perf_counter() - t0:.1f} s")
    model = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params,
                                               vision={"kind": "qwen2_vl_vit", "cfg": vcfg, "params": vit}),
                              *QWEN2VL_KNOBS)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    frames = coherent_frames(np.random.default_rng(0), 64, 360, 480)
    pre = pipe._prepare_frames(frames)
    patches, grid = qwen2_vl_vit.pixels_to_patches(pre, vcfg)
    chk.expect(pre.shape == (64, 364, 476, 3) and grid == QWEN2VL_GRID,
               f"qwen2vl: 64 frames 360x480 -> smart_resize {pre.shape[1:3]}, grid {grid}")

    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "bidir_attn_fwd": ba.bidir_attn_fwd,
                "ragged_decode_attn": da.ragged_decode_attn}
    _zero_counts(wrappers)
    answer = pipe.ask(QUESTION, frames=frames, max_new_tokens=8)
    torch.cuda.synchronize()
    counts = _ran(wrappers)
    res = pipe.last_result
    inputs = pipe.build_inputs(QUESTION, frames=frames)
    toks = [int(t) for t in answer.split()]
    ev = [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]
    log(f"  pixels to answer: launches {counts}; events {ev}, final length {res.valid_len} of "
        f"{inputs.input_embeds.shape[0]}, decode base {res.decode_pos_base}, tokens {toks}")
    chk.expect(inputs.image_token_length == 7072 and inputs.patch_num == 221 and res.pos_dims == 3,
               f"qwen2vl: {inputs.image_token_length} video tokens (32 x 221) of {inputs.input_embeds.shape[0]}, "
               f"(3, S) positions")
    chk.expect(res.decode_pos_base == int(inputs.position_ids.max()) + 1,
               f"qwen2vl: decode base {res.decode_pos_base} = max(positions) + 1")
    chk.expect(counts["bidir_attn_fwd"] == vcfg.depth,
               f"qwen2vl: kernel E launched once a tower layer ({counts['bidir_attn_fwd']} of {vcfg.depth})")
    for name in ("flash_attn_fwd", "gemv_stacked", "gemv_gateup", "ragged_decode_attn"):
        chk.expect(counts[name] > 0, f"qwen2vl: {name}: {counts[name]} launches in the pixels-to-answer run")
    if not any(e[1] == "prune" for e in ev):
        log(f"  attn_importance_rows: {counts['attn_importance_rows']} launches (the random tower's video "
            f"prunes nothing: kernel B runs on the coherent prompt below)")
    chk.expect(bool(torch.isfinite(res.logits).all()) and len(toks) == 8
               and all(0 <= t < cfg.vocab_size for t in toks), "qwen2vl: logits finite, 8 tokens in the vocabulary")
    _set_launches(_shape_entry(kernels["bidir_attn_fwd"], "qwen2vl"), counts["bidir_attn_fwd"])

    t_enc = cuda_time_ms(lambda: qwen2_vl_vit.encode_video(vit, patches, *grid, vcfg), iters=2, warmup=1)
    eng = model.engine()
    args = (inputs.input_embeds, inputs.patch_type, inputs.position_ids, inputs.patch_num,
            inputs.image_token_start, inputs.image_token_length)
    t_pre = {mode: cuda_time_ms(lambda mode=mode: eng.prefill(*args, mode=mode), iters=2, warmup=1)
             for mode in ("fused", "planned", "dense")}
    t_p2a = cuda_time_ms(lambda: pipe.ask(QUESTION, frames=frames, max_new_tokens=8), iters=2, warmup=1)
    log(f"  encode ms (64 preprocessed frames, 28,288 patches; CUDA events, mean of 2): {t_enc:.2f}")
    log(f"  prefill ms at {inputs.input_embeds.shape[0]} tokens (mean of 2): fused {t_pre['fused']:.2f}, planned "
        f"{t_pre['planned']:.2f}, dense {t_pre['dense']:.2f}, dense / fused {t_pre['dense'] / t_pre['fused']:.3f}")
    log(f"  pixels-to-answer ms (64 uint8 frames -> 8 tokens, bf16; mean of 2): {t_p2a:.2f}")

    # The LLM alone on a coherent synthetic video of the same layout: it
    # must prune, with kernel B at Qwen2-VL's 4 capture rows.
    embed_rows = qwen2.embed(params, torch.arange(100, 150, device="cuda")).float().cpu().numpy()
    inp_c = qwen2vl_coherent_prompt(embed_rows)
    args_c = (inp_c.input_embeds, inp_c.patch_type, inp_c.position_ids, inp_c.patch_num, inp_c.image_token_start,
              inp_c.image_token_length)
    b_log = CallLog(fp, {"flash_causal_attention_importance":
                         lambda q, k, v, valid_len, num, key_valid=None: (num, q.shape[0])})
    _zero_counts(wrappers)
    with b_log:
        res_c = eng.prefill(*args_c, mode="fused")
        torch.cuda.synchronize()
    counts_c = _ran(wrappers)
    ev_c = [(e.layer, e.kind, e.tokens_removed) for e in res_c.telemetry.events]
    b_rows = b_log.counts()
    phase_s = _shape_entry(kernels["attn_importance_rows"], "qwen2vl")["S"]
    log(f"  coherent prompt ({len(inp_c.patch_type)} tokens): events {ev_c}, buckets "
        f"{[e.bucket for e in res_c.telemetry.events]}, final length {res_c.valid_len}; kernel B calls by "
        f"(capture rows, S) {b_rows}; launches {counts_c}")
    chk.expect(any(e[1] == "prune" for e in ev_c), "qwen2vl coherent prompt: the prefill prunes")
    chk.expect(counts_c["attn_importance_rows"] >= 1 and all(num == 4 for num, _ in b_rows)
               and sum(b_rows.values()) == counts_c["attn_importance_rows"],
               f"qwen2vl coherent prompt: kernel B launched with 4 capture rows ({b_rows})")
    first_prune = next((i for i, e in enumerate(ev_c) if e[1] == "prune"), len(ev_c))
    live = len(inp_c.patch_type) - sum(e[2] for e in ev_c[:first_prune])
    chk.expect(all(s == phase_s for _, s in b_rows) and live == QWEN2VL_PHASE_LIVE,
               f"qwen2vl coherent prompt: kernel B ran at the phase length ({phase_s}) and live tokens "
               f"({live}) phase 2 timed it at")
    _set_launches(_shape_entry(kernels["attn_importance_rows"], "qwen2vl"), counts_c["attn_importance_rows"])
    res_cp = eng.prefill(*args_c, mode="planned")
    chk.expect([(e.layer, e.kind, e.tokens_removed) for e in res_cp.telemetry.events] == ev_c
               and res_cp.mode == "planned", f"qwen2vl coherent prompt: planned ({res_cp.mode}) makes fused's events")
    t_c = cuda_time_ms(lambda: eng.prefill(*args_c, mode="fused"), iters=2, warmup=1)
    t_cd = cuda_time_ms(lambda: eng.prefill(*args_c, mode="dense"), iters=2, warmup=1)
    log(f"  coherent prompt prefill ms (mean of 2): fused {t_c:.2f}, dense {t_cd:.2f}, dense / fused "
        f"{t_cd / t_c:.3f}")

    # Weight-only int8 decode of 8 tokens as the captured graph, at the
    # mRoPE decode base: the layer weights become int8 pairs in place.
    ff = eng.ff
    del eng, pipe, model
    params_q = quantize_params_int8(params)
    eng_q = CompressionEngine(params_q, cfg, ff)
    _zero_counts(wrappers)
    toks_q = eng_q.generate(res_c, 8)
    torch.cuda.synchronize()
    counts_q = _ran(wrappers)
    t_gen = cuda_time_ms(lambda: eng_q.generate(res_c, 8), iters=2, warmup=1)
    log(f"  int8 decode graph at base {res_c.decode_pos_base}: tokens {toks_q}, launches {counts_q}, "
        f"generate(8) {t_gen:.2f} ms")
    chk.expect(res_c.decode_pos_base == int(inp_c.position_ids.max()) + 1 and len(toks_q) == 8
               and all(0 <= t < cfg.vocab_size for t in toks_q)
               and all(counts_q[n] > 0 for n in ("gemv_stacked", "gemv_gateup", "ragged_decode_attn")),
               "qwen2vl: int8 decode graph (C, D, G) from max(positions) + 1, 8 tokens in the vocabulary")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# -- InternVL (phases 5c and 12) --------------------------------------------------------

# InternVL2.5-8B at 64 frames: InternViT-300M encodes each 448 x 448 frame
# as 1,024 patches + CLS (kernel E at B = 64, N = 1,025, 16 heads of 64) and
# the pixel shuffle leaves 256 tokens a frame; the published FrameFusion
# knobs (cost 0.3, S_th 0.5, r_min 0.1).
INTERNVL_FRAMES = 64
INTERNVL_E_SHAPE = (INTERNVL_FRAMES, 1025, 16, 64)
INTERNVL_KNOBS = (0.3, 0.5, 0.1)
# * The cross-device InternVL run also holds layer 0's cached keys (the
#   tokens the layer -1 merge kept, in order: the keep set itself, as the
#   CPU tests hold it) to LOGIT_RTOL of the largest: a token kept on one
#   device and not the other would differ by O(1); a bf16 run's keys differ
#   from its fp32 run's by 7.4e-3 on the CPU. The prune's keep set is
#   held by its size (events, cache lengths) and the logits bound: near
#   the cut the random model's importances lie closer together than two
#   bf16 runs move them (``tiny_internvl_run`` on the CPU, bf16 against
#   fp32, keeps other near-tied tokens), so which of those it keeps is
#   rounding.


def numpy_internvit_params(vcfg, seed: int, scale: float, resid_scale: float) -> dict:
    """Random InternViT weights (qkv bias, no qk norm, layer scales of 1) in
    the port's pytree layout, drawn with numpy; the blocks write to the
    residual stream at ``resid_scale``."""
    rng = np.random.default_rng(seed)
    n_l, d, i = vcfg.num_layers, vcfg.hidden_size, vcfg.intermediate_size

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": np.ones((n_l, d), np.float32), "ln1_b": norm(n_l, d),
              "ln2_w": np.ones((n_l, d), np.float32), "ln2_b": norm(n_l, d),
              "wq": norm(n_l, d, d), "bq": norm(n_l, d), "wk": norm(n_l, d, d), "bk": norm(n_l, d),
              "wv": norm(n_l, d, d), "bv": norm(n_l, d), "wo": norm(n_l, d, d), "bo": norm(n_l, d),
              "w_fc1": norm(n_l, d, i), "b_fc1": norm(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": norm(n_l, d),
              "lambda1": np.ones((n_l, d), np.float32), "lambda2": np.ones((n_l, d), np.float32)}
    for name in ("wo", "bo", "w_fc2", "b_fc2"):
        layers[name] *= np.float32(resid_scale / scale)
    return {"patch_kernel": norm(vcfg.patch_size, vcfg.patch_size, 3, d), "patch_bias": norm(d),
            "cls_token": norm(d), "pos_embed": norm(vcfg.num_patches + 1, d), "layers": layers}


def numpy_internvl_projector(vcfg, seed: int, scale: float) -> dict:
    """Random ``mlp1`` projector (LayerNorm, Linear, GELU, Linear) drawn with numpy."""
    rng = np.random.default_rng(seed)
    din, t = vcfg.hidden_size * vcfg.shuffle_unit, vcfg.text_hidden_size
    return {"ln_w": np.ones(din, np.float32), "ln_b": np.zeros(din, np.float32),
            "w1": rng.standard_normal((din, t), dtype=np.float32) * np.float32(scale), "b1": np.zeros(t, np.float32),
            "w2": rng.standard_normal((t, t), dtype=np.float32) * np.float32(scale), "b2": np.zeros(t, np.float32)}


def tiny_internvl_run(device: str, dtype: torch.dtype) -> dict:
    """The tiny InternVL pixels-to-answer run of phase 5c on one device: an
    InternViT of head dim 64 (hidden 128, 2 heads, depth 2; 8 x 8 patches +
    CLS, so N = 65 is one past a key tile) and a 6-layer LLM with InternLM2's
    attention (no qkv bias, 8 query heads over 2 KV heads: groups of 4),
    weights drawn with numpy (``readout_params``), through TextPipeline.ask
    on 12 uint8 frames (the interleaved ``FrameN: <image>`` prompt). Returns
    the features, events, cache lengths, tokens, prefill logits and layer
    0's cached keys (fp32 on the CPU), and E's and B's launches."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import internvl_vit
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.pipeline import TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=1024, intermediate_size=2048, num_heads=8, num_kv_heads=2,
                          qkv_bias=False, dtype=dtype)
    vcfg = internvl_vit.tiny_internvit_config(image_size=56, hidden_size=128, intermediate_size=256, num_heads=2,
                                              attention_bias=True, text_hidden_size=cfg.hidden_size, dtype=dtype)
    params = _cast_floats(qwen2.params_from_numpy(readout_params(cfg, seed=0, resid_scale=0.03), device), dtype)
    vit = _cast_floats(qwen2.params_from_numpy(numpy_internvit_params(vcfg, seed=1, scale=0.05, resid_scale=0.005),
                                               device), dtype)
    proj = _cast_floats(qwen2.params_from_numpy(numpy_internvl_projector(vcfg, seed=2, scale=0.05), device), dtype)
    model = apply_framefusion(FrameFusionModel(family="internvl", cfg=cfg, params=params, attn_impl="flash"),
                              0.3, 0.95, 0.1)
    model.ff = model.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    frames = half_static_frames(np.random.default_rng(8), 12, 112, 140)
    launches = ba.bidir_attn_fwd.launches, fp.attn_importance_rows.launches
    feats = internvl_vit.extract_features(vit, proj, pipe._prepare_frames(frames), vcfg)
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    res = pipe.last_result
    k0, _, n0 = res.layer_caches[0]
    return dict(feats=feats.float().cpu(), events=[(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
                lens=[c[2] for c in res.layer_caches], tokens=toks, logits=res.logits.float().cpu(),
                keys=k0[:n0].float().cpu(), e=ba.bidir_attn_fwd.launches - launches[0],
                b=fp.attn_importance_rows.launches - launches[1])


def phase_cross_internvl(chk: Checks) -> None:
    cpu = tiny_internvl_run("cpu", torch.bfloat16)
    gpu = tiny_internvl_run("cuda", torch.bfloat16)
    log(f"  cpu events {cpu['events']} tokens {cpu['tokens']}; cuda events {gpu['events']} tokens {gpu['tokens']}")
    for what, label, bound in (("feats", "tower features (head dim 64)", FEATURE_RTOL),
                               ("logits", "prefill logits", LOGIT_RTOL),
                               ("keys", "layer 0's cached keys (the merge's keep set, in order)", LOGIT_RTOL)):
        same = cpu[what].shape == gpu[what].shape
        rel = float((cpu[what] - gpu[what]).abs().max() / cpu[what].abs().max()) if same else math.inf
        chk.expect(rel <= bound, f"cross internvl: {label} differ by {rel:.3e} of their largest <= {bound}")
    chk.expect(cpu["events"] == gpu["events"] and cpu["lens"] == gpu["lens"],
               "cross internvl: events and cache lengths equal")
    chk.expect(cpu["tokens"] == gpu["tokens"], "cross internvl: greedy tokens equal")
    chk.expect(len(set(gpu["tokens"])) >= 3, f"cross internvl: the tokens vary ({len(set(gpu['tokens']))} distinct of 8)")
    chk.expect(any(e[1] == "prune" for e in cpu["events"]),
               f"cross internvl: the scenario merges and prunes ({cpu['events']})")
    chk.expect(cpu["e"] == cpu["b"] == 0 and gpu["e"] > 0 and gpu["b"] > 0,
               f"cross internvl: kernels E and B launched on the card only (E {gpu['e']}, B {gpu['b']} launches)")


def _events(res) -> list:
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def phase_internvl(chk: Checks, kernels: dict, ctx: dict) -> None:
    """InternVL2.5-8B at full width, pixels to answer, then the LLM on a
    coherent prompt of the same interleaved layout, the int8 decode graph,
    and the kernel rows at the shapes these runs gave each kernel."""
    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.config import internlm2_8b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.models.vision import internvl_vit
    from framefusion_tpu_torch.pipeline import TextPipeline

    ctx.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native.load(required=True)
    cfg = internlm2_8b_config()  # InternLM2.5-7B: 32 layers, hidden 4096, 32 / 8 heads, no qkv bias
    vcfg = internvl_vit.internvit_300m_config(dtype=torch.bfloat16)  # 24 layers, 1024 wide, 16 heads of 64
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    vit = internvl_vit.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    proj = internvl_vit.init_projector(vcfg, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    log(f"  random InternVL2.5-8B: InternLM2.5-7B ({sum(t.numel() for t in params['layers'].values()) / 1e9:.2f} B "
        f"block params), InternViT-300M and mlp1 on the card in {time.perf_counter() - t0:.1f} s")
    model = apply_framefusion(FrameFusionModel(family="internvl", cfg=cfg, params=params,
                                               vision={"kind": "internvl_vit", "cfg": vcfg, "params": vit,
                                                       "projector": proj}), *INTERNVL_KNOBS)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    del model, params
    n_img = INTERNVL_FRAMES * vcfg.tokens_per_image

    def check_inputs(inputs):
        s_prompt = int(inputs.input_embeds.shape[0])
        return (inputs.patch_num == 256 and int((inputs.patch_type >= 0).sum()) == n_img
                and n_img < inputs.image_token_length < s_prompt and inputs.num_importance_queries == 1,
                f"{n_img} image tokens (64 x 256) in a span of {inputs.image_token_length} (the frame labels "
                f"inside it) of {s_prompt}, 1 importance row")

    # The LLM alone on a coherent synthetic video spliced into the same
    # interleaved prompt (0.45 of each frame's tokens resemble the previous
    # frame's): it must prune, with kernel B at one capture row and 32 / 8
    # heads over a window holding the frame labels.
    h, _, _, _ = build_video_prompt(np.random.default_rng(12), cfg.hidden_size, n_frames=INTERNVL_FRAMES,
                                    patch_num=vcfg.tokens_per_image, n_pre=0, n_post=0, coherent=0.45)
    _family_phase(chk, kernels, tag="internvl", pipe=pipe, frames=coherent_frames(np.random.default_rng(0),
                                                                                  INTERNVL_FRAMES, 360, 480),
                  pre_shape=(INTERNVL_FRAMES, 448, 448, 3),
                  encode=lambda px: internvl_vit.extract_features(vit, proj, px, vcfg),
                  encode_label="64 preprocessed frames, 65,600 tower tokens, pixel shuffle and mlp1",
                  e_shape=INTERNVL_E_SHAPE, e_launches=vcfg.num_layers, e_label="once a tower layer",
                  check_inputs=check_inputs,
                  coherent=dict(video_features=torch.from_numpy(h).reshape(INTERNVL_FRAMES, -1, h.shape[1])))


def _family_phase(chk: Checks, kernels: dict, *, tag: str, pipe, frames, pre_shape: tuple, encode,
                  encode_label: str, e_shape: tuple, e_launches: int, e_label: str, check_inputs,
                  coherent: dict) -> dict:
    """One family at full width through ``pipe`` (its model on the card,
    FrameFusion applied), as phases 12-16 run it: pixels to answer (8
    greedy tokens, the bf16 decode graph) with the launches of A-G counted
    around it (E ``e_launches`` times), the prompt held by
    ``check_inputs(inputs) -> (ok, text)``; encode (``encode(pixels on the
    card)``), fused / planned / dense prefill and pixels-to-answer ms and
    the device idle share; then the LLM on the ``coherent`` video features
    (``build_inputs``' keyword arguments) spliced into the family's prompt,
    which must prune with kernel B at the family's capture rows, its events
    equal through the planned and segmented executors; the int8 decode
    graph's ms/step beside its weight-stream floor; last, each kernel
    against its plain version at the shapes these runs gave it, with the
    launches counted here (entries with ``"path": tag``). The model's
    weights are quantized in place and then dropped: the phase ends with
    the model gone. Returns the encode ms and E's row."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.core import bucket_length
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.parallel.workers import CallLog
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = pipe.model.cfg
    pre = pipe._prepare_frames(frames)
    chk.expect(pre.shape == pre_shape, f"{tag}: {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]} -> "
                                       f"{pre.shape[1:3]}")
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "bidir_attn_fwd": ba.bidir_attn_fwd,
                "ragged_decode_attn": da.ragged_decode_attn}
    a_keys: dict = {}  # kernel A's launches by (S, key_valid given), over every prefill of this phase
    _zero_counts(wrappers)
    with _a_log(fp) as a_log, _c_log(mv) as bf16_log:
        answer = pipe.ask(QUESTION, frames=frames, max_new_tokens=8)  # the bf16 decode graph, captured here
        torch.cuda.synchronize()
    counts = _ran(wrappers)
    c_counts = {"bf16": bf16_log.counts(DecodeGraph.replays)}  # kernel C's launches by (K, widths)
    d_counts = {"bf16": counts["gemv_gateup"]}
    for key, n in a_log.counts().items():
        a_keys[key] = a_keys.get(key, 0) + n
    res = pipe.last_result
    inputs = pipe.build_inputs(QUESTION, frames=frames)
    s_prompt = int(inputs.input_embeds.shape[0])
    toks = [int(t) for t in answer.split()]
    ev = _events(res)
    log(f"  pixels to answer: launches {counts}; kernel A by (S, mask) {a_log.counts()}; events {ev}, final length "
        f"{res.valid_len} of {s_prompt}, tokens {toks}")
    ok, text = check_inputs(inputs)
    chk.expect(ok, f"{tag}: {text}")
    chk.expect(counts["bidir_attn_fwd"] == e_launches,
               f"{tag}: kernel E launched {e_label} ({counts['bidir_attn_fwd']} of {e_launches})")
    for name in ("flash_attn_fwd", "gemv_stacked", "gemv_gateup", "ragged_decode_attn"):
        chk.expect(counts[name] > 0, f"{tag}: {name}: {counts[name]} launches in the pixels-to-answer run")
    if not any(e[1] == "prune" for e in ev):
        log(f"  attn_importance_rows: {counts['attn_importance_rows']} launches (the random tower's video prunes "
            f"nothing: kernel B runs on the coherent prompt below)")
    chk.expect(bool(torch.isfinite(res.logits).all()) and len(toks) == 8
               and all(0 <= t < cfg.vocab_size for t in toks), f"{tag}: logits finite, 8 tokens in the vocabulary")

    pre_dev = torch.from_numpy(pre).cuda()
    t_enc = cuda_time_ms(lambda: encode(pre_dev), iters=2, warmup=1)
    del pre_dev
    eng = pipe.model.engine()
    args = (inputs.input_embeds, inputs.patch_type, inputs.position_ids, inputs.patch_num,
            inputs.image_token_start, inputs.image_token_length)
    with _a_log(fp) as d_log:
        eng.prefill(*args, mode="dense")
        torch.cuda.synchronize()
    for key, n in d_log.counts().items():
        a_keys[key] = a_keys.get(key, 0) + n
    res_f = eng.prefill(*args, mode="fused")  # the engine alone, no pipeline and no decode graph
    chk.expect(_events(res_f) == ev and res_f.valid_len == res.valid_len,
               f"{tag}: the pixels-to-answer prefill's events (patch_num {inputs.patch_num}) equal a direct fused "
               f"prefill's on the same inputs ({_events(res_f)})")
    del res_f
    t_pre = {mode: cuda_time_ms(lambda mode=mode: eng.prefill(*args, mode=mode), iters=2, warmup=1)
             for mode in ("fused", "planned", "dense")}
    t_p2a = cuda_time_ms(lambda: pipe.ask(QUESTION, frames=frames, max_new_tokens=8), iters=2, warmup=1)
    prof = kernel_bench.device_profile(lambda: pipe.ask(QUESTION, frames=frames, max_new_tokens=8))
    log(f"  encode ms ({encode_label}; CUDA events, mean of 2): {t_enc:.2f}")
    log(f"  prefill ms at {s_prompt} tokens (mean of 2): fused {t_pre['fused']:.2f}, planned {t_pre['planned']:.2f}, "
        f"dense {t_pre['dense']:.2f}, dense / fused {t_pre['dense'] / t_pre['fused']:.3f}")
    log(f"  pixels-to-answer ms ({frames.shape[0]} uint8 frames -> 8 tokens, bf16; mean of 2): {t_p2a:.2f}; "
        f"profiler over one: device idle share {prof['idle_share']:.4f} of {prof['window_us'] / 1e3:.2f} ms, "
        f"{prof['launches']} device operations")
    chk.expect(prof["launches"] > 0, f"{tag}: the profiler saw the pixels-to-answer run's device operations")

    inp_c = pipe.build_inputs(QUESTION, **coherent)
    args_c = (inp_c.input_embeds, inp_c.patch_type, inp_c.position_ids, inp_c.patch_num, inp_c.image_token_start,
              inp_c.image_token_length)
    b_log = CallLog(fp, {"flash_causal_attention_importance":
                         lambda q, k, v, valid_len, num, key_valid=None: (num, q.shape[0], q.shape[1], k.shape[1])})
    _zero_counts(wrappers)
    with b_log, _a_log(fp) as c_log:
        res_c = eng.prefill(*args_c, mode="fused")
        torch.cuda.synchronize()
    counts_c = _ran(wrappers)
    for key, n in c_log.counts().items():
        a_keys[key] = a_keys.get(key, 0) + n
    ev_c = _events(res_c)
    b_rows = b_log.counts()
    merge0 = next(e for e in ev_c if e[0] == -1)
    prune = next((e for e in ev_c if e[1] == "prune"), None)
    log(f"  coherent prompt ({len(inp_c.patch_type)} tokens, patch_num {inp_c.patch_num}): events {ev_c}, buckets "
        f"{[e.bucket for e in res_c.telemetry.events]}, final length {res_c.valid_len}; tokens after the layer -1 "
        f"merge {merge0[3]}, after the prune {None if prune is None else prune[3]}; kernel B calls by (capture rows, "
        f"S, Hq, Hk) {b_rows}; kernel A by (S, mask) {c_log.counts()}; launches {counts_c}")
    phase_s = bucket_length(merge0[3], eng.ff.bucket)
    chk.expect(prune is not None, f"{tag} coherent prompt: the prefill prunes")
    heads, num = (cfg.num_heads, cfg.num_kv_heads), eng.ff.num_importance_queries
    chk.expect(counts_c["attn_importance_rows"] >= 1 and sum(b_rows.values()) == counts_c["attn_importance_rows"]
               and all(k == (num, phase_s) + heads for k in b_rows),
               f"{tag} coherent prompt: kernel B launched with {num} capture rows, Hq {heads[0]} / Hk {heads[1]}, at "
               f"the phase length {phase_s} ({b_rows})")
    for mode in ("planned", "segmented"):
        res_m = eng.prefill(*args_c, mode=mode)
        chk.expect(_events(res_m) == ev_c and res_m.mode == mode,
                   f"{tag} coherent prompt: {mode} ({res_m.mode}) makes fused's events")
        del res_m
    t_c = cuda_time_ms(lambda: eng.prefill(*args_c, mode="fused"), iters=2, warmup=1)
    t_cd = cuda_time_ms(lambda: eng.prefill(*args_c, mode="dense"), iters=2, warmup=1)
    log(f"  coherent prompt prefill ms (mean of 2): fused {t_c:.2f}, dense {t_cd:.2f}, dense / fused {t_cd / t_c:.3f}")

    # Weight-only int8 decode as the captured graph: the layer weights become
    # int8 pairs in place (the bf16 model is gone after this).
    ff = eng.ff
    pipe.model._engine = None
    del eng, res, inputs, args
    params_q = quantize_params_int8(pipe.model.params)
    eng_q = CompressionEngine(params_q, cfg, ff)
    _zero_counts(wrappers)
    with _c_log(mv) as q_log:
        toks_q = eng_q.generate(res_c, 8)  # a new engine: its own graph, captured here
        torch.cuda.synchronize()
    counts_q = _ran(wrappers)
    c_counts["int8"], d_counts["int8"] = q_log.counts(DecodeGraph.replays), counts_q["gemv_gateup"]
    steps = 32
    graph = eng_q.decode_graph(res_c, steps + 1)
    _, _, lens = eng_q.make_decode_state(res_c, steps + 1, pools=(graph.k_pool, graph.v_pool))

    def replay_ms() -> float:
        graph.start(lens, res_c.decode_pos_base, res_c.logits)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.run(steps)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / steps

    readings = [replay_ms(), replay_ms()]
    floor_ms = kernel_bench.weight_stream_bytes(params_q) / kernel_bench.H100_BYTES_PER_S * 1e3
    log(f"  int8 decode graph: tokens {toks_q}, launches {counts_q}; kernel C by (K, widths) {c_counts['int8']}; "
        f"{sum(readings) / 2:.3f} ms/step over {steps} replays ({readings[0]:.3f}, {readings[1]:.3f}); weight-stream "
        f"floor {floor_ms:.3f} ms ({kernel_bench.weight_stream_bytes(params_q) / 1e9:.3f} GB at 3.35 TB/s; the step "
        f"at {floor_ms / (sum(readings) / 2):.3f} of it)")
    chk.expect(len(toks_q) == 8 and all(0 <= t < cfg.vocab_size for t in toks_q)
               and all(counts_q[n] > 0 for n in ("gemv_stacked", "gemv_gateup", "ragged_decode_attn")),
               f"{tag}: int8 decode graph (C, D, G), 8 tokens in the vocabulary")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n0, s_view = int(res_c.layer_caches[0][2]), int(graph.k_pool.shape[1])
    trailing = int(len(inp_c.patch_type) - inp_c.image_token_start - inp_c.image_token_length)
    graph.busy = False
    del graph, eng_q, res_c, inp_c, args_c
    params_q.clear()  # the model is gone: the rows below take the card's memory
    torch.cuda.empty_cache()

    # The kernel rows at the shapes these runs gave each kernel.
    gen = torch.Generator(device="cuda").manual_seed(12)
    e = _e_row(chk, kernels, gen, e_shape, tag)
    _set_launches(e, counts["bidir_attn_fwd"])
    for (s, masked), n in sorted(a_keys.items()):
        # A phase layer's dead keys: the bucket's padding and the tokens the
        # layer -1 merge took (the coherent prompt's share).
        dead = 1 - merge0[3] / s if masked else 0.0
        label = (f"{tag} phase layers: S {s}, key_valid with {dead:.0%} dead keys" if masked else
                 f"{tag} {'dense prefill' if s == s_prompt else 'tail'}: S {s}, no mask")
        regime, _ = _a_regime(chk, kernels, gen, s, *heads, dead, label)
        regime.update(path=tag)
        _set_launches(regime, n)
    b = _b_row(chk, kernels, gen, phase_s, merge0[3], num, *heads, trailing, tag)
    _set_launches(b, counts_c["attn_importance_rows"])
    hid, inter, kv_w = cfg.hidden_size, cfg.intermediate_size, cfg.num_kv_heads * cfg.head_dim_
    widths = {"qkv": (hid, [hid, kv_w, kv_w]), "wo": (hid, [hid]), "w_down": (inter, [hid]),
              "gateup": (hid, [inter, inter])}
    for wdtype in ("bf16", "int8"):
        for name, (kdim, ns) in widths.items():
            key = "gemv_gateup" if name == "gateup" else "gemv_stacked"
            (row,) = _cd_rows(chk, kernels, gen, name, wdtype, kdim, ns, (1,), path=tag)
            # bf16: the pixels-to-answer decode's launches; int8: the int8 decode graph's
            _set_launches(row, d_counts[wdtype] if key == "gemv_gateup"
                          else c_counts[wdtype].get((kdim, tuple(ns)), 0))
            kernels[key]["shapes"].append(row)
    g = _g_row(chk, kernels, gen, n0 + 1, s_view, *heads, tag)
    _set_launches(g, counts_q["ragged_decode_attn"])
    rows = [e, b, g] + [x for n in ("flash_attn_fwd", "gemv_stacked", "gemv_gateup")
                        for x in kernels[n]["regimes" if n == "flash_attn_fwd" else "shapes"]
                        if x.get("path") == tag]
    chk.expect(all(r["launches"] > 0 for r in rows),
               f"{tag}: every row's shape was launched on this phase's path "
               f"({[(r.get('regime', r.get('shape')), r['launches']) for r in rows]})")
    return {"encode_ms": t_enc, "e_row": e}


# -- NVILA-8B and MiniCPM-V 2.6 (phases 5d, 13 and 14) ----------------------------------

# NVILA-8B at 64 frames: SigLIP-so400m at 448 px (32 x 32 patches, kernel E
# at (16, 1,024, 16, 72) over 26 layers: feature_layer -2) and the
# mlp_downsample connector (2 x 2 space-to-channel: 4,608 -> 3,584 ->
# 3,584), 256 tokens a frame: a 16,384-token video span, the dense prefill
# in kernel A's blocked regime. MiniCPM-V 2.6: SigLIP at its checkpoint's
# native 980 px (70 x 70 = 4,900 patches, E at (16, 4,900, 16, 72) over all
# 27 layers) and the resampler (64 queries, 28 heads of 128), 64 + 2
# separator rows a frame: a 4,224-row span at patch_num 66. Both on the
# Qwen2-7B backbone at the families' published S_th of 0.7.
NVILA_FRAMES = MINICPMV_FRAMES = 64
NVILA_E_SHAPE = (16, 1024, 16, 72)
MINICPMV_E_SHAPE = (16, 4900, 16, 72)
FAMILY_KNOBS = (0.3, 0.7, 0.1)


def phase_nvila(chk: Checks, kernels: dict, ctx: dict) -> None:
    """NVILA-8B at full width: pixels to answer, the coherent prompt that
    prunes, the int8 decode graph and the kernel rows (``_family_phase``)."""
    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.models.vision import nvila_frontend, siglip
    from framefusion_tpu_torch.pipeline import TextPipeline

    ctx.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native.load(required=True)
    cfg = qwen2_7b_config()
    vcfg = siglip.ViTConfig(image_size=448, dtype=torch.bfloat16)  # so400m: 27 layers, 1152 wide, 16 heads of 72
    pcfg = nvila_frontend.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=cfg.hidden_size)
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))  # phase 4's weights
    vit = siglip.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    proj = nvila_frontend.init_projector(pcfg, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    log(f"  random NVILA-8B: Qwen2-7B (phase 4's weights), SigLIP-so400m at 448 px and the mlp_downsample "
        f"connector ({proj['w1'].shape[0]} -> {pcfg.llm_dim} -> {pcfg.llm_dim}, fp32) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    model = apply_framefusion(FrameFusionModel(family="nvila", cfg=cfg, params=params), *FAMILY_KNOBS)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": proj, "cfg": pcfg})
    del model, params
    n_img = NVILA_FRAMES * 256

    def check_inputs(inputs):
        s_prompt = int(inputs.input_embeds.shape[0])
        return (inputs.patch_num == 256 and inputs.image_token_length == n_img > 8192
                and int((inputs.patch_type >= 0).sum()) == n_img and inputs.num_importance_queries == 1,
                f"{n_img} video tokens (64 x 256, space-to-channel of 32 x 32) of {s_prompt}, 1 importance row")

    h, _, _, _ = build_video_prompt(np.random.default_rng(13), cfg.hidden_size, n_frames=NVILA_FRAMES,
                                    patch_num=256, n_pre=0, n_post=0, coherent=0.45)
    pipe.nvila_num_frames = NVILA_FRAMES  # beside precomputed features (the coherent prompt)
    _family_phase(chk, kernels, tag="nvila", pipe=pipe,
                  frames=coherent_frames(np.random.default_rng(0), NVILA_FRAMES, 360, 480),
                  pre_shape=(NVILA_FRAMES, 448, 448, 3),
                  encode=lambda px: nvila_frontend.encode_video(vit, vcfg, proj, pcfg, px),
                  encode_label="64 preprocessed frames, 65,536 tower tokens to layer -2, the connector",
                  e_shape=NVILA_E_SHAPE, e_launches=(vcfg.num_layers - 1) * NVILA_FRAMES // 16,
                  e_label="26 layers x 4 batches of 16", check_inputs=check_inputs,
                  coherent=dict(video_features=torch.from_numpy(h)))


def phase_minicpmv(chk: Checks, kernels: dict, ctx: dict) -> None:
    """MiniCPM-V 2.6 at full width: pixels to answer at 980 px (patch_num
    66: the separators carry patch ids), the coherent prompt that prunes,
    the int8 decode graph and the kernel rows (``_family_phase``)."""
    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.models.vision import minicpmv_frontend, siglip
    from framefusion_tpu_torch.pipeline import TextPipeline

    ctx.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native.load(required=True)
    cfg = qwen2_7b_config()
    vcfg = siglip.ViTConfig(image_size=980, dtype=torch.bfloat16)  # 70 x 70 patches, 27 layers
    rcfg = minicpmv_frontend.ResamplerConfig(embed_dim=cfg.hidden_size, num_heads=cfg.hidden_size // 128,
                                             kv_dim=vcfg.hidden_size)  # 64 queries, 28 heads of 128, fp32
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))  # phase 4's weights
    vit = siglip.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    res_params = minicpmv_frontend.init_params(rcfg, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    log(f"  random MiniCPM-V 2.6: Qwen2-7B (phase 4's weights), SigLIP at 980 px and the resampler "
        f"({rcfg.num_queries} queries, {rcfg.num_heads} heads, fp32) on the card in {time.perf_counter() - t0:.1f} s")
    model = apply_framefusion(FrameFusionModel(family="minicpmv", cfg=cfg, params=params,
                                               vision={"kind": "minicpmv", "cfg": vcfg, "params": vit,
                                                       "projector": {"params": res_params, "cfg": rcfg}}),
                              *FAMILY_KNOBS)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": res_params, "cfg": rcfg})
    del model, params
    tpf = rcfg.num_queries + 2

    def check_inputs(inputs):
        s_prompt = int(inputs.input_embeds.shape[0])
        span = inputs.patch_type[inputs.image_token_start:inputs.image_token_start + inputs.image_token_length]
        return (inputs.patch_num == tpf and inputs.image_token_length == MINICPMV_FRAMES * tpf
                and np.array_equal(span, np.tile(np.arange(tpf), MINICPMV_FRAMES)),
                f"{inputs.image_token_length} span rows (64 x (64 resampled + 2 separators), the separators' patch "
                f"ids 64 and 65), patch_num {inputs.patch_num}, of {s_prompt}")

    h, _, _, _ = build_video_prompt(np.random.default_rng(14), cfg.hidden_size, n_frames=MINICPMV_FRAMES,
                                    patch_num=rcfg.num_queries, n_pre=0, n_post=0, coherent=0.45)
    _family_phase(chk, kernels, tag="minicpmv", pipe=pipe,
                  frames=coherent_frames(np.random.default_rng(0), MINICPMV_FRAMES, 360, 480),
                  pre_shape=(MINICPMV_FRAMES, 980, 980, 3),
                  encode=lambda px: minicpmv_frontend.encode_video(vit, vcfg, res_params, rcfg, px),
                  encode_label="64 preprocessed frames, 313,600 tower tokens, the resampler",
                  e_shape=MINICPMV_E_SHAPE, e_launches=vcfg.num_layers * MINICPMV_FRAMES // 16,
                  e_label="27 layers x 4 batches of 16", check_inputs=check_inputs,
                  coherent=dict(video_features=torch.from_numpy(h).reshape(MINICPMV_FRAMES, rcfg.num_queries,
                                                                           h.shape[1])))


def numpy_nvila_projector(vision_dim: int, llm_dim: int, seed: int, scale: float) -> dict:
    """Random mlp_downsample connector (LayerNorm, Linear, GELU, Linear) drawn with numpy."""
    rng = np.random.default_rng(seed)
    din = vision_dim * 4
    return {"ln_w": np.ones(din, np.float32), "ln_b": np.zeros(din, np.float32),
            "w1": rng.standard_normal((din, llm_dim), dtype=np.float32) * np.float32(scale),
            "b1": np.zeros(llm_dim, np.float32),
            "w2": rng.standard_normal((llm_dim, llm_dim), dtype=np.float32) * np.float32(scale),
            "b2": np.zeros(llm_dim, np.float32)}


def numpy_resampler_params(rcfg, seed: int, scale: float) -> dict:
    """Random MiniCPM-V resampler drawn with numpy (LayerNorms at 1 / 0, biases 0)."""
    rng = np.random.default_rng(seed)
    d = rcfg.embed_dim

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    out = {"query": norm(rcfg.num_queries, d), "w_kv": norm(rcfg.kv_dim, d), "proj": norm(d, d)}
    for name in ("q", "k", "v", "o"):
        out[f"w_{name}"], out[f"b_{name}"] = norm(d, d), np.zeros(d, np.float32)
    for ln in ("ln_q", "ln_kv", "ln_post"):
        out[f"{ln}_w"], out[f"{ln}_b"] = np.ones(d, np.float32), np.zeros(d, np.float32)
    return out


def block_images(rng: np.random.Generator, n: int, side: int, block: int) -> np.ndarray:
    """uint8 (n, side, side, 3) images of ``block``-pixel noise blocks: each
    block, in raster order across the images, copies the one before it with
    probability 1/2 and is new noise otherwise. With ``block`` the
    connector's 2 x 2 patches, a token then equals the token before it up
    to its position embedding, or is unrelated: the similarities of a
    multi-image prompt (``patch_num = 1``) fall far from the threshold."""
    per = side // block
    tiles, prev = [], None
    for _ in range(n * per * per):
        prev = prev if prev is not None and rng.random() < 0.5 else rng.integers(0, 256, (block, block, 3))
        tiles.append(prev)
    grid = np.asarray(tiles).reshape(n, per, per, block, block, 3).transpose(0, 1, 3, 2, 4, 5)
    return grid.reshape(n, side, side, 3).astype(np.uint8)


def tiny_families_run(device: str, dtype: torch.dtype) -> dict:
    """The tiny runs of phase 5d on one device, weights drawn with numpy: a
    6-layer Qwen2 LLM (``readout_params``; 4 / 2 heads of 128) and a SigLIP
    tower of head dim 72 (288 wide, 4 heads, 3 layers, 56 px: 8 x 8
    patches) through each family's frontend and prompt:

    * ``nvila_video``: TextPipeline.ask on 12 uint8 frames (the connector's
      16 tokens a frame);
    * ``nvila_multi_image``: 8 block images, each through the connector,
      spliced by ``build_prefill_inputs_multi_image`` (patch_num 1), then
      ``generate``;
    * ``minicpmv``: TextPipeline.ask on 12 frames that repeat or change
      whole (the resampler's 8 tokens + 2 separators a frame);
    * ``llava_next_video``: 12 half-static frames through the tower, the
      LLaVA projector and 2 x 2 pooling (16 tokens a frame, no newline
      rows), patch ids from the family's own adapter
      (``llava_next_video.build_prefill_inputs``: ViT patches / pool
      kernel^2 a frame), then ``generate``.

    Returns per run the features, events, cache lengths, tokens, prefill
    logits and layer 0's cached keys (fp32 on the CPU), and E's and B's
    launches."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters import llava_next_video, nvila
    from framefusion_tpu_torch.models.adapters.common import splice_embeddings
    from framefusion_tpu_torch.models.vision import llava_frontend, minicpmv_frontend, nvila_frontend, siglip
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.pipeline import DEFAULT_TEMPLATE, TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=dtype)
    vcfg = siglip.ViTConfig(image_size=56, patch_size=7, hidden_size=288, intermediate_size=576, num_layers=3,
                            num_heads=4, dtype=dtype)
    params = _cast_floats(qwen2.params_from_numpy(readout_params(cfg, seed=0, resid_scale=0.03), device), dtype)
    vit = _cast_floats(siglip.params_from_numpy(numpy_vit_params(vcfg, seed=1, scale=0.05, resid_scale=0.005),
                                                device), dtype)
    pcfg = nvila_frontend.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=cfg.hidden_size)
    proj = nvila_frontend.projector_from_numpy(numpy_nvila_projector(vcfg.hidden_size, cfg.hidden_size, 2, 0.05),
                                               device)
    rcfg = minicpmv_frontend.ResamplerConfig(num_queries=8, embed_dim=cfg.hidden_size, num_heads=4,
                                             kv_dim=vcfg.hidden_size)
    res_params = minicpmv_frontend.params_from_numpy(numpy_resampler_params(rcfg, 3, 0.05), device)

    def model_of(family, s_th=0.95):
        m = apply_framefusion(FrameFusionModel(family=family, cfg=cfg, params=params, attn_impl="flash"),
                              0.3, s_th, 0.1)
        m.ff = m.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
        return m

    def launches():
        return ba.bidir_attn_fwd.launches, fp.attn_importance_rows.launches

    def result(feats, res, toks, before):
        k0, _, n0 = res.layer_caches[0]
        after = launches()
        return dict(feats=feats.float().cpu(), events=[(e.layer, e.kind, e.tokens_removed)
                                                       for e in res.telemetry.events],
                    lens=[c[2] for c in res.layer_caches], tokens=toks, logits=res.logits.float().cpu(),
                    keys=k0[:n0].float().cpu(), e=after[0] - before[0], b=after[1] - before[1])

    out = {}
    pipe = TextPipeline(model=model_of("nvila"), tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": proj, "cfg": pcfg})
    frames = half_static_frames(np.random.default_rng(8), 12, 112, 140)
    before = launches()
    feats = nvila_frontend.encode_video(vit, vcfg, proj, pcfg, pipe._prepare_frames(frames))
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    out["nvila_video"] = result(feats, pipe.last_result, toks, before)

    images = pipe._prepare_frames(block_images(np.random.default_rng(9), 8, vcfg.image_size, 2 * vcfg.patch_size))
    before = launches()
    per_image = [nvila_frontend.encode_video(vit, vcfg, proj, pcfg, images[i:i + 1]).float() for i in range(8)]
    pre, _, post = DEFAULT_TEMPLATE.format(question=QUESTION).partition("<image>")
    ids_pre = StubTokenizer().encode(pre)
    text = pipe._embed_ids(ids_pre + [TextPipeline.PLACEHOLDER_ID] + StubTokenizer().encode(post))
    inputs = nvila.build_prefill_inputs_multi_image(text, per_image, len(ids_pre))
    # A copied block's token sits near 0.97 from the one before it, a new one near 0.
    toks, res = model_of("nvila", s_th=0.8).generate(inputs, max_new_tokens=8)
    out["nvila_multi_image"] = result(torch.cat(per_image), res, toks, before)

    rng = np.random.default_rng(10)
    scenes = [rng.integers(0, 256, (vcfg.image_size, vcfg.image_size, 3)) for _ in range(6)]
    frames = np.stack([scenes[i] for i in (0, 0, 1, 1, 1, 2, 3, 3, 4, 4, 4, 5)]).astype(np.uint8)
    pipe = TextPipeline(model=model_of("minicpmv"), tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": res_params, "cfg": rcfg})
    before = launches()
    feats = minicpmv_frontend.encode_video(vit, vcfg, res_params, rcfg, pipe._prepare_frames(frames))
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    out["minicpmv"] = result(feats, pipe.last_result, toks, before)
    out["minicpmv"]["patch_num"] = pipe.build_inputs(QUESTION, frames=frames).patch_num

    lproj = _cast_floats(llava_frontend.params_from_numpy(
        numpy_projector(vcfg.hidden_size, cfg.hidden_size, seed=4, scale=0.05), device), dtype)
    pipe = TextPipeline(model=model_of("llava_next_video"), tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    pixels = pipe._prepare_frames(half_static_frames(np.random.default_rng(11), 12, 112, 140))
    before = launches()
    tower = llava_frontend.project(lproj, siglip.encode(vit, pixels, vcfg, feature_layer=-2))
    grid, _ = llava_frontend.pool_2d(tower, vcfg.patches_per_side)
    feats = grid.reshape(-1, cfg.hidden_size)
    ids = ids_pre + [TextPipeline.PLACEHOLDER_ID] + StubTokenizer().encode(post)
    embeds = splice_embeddings(pipe._embed_ids(ids), len(ids_pre), feats.to(torch.float32))
    mask = np.zeros(embeds.shape[0], bool)
    mask[len(ids_pre):len(ids_pre) + feats.shape[0]] = True
    inputs = llava_next_video.build_prefill_inputs(embeds, mask, num_vit_patches=vcfg.patches_per_side ** 2)
    toks, res = pipe.model.generate(inputs, max_new_tokens=8)
    out["llava_next_video"] = result(feats, res, toks, before)
    out["llava_next_video"]["patch_num"] = inputs.patch_num
    return out


def phase_cross_families(chk: Checks) -> None:
    cpu = tiny_families_run("cpu", torch.bfloat16)
    gpu = tiny_families_run("cuda", torch.bfloat16)
    chk.expect(cpu["minicpmv"]["patch_num"] == gpu["minicpmv"]["patch_num"] == 10,
               "cross minicpmv: patch_num 10 (8 resampled tokens + 2 separators a frame)")
    chk.expect(cpu["llava_next_video"]["patch_num"] == gpu["llava_next_video"]["patch_num"] == 16,
               "cross llava_next_video: patch_num 16 (64 ViT patches / a 2 x 2 pool kernel)")
    for name in cpu:
        c, g = cpu[name], gpu[name]
        log(f"  {name}: cpu events {c['events']} tokens {c['tokens']}; cuda events {g['events']} tokens {g['tokens']}")
        for what, label, bound in (("feats", "frontend features (SigLIP at head dim 72)", FEATURE_RTOL),
                                   ("logits", "prefill logits", LOGIT_RTOL),
                                   ("keys", "layer 0's cached keys (the merge's keep set, in order)", LOGIT_RTOL)):
            same = c[what].shape == g[what].shape
            rel = float((c[what] - g[what]).abs().max() / c[what].abs().max()) if same else math.inf
            chk.expect(rel <= bound, f"cross {name}: {label} differ by {rel:.3e} of their largest <= {bound}")
        chk.expect(c["events"] == g["events"] and c["lens"] == g["lens"],
                   f"cross {name}: events and cache lengths equal")
        chk.expect(c["tokens"] == g["tokens"], f"cross {name}: greedy tokens equal")
        chk.expect(len(set(g["tokens"])) >= 3, f"cross {name}: the tokens vary ({len(set(g['tokens']))} distinct)")
        chk.expect(any(e[1].startswith("merge") and e[2] for e in c["events"]),
                   f"cross {name}: the scenario merges ({c['events']})")
        chk.expect(c["e"] == 0 and g["e"] > 0, f"cross {name}: kernel E launched on the card only "
                                               f"({g['e']} launches)")
        if c["b"] is not None and any(e[1] == "prune" for e in c["events"]):
            chk.expect(c["b"] == 0 and g["b"] > 0, f"cross {name}: kernel B launched on the card only "
                                                   f"({g['b']} launches)")


# -- Qwen2.5-VL (phases 5e, 15 and 16) ---------------------------------------------------

# Qwen2.5-VL at 360 x 480 frames: the Qwen2-VL geometry (smart_resize to 364
# x 476, 26 x 34 patches, 221 merged patches a temporal frame); the tower's
# four full-attention blocks run kernel E at B = grid_t, N = 884, its 28
# window blocks attend within 112-pixel windows (4 x 4 merge units, ragged
# at the grid's right and bottom edges: 20 windows of up to 64 tokens a
# frame). Qwen2.5-VL-7B: 64 frames, grid (32, 26, 34), 7,072 video tokens.
# Qwen2.5-VL-72B: 256 frames, grid (128, 26, 34), 113,152 tower tokens and
# 28,288 video tokens; its LLM's 80 layers (~145 GB in bf16) are cut to 16
# (28.1 GB of blocks + 5.0 GB of embedding and head) to fit one card.
QWEN25VL_GRID = (32, 26, 34)
QWEN25VL_E_SHAPE = (32, 884, 16, 80)
QWEN25VL_72B_FRAMES, QWEN25VL_72B_LAYERS = 256, 16
QWEN25VL_72B_GRID = (128, 26, 34)
QWEN25VL_72B_E_SHAPE = (128, 884, 16, 80)
# * The cross-device Qwen2.5-VL run holds the tower's features, the prefill
#   logits and layer 0's cached keys (the merge's keep set) to the bounds of
#   phases 5b and 5c: FEATURE_RTOL and LOGIT_RTOL.


def numpy_qwen25vl_vit_params(vcfg, seed: int, scale: float, resid_scale: float) -> dict:
    """Random Qwen2.5-VL tower weights in the JAX package's pytree layout,
    drawn with numpy; the blocks write to the residual stream at
    ``resid_scale``."""
    rng = np.random.default_rng(seed)
    n_l, d, i, mu = vcfg.depth, vcfg.hidden_size, vcfg.intermediate_size, vcfg.merge_unit

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": 1 + norm(n_l, d), "ln2_w": 1 + norm(n_l, d), "w_qkv": norm(n_l, d, 3 * d),
              "b_qkv": norm(n_l, 3 * d), "wo": norm(n_l, d, d), "bo": norm(n_l, d), "w_gate": norm(n_l, d, i),
              "b_gate": norm(n_l, i), "w_up": norm(n_l, d, i), "b_up": norm(n_l, i), "w_down": norm(n_l, i, d),
              "b_down": norm(n_l, d)}
    for name in ("wo", "bo", "w_down", "b_down"):
        layers[name] *= np.float32(resid_scale / scale)
    return {"patch_proj": norm(vcfg.patch_dim, d), "layers": layers, "merger_ln_w": np.ones(d, np.float32),
            "merger_w0": norm(mu * d, mu * d), "merger_b0": np.zeros(mu * d, np.float32),
            "merger_w1": norm(mu * d, vcfg.out_hidden_size),
            "merger_b1": np.zeros(vcfg.out_hidden_size, np.float32)}


def tiny_qwen25vl_run(device: str, dtype: torch.dtype) -> dict:
    """The tiny Qwen2.5-VL pixels-to-answer run of phase 5e on one device: a
    tower of head dim 80 (hidden 160, 2 heads, depth 3, block 1 full
    attention, the published patch 14 and window 112) and phase 5b's 6-layer
    mRoPE LLM (``readout_params``), weights drawn with numpy, through
    TextPipeline.ask on 12 uint8 frames of 112 x 140 (grid (6, 8, 10): a
    full and a ragged window a frame, the always-pad quirk's empty row
    dropped). Returns the tower features, events, cache lengths, decode
    base, tokens, prefill logits and layer 0's cached keys (fp32 on the
    CPU), and E's and B's launches."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import qwen25_vl_vit
    from framefusion_tpu_torch.models.vision.qwen2_vl_vit import pixels_to_patches
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.pipeline import TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          mrope_section=(16, 24, 24), dtype=dtype)
    vcfg = qwen25_vl_vit.Qwen25VLViTConfig(hidden_size=160, depth=3, num_heads=2, intermediate_size=320,
                                           fullatt_block_indexes=(1,), out_hidden_size=cfg.hidden_size, dtype=dtype)
    params = _cast_floats(qwen2.params_from_numpy(readout_params(cfg, seed=0, resid_scale=0.03), device), dtype)
    vit = _cast_floats(qwen2.params_from_numpy(numpy_qwen25vl_vit_params(vcfg, seed=1, scale=0.05,
                                                                         resid_scale=0.005), device), dtype)
    model = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params, attn_impl="flash"),
                              0.3, 0.95, 0.1)
    model.ff = model.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    frames = half_static_frames(np.random.default_rng(7), 12, 112, 140)
    patches, grid = pixels_to_patches(pipe._prepare_frames(frames), vcfg)
    launches = ba.bidir_attn_fwd.launches, fp.attn_importance_rows.launches
    feats = qwen25_vl_vit.encode_video(vit, patches, *grid, vcfg)
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    res = pipe.last_result
    k0, _, n0 = res.layer_caches[0]
    return dict(grid=grid, feats=feats.float().cpu(), events=[(e.layer, e.kind, e.tokens_removed)
                                                              for e in res.telemetry.events],
                lens=[c[2] for c in res.layer_caches], base=res.decode_pos_base, tokens=toks,
                logits=res.logits.float().cpu(), keys=k0[:n0].float().cpu(),
                e=ba.bidir_attn_fwd.launches - launches[0], b=fp.attn_importance_rows.launches - launches[1])


def phase_cross_qwen25vl(chk: Checks) -> None:
    cpu = tiny_qwen25vl_run("cpu", torch.bfloat16)
    gpu = tiny_qwen25vl_run("cuda", torch.bfloat16)
    log(f"  grid {cpu['grid']}; cpu events {cpu['events']} decode base {cpu['base']} tokens {cpu['tokens']}; cuda "
        f"events {gpu['events']} decode base {gpu['base']} tokens {gpu['tokens']}")
    for what, label, bound in (("feats", "tower features (head dim 80, window and full-attention blocks)",
                                FEATURE_RTOL), ("logits", "prefill logits", LOGIT_RTOL),
                               ("keys", "layer 0's cached keys (the merge's keep set, in order)", LOGIT_RTOL)):
        same = cpu[what].shape == gpu[what].shape
        rel = float((cpu[what] - gpu[what]).abs().max() / cpu[what].abs().max()) if same else math.inf
        chk.expect(rel <= bound, f"cross qwen25vl: {label} differ by {rel:.3e} of their largest <= {bound}")
    chk.expect(cpu["grid"] == (6, 8, 10), f"cross qwen25vl: grid {cpu['grid']} (ragged edge windows)")
    chk.expect((cpu["events"], cpu["lens"], cpu["base"]) == (gpu["events"], gpu["lens"], gpu["base"]),
               "cross qwen25vl: events, cache lengths and decode base equal")
    chk.expect(cpu["tokens"] == gpu["tokens"], "cross qwen25vl: greedy tokens equal")
    chk.expect(len(set(gpu["tokens"])) >= 3, f"cross qwen25vl: the tokens vary ({len(set(gpu['tokens']))} distinct)")
    chk.expect(any(e[1] == "prune" for e in cpu["events"]),
               f"cross qwen25vl: the scenario merges and prunes ({cpu['events']})")
    chk.expect(cpu["e"] == cpu["b"] == 0 and gpu["e"] == 2 and gpu["b"] > 0,
               f"cross qwen25vl: kernels E (once a full-attention block an encode) and B launched on the card only "
               f"(E {gpu['e']}, B {gpu['b']} launches)")


def _qwen25vl_family(chk: Checks, kernels: dict, tag: str, cfg, vcfg, n_frames: int, grid: tuple,
                     e_shape: tuple, seed: int) -> None:
    """Phases 15 and 16: a Qwen2.5-VL model at full width (random weights
    made on the card, the LLM's the seed-0 draw of its geometry) through
    ``_family_phase``: pixels to answer on ``n_frames`` uint8 frames of 360
    x 480 at the published knobs, the coherent prompt that prunes (B at 4
    capture rows), the int8 decode graph and the kernel rows (``"path":
    tag``); then the encode split into E's launches (one a full-attention
    block), the window blocks' attention (timed alone on the tower's own
    window layout) and the rest."""
    from framefusion_tpu_torch import native
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.models.vision import qwen25_vl_vit
    from framefusion_tpu_torch.models.vision.qwen2_vl_vit import pixels_to_patches
    from framefusion_tpu_torch.pipeline import TextPipeline

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native.load(required=True)
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    vit = qwen25_vl_vit.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    log(f"  random {tag}: LLM ({cfg.num_layers} layers, hidden {cfg.hidden_size}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads, {sum(t.numel() for t in params['layers'].values()) / 1e9:.2f} B block params) "
        f"and the Qwen2.5-VL tower (depth {vcfg.depth}, {vcfg.num_heads} heads of {vcfg.head_dim}, full attention at "
        f"{vcfg.fullatt_block_indexes}, out {vcfg.out_hidden_size}) on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params,
                                               vision={"kind": "qwen25_vl_vit", "cfg": vcfg, "params": vit}),
                              *QWEN2VL_KNOBS)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    del model, params
    frames = coherent_frames(np.random.default_rng(0), n_frames, 360, 480)
    patches, got_grid = pixels_to_patches(pipe._prepare_frames(frames), vcfg)
    chk.expect(got_grid == grid, f"{tag}: {n_frames} frames 360x480 -> grid {got_grid}")
    patches = torch.from_numpy(patches).cuda()
    grid_t, grid_h, grid_w = grid
    patch_num = grid_h * grid_w // vcfg.merge_unit
    n_video = grid_t * patch_num

    def check_inputs(inputs):
        s_prompt = int(inputs.input_embeds.shape[0])
        start = inputs.image_token_start
        step = int(inputs.position_ids[0, start + patch_num] - inputs.position_ids[0, start])
        return (inputs.patch_num == patch_num and inputs.image_token_length == n_video
                and inputs.num_importance_queries == 4 and inputs.position_ids.shape == (3, s_prompt)
                and step == vcfg.tokens_per_second,
                f"{n_video} video tokens ({grid_t} x {patch_num}) of {s_prompt}, (3, S) positions whose temporal "
                f"stream steps by {step} a frame (second_per_grid_ts 1.0 x tokens_per_second "
                f"{vcfg.tokens_per_second}), 4 importance rows")

    h, _, _, _ = build_video_prompt(np.random.default_rng(seed), cfg.hidden_size, n_frames=grid_t,
                                    patch_num=patch_num, n_pre=0, n_post=0, coherent=0.45)
    n_full = len(vcfg.fullatt_block_indexes)
    out = _family_phase(chk, kernels, tag=tag, pipe=pipe, frames=frames, pre_shape=(n_frames, 364, 476, 3),
                        encode=lambda _px: qwen25_vl_vit.encode_video(vit, patches, *grid, vcfg),
                        encode_label=f"{n_frames} preprocessed frames, {patches.shape[0]:,} tower tokens",
                        e_shape=e_shape, e_launches=n_full, e_label="once a full-attention block",
                        check_inputs=check_inputs,
                        coherent=dict(video_features=torch.from_numpy(h), video_grid_thw=grid))
    del h
    # The encode's split: E's launches at its row's time, the window blocks'
    # attention timed alone on the tower's window layout at its shape.
    wg, wv, back = qwen25_vl_vit.padded_window_layout(*grid, vcfg)
    layout = (torch.from_numpy(wg.reshape(-1)).cuda(), torch.from_numpy(wv).cuda()[:, None, None, :],
              torch.from_numpy(back).cuda())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (_rand(gen, (patches.shape[0], vcfg.num_heads, vcfg.head_dim)) for _ in range(3))
    t_win = cuda_time_ms(lambda: qwen25_vl_vit.window_attention(q, k, v, *layout, vcfg.head_dim ** -0.5), iters=5)
    n_win = vcfg.depth - n_full
    t_e, t_enc = out["e_row"]["ms"], out["encode_ms"]
    rest = t_enc - n_full * t_e - n_win * t_win
    log(f"  encode split: {t_enc:.2f} ms = E {n_full} x {t_e:.4f} ({n_full * t_e:.2f} ms) + window attention "
        f"{n_win} x {t_win:.3f} ({n_win * t_win:.2f} ms; {wv.shape[0]} windows of {wv.shape[1]} slots, "
        f"{wv.mean():.3f} of them tokens) + the rest {rest:.2f} ms (GEMMs, norms, rotary, gathers, the merger)")
    chk.expect(rest > 0, f"{tag}: the encode's parts sum within its time ({rest:.2f} ms left)")


def phase_qwen25vl(chk: Checks, kernels: dict, ctx: dict) -> None:
    """Qwen2.5-VL-7B at full size: the published tower (depth 32, hidden
    1280, 16 heads of 80, intermediate 3420, window 112, full attention at
    7 / 15 / 23 / 31, out 3584) and phase 4's Qwen2-7B weights with mRoPE
    (16, 24, 24); 64 frames (grid (32, 26, 34), 7,072 video tokens)."""
    from framefusion_tpu_torch.config import qwen2_vl_7b_config
    from framefusion_tpu_torch.models.vision import qwen25_vl_vit

    ctx.clear()
    _qwen25vl_family(chk, kernels, "qwen25vl", qwen2_vl_7b_config(),
                     qwen25_vl_vit.Qwen25VLViTConfig(dtype=torch.bfloat16), 64, QWEN25VL_GRID, QWEN25VL_E_SHAPE,
                     seed=15)


def phase_qwen25vl_72b(chk: Checks, kernels: dict, ctx: dict) -> None:
    """Qwen2.5-VL-72B's widths on 256 frames: the LLM at
    ``qwen25_vl_72b_config(num_layers=16)`` (hidden 8192, 64 / 8 heads of
    128, intermediate 29,568, vocab 152,064; the depth cut from 80 to fit
    one card), the same tower with out 8192; 256 frames (grid (128, 26,
    34): 113,152 tower tokens, 28,288 video tokens)."""
    from framefusion_tpu_torch.config import qwen25_vl_72b_config
    from framefusion_tpu_torch.models.vision import qwen25_vl_vit

    ctx.clear()
    cfg = qwen25_vl_72b_config(num_layers=QWEN25VL_72B_LAYERS)
    log(f"  depth cut: {QWEN25VL_72B_LAYERS} of the published 80 layers (~1.756 GB a layer in bf16; 80 layers and "
        f"the 2.49 GB embedding and head would take ~145 GB of the card's 80)")
    _qwen25vl_family(chk, kernels, "qwen25vl_72b", cfg,
                     qwen25_vl_vit.Qwen25VLViTConfig(out_hidden_size=cfg.hidden_size, dtype=torch.bfloat16),
                     QWEN25VL_72B_FRAMES, QWEN25VL_72B_GRID, QWEN25VL_72B_E_SHAPE, seed=16)


# -- Qwen2-MoE (phases 3b and 17) -------------------------------------------------------

# Phase 3b's MoE stack: 8 experts, top-2, at the run's capacity factor 1.25.
# Its router reads a signature: the last 8 columns of every embedding and
# prompt row hold a permutation of 0..7 (one patch's rows the same one in
# every frame), and the blocks write to the residual stream at 0.003, so each
# token's expert order holds by margins (1 in units of the row's rms, ~1)
# far above any bf16 rounding and the card and the CPU route alike; the
# experts that several patches share overflow the capacity, so tokens drop.
MOE_CROSS_EXPERTS = 8
# Phase 17: Qwen2-57B-A14B's prompt knobs (the main path's) and its decode
# batch sizes (B = 8: 64 routed rows, kernel C's and D's limit a launch).
MOE_KNOBS = (0.3, 0.6, 0.1)
MOE_BATCH = (1, 4, 8)


def moe_cross_params(cfg, seed: int, resid_scale: float) -> dict:
    """``readout_params``'s attention, embeddings and decisive head on a MoE
    stack: a signature (a permutation of 0..E-1) in the last E columns of
    every embedding row, a router that reads those columns, experts and a
    shared expert; attention, experts and shared expert write to the
    residual stream at ``resid_scale``."""
    e, d = cfg.num_experts, cfg.hidden_size
    rng = np.random.default_rng(seed + 2)
    dense = cfg.replace(num_experts=0, intermediate_size=cfg.moe_intermediate_size)
    tree = numpy_params(dense, seed=seed, scale=0.05)
    for name in ("w_gate", "w_up", "w_down"):
        del tree["layers"][name]
    tree["embed"] *= np.float32(20.0)
    tree["embed"][:, d - e:] = np.stack([rng.permutation(e) for _ in range(cfg.vocab_size)]).astype(np.float32)
    tree["lm_head"] = np.ascontiguousarray(tree["embed"][rng.permutation(cfg.vocab_size)].T) / np.float32(20.0)
    tree["layers"]["wo"] *= np.float32(resid_scale / 0.05)  # as readout_params scales its blocks' outputs
    n_l, mi, si = cfg.num_layers, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size

    def norm(*shape, scale=0.05):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    router = np.zeros((n_l, d, e), np.float32)
    router[:, d - e:, :] = np.eye(e, dtype=np.float32)
    tree["layers"].update(router=router, w_gate=norm(n_l, e, d, mi), w_up=norm(n_l, e, d, mi),
                          w_down=norm(n_l, e, mi, d, scale=resid_scale), sw_gate=norm(n_l, d, si),
                          sw_up=norm(n_l, d, si), sw_down=norm(n_l, si, d, scale=resid_scale),
                          shared_gate=norm(n_l, d, 1))
    return tree


def tiny_moe_run(device: str, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Phase 3b's bf16 MoE model (6 layers, hidden 512, 4 / 2 heads, 8
    experts top-2 of width 256, shared expert 512, factor 1.25) through the
    fused, planned and segmented prefill (the drops of every MLP call
    recorded) and 8 greedy tokens each (the decode graph on the card, its
    step eagerly on the CPU): mode -> (events, cache lengths, drops, tokens,
    prefill logits fp32 on the CPU); and the routed kernels' launches."""
    from framefusion_tpu_torch.config import FrameFusionConfig, tiny_moe_llm_config
    from framefusion_tpu_torch.models import moe, qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = tiny_moe_llm_config(num_layers=6, hidden_size=512, num_heads=4, num_kv_heads=2, num_experts=MOE_CROSS_EXPERTS,
                              num_experts_per_tok=2, moe_intermediate_size=256, shared_expert_intermediate_size=512,
                              moe_capacity_factor=1.25, dtype=dtype)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1, schedule_num_layers=6,
                           bucket=32)
    patch_num, e = 8, cfg.num_experts
    rng = np.random.default_rng(7)
    tree = moe_cross_params(cfg, seed=0, resid_scale=0.003)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=patch_num, n_pre=6, n_post=5)
    h *= np.float32(20.0)  # the embeddings' unit scale
    h[:, -e:] = np.stack([rng.permutation(e) for _ in range(len(pt))])
    patch_sig = np.stack([rng.permutation(e) for _ in range(patch_num)])
    vision = np.arange(img_start, img_start + n_img)
    h[vision, -e:] = patch_sig[pt[vision]]
    h[-1] = tree["embed"][7]
    params = _cast_floats(qwen2.params_from_numpy(tree, device), cfg.dtype)
    eng = CompressionEngine(params, cfg, ff, attn_impl="flash")
    routed = (mv.gemv_stacked.launches, mv.gemv_gateup.launches)
    out = {}
    for mode in ("fused", "planned", "segmented"):
        with moe.record_drops() as drops:
            res = eng.prefill(h, pt, np.arange(len(pt)), patch_num, img_start, n_img, mode=mode)
        toks = eng.generate(res, 8)
        out[mode] = ([(ev.layer, ev.kind, ev.tokens_removed) for ev in res.telemetry.events],
                     [c[2] for c in res.layer_caches], [(s, c, int(d)) for s, c, d in drops], toks,
                     res.logits.float().cpu(), res.mode)
    out["launches"] = (mv.gemv_stacked.launches - routed[0], mv.gemv_gateup.launches - routed[1])
    return out


def phase_cross_moe(chk: Checks) -> None:
    """Phase 3b: the tiny MoE model on the CPU (plain versions) and on the
    card (kernels, the routed decode on C and D as a captured graph)."""
    got = {dev: tiny_moe_run(dev) for dev in ("cpu", "cuda")}
    for mode in ("fused", "planned", "segmented"):
        cpu, gpu = got["cpu"][mode], got["cuda"][mode]
        rel = float((cpu[4] - gpu[4]).abs().max() / cpu[4].abs().max())
        log(f"  moe {mode} ({gpu[5]}): events {gpu[0]}, drops (rows, capacity, dropped) {gpu[2]}, tokens cpu "
            f"{cpu[3]} cuda {gpu[3]}")
        chk.expect(cpu[0] == gpu[0] and cpu[1] == gpu[1] and cpu[5] == gpu[5],
                   f"cross moe {mode}: events, cache lengths and mode equal")
        chk.expect(cpu[2] == gpu[2], f"cross moe {mode}: every MLP call's capacity and drops equal")
        chk.expect(sum(d for _, _, d in gpu[2]) > 0, f"cross moe {mode}: the experts overflow at factor 1.25")
        chk.expect(cpu[3] == gpu[3] and len(set(gpu[3])) >= 3, f"cross moe {mode}: greedy tokens equal and varied")
        chk.expect(rel <= LOGIT_RTOL, f"cross moe {mode}: prefill logits differ by {rel:.3e} of their largest "
                                      f"<= {LOGIT_RTOL}")
        chk.expect(len(gpu[0]) > 1, f"cross moe {mode}: the scenario compresses ({len(gpu[0])} events)")
    chk.expect(got["cpu"]["launches"] == (0, 0) and min(got["cuda"]["launches"]) > 0,
               f"cross moe: C and D launched on the card only ({got['cuda']['launches']})")


def moe_57b_params(cfg, seed: int) -> dict:
    """Random Qwen2-57B-A14B weights, weight-only int8 with the int8 LM head,
    built on the card from a seeded generator one layer at a time: each
    layer's bf16 matrices (the experts' ~3.5 GB) are drawn, quantized with
    ``quantize_weight`` into the int8 stacks and dropped; the head is drawn
    in bf16 and quantized with ``quantize_head``. The router and the shared
    expert's gate stay bf16, as ``quantize_params_int8`` leaves them."""
    from framefusion_tpu_torch.ops.quant import quantize_head, quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_l, d, e, hd = cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.head_dim_
    nq, nk, mi, si = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.moe_intermediate_size, \
        cfg.shared_expert_intermediate_size

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(0.02)

    shapes = {"wq": (d, nq), "wk": (d, nk), "wv": (d, nk), "wo": (nq, d), "w_gate": (e, d, mi), "w_up": (e, d, mi),
              "w_down": (e, mi, d), "sw_gate": (d, si), "sw_up": (d, si), "sw_down": (si, d)}
    layers = {name: {"q8": torch.empty((n_l,) + shape, dtype=torch.int8, device="cuda"),
                     "scale": torch.empty((n_l,) + shape[:-2] + shape[-1:], dtype=torch.float32, device="cuda")}
              for name, shape in shapes.items()}
    layers.update(ln1=torch.ones((n_l, d), dtype=torch.bfloat16, device="cuda"),
                  ln2=torch.ones((n_l, d), dtype=torch.bfloat16, device="cuda"),
                  router=torch.empty((n_l, d, e), dtype=torch.bfloat16, device="cuda"),
                  shared_gate=torch.empty((n_l, d, 1), dtype=torch.bfloat16, device="cuda"),
                  bq=torch.zeros((n_l, nq), dtype=torch.bfloat16, device="cuda"),
                  bk=torch.zeros((n_l, nk), dtype=torch.bfloat16, device="cuda"),
                  bv=torch.zeros((n_l, nk), dtype=torch.bfloat16, device="cuda"))
    for l in range(n_l):
        for name, shape in shapes.items():
            q = quantize_weight(draw(*shape))
            layers[name]["q8"][l], layers[name]["scale"][l] = q["q8"], q["scale"]
            del q
        layers["router"][l], layers["shared_gate"][l] = draw(d, e), draw(d, 1)
    return {"embed": draw(cfg.vocab_size, d), "layers": layers,
            "final_norm": torch.ones((d,), dtype=torch.bfloat16, device="cuda"),
            "lm_head": quantize_head(draw(d, cfg.vocab_size))}


def moe_decode_bytes(params: dict, cfg) -> dict:
    """The bytes one decode step must read, by part: the attention's int8
    matrices and scales, the k routed experts' (k / E of the expert stacks),
    the shared expert's, the router and shared gate, the norms, the head."""
    def nbytes(t):
        return sum(nbytes(v) for v in t.values()) if isinstance(t, dict) else t.numel() * t.element_size()

    lay = params["layers"]
    routed = sum(nbytes(lay[n]) for n in ("w_gate", "w_up", "w_down")) * cfg.num_experts_per_tok / cfg.num_experts
    return {"attention": sum(nbytes(lay[n]) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")),
            "routed experts": routed, "shared expert": sum(nbytes(lay[n]) for n in ("sw_gate", "sw_up", "sw_down")),
            "router, gate, norms": sum(nbytes(lay[n]) for n in ("router", "shared_gate", "ln1", "ln2"))
            + nbytes(params["final_norm"]),
            "head": nbytes(params["lm_head"])}


def _routed_row(chk, kernels, gen, name: str, w, scales, idx_sets, path: str) -> dict:
    """Kernel C (``name`` "down") or D ("gateup") over routed rows: row r
    reads matrix idx[r] of the model's whole (L, E, K, N) int8 stack(s)
    ``w``; against its plain version (``w.view(L * E, K, N)[idx]``
    products), timed from graph replays cycling the index sets ``idx_sets``
    (each a (rows,) int32 set of one decode step's routing, ``l * E + e``),
    beside its bound (the distinct experts' bytes this run's indices read)
    and ``torch.bmm`` on the routed matrices gathered and cast to bf16
    beforehand (the gather not timed)."""
    from framefusion_tpu_torch.kernel_bench import graph_time_ms
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv

    key = "gemv_gateup" if name == "gateup" else "gemv_stacked"
    rows = int(idx_sets[0].shape[0])
    k, n = w[0].shape[-2:]
    x = _rand(gen, (rows, k))
    cur = [0]

    def idx():
        cur[0] = (cur[0] + 1) % len(idx_sets)
        return idx_sets[cur[0]]

    if name == "gateup":
        out = mv.matvec_routed_gateup(x, w[0], w[1], scales[0], scales[1], idx_sets[0])
        ref = mv.gemv_gateup_plain(x, w[0].flatten(0, 1), w[1].flatten(0, 1), scales[0].flatten(0, 1),
                                   scales[1].flatten(0, 1), 0, idx_sets[0])
        run_k = lambda: mv.matvec_routed_gateup(x, w[0], w[1], scales[0], scales[1], idx())  # noqa: E731
        run_p = lambda: mv.gemv_gateup_plain(x, w[0].flatten(0, 1), w[1].flatten(0, 1),  # noqa: E731
                                             scales[0].flatten(0, 1), scales[1].flatten(0, 1), 0, idx())
    else:
        out = mv.matvec_routed(x, w[0], idx_sets[0])
        ref = mv.gemv_stacked_plain(x, [w[0].flatten(0, 1)], 0, idx_sets[0])[0]
        run_k = lambda: mv.matvec_routed(x, w[0], idx())  # noqa: E731
        run_p = lambda: mv.gemv_stacked_plain(x, [w[0].flatten(0, 1)], 0, idx())[0]  # noqa: E731
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    shape = f"routed {name} int8 B={rows} K={k} N={n}{'x2' if name == 'gateup' else ''}"
    chk.expect(rel <= GEMV_RTOL, f"{key} {shape}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {GEMV_RTOL}")
    _max_err(kernels[key], err)
    # The yardstick: one bmm over the routed matrices, gathered and cast first.
    gathered = [torch.cat([wi.flatten(0, 1)[s.long()] for wi in w], dim=-1).to(torch.bfloat16) for s in idx_sets[:2]]
    lib = [0]

    def run_l():
        lib[0] ^= 1
        return torch.bmm(x[:, None, :], gathered[lib[0]])

    t_k, t_p, t_l = graph_time_ms(run_k, iters=20), graph_time_ms(run_p, iters=3), graph_time_ms(run_l, iters=20)
    distinct = sum(len(torch.unique(s)) for s in idx_sets) / len(idx_sets)
    entry = {"path": path, "shape": shape, "launches": None, "distinct_experts": distinct}
    per_expert = k * n * len(w) + (n * 4 * len(w) if name == "gateup" else 0)  # D reads the scales, C's caller
    t_b = _bound(entry, distinct * per_expert + rows * (k * 2 + n * 4 + 4), 2 * rows * k * n * len(w))
    entry.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
    was = WAS_MS.get((f"routed {name}", "int8", rows)) if path == "moe_57b" else None
    log(f"  {key} {shape}: kernel {t_k:.4f} ms ({t_b / t_k:.3f} of the bound {t_b:.4f} ms over {distinct:.1f} "
        f"distinct experts, {entry['bound_by']}{'' if was is None else f'; was {was:.4f} ms'}), "
        f"plain {t_p:.4f} ms, torch.bmm on pre-gathered bf16 {t_l:.4f} ms (kernel / library {t_k / t_l:.3f})")
    return entry


def _head_row(chk, kernels, gen, head: dict, rows: int, path: str) -> dict:
    """Kernel C as a one-layer stack over the int8 LM head (``matvec_q8``),
    against its plain version, beside its bound and ``torch.matmul`` on the
    head cast to bf16 beforehand."""
    from framefusion_tpu_torch.kernel_bench import graph_time_ms
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv

    k, n = head["q8"].shape
    x = _rand(gen, (rows, k))
    out = mv.matvec_q8(x, head["q8"], head["scale"])
    ref = mv.gemv_stacked_plain(x, [head["q8"][None]], 0)[0] * head["scale"]
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    shape = f"lm_head int8 B={rows} K={k} N={n}"
    chk.expect(rel <= GEMV_RTOL, f"gemv_stacked {shape}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {GEMV_RTOL}")
    _max_err(kernels["gemv_stacked"], err)
    w_bf16 = (head["q8"].to(torch.float32) * head["scale"]).to(torch.bfloat16)
    t_k = graph_time_ms(lambda: mv.matvec_q8(x, head["q8"], head["scale"]), iters=20)
    t_p = graph_time_ms(lambda: mv.gemv_stacked_plain(x, [head["q8"][None]], 0)[0] * head["scale"], iters=5)
    t_l = graph_time_ms(lambda: torch.matmul(x, w_bf16), iters=20)
    del w_bf16
    entry = {"path": path, "shape": shape, "launches": None}
    t_b = _bound(entry, k * n + n * 4 + rows * (k * 2 + n * 4), 2 * rows * k * n)
    entry.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
    log(f"  gemv_stacked {shape}: kernel {t_k:.4f} ms ({t_b / t_k:.3f} of the bound {t_b:.4f} ms, "
        f"{entry['bound_by']}), plain {t_p:.4f} ms, torch.matmul on the bf16 head {t_l:.4f} ms "
        f"(kernel / library {t_k / t_l:.3f})")
    return entry


def _routed_log(mv):
    """The MoE decode's C and D calls: the routed experts' and the head's by
    (entry point, rows), the stacked matvecs' (the shared expert, the
    attention) by (entry point, K, N)."""
    from framefusion_tpu_torch.parallel.workers import CallLog

    return CallLog(mv, {"matvec_routed": lambda x, w, index: ("down", x.shape[0]),
                        "matvec_routed_gateup": lambda x, wg, wu, sg, su, index: ("gateup", x.shape[0]),
                        "matvec_q8": lambda x, w8, scale: ("lm_head", x.shape[0]),
                        "matvec_stacked": lambda x, w, layer: ("stacked", x.shape[1], w.shape[2]),
                        "matvec_stacked_gateup": lambda x, wg, wu, sg, su, layer: (
                            "stacked gateup", x.shape[1], wg.shape[2])})


def phase_moe_57b(chk: Checks, kernels: dict, ctx: dict) -> None:
    """Phase 17: Qwen2-57B-A14B at full size on one card, int8 with the int8
    head (``moe_57b_params``), through FrameFusionModel + apply_framefusion
    on the main path's 64-frame prompt."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.config import qwen2_moe_a14b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import moe
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.runtime import spec_decode
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph
    from framefusion_tpu_torch.runtime.serving import ServeRequest

    tag = "moe_57b"
    ctx.clear()
    torch.cuda.empty_cache()
    cfg = qwen2_moe_a14b_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe_57b_params(cfg, seed=17)
    torch.cuda.synchronize()
    parts = moe_decode_bytes(params, cfg)
    floor_ms = sum(parts.values()) / kernel_bench.H100_BYTES_PER_S * 1e3
    held = torch.cuda.memory_allocated()
    log(f"  random Qwen2-57B-A14B, int8 with the int8 head, built on the card in {time.perf_counter() - t0:.1f} s: "
        f"{held / 1e9:.2f} GB held ({held / 2**30:.2f} GiB); a decode step reads "
        f"{ {k: round(v / 1e9, 3) for k, v in parts.items()} } GB: {sum(parts.values()) / 1e9:.3f} GB, floor "
        f"{floor_ms:.3f} ms at 3.35 TB/s")
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to("cuda", torch.bfloat16), patch_type=pt,
                           position_ids=np.arange(len(pt)), patch_num=182, image_token_start=img_start,
                           image_token_length=n_img)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), *MOE_KNOBS)
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup,
                "ragged_decode_attn": da.ragged_decode_attn}

    # The main path: the fused prefill and 8 tokens through the int8 decode graph.
    _zero_counts(wrappers)
    with moe.record_drops() as drops, _routed_log(mv) as r_log:
        toks, res = model.generate(inputs, max_new_tokens=8)
        torch.cuda.synchronize()
    ran, replays = _ran(wrappers), DecodeGraph.replays
    routed = r_log.counts(replays)
    drops = [(s, c, int(d)) for s, c, d in drops]
    ev = _events(res)
    log(f"  fused + generate(8): launches that ran {ran} ({replays} decode-graph replays); routed C / D and the "
        f"head by (call, rows) {routed}; events {ev}, final length {res.valid_len} of {len(pt)}, tail from layer "
        f"{res.telemetry.tail_start_layer}, tokens {toks}")
    log(f"  capacity drops by MLP call (rows, capacity, (token, rank) choices dropped of rows x 8): {drops}")
    chk.expect(all(ran[n] > 0 for n in wrappers if n != "attn_importance_rows" or any(e[1] == "prune" for e in ev)),
               f"{tag}: A{', B' if any(e[1] == 'prune' for e in ev) else ''}, C, D and G ran on the main path ({ran})")
    chk.expect(routed.get(("gateup", cfg.num_experts_per_tok), 0) == replays * cfg.num_layers + cfg.num_layers
               and routed.get(("down", cfg.num_experts_per_tok), 0) == routed[("gateup", cfg.num_experts_per_tok)]
               and routed.get(("lm_head", 1), 0) == replays + 1,
               f"{tag}: every decode step ran the routed experts on D and C ({cfg.num_experts_per_tok} rows, once a "
               f"layer) and the head on C, in the warm-up step and each replay")
    chk.expect(len(drops) == cfg.num_layers and all(s >= res.valid_len for s, _, _ in drops),
               f"{tag}: one routed MLP call a layer, at the rows the executor holds")
    chk.expect(bool(torch.isfinite(res.logits).all()) and res.logits.shape == (cfg.vocab_size,) and len(toks) == 8
               and all(0 <= t < cfg.vocab_size for t in toks), f"{tag}: logits finite (vocab,), 8 tokens")
    chk.expect(res.valid_len < len(pt), f"{tag}: the prompt was compressed ({res.valid_len} of {len(pt)})")

    eng = model.engine()
    args = (inputs.input_embeds, pt, inputs.position_ids, 182, img_start, n_img)
    res_p = eng.prefill(*args, mode="planned")
    res_d = eng.dense_prefill(inputs.input_embeds, inputs.position_ids)
    chk.expect(res_p.mode == "planned" and bool(torch.isfinite(res_p.logits).all()),
               f"{tag}: planned prefill ({res_p.mode}, {res_p.plan_source}): events {_events(res_p)}")
    chk.expect(bool(torch.isfinite(res_d.logits).all()), f"{tag}: dense prefill logits finite")
    del res_d
    t_pre = {mode: cuda_time_ms(lambda mode=mode: eng.prefill(*args, mode=mode), iters=2, warmup=1)
             for mode in ("fused", "planned", "dense")}
    prof = kernel_bench.device_profile(lambda: eng.prefill(*args, mode="fused"))
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]
    log(f"  prefill ms at {len(pt)} tokens (CUDA events, mean of 2): fused {t_pre['fused']:.2f}, planned "
        f"{t_pre['planned']:.2f}, dense {t_pre['dense']:.2f}, dense / fused {t_pre['dense'] / t_pre['fused']:.3f}; "
        f"fused under the profiler: device idle share {prof['idle_share']:.4f} of {prof['window_us'] / 1e3:.2f} ms, "
        f"{prof['launches']} device operations; top device kernels (ms) "
        f"{ {k[:70]: round(v / 1e3, 2) for k, v in top} }")
    chk.expect(prof["launches"] > 0, f"{tag}: the profiler saw the fused prefill's device operations")

    # The decode step as one captured graph: ms/step over 32 replays.
    steps = 32
    graph = eng.decode_graph(res, steps + 1)
    _, _, lens = eng.make_decode_state(res, steps + 1, pools=(graph.k_pool, graph.v_pool))
    readings = []
    for _ in range(2):
        graph.start(lens, res.decode_pos_base, res.logits)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.run(steps)
        e1.record()
        torch.cuda.synchronize()
        readings.append(e0.elapsed_time(e1) / steps)
    graph.start(lens, res.decode_pos_base, res.logits)
    dprof = kernel_bench.device_profile(lambda: graph.run(8))
    per_step = {k: v / 8 for k, v in sorted(dprof["by_name"].items(), key=lambda kv: -kv[1])}
    graph.busy = False
    ms_step = sum(readings) / 2
    log(f"  int8 decode graph: {ms_step:.3f} ms/step over {steps} replays ({readings[0]:.3f}, {readings[1]:.3f}), "
        f"{ms_step / floor_ms:.2f}x the {floor_ms:.3f} ms floor; profiler over 8 replays: device idle share "
        f"{dprof['idle_share']:.4f}, {dprof['launches'] / 8:.0f} device operations a step; top kernels a step (us) "
        f"{ {k[:60]: round(v, 2) for k, v in list(per_step.items())[:8]} }")

    # generate_batch at B = 1, 4, 8 over 8 distinct prompts' fused prefills.
    eng._graphs.clear()
    batch = batch_prompts(cfg.hidden_size, max(MOE_BATCH), seed0=0)
    res_b = [eng.prefill(h_, pt_, pos_, 182, s_, n_) for h_, pt_, pos_, s_, n_ in batch]
    b_launch = {}
    for bsz in MOE_BATCH:
        rs = res_b[:bsz]
        _zero_counts(wrappers)
        with _routed_log(mv) as b_log:
            toks_b = eng.generate_batch(rs, 8)
            torch.cuda.synchronize()
        b_launch[bsz] = b_log.counts(DecodeGraph.replays)
        g32 = eng._start_batch_decode(rs, steps + 1, None, None)
        lens_b = [[int(r.layer_caches[l][2]) for r in rs] for l in range(cfg.num_layers)]
        start = (lens_b, [r.decode_pos_base for r in rs], torch.stack([r.logits for r in rs]))
        rd = []
        for _ in range(2):
            g32.start(*start)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            g32.run(steps)
            e1.record()
            torch.cuda.synchronize()
            rd.append(e0.elapsed_time(e1) / steps)
        g32.busy = False
        del g32
        ms_b = sum(rd) / 2
        ctx.setdefault("moe_batch", {})[bsz] = ms_b
        log(f"  generate_batch B={bsz}: {ms_b:.3f} ms/step over {steps} replays ({rd[0]:.3f}, {rd[1]:.3f}), "
            f"{bsz * 1e3 / ms_b:.1f} tokens/s; routed calls by (call, rows) {b_launch[bsz]}")
        chk.expect(len(toks_b) == bsz and all(len(t) == 8 and all(0 <= x < cfg.vocab_size for x in t) for t in toks_b)
                   and b_launch[bsz].get(("gateup", bsz * cfg.num_experts_per_tok), 0) > 0,
                   f"{tag}: generate_batch B={bsz}: rows of 8 tokens, the routed experts on D at "
                   f"{bsz * cfg.num_experts_per_tok} rows")

    # One speculative macro step at K = 5, then a 2-slot serving loop.
    n_spec, kq = 16, SPEC_DRAFT + 1
    out_s = eng.generate_spec(res, n_spec, draft_len=SPEC_DRAFT)
    plain = eng.generate(res, n_spec)
    agree = next((j for j, (a, b) in enumerate(zip(out_s, plain)) if a != b), n_spec)
    sgraph = eng.spec_graph(res, n_spec, SPEC_DRAFT, spec_decode.history_cap([0], n_spec, SPEC_DRAFT))
    _, _, lens_s = eng.make_decode_state(res, 0, pools=(sgraph.k_pool, sgraph.v_pool))
    rd = []
    for _ in range(2):
        sgraph.start(lens_s, res.decode_pos_base, res.logits, [[]], n_spec)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        sgraph.run(4)
        e1.record()
        torch.cuda.synchronize()
        rd.append(e0.elapsed_time(e1) / 4)
    sgraph.busy = False
    del sgraph
    log(f"  generate_spec({n_spec}, K={kq}): agreement with generate({n_spec}) before the first difference (not "
        f"gated: bf16 ties) {agree} of {n_spec}; macro step {sum(rd) / 2:.3f} ms over 4 replays ({rd[0]:.3f}, "
        f"{rd[1]:.3f}), {sum(rd) / 2 / ms_step:.2f}x the decode step")
    chk.expect(len(out_s) == n_spec and all(0 <= t < cfg.vocab_size for t in out_s),
               f"{tag}: generate_spec at K = {kq} gives {n_spec} tokens in the vocabulary")
    eng._graphs.clear()
    solo = [eng.generate_greedy(r, 8) for r in res_b[:2]]
    eng._graphs.clear()
    loop = model.serving_loop(max_slots=2, max_new_cap=8, chunk_steps=4,
                              prefix_cap=max(int(c[2]) for r in res_b[:2] for c in r.layer_caches))
    reqs = [PrefillInputs(torch.from_numpy(h_).to("cuda", torch.bfloat16), pt_, pos_, 182, s_, n_)
            for h_, pt_, pos_, s_, n_ in batch[:2]]
    ids = [loop.submit(ServeRequest(r, max_new_tokens=8)) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = loop.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    got = [served[i].tokens for i in ids]
    log(f"  ServingLoop (2 slots, 2 requests of 8 tokens): {t_serve * 1e3:.1f} ms wall, tokens {got}; agreement "
        f"with each request's solo generate_greedy before the first difference (not gated: bf16 ties) "
        f"{[next((j for j, (a, b) in enumerate(zip(g, s_)) if a != b), 8) for g, s_ in zip(got, solo)]} of 8")
    chk.expect(all(len(t) == 8 and all(0 <= x < cfg.vocab_size for x in t) for t in got),
               f"{tag}: the serving loop ended both requests with 8 tokens in the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated: {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)")
    del loop, served, res_b, res_p, res, graph, eng, model
    head = params["lm_head"]
    w_routed = [params["layers"][n] for n in ("w_gate", "w_up", "w_down")]  # the whole 28-layer stacks
    params.clear()
    torch.cuda.empty_cache()

    # The kernel rows at the routed shapes and the head: the index sets are
    # random top-8 routings (distinct experts within a token), ``l * E + e``
    # into the whole (L * E, K, N) view as the model reads it; one call's
    # tokens share its layer, as a decode step's do, and set i is at layer
    # L - 1 - 3i (27, 24, ..., 6); 8 rows a call for one token, 64 for B = 8.
    gen = torch.Generator(device="cuda").manual_seed(17)
    n_l, n_e, top_k = cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok

    def idx_sets(tokens: int):
        return [torch.cat([(n_l - 1 - 3 * i) * n_e + torch.randperm(n_e, generator=gen, device="cuda")[:top_k]
                           for _ in range(tokens)]).to(torch.int32) for i in range(8)]

    for tokens in (1, 8):
        sets = idx_sets(tokens)
        d_row = _routed_row(chk, kernels, gen, "gateup", [w_routed[0]["q8"], w_routed[1]["q8"]],
                            [w_routed[0]["scale"], w_routed[1]["scale"]], sets, tag)
        c_row = _routed_row(chk, kernels, gen, "down", [w_routed[2]["q8"]], [None], sets, tag)
        rows = tokens * cfg.num_experts_per_tok
        counts = routed if tokens == 1 else b_launch[8]
        _set_launches(d_row, counts.get(("gateup", rows), 0))
        _set_launches(c_row, counts.get(("down", rows), 0))
        kernels["gemv_gateup"]["shapes"].append(d_row)
        kernels["gemv_stacked"]["shapes"].append(c_row)
    del w_routed
    torch.cuda.empty_cache()
    h_row = _head_row(chk, kernels, gen, head, 1, tag)
    _set_launches(h_row, routed.get(("lm_head", 1), 0))
    kernels["gemv_stacked"]["shapes"].append(h_row)
    # The shared expert, one decode row: D at 3,584 -> 2 x 20,480 and C down
    # at K 20,480, int8 (no earlier phase runs these widths).
    hid, si = cfg.hidden_size, cfg.shared_expert_intermediate_size
    for name, kdim, ns, key in (("gateup", hid, [si, si], ("stacked gateup", hid, si)),
                                ("w_down", si, [hid], ("stacked", si, hid))):
        (row,) = _cd_rows(chk, kernels, gen, name, "int8", kdim, ns, (1,), path=tag)
        _set_launches(row, routed.get(key, 0))
        kernels["gemv_gateup" if name == "gateup" else "gemv_stacked"]["shapes"].append(row)
    rows = [e for n in ("gemv_stacked", "gemv_gateup") for e in kernels[n]["shapes"] if e.get("path") == tag]
    chk.expect(all(r["launches"] > 0 for r in rows), f"{tag}: every row's shape ran on this phase's path "
                                                     f"({[(r['shape'], r['launches']) for r in rows]})")
    del head
    torch.cuda.empty_cache()


def _shape_entry(kernel: dict, tag: str) -> dict:
    """The entry of ``kernel``'s ``shapes`` that phase 2 made for ``tag``."""
    return next(e for e in kernel["shapes"] if e.get("path") == tag)


def phase_cross_baselines(chk: Checks) -> None:
    """Every method on the CPU (plain versions) and on the card (kernels).
    With ``readout_params`` the greedy tokens hold by construction, so the
    token check only guards against a gross fault; the logits bounds are the
    checks that can fail: the prefill's for every method, and the last decode
    step's for the sink-cache decode, which shows in nothing else."""
    cpu = tiny_baselines_run("cpu")
    gpu = tiny_baselines_run("cuda")
    for name in baseline_methods(6):
        c, g = cpu[name], gpu[name]
        rel = float((c[3] - g[3]).abs().max() / c[3].abs().max())
        log(f"  {name}: events {g[0]}, cache lengths {g[1]}; cpu tokens {c[2]}, cuda tokens {g[2]}")
        chk.expect(c[0] == g[0] and c[1] == g[1], f"cross {name}: events and cache lengths equal")
        chk.expect(c[2] == g[2], f"cross {name}: greedy tokens equal")
        chk.expect(rel <= LOGIT_RTOL, f"cross {name}: prefill logits differ by {rel:.3e} of their largest "
                                      f"<= {LOGIT_RTOL}")
        if c[4] is not None:
            rel_d = float((c[4] - g[4]).abs().max() / c[4].abs().max())
            chk.expect(rel_d <= LOGIT_RTOL, f"cross {name}: the last decode step's logits differ by {rel_d:.3e} of "
                                            f"their largest <= {LOGIT_RTOL}")
    chk.expect(cpu["F"] == 0 and gpu["F"] == 12, f"cross: kernel F launched on the card only, once per layer of "
                                                 f"the two StreamingLLM prefills ({cpu['F']}, {gpu['F']})")


def phase_baselines(chk: Checks, kernels: dict) -> None:
    """The paper's method comparison at full width: random Qwen2-7B weights
    (bf16, drawn afresh: phase 4 quantized its own), the 64-frame prompt,
    every method's prefill and 8 greedy tokens."""
    from framefusion_tpu_torch.baselines import replace_forward
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp
    from framefusion_tpu_torch.ops.rope import apply_rope

    cfg = qwen2_7b_config()
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to("cuda", torch.bfloat16), patch_type=pt,
                           position_ids=np.arange(len(pt)), patch_num=182, image_token_start=img_start,
                           image_token_length=n_img)
    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
    methods = {"dense": model, "framefusion": apply_framefusion(model, 0.3, 0.6, 0.1)}
    methods.update({name: replace_forward(model, mode, **kw) for name, (mode, kw) in
                    baseline_methods(cfg.num_layers).items()})
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "sink_attn_fwd": sp.sink_attn_fwd}

    _zero_counts(wrappers)
    results = {}
    for name, m in methods.items():
        f0 = sp.sink_attn_fwd.launches
        res = m.prefill(inputs)
        torch.cuda.synchronize()
        if getattr(m.engine(), "mode", None) == "streamingllm":
            n_f = sp.sink_attn_fwd.launches - f0
            chk.expect(n_f == cfg.num_layers, f"{name}: {n_f} kernel F launches in the prefill (one per layer)")
        toks = m.engine().generate(res, 8)
        results[name] = (res, toks)
    torch.cuda.synchronize()
    counts = _ran(wrappers)
    _set_launches(kernels["sink_attn_fwd"], counts["sink_attn_fwd"])
    log(f"  launches over the eight methods' prefill + generate(8): {counts}")
    for name, n in counts.items():
        chk.expect(n > 0, f"{name}: {n} launches in the method comparison")

    # Kernel F on the tensors the StreamingLLM prefill gives it: layer 0's
    # q, k, v at the bucket-padded length, with the prefill's sink and window.
    eng = methods["streamingllm"].engine()
    h0, _, pos0, _ = eng._prep_inputs(inputs.input_embeds, pt, inputs.position_ids)
    lp = qwen2.layer_slice(params["layers"], 0)
    q, k, v = qwen2._project_qkv(lp, qwen2.rmsnorm(h0, lp["ln1"], cfg.rms_norm_eps), cfg)
    q, k = apply_rope(q, k, *qwen2.token_cos_sin(pos0, cfg))
    window = int(0.3 * len(pt)) - 8
    out, ref = sp.sink_attn_fwd(q, k, v, 8, window).float(), sp.sink_attn_fwd_plain(q, k, v, 8, window).float()
    err_rh = (out - ref).abs().amax(-1)
    rel = (err_rh / ref.abs().amax(-1).clamp(min=1e-30)).max().item()
    _max_err(kernels["sink_attn_fwd"], err_rh.max().item())
    chk.expect(rel <= ATTN_ROW_RTOL, f"F on the StreamingLLM prefill's layer-0 q, k, v (S={q.shape[0]}, window "
                                     f"{window}): max_abs_err {err_rh.max().item():.3e}; per (row, head) error / its "
                                     f"largest output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
    del h0, q, k, v, out, ref, err_rh

    t_prefill = {}
    for name, m in methods.items():
        res, toks = results[name]
        t_pre = t_prefill[name] = cuda_time_ms(lambda: m.prefill(inputs), iters=3, warmup=1)
        tel = res.telemetry
        reduction = tel.vision_token_reduction if tel is not None else 0.0
        log(f"  {name}: prefill {t_pre:.2f} ms (CUDA events, mean of 3), tokens kept {res.valid_len} of {len(pt)}, "
            f"vision-token reduction {reduction:.4f}, tokens {toks}")
        chk.expect(bool(torch.isfinite(res.logits).all()) and res.logits.shape == (cfg.vocab_size,)
                   and len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks),
                   f"{name}: logits finite, 8 tokens in the vocabulary")
    log("  prefill ms against dense's: " + ", ".join(f"{name} {t / t_prefill['dense']:.3f}"
                                                       for name, t in t_prefill.items() if name != "dense"))
    t_gen = cuda_time_ms(lambda: methods["streamingllm_sink_decode"].engine().generate(
        results["streamingllm_sink_decode"][0], 8), iters=3, warmup=1)
    log(f"  sink-cache decode: generate(8) {t_gen:.2f} ms = {t_gen / 7:.2f} ms per decode step")

    # A window over the whole prompt makes the sink mask causal: the first
    # token must be dense's.
    # FastV keeping every token is a causal prefill (kernel A) at the same
    # padded length as StreamingLLM's.
    full = replace_forward(model, "streamingllm", init_num=8, length_rate=1.0).prefill(inputs)
    causal = replace_forward(model, "fastv", fastv_k=3, fastv_r=0.0).prefill(inputs)
    dense = results["dense"][0].logits
    rel = float((full.logits - dense).abs().max() / dense.abs().max())
    rel_c = float((full.logits - causal.logits).abs().max() / causal.logits.abs().max())
    top2 = torch.topk(dense, 2).values
    tok_s, tok_d = int(torch.argmax(full.logits)), int(torch.argmax(dense))
    chk.expect(tok_s == tok_d, f"streamingllm length_rate 1.0: first token {tok_s} == dense's {tok_d} (logits "
                               f"differ by {rel:.3e} of their largest; dense's top-2 margin "
                               f"{float(top2[0] - top2[1]):.4f})")
    chk.expect(rel_c <= LOGIT_RTOL, f"streamingllm length_rate 1.0: logits differ from the causal prefill at the "
                                    f"same padded length (FastV keeping every token) by {rel_c:.3e} <= {LOGIT_RTOL}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_batch(chk: Checks, kernels: dict, ctx: dict) -> None:
    """The batched main path at full width: random Qwen2-7B weights (bf16)
    and 8 distinct 64-frame prompts; ``prefill_planned_batch`` at B = 1, 2,
    4, 8 against the solo ``prefill_planned`` at the same buckets, then
    ``generate_batch`` on the int8 model as a captured graph of
    ``decode_step_batch`` (kernels C and D at B rows)."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph
    from framefusion_tpu_torch.runtime.engine import CompressionEngine, PlanHistory, best_tail_split

    cfg = qwen2_7b_config()
    b_max, n, steps, forced = max(BATCH_SIZES), 8, 32, 3
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    batch = [(torch.from_numpy(h).to("cuda", cfg.dtype), pt, pos, s0, n_img)
             for h, pt, pos, s0, n_img in batch_prompts(cfg.hidden_size, b_max)]
    log(f"  {b_max} prompts of {len(batch[0][1])} tokens (seeds 0..{b_max - 1}, coherence 0.35 / 0.45 / 0.55) made "
        f"in {time.perf_counter() - t0:.1f} s")
    eng = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), 0.3, 0.6, 0.1).engine()
    # Each prompt's solo fused prefill seeds PlanHistory (one geometry): the
    # batches and the solo planned prefills then plan at its buckets.
    for i, b in enumerate(batch):
        res = eng.prefill(*b[:3], 182, *b[3:])
        if i == 0:
            ctx["res_fused"] = res  # phase 10's solo speculative decode
    pre_plan, plan = eng.plan_history.suggest(PlanHistory.key(182, 64, eng.ff), eng.ff.bucket)
    args = [(*b[:3], 182, *b[3:]) for b in batch]
    solo = [eng.prefill_planned(*a, plan_len=plan, pre_plan_len=pre_plan) for a in args]

    def ev(r):
        return [(e.layer, e.kind, e.tokens_removed) for e in r.telemetry.events]

    log(f"  PlanHistory buckets: pre_plan {pre_plan}, plan {plan}; solo planned: modes {[r.mode for r in solo]}, "
        f"final lengths {[r.valid_len for r in solo]}, tail from layers {[r.telemetry.tail_start_layer for r in solo]}")
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup}
    res_max = None
    for bsz in BATCH_SIZES:
        part = batch[:bsz]
        _zero_counts(wrappers)
        res = eng.prefill_planned_batch(part, 182)
        torch.cuda.synchronize()
        if bsz == b_max:
            ran, res_max = _ran(wrappers), res
            for name in ("flash_attn_fwd", "attn_importance_rows"):
                kernels[name]["batch_launches"] = {"eager": ran[name], "captured": 0, "replayed": 0}
            log(f"  batch of {bsz}: kernel launches that ran in prefill_planned_batch {ran}")
        same = all(r.mode == "planned_batch" and r.plan_source == "history" and ev(r) == ev(s)
                   and r.valid_len == s.valid_len and [c[2] for c in r.layer_caches] == [c[2] for c in s.layer_caches]
                   for r, s in zip(res, solo))
        rel = max(float((r.logits - s.logits).abs().max() / s.logits.abs().max()) for r, s in zip(res, solo))
        chk.expect(same, f"batch B={bsz}: every prompt planned from history, events, final and cache lengths equal "
                         f"the solo planned prefill's (shared tail from layer {res[0].telemetry.tail_start_layer})")
        chk.expect(rel <= LOGIT_RTOL and all(bool(torch.isfinite(r.logits).all()) for r in res),
                   f"batch B={bsz}: prefill logits finite, {rel:.3e} of the largest from the solo prefill's "
                   f"<= {LOGIT_RTOL}")
        part_args = args[:bsz]
        t_batch = cuda_time_ms(lambda: eng.prefill_planned_batch(part, 182), iters=2, warmup=0)
        t_solo = cuda_time_ms(lambda: [eng.prefill_planned(*a, plan_len=plan, pre_plan_len=pre_plan)
                                       for a in part_args], iters=2, warmup=0)
        log(f"  batch B={bsz}: prefill_planned_batch {t_batch:.2f} ms against {bsz} solo prefill_planned "
            f"{t_solo:.2f} ms (batch / solo {t_batch / t_solo:.3f}; CUDA events, mean of 2)")
    del solo
    log(f"  max_memory_allocated (bf16 prefills): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The batched decode on the int8 model (the decode configuration of
    # phases 4b and 4c), over the B = 8 batch's results.
    params_q = quantize_params_int8(params)
    eng_q = CompressionEngine(params_q, cfg, eng.ff)
    floor_ms = kernel_bench.weight_stream_bytes(params_q) / kernel_bench.H100_BYTES_PER_S * 1e3
    gen = torch.Generator(device="cuda").manual_seed(9)
    for bsz in BATCH_SIZES:
        res = res_max[:bsz]
        lens = [[int(r.layer_caches[l][2]) for r in res] for l in range(cfg.num_layers)]
        start = (lens, [r.decode_pos_base for r in res], torch.stack([r.logits for r in res]))
        _zero_counts(wrappers)
        with _cd_log(mv) as cd_log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = eng_q.batch_decode_graph(res, n)
            torch.cuda.synchronize()
            t_capture = time.perf_counter() - t0
            toks = eng_q.generate_batch(res, n)
            torch.cuda.synchronize()
        replays, ran = DecodeGraph.replays, _ran(wrappers)
        cd = cd_log.counts(replays)
        captured = {k: w.captured for k, w in wrappers.items() if w.captured}
        log(f"  decode B={bsz}: pool {tuple(graph.k_pool.shape)}, write_pos {graph.write_pos}, split "
            f"{graph.tail_split}; warm-up step + capture {t_capture * 1e3:.1f} ms; generate_batch({n}): "
            f"{replays} replays; launches that ran {ran}, captured {captured}; C/D by (kernel, rows, K, widths) {cd}")
        chk.expect(replays == n - 1 and captured == {"gemv_stacked": 3 * cfg.num_layers, "gemv_gateup": cfg.num_layers}
                   and all(DecodeGraph.replayed[k] == replays * c for k, c in captured.items())
                   and sum(cd.values()) == ran["gemv_stacked"] + ran["gemv_gateup"],
                   f"decode B={bsz}: one batched graph, captured with C three times and D once a layer, replayed "
                   f"for the {n - 1} tokens after the prefill's; every C and D launch recorded with its rows")
        for (key, rows, kdim, widths), count in cd.items():
            name = "gateup" if key == "gemv_gateup" else SHAPES_C.get((kdim, widths))
            for shape in kernels[key]["shapes"]:
                if shape["shape"] == f"{name} int8 B={rows}":
                    shape["launches"] = count
        if bsz == b_max:
            for name in ("gemv_stacked", "gemv_gateup"):
                kernels[name]["batch_launches"] = {"eager": wrappers[name].launches,
                                                   "captured": wrappers[name].captured,
                                                   "replayed": DecodeGraph.replayed[name]}

        # Teacher forcing: the batched replays against each row's solo eager
        # "ragged" steps (host ints, kernel G), all fed the solo steps' tokens.
        graph = eng_q._start_batch_decode(res, n, None, None)
        solo_states = []
        for r in res:
            k_pool, v_pool, lens_r = eng_q.make_decode_state(r, n)
            solo_states.append([k_pool, v_pool, lens_r, best_tail_split(lens_r, int(k_pool.shape[1]), n,
                                                                        eng_q.ff.bucket)])
        tok, worst = torch.stack([torch.argmax(r.logits) for r in res]), 0.0
        for step in range(forced):
            rows = []
            for i, (r, st) in enumerate(zip(res, solo_states)):
                logits, st[0], st[1], st[2] = qwen2.decode_step(params_q, qwen2.embed(params_q, tok[i]),
                                                                r.decode_pos_base + step, st[0], st[1], st[2], cfg,
                                                                attn_impl="ragged", tail_split=st[3])
                rows.append(logits)
            ref = torch.stack(rows)
            graph.tok.copy_(tok)
            graph.run(1)
            worst = max(worst, float(((graph.logits - ref).abs().amax(-1) / ref.abs().amax(-1)).max()))
            tok = torch.argmax(ref, dim=-1)
        graph.busy = False
        del solo_states
        chk.expect(worst <= LOGIT_RTOL, f"decode B={bsz}: {forced} teacher-forced batched replays against the solo "
                                        f"eager steps: logits differ by {worst:.3e} of their row's largest "
                                        f"<= {LOGIT_RTOL}")
        solo_toks = [eng_q.generate(r, n) for r in res]
        agree = [next((j for j, (a, c) in enumerate(zip(s_, t_)) if a != c), n) for s_, t_ in zip(solo_toks, toks)]
        chk.expect(all(0 <= t < cfg.vocab_size for row in toks for t in row) and len(toks) == bsz,
                   f"decode B={bsz}: {bsz} rows of {n} tokens in the vocabulary")
        log(f"  decode B={bsz}: greedy tokens agreeing with the solo decodes before the first difference "
            f"(reported, not gated: bf16 ties): {agree} of {n}")

        # ms/step over 32 replays (two readings); the plain attention alone.
        g32 = eng_q._start_batch_decode(res, steps + 1, None, None)
        readings = []
        for _ in range(2):
            g32.start(*start)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            g32.run(steps)
            e1.record()
            torch.cuda.synchronize()
            readings.append(e0.elapsed_time(e1) / steps)
        ms = sum(readings) / 2
        q = _rand(gen, (bsz, cfg.num_heads, cfg.head_dim_))
        kv_cur = _rand(gen, (2, bsz, cfg.num_kv_heads, cfg.head_dim_))
        pos_iota = torch.arange(g32.k_pool.shape[2], device="cuda")
        in_decode = (pos_iota >= g32.write_pos) & (pos_iota < g32.write_pos + steps // 2)
        prefix = [pos_iota[None, :] < g32.lens[l][:, None] for l in range(cfg.num_layers)]
        t_attn = kernel_bench.graph_time_ms(lambda: [qwen2.batch_decode_attention(
            q, kv_cur[0], kv_cur[1], g32.k_pool, g32.v_pool, l, prefix[l], in_decode, g32.tail_split,
            cfg.head_dim_ ** -0.5) for l in range(cfg.num_layers)], iters=3)
        log(f"  decode B={bsz}: {ms:.3f} ms/step over {steps} replays ({readings[0]:.3f}, {readings[1]:.3f}), "
            f"{bsz * 1e3 / ms:.1f} tokens/s, {ms / floor_ms:.2f}x the {floor_ms:.3f} ms weight-stream floor; the "
            f"plain attention of a step alone (28 layers, a captured graph at step {steps // 2}) {t_attn:.3f} ms, "
            f"{t_attn / ms:.3f} of the step")
        chk.expect(all(math.isfinite(t) and t > 0 for t in readings + [t_attn]), f"decode B={bsz}: times measured")
        if bsz in (1, b_max):
            g32.start(*start)
            prof = kernel_bench.device_profile(lambda: g32.run(8))
            per_step = {k: v / 8 for k, v in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])}

            def part_ms(name):
                return sum(v for k, v in per_step.items() if name in k) / 1e3

            chk.expect(prof["launches"] > 0, f"decode B={bsz}: the profiler saw the replays' device operations")
            log(f"  decode B={bsz}, profiler over 8 replays: device idle share {prof['idle_share']:.4f} of the "
                f"{prof['window_us'] / 8e3:.3f} ms a step; {prof['launches'] / 8:.0f} device operations a step; "
                f"device ms a step: C+D pass (gemv_kernel, rows_kernel) "
                f"{part_ms('gemv_kernel') + part_ms('rows_kernel'):.3f}, D epilogue "
                f"{part_ms('gateup_reduce'):.3f}, all {prof['busy_us'] / 8e3:.3f}")
            log(f"  decode B={bsz}, top device kernels a step (us): "
                f"{ {k[:60]: round(v, 2) for k, v in list(per_step.items())[:8]} }")
        g32.busy = False
        del g32, graph
    for shape in kernels["gemv_stacked"]["shapes"] + kernels["gemv_gateup"]["shapes"]:
        if " bf16 B=" in shape["shape"]:
            shape["launches"] = 0  # this phase and phase 10 decode int8
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ctx.update(cfg=cfg, params_q=params_q, eng_q=eng_q, batch=batch, res_batch=res_max[:4])  # for phase 10


def _graph_equals_eager(owner, replay, eager, n: int) -> list:
    """``replay(n)`` against ``n`` calls of ``eager()`` run on the capture
    stream from the same state: the names of ``owner``'s tensors that are
    not bitwise equal afterwards. The state is put back as it was."""
    from framefusion_tpu_torch.runtime.decode_graph import capture_stream

    names = [k for k, v in vars(owner).items() if isinstance(v, torch.Tensor) and k != "counters"]
    start = {k: getattr(owner, k).clone() for k in names}
    replay(n)
    torch.cuda.synchronize()
    replayed = {k: getattr(owner, k).clone() for k in names}
    for k in names:
        getattr(owner, k).copy_(start[k])
    stream = capture_stream("cuda")
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(n):
            eager()
    torch.cuda.synchronize()
    differ = [k for k in names if not torch.equal(getattr(owner, k), replayed[k])]
    for k in names:
        getattr(owner, k).copy_(start[k])
    torch.cuda.synchronize()
    return differ


def phase_spec_serve(chk: Checks, kernels: dict, ctx: dict) -> None:
    """Speculative decoding and the serving loop at full width, on phase
    9's int8 model (Qwen2-7B, seed 0, phase 4's weights) and prompts:
    teacher-forced checks of the verify programs' device forms, each
    captured macro step against its eager body, generate_spec and
    generate_spec_batch against generate and generate_batch, and the
    ServingLoop over the 8 prompts at draft_len 0 and 4."""
    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.runtime import spec_decode
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph
    from framefusion_tpu_torch.runtime.engine import best_tail_split, best_tail_split_batch
    from framefusion_tpu_torch.runtime.serving import ServeRequest, ServingLoop

    cfg, params, eng = ctx["cfg"], ctx["params_q"], ctx["eng_q"]
    res, res_b = ctx["res_fused"], ctx["res_batch"]
    eng._graphs.clear()
    dev, n_l, kq = torch.device("cuda"), cfg.num_layers, SPEC_DRAFT + 1
    n_spec, n_batch = 64, 32
    yes = torch.ones((), dtype=torch.bool, device=dev)
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup}
    spec = {name: {"eager": 0, "captured": 0, "replayed": 0} for name in ("gemv_stacked", "gemv_gateup")}
    by_rows: dict = {}  # C / D launches by (kernel, rows, K, widths) over the main-path runs

    def tally(cd_log):
        """Add the main-path run since ``_zero_counts`` to phase 10's counts."""
        for name, entry in spec.items():
            entry["eager"] += wrappers[name].launches
            entry["captured"] += wrappers[name].captured
            entry["replayed"] += DecodeGraph.replayed[name]
        for key, n in cd_log.counts(DecodeGraph.replays).items():
            by_rows[key] = by_rows.get(key, 0) + n

    # -- the verify programs' device forms ---------------------------------
    toks = eng.generate(res, kq)  # the rows both sides are fed (teacher forcing)
    rows = torch.tensor(toks, device=dev)
    k_pool, v_pool, lens = eng.make_decode_state(res, n_spec + SPEC_DRAFT)
    split = best_tail_split(lens, int(k_pool.shape[1]), n_spec + SPEC_DRAFT, eng.ff.bucket)
    lv = qwen2.verify_step(params, qwen2.embed(params, rows), res.decode_pos_base + torch.arange(kq, device=dev),
                           k_pool.clone(), v_pool.clone(), torch.tensor(lens, device=dev), cfg, attn_impl="flash",
                           tail_split=split, gate=yes)[0]
    for impl in ("flash", "ragged"):
        kp, vp, ln, seq = k_pool.clone(), v_pool.clone(), lens, []
        for i in range(kq):
            lg, kp, vp, ln = qwen2.decode_step(params, qwen2.embed(params, rows[i]), res.decode_pos_base + i, kp, vp,
                                               ln, cfg, attn_impl=impl, tail_split=split)
            seq.append(lg)
        err = kernel_bench.rel_err(lv, torch.stack(seq))
        chk.expect(bool(torch.isfinite(lv).all()) and err <= LOGIT_RTOL,
                   f"spec: device-form verify_step (K={kq}, kernels C and D at {kq} rows) against {kq} eager "
                   f"decode_step(\"{impl}\") steps, teacher forced at full width: logits differ by {err:.3e} of the "
                   f"largest <= {LOGIT_RTOL}")
    del k_pool, v_pool, kp, vp, seq

    lens_b = [[int(c[2]) for c in r.layer_caches] for r in res_b]
    s_pool_b, write_pos = spec_decode.spec_geometry(lens_b, n_batch, SPEC_DRAFT, eng.ff.bucket)
    split_b = best_tail_split_batch(lens_b, s_pool_b, write_pos, eng.ff.bucket)
    shape = (n_l, SPEC_B, s_pool_b, cfg.num_kv_heads, cfg.head_dim_)
    kb, vb = torch.zeros(shape, dtype=cfg.dtype, device=dev), torch.zeros(shape, dtype=cfg.dtype, device=dev)
    for b, r in enumerate(res_b):
        eng.make_decode_state(r, 0, pools=(kb, vb), column=b)
    gen = torch.Generator(device="cuda").manual_seed(10)
    embs = qwen2.embed(params, torch.randint(0, cfg.vocab_size, (SPEC_B, kq), generator=gen, device=dev))
    pos = [[r.decode_pos_base + 2 + i for i in range(kq)] for r in res_b]
    dmask = torch.zeros((SPEC_B, s_pool_b), dtype=torch.bool, device=dev)
    dmask[:, write_pos:write_pos + 3] = True  # committed rows of an earlier step
    lens_lb = [list(col) for col in zip(*lens_b)]
    host = qwen2.verify_step_batch(params, embs, pos, kb.clone(), vb.clone(), lens_lb, dmask, write_pos, 1, cfg,
                                   tail_split=split_b)
    devf = qwen2.verify_step_batch(params, embs, torch.tensor(pos, device=dev), kb.clone(), vb.clone(),
                                   torch.tensor(lens_lb, device=dev), dmask, torch.tensor(write_pos, device=dev),
                                   torch.tensor(1, device=dev), cfg, tail_split=split_b, gate=yes)
    chk.expect(all(torch.equal(a, b) for a, b in zip(host[:3], devf[:3])) and bool(torch.isfinite(host[0]).all()),
               f"spec: device-form verify_step_batch (B={SPEC_B}, K={kq}, pools {tuple(kb.shape)}, split {split_b}) "
               f"bitwise its host-int form (logits and pools)")
    del kb, vb, host, devf

    # -- generate_spec (solo) against generate ------------------------------
    walls = {}
    _zero_counts(wrappers)
    with _cd_log(mv) as cd:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_spec, stats = eng.generate_spec(res, n_spec, draft_len=SPEC_DRAFT, return_stats=True)
        walls["spec first"] = (time.perf_counter() - t0) * 1e3
    replays, captured = DecodeGraph.replays, {k: w.captured for k, w in wrappers.items() if w.captured}
    tally(cd)
    chk.expect(replays == stats["macro_steps"] and captured == {"gemv_stacked": 3 * n_l, "gemv_gateup": n_l}
               and all(DecodeGraph.replayed[k] == replays * c for k, c in captured.items()),
               f"generate_spec: one captured macro step with C three times and D once a layer ({captured}), "
               f"{replays} replays for {stats['macro_steps']} macro steps")
    for kind, fn in (("spec", lambda: eng.generate_spec(res, n_spec, draft_len=SPEC_DRAFT)),
                     ("plain", lambda: eng.generate(res, n_spec)), ("plain", lambda: eng.generate(res, n_spec)),
                     ("spec", lambda: eng.generate_spec(res, n_spec, draft_len=SPEC_DRAFT))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        walls.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
    plain = eng.generate(res, n_spec)
    agree = next((j for j, (a, b) in enumerate(zip(out_spec, plain)) if a != b), n_spec)
    chk.expect(len(out_spec) == n_spec and all(0 <= t < cfg.vocab_size for t in out_spec) and got == out_spec,
               f"generate_spec({n_spec}): {n_spec} tokens in the vocabulary, the same on every call")
    log(f"  generate_spec({n_spec}, draft_len {SPEC_DRAFT}): {stats['macro_steps']} macro steps, "
        f"{stats['tokens_per_pass']:.3f} tokens a pass, acceptance {stats['accepted']} / {stats['drafted']} "
        f"({stats['accepted'] / max(stats['drafted'], 1):.3f}; random weights repeat tokens: claims nothing); "
        f"tokens agreeing with generate({n_spec}) before the first difference (bf16 ties not gated): "
        f"{agree} of {n_spec}")
    log(f"  wall ms after the prefill: generate_spec({n_spec}) {walls['spec']} (first call with its capture "
        f"{walls['spec first']:.1f}), generate({n_spec}) {walls['plain']}; spec / plain "
        f"{sum(walls['spec']) / sum(walls['plain']):.3f}")

    # The mechanism with drafts that hit: the history seeded with the plain
    # decode's own tokens (an oracle; the same tokens must come out).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_o, stats_o = eng.generate_spec(res, n_spec, draft_len=SPEC_DRAFT, prompt_ids=plain, return_stats=True)
    wall_o = (time.perf_counter() - t0) * 1e3
    agree_o = next((j for j, (a, b) in enumerate(zip(out_o, plain)) if a != b), n_spec)
    log(f"  generate_spec({n_spec}) with the plain tokens as its history (oracle drafts): {stats_o['macro_steps']} "
        f"macro steps, {stats_o['tokens_per_pass']:.3f} tokens a pass, acceptance {stats_o['accepted']} / "
        f"{stats_o['drafted']}, wall {wall_o:.1f} ms; agreement with generate({n_spec}) {agree_o} of {n_spec}")
    chk.expect(stats_o["macro_steps"] < n_spec - 1 and len(out_o) == n_spec,
               f"generate_spec with oracle drafts: {stats_o['macro_steps']} macro steps < {n_spec - 1}")

    hist_cap = spec_decode.history_cap([0], n_spec, SPEC_DRAFT)
    graph = eng.spec_graph(res, n_spec, SPEC_DRAFT, hist_cap)
    _, _, lens = eng.make_decode_state(res, 0, pools=(graph.k_pool, graph.v_pool))

    def macro_ms(g, start, steps=16):
        readings = []
        for _ in range(2):
            start()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            g.run(steps)
            e1.record()
            torch.cuda.synchronize()
            readings.append(e0.elapsed_time(e1) / steps)
        return readings

    start_solo = lambda: graph.start(lens, res.decode_pos_base, res.logits, [[]], n_spec)  # noqa: E731
    ms_solo = macro_ms(graph, start_solo)
    start_solo()
    graph.run(2)
    differ = _graph_equals_eager(graph, graph.run, graph._step, 3)
    chk.expect(not differ, f"spec: 3 replayed solo macro steps bitwise the eager ones (differ: {differ})")
    graph.busy = False

    # -- generate_spec_batch (B = 4) against generate_batch -----------------
    _zero_counts(wrappers)
    with _cd_log(mv) as cd:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_b, stats_b = eng.generate_spec_batch(res_b, n_batch, draft_len=SPEC_DRAFT, return_stats=True)
        wall_b = (time.perf_counter() - t0) * 1e3
    replays = DecodeGraph.replays
    tally(cd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_b2 = eng.generate_spec_batch(res_b, n_batch, draft_len=SPEC_DRAFT)
    wall_b2 = (time.perf_counter() - t0) * 1e3
    plain_b = eng.generate_batch(res_b, n_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_batch(res_b, n_batch)
    wall_pb = (time.perf_counter() - t0) * 1e3
    agree_b = [next((j for j, (a, b) in enumerate(zip(s_, p_)) if a != b), n_batch) for s_, p_ in zip(out_b, plain_b)]
    chk.expect(out_b2 == out_b and len(out_b) == SPEC_B and all(len(r) == n_batch for r in out_b)
               and all(0 <= t < cfg.vocab_size for r in out_b for t in r) and replays == stats_b["macro_steps"],
               f"generate_spec_batch(B={SPEC_B}, {n_batch}): rows of {n_batch} tokens in the vocabulary, the same on "
               f"every call, one replay a macro step")
    log(f"  generate_spec_batch(B={SPEC_B}, {n_batch}): {stats_b['macro_steps']} macro steps, "
        f"{stats_b['tokens_per_pass']:.3f} tokens a pass (the slowest row), accepted {stats_b['accepted']} of "
        f"drafted {stats_b['drafted']}; agreement with generate_batch before the first difference (not gated): "
        f"{agree_b} of {n_batch}; wall ms {wall_b2:.1f} (first call with its capture {wall_b:.1f}), "
        f"generate_batch {wall_pb:.1f}")
    bgraph = eng.spec_batch_graph(res_b, n_batch, SPEC_DRAFT, spec_decode.history_cap([0] * SPEC_B, n_batch,
                                                                                       SPEC_DRAFT))
    cols = [eng.make_decode_state(r, 0, pools=(bgraph.k_pool, bgraph.v_pool), column=b)[2]
            for b, r in enumerate(res_b)]
    start_b = lambda: bgraph.start(list(zip(*cols)), [r.decode_pos_base for r in res_b],  # noqa: E731
                                   torch.stack([r.logits for r in res_b]), [[]] * SPEC_B, n_batch)
    ms_b = macro_ms(bgraph, start_b)
    start_b()
    bgraph.run(2)
    differ = _graph_equals_eager(bgraph, bgraph.run, bgraph._step, 3)
    chk.expect(not differ, f"spec: 3 replayed batched macro steps bitwise the eager ones (differ: {differ})")
    bgraph.busy = False
    floor_ms = kernel_bench.weight_stream_bytes(params) / kernel_bench.H100_BYTES_PER_S * 1e3
    log(f"  macro step ms over 16 replays (two readings): solo K={kq} {ms_solo} (pool "
        f"{tuple(graph.k_pool.shape)}, split {graph.tail_split}), B={SPEC_B} x K={kq} {ms_b} (pool "
        f"{tuple(bgraph.k_pool.shape)}, split {bgraph.tail_split}); weight-stream floor {floor_ms:.3f} ms")
    chk.expect(all(math.isfinite(t) and t > 0 for t in ms_solo + ms_b), "spec: macro-step times measured")
    del graph, bgraph
    eng._graphs.clear()

    # -- the serving loop -----------------------------------------------------
    inputs = [PrefillInputs(h, pt, pos_, 182, s0, n_img) for h, pt, pos_, s0, n_img in ctx["batch"]]
    budgets = [32, 20, 32, 12, 28, 32, 16, 24]
    order = [2, 0, 5, 7, 1, 4, 6, 3]  # the staggered submission order
    solo, max_lens = {}, [0] * n_l
    for i, inp in enumerate(inputs):
        r = eng.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, 182, inp.image_token_start,
                        inp.image_token_length)
        solo[i] = eng.generate_greedy(r, budgets[i])
        max_lens = [max(a, int(c[2])) for a, c in zip(max_lens, r.layer_caches)]
        del r
    eng._graphs.clear()
    log(f"  serving: solo references (fused prefill on the int8 weights, then generate_greedy); per-layer longest "
        f"cache {max_lens}")
    for draft in (0, SPEC_DRAFT):
        loop = ServingLoop(eng, max_slots=SPEC_B, max_new_cap=32, chunk_steps=8, draft_len=draft,
                           prefix_cap=max(max_lens), tail_pool=(2, 3456))
        ids = {loop.submit(ServeRequest(inputs[i], max_new_tokens=budgets[i])): i for i in order}
        _zero_counts(wrappers)
        with _cd_log(mv) as cd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = loop.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ran, replays = _ran(wrappers), DecodeGraph.replays
        captured = {k: w.captured for k, w in wrappers.items() if w.captured}
        tally(cd)
        # A replayed chunk step against the eager one, on a loop of its own
        # (its launches are no part of the path): four admissions, a chunk.
        check = ServingLoop(eng, max_slots=SPEC_B, max_new_cap=32, chunk_steps=8, draft_len=draft,
                            prefix_cap=max(max_lens), tail_pool=(2, 3456))
        for i in order[:SPEC_B]:
            check.submit(ServeRequest(inputs[i], max_new_tokens=budgets[i]))
        check.step()
        cgraph = next(iter(check._graphs.values()))
        differ = _graph_equals_eager(check, cgraph._replay, lambda: check._macro_step(cgraph.split), 2)
        del check, cgraph
        chk.expect(not differ, f"serving draft_len {draft}: 2 replayed chunk steps bitwise the eager ones "
                               f"(differ: {differ})")
        ended = sorted(ids.values()) == sorted(ids[r] for r in results) and all(
            1 <= len(results[r].tokens) <= budgets[ids[r]] for r in results)
        agree = {ids[r]: next((j for j, (a, b) in enumerate(zip(results[r].tokens, solo[ids[r]])) if a != b),
                              len(solo[ids[r]])) for r in results}
        n_tok = sum(len(r.tokens) for r in results.values())
        chk.expect(ended and all(0 <= t < cfg.vocab_size for r in results.values() for t in r.tokens),
                   f"serving draft_len {draft}: every request of {len(inputs)} ended with tokens in the vocabulary")
        log(f"  serving draft_len {draft} (slots {loop.b}, chunk {loop.chunk}, max_new_cap {loop.max_new_cap}, "
            f"tail_pool (2, 3456), phys {loop.phys}: pools {tuple(loop.k_pool.shape)}"
            f"{'' if loop.k_tail is None else f' + {tuple(loop.k_tail.shape)}'}): "
            f"{loop._chunk_idx} chunks, admission "
            f"{sum(r.admit_s for r in results.values()) / len(results) * 1e3:.1f} ms each, {loop.captures} captures in "
            f"{loop.capture_s * 1e3:.1f} ms, {loop.compactions} compactions; {len(inputs) / wall:.3f} requests/s, "
            f"{n_tok / wall:.1f} tokens/s over {wall:.2f} s; mean queue_s "
            f"{sum(r.queue_s for r in results.values()) / len(results):.3f}, serve_s "
            f"{sum(r.serve_s for r in results.values()) / len(results):.3f}")
        log(f"  serving draft_len {draft}: tokens agreeing with each request's solo generate_greedy before the first "
            f"difference (bf16 ties not gated), by prompt: {dict(sorted(agree.items()))} of "
            f"{dict(enumerate(budgets))}; admitted at chunks "
            f"{ {ids[r]: results[r].admitted_step for r in sorted(results)} }")
        log(f"  serving draft_len {draft}: launches that ran {ran}; captured {captured}; {replays} replays")
        chk.expect(loop.phys is not None and loop.captures == 1
                   and captured == {"gemv_stacked": 3 * n_l, "gemv_gateup": n_l},
                   f"serving draft_len {draft}: the split pools (phys {loop.phys}) and one chunk graph, captured with "
                   f"C three times and D once a layer")
        chk.expect(ran["flash_attn_fwd"] > 0 and ran["gemv_stacked"] > 0 and ran["gemv_gateup"] > 0,
                   f"serving draft_len {draft}: kernels A, C and D ran")
        del loop, results
    for name, entry in spec.items():
        kernels[name]["spec_launches"] = entry
    for (key, nrows, kdim, widths), count in by_rows.items():
        if nrows in VERIFY_ROWS:
            name = "gateup" if key == "gemv_gateup" else SHAPES_C.get((kdim, widths))
            for shape in kernels[key]["shapes"]:
                if shape["shape"] == f"{name} int8 B={nrows}":
                    shape["launches"] = count
    log(f"  phase 10 C and D launches (generate_spec, generate_spec_batch, serving at draft_len 0 and {SPEC_DRAFT}): "
        f"{spec}; by (kernel, rows, K, widths) {by_rows}")
    chk.expect(all(e["replayed"] > 0 and e["captured"] > 0 for e in spec.values()),
               "phase 10: kernels C and D were captured and replayed on the speculative paths")
    ctx.clear()


# The long video's dense prefill (example_longvideo at 128 frames): kernel A
# over the whole 23,345-token prompt, no mask, Qwen2-7B's 28 / 4 heads.
LONGVIDEO_S = 35 + 128 * 182 + 14
REGIME_LONGVIDEO = "long video's dense prefill: S 23,345, no mask"


# Training (phases 3c, 10d):
# * the fp32 step on the CPU and on the card: the same ops summed in other
#   orders, so the loss agrees to fp32 rounding (TRAIN_LOSS_RTOL, as the CPU
#   test against JAX); Adam divides each gradient by its own running RMS, so
#   an element whose gradient is tiny moves up to lr a step in a direction
#   rounding sets: each parameter within 5% of the most three steps can move
#   it (the CPU test against JAX saw 0.7%).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LR = 1e-3
TRAIN_PARAM_TOL = 0.05 * 3 * TRAIN_LR
# * random weights (std 0.02) give logits of std ~0.02 * sqrt(3,584) = 1.2
#   after the final norm: the first loss is about ln V + 1.2^2 / 2 = 12.65,
#   so within 1.5 of ln V = 11.93.
TRAIN_FIRST_LOSS_TOL = 1.5
# * bf16 against fp32 forward of the same weights: bf16 rounds each
#   product's inputs and outputs to 8 bits (2^-9 relative), over 4 layers
#   and a 152,064-way softmax; 0.05 is ~0.4% of the loss.
TRAIN_BF16_LOSS_TOL = 0.05


def phase_cross_train(chk: Checks) -> None:
    """Three fp32 AdamW steps of the tiny stack on the CPU and on the card."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.parallel.train import leaves, make_optimizer, make_train_step

    cfg = tiny_llm_config(num_layers=2)
    tree = numpy_params(cfg, seed=17, scale=0.05)
    batches = np.random.default_rng(17).integers(0, cfg.vocab_size, (3, 2, 24))
    runs = {}
    for dev in ("cpu", "cuda"):
        step, init = make_train_step(cfg, dev, make_optimizer(TRAIN_LR))
        params, opt = init(qwen2.params_from_numpy(tree, device=dev))
        losses = []
        for b in batches:
            params, opt, loss = step(params, opt, torch.from_numpy(b))
            losses.append(loss)
        runs[dev] = ([float(x) for x in losses], [t.detach().cpu() for t in leaves(params)])
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
    param_err = max((a - b).abs().max().item() for a, b in zip(p_cpu, p_gpu))
    log(f"  cross_train: losses CPU {l_cpu}, card {l_gpu}; largest parameter difference {param_err:.3e}")
    chk.expect(loss_err <= TRAIN_LOSS_RTOL, f"cross_train: losses agree ({loss_err:.2e} <= {TRAIN_LOSS_RTOL:.0e})")
    chk.expect(param_err <= TRAIN_PARAM_TOL,
               f"cross_train: parameters after 3 steps agree ({param_err:.2e} <= {TRAIN_PARAM_TOL:.1e})")


def phase_train(chk: Checks) -> None:
    """Five AdamW steps at Qwen2-7B's widths, 4 layers, B = 2, T = 2,048."""
    import gc
    import statistics

    from framefusion_tpu_torch import kernel_bench
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.parallel.train import (leaves, lm_loss, make_optimizer, make_train_step,
                                                      step_gemm_flops, tree_map)

    cfg = qwen2_7b_config(num_layers=4)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2048))).to("cuda")
    tokens = ids.numel()
    with torch.no_grad():  # the fp32 forward of the same weights, before any step
        loss32 = float(lm_loss(tree_map(torch.Tensor.float, params), ids, cfg))
    gc.collect()
    torch.cuda.empty_cache()
    step, init = make_train_step(cfg, optimizer=make_optimizer(1e-4))
    params, opt = init(params)
    losses, norms, ms = [], [], []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, loss = step(params, opt, ids)
        stop.record()
        norms.append(torch.linalg.vector_norm(torch.stack([t.grad.float().norm() for t in leaves(params)])))
        losses.append(loss)
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    losses, norms = [float(x) for x in losses], [float(x) for x in norms]
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    step_ms = statistics.median(ms[1:])  # steps 2-5: the first allocates the optimizer's state
    flops = step_gemm_flops(cfg, tokens)
    log(f"  train: {n_params / 1e9:.3f} B params (4 of 28 layers, bf16), B = 2, T = 2,048; losses {losses}; "
        f"gradient norms {norms}; fp32 forward loss {loss32:.5f}")
    log(f"  train: ms a step {[round(x, 2) for x in ms]} -> {step_ms:.2f} ms (median of steps 2-5), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB above the {base / 1e9:.2f} GB held before, "
        f"GEMMs {flops / 1e12:.2f} TFLOP a step = {flops / (step_ms * 1e-3) / 989e12:.3f} of the bf16 peak")
    # One more step under torch.profiler: where the step's device time goes.
    prof = kernel_bench.device_profile(lambda: step(params, opt, ids))
    if prof["window_us"]:
        # fp32 GEMMs are the einsum attention's (the projections and the head run bf16 on the tensor cores)
        kinds = {"fp32 GEMM": ("f32f32",), "bf16 GEMM": ("gemm", "xmma", "cutlass", "nvjet"),
                 "AdamW": ("multi_tensor", "foreach", "adam"), "softmax": ("softmax",), "reduce": ("reduce",)}
        by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
        for name, us in prof["by_name"].items():
            kind = next((k for k, keys in kinds.items() if any(key in name.lower() for key in keys)), "other")
            by_kind[kind] += us
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
        log(f"  train: profiled step: device window {prof['window_us'] / 1e3:.2f} ms, busy {prof['busy_us'] / 1e3:.2f} "
            f"ms, idle share {prof['idle_share']:.3f}, {prof['launches']} device operations; ms by kind "
            f"{ {k: round(v / 1e3, 2) for k, v in by_kind.items()} }; largest: "
            f"{[(n[:60], round(us / 1e3, 2)) for n, us in top]}")
    else:
        log("  train: torch.profiler saw no device operation (not measured)")
    chk.expect(all(math.isfinite(x) for x in losses + norms), "train: every loss and gradient norm finite")
    chk.expect(abs(losses[0] - math.log(cfg.vocab_size)) <= TRAIN_FIRST_LOSS_TOL,
               f"train: first loss {losses[0]:.4f} within {TRAIN_FIRST_LOSS_TOL} of ln V = "
               f"{math.log(cfg.vocab_size):.4f}")
    chk.expect(losses[-1] < losses[0], f"train: the loss falls over 5 steps ({losses[0]:.4f} -> {losses[-1]:.4f})")
    chk.expect(abs(losses[0] - loss32) <= TRAIN_BF16_LOSS_TOL,
               f"train: first bf16 loss {losses[0]:.5f} within {TRAIN_BF16_LOSS_TOL} of the fp32 forward's "
               f"{loss32:.5f}")
    del params, opt, step, init
    gc.collect()
    torch.cuda.empty_cache()


def phase_probes(chk: Checks) -> None:
    """Both trained-model probes on the card at a short training run."""
    import tempfile

    from framefusion_tpu_torch.scripts import accuracy_probe, spec_probe

    tmp = tempfile.TemporaryDirectory()
    for name, mod, argv in (("accuracy_probe", accuracy_probe, ["--steps", "300", "--eval", "16"]),
                            ("spec_probe", spec_probe, ["--steps", "300", "--eval", "8"])):
        path = os.path.join(tmp.name, f"{name}.json")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = mod.main(argv + ["--json", path])
        wall = time.perf_counter() - t0
        with open(path) as f:
            parsed = json.loads(f.read(), parse_constant=_refuse_constant)
        chk.expect(parsed == rec, f"probes: {name}'s record strict-parses")
        chk.expect(rec["final_loss"] < rec["first_loss"],
                   f"probes: {name} trained ({rec['first_loss']} -> {rec['final_loss']} in 300 steps), {wall:.1f} s")
        if name == "accuracy_probe":
            log(f"  accuracy_probe: dense {rec['dense_accuracy']}, nudged {rec['dense_accuracy_one_ulp_nudge']}, "
                f"sweep {[(p['cost'], p.get('accuracy'), p.get('token_reduction')) for p in rec['sweep']]}")
        else:
            rows = [k for k in rec if isinstance(rec[k], dict) and "greedy_match" in rec[k]]
            serving = [k for k in rec if k.endswith("_serving")]
            for k in rows:
                log(f"  spec_probe {k}: acceptance {rec[k]['acceptance']}, tokens a pass "
                    f"{rec[k]['tokens_per_weight_pass']}, echo accuracy {rec[k]['echo_accuracy']}")
            chk.expect(len(rows) == 5 and all(rec[k]["greedy_match"] for k in rows),
                       "probes: spec_probe keeps greedy_match in every row")
            n = 8 * 10
            chk.expect(len(serving) == 3 and all(rec[k]["agreement"] == f"{n}/{n}" for k in serving),
                       f"probes: serving agreement {[rec[k]['agreement'] for k in serving]}, each {n}/{n}")
    tmp.cleanup()
    torch.cuda.empty_cache()


def phase_bench_modes(chk: Checks) -> None:
    """``kernel_bench``'s five modes once each (engine and ledger on one
    model): each row finite beside its bound, every row that launches a
    kernel held against its reference (``kernel_bench.row_failures``), and
    each mode's kernels launched in its run."""
    import gc

    from framefusion_tpu_torch import kernel_bench as kb

    model = []

    def engine_rows(fn):
        if not model:
            model.extend(kb.engine_model(8192))
        return fn(*model, log=log)

    modes = (("attn", kb.bench_attention, ("flash_attn_fwd",)), ("quant", kb.bench_quant, ()),
             ("decode", kb.bench_decode, ("gemv_stacked", "gemv_gateup")),
             ("engine", lambda log: engine_rows(kb.bench_engine),
              ("flash_attn_fwd", "attn_importance_rows", "gemv_stacked", "gemv_gateup", "ragged_decode_attn")),
             ("ledger", lambda log: engine_rows(kb.bench_ledger), ("flash_attn_fwd", "attn_importance_rows")))
    wrappers = _all_wrappers()
    t0 = time.perf_counter()
    for mode, bench, kernels in modes:
        _zero_counts(wrappers)
        rows = bench(log=log)
        ran = _ran(wrappers)
        bounded = [r for r in rows if "bound_ms" in r]
        checked = [r for r in rows if "tol" in r]
        chk.expect(bool(rows) and all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
                   and all(r["bound_ms"] > 0 for r in bounded),
                   f"bench_modes: {mode}: {len(rows)} rows, each time finite, {len(bounded)} beside a bound")
        failed = kb.row_failures(rows)
        chk.expect(not failed and (bool(checked) or not kernels),
                   f"bench_modes: {mode}: {len(checked)} rows held against their reference, failed {failed}")
        chk.expect(all(ran[k] > 0 for k in kernels),
                   f"bench_modes: {mode}: launches {({k: ran[k] for k in kernels})}")
        torch.cuda.empty_cache()
    log(f"  bench_modes: {time.perf_counter() - t0:.1f} s")
    del model[:]
    gc.collect()
    torch.cuda.empty_cache()


def _all_wrappers() -> dict:
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp

    return {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
            "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "bidir_attn_fwd": ba.bidir_attn_fwd,
            "sink_attn_fwd": sp.sink_attn_fwd, "ragged_decode_attn": da.ragged_decode_attn}


def phase_eval(chk: Checks) -> None:
    """``evaluation.run_offline_eval`` on a full-width Qwen2-7B built here
    (bf16, random weights drawn on the card from seed 0) over 3 prompts of the
    main path (64 frames x 182 patches, ``build_video_prompt`` seeds 0-2),
    dense against FrameFusion at cost 0.3, S_th 0.6, r_min 0.1, 16 tokens."""
    import gc

    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.evaluation import evaluate_pair, run_offline_eval
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt

    cfg = qwen2_7b_config()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    dense = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
    ff = apply_framefusion(dense, 0.3, 0.6, 0.1)
    prompts = []
    for seed in range(3):
        h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(seed), cfg.hidden_size)
        prompts.append(PrefillInputs(torch.from_numpy(h).to("cuda", cfg.dtype), pt, np.arange(len(pt)), 182,
                                     img_start, n_img))
    wrappers = _all_wrappers()
    _zero_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = run_offline_eval(dense, ff, prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = _ran(wrappers)
    text = json.dumps(report, allow_nan=False)
    chk.expect(json.loads(text) == report and report["num_prompts"] == 3,
               f"eval: the report strict-parses ({len(text)} bytes, allow_nan=False), 3 prompts")
    log(f"  eval: run_offline_eval over 3 main-path prompts (11,697 tokens each, 16 tokens): {wall:.2f} s wall "
        f"(graph captures included); mean reduction {report['mean_reduction']:.4f}, greedy agreement "
        f"{report['mean_greedy_agreement']:.4f}, first-token match {report['first_token_match_rate']:.4f}, "
        f"mean first-token KL {report['mean_kl_first_token']:.6g}; launches that ran {ran}")
    for name in ("flash_attn_fwd", "attn_importance_rows", "gemv_stacked", "gemv_gateup", "ragged_decode_attn"):
        chk.expect(ran[name] > 0, f"eval: {name} launched {ran[name]} times")
    for i, (p, row) in enumerate(zip(prompts, report["per_prompt"])):
        res = ff.prefill(p)
        chk.expect(row["final_tokens"] == res.valid_len
                   and row["vision_token_reduction"] == res.telemetry.vision_token_reduction
                   and row["prompt_tokens"] == p.input_embeds.shape[0],
                   f"eval prompt {i}: final_tokens {row['final_tokens']} and reduction "
                   f"{row['vision_token_reduction']:.4f} are its fused prefill's ({res.valid_len}, "
                   f"{res.telemetry.vision_token_reduction:.4f})")
        del res
        chk.expect(math.isfinite(row["kl_first_token"]) and row["kl_first_token"] >= -1e-6,
                   f"eval prompt {i}: KL {row['kl_first_token']:.6g} finite and not below 0")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        again = evaluate_pair(dense, ff, p, max_new_tokens=16)
        torch.cuda.synchronize()
        log(f"  eval prompt {i}: evaluate_pair {(time.perf_counter() - t1) * 1e3:.2f} ms wall (dense and fused "
            f"prefill, two 16-token graph decodes; captured before), final {again.final_tokens} of "
            f"{again.prompt_tokens}, greedy match {again.greedy_match_len} / agreement {again.greedy_agreement:.4f}, "
            f"top-1 {again.top1_logit_match}, KL {again.kl_first_token:.6g}")
    t_dense = cuda_time_ms(lambda: dense.prefill(prompts[0]), iters=3, warmup=1)
    t_ff = cuda_time_ms(lambda: ff.prefill(prompts[0]), iters=3, warmup=1)
    log(f"  eval prompt 0: dense prefill {t_dense:.2f} ms, FrameFusion prefill {t_ff:.2f} ms (CUDA events, mean of 3)")
    del dense, ff, params, prompts
    gc.collect()
    torch.cuda.empty_cache()


def _run_script(name: str, argv: list):
    """``framefusion_tpu_torch.scripts.<name>.main(argv)`` in this process,
    its standard output captured. Returns (main's result, the output, seconds)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"framefusion_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t0


def _table(text: str, first: str = "method") -> list:
    """The last table of a script's output whose header starts with ``first``:
    its header and rows, as lines."""
    lines = text.splitlines()
    starts = [i for i, l in enumerate(lines) if l.split()[:1] == [first]]
    if not starts:
        return []
    out = []
    for line in lines[starts[-1]:]:
        if not line.strip() or line.startswith("("):
            break
        out.append(line)
    return out


def _refuse_constant(name: str):
    raise ValueError(f"not strict JSON: {name}")


def phase_scripts(chk: Checks, kernels: dict) -> None:
    """Each ported script's ``main(argv)`` in process on the card, its output
    contract checked; then kernel A at the long video's dense shape against
    its plain version."""
    import gc
    import tempfile

    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp

    wrappers = _all_wrappers()
    runs = [
        ("example_llava", ["--full-size"]),
        ("example_baselines", ["--full"]),
        ("example_longvideo", []),
        ("example_batched", ["--int8", "--batch", "4", "--frames", "16"]),
        ("example_serving", ["--int8", "--speculative", "--requests", "8", "--slots", "4", "--frames", "16"]),
        ("example_qwen2vl", []),
        ("example_internvl", []),
        ("example_minicpmv", []),
        ("example_nvila", []),
        ("demo_compare", ["--selftest"]),
    ]
    longvideo_a = 0
    tmp = tempfile.TemporaryDirectory()
    json_path = os.path.join(tmp.name, "serving.json")
    for name, argv in runs:
        if name == "example_serving":
            argv = argv + ["--json", json_path]
        _zero_counts(wrappers)
        with _a_log(fp) as a_log:
            try:
                out, text, wall = _run_script(name, argv)
            except Exception as exc:  # noqa: BLE001 - reported as this script's failure, the phase goes on
                import traceback

                traceback.print_exc()
                chk.expect(False, f"scripts: {name} {' '.join(argv)} raised {type(exc).__name__}: {exc}")
                gc.collect()
                torch.cuda.empty_cache()
                continue
        ran = {k: v for k, v in _ran(wrappers).items() if v}
        table = _table(text)
        log(f"  {name} {' '.join(argv)}: {wall:.2f} s wall; launches that ran {ran}")
        for line in table:
            log(f"    | {line}")
        for line in text.splitlines():
            if line.startswith(("speedup", "decode ", "served ", "  latency", "  oracle", "parity", "sanity",
                                "  B=", "tail pool", "prompt:", "batched[0]", "4 compressed", "  sequential")):
                log(f"    {line.strip()}")
        if name in ("example_llava", "example_qwen2vl", "example_internvl", "example_minicpmv", "example_nvila"):
            cols = table[0].split() if table else []
            want = ["method", "prefill_ms", "tokens_kept"] + (["first_tokens"] if name == "example_llava" else [])
            dense, ffr = out["dense"], out["ff"]
            ok = (cols == want and ffr.valid_len < dense.valid_len and bool(torch.isfinite(ffr.logits).all())
                  and bool(torch.isfinite(dense.logits).all()) and "speedup:" in text and "CUDA events" in text)
            if name == "example_llava":
                ok = ok and len(out["dense_tokens"]) == len(out["ff_tokens"]) == 16
                chk.expect(dense.valid_len == 64 * 182 + 39,
                           f"scripts: example_llava --full-size: a {dense.valid_len}-token prompt (64 x 182 video "
                           f"rows in place of 1 of 40 text rows), compressed to {ffr.valid_len}")
            chk.expect(ok, f"scripts: {name}: table {cols}, tokens kept {dense.valid_len} -> {ffr.valid_len}, "
                           f"finite logits, speedup line, CUDA-event times")
        elif name == "example_baselines":
            methods = [r["method"] for r in out]
            chk.expect(methods == ["dense", "framefusion", "fastv", "streamingllm", "prefill_merge",
                                   "merge_then_fastv", "fastv_then_merge"]
                       and out[0]["tokens_kept"] == 11697 and all(r["tokens_kept"] <= 11697 for r in out)
                       and out[1]["tokens_kept"] < 11697 and ran.get("sink_attn_fwd", 0) > 0,
                       f"scripts: example_baselines --full: 7 methods at 11,697 tokens, kept "
                       f"{[r['tokens_kept'] for r in out]}; kernel F launched {ran.get('sink_attn_fwd', 0)} times")
        elif name == "example_longvideo":
            longvideo_a = a_log.counts().get((LONGVIDEO_S, False), 0)
            rows = out["rows"]
            chk.expect(rows[0]["tokens"] == LONGVIDEO_S and out["res"].valid_len < LONGVIDEO_S
                       and bool(torch.isfinite(out["res"].logits).all()) and longvideo_a > 0
                       and "weights=int8" in text,
                       f"scripts: example_longvideo: dense at {rows[0]['tokens']} tokens (kernel A launched "
                       f"{longvideo_a} times at S {LONGVIDEO_S}), FrameFusion kept {out['res'].valid_len}; int8")
        elif name == "example_batched":
            chk.expect(len(out["tokens_batch"]) == 4 and all(len(t) == 32 for t in out["tokens_batch"])
                       and out["tokens_batch"][0][0] == out["tokens_single"][0],
                       f"scripts: example_batched --int8: 4 x 32 tokens, the first token equal to the solo decode's")
        elif name == "example_serving":
            with open(json_path) as f:
                rec = json.loads(f.read(), parse_constant=_refuse_constant)
            chk.expect(rec == out and rec["requests"] == 8 and rec["total_tokens"] > 0
                       and rec["parity_prefix"] >= 1 and "speculative_agreement" in rec and rec["int8"],
                       f"scripts: example_serving --int8 --speculative: the JSON strict-parses, "
                       f"{rec['total_tokens']} tokens at {rec['serving_tokens_per_s']} tokens/s, speculative "
                       f"{rec['speculative_tokens_per_s']} tokens/s, agreement {rec['speculative_agreement']}, "
                       f"parity prefix {rec['parity_prefix']}")
        elif name == "demo_compare":
            chk.expect(all(len(v) >= 2 for v in out["partials"].values()) and "sanity ok" in text,
                       f"scripts: demo_compare --selftest: two replicas streamed "
                       f"{ {k: len(v) for k, v in out['partials'].items()} } updates, each ending with its solo "
                       f"decode's tokens")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    tmp.cleanup()

    gen = torch.Generator(device="cuda").manual_seed(23)
    regime, _ = _a_regime(chk, kernels, gen, LONGVIDEO_S, 28, 4, 0.0, REGIME_LONGVIDEO)
    regime.update(launches=longvideo_a, path="scripts")
    torch.cuda.empty_cache()


# Phases 18-19: serving across ranks.
PAR_SEED = 18
PAR_DECODE = 16  # tokens of the sharded int8 decodes
EP_LAYERS = 14  # Qwen2-57B-A14B's depth for expert parallelism on one card (module docstring, 19c)
# Qwen2-7B's depth for the sharded serving runs (19a, 19b): their host-staged
# collectives take ~0.94 of a TP prefill and grow with the layers, and the
# whole run has to stay inside its time limit.
PAR_LAYERS = 8
PAR_PATHS = ("tp2", "tp4", "ep2")


def _par_events_ok(chk, label, got, want) -> None:
    chk.expect(got == want, f"{label}: events equal the one-process run's ({got})")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape:
        return math.inf
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def tiny_parallel_setup():
    """Phase 18's models, prompts and rank jobs."""
    from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config, tiny_moe_llm_config
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4,
                          head_dim=128, dtype=torch.bfloat16)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1, schedule_num_layers=6,
                           bucket=32)
    tree = readout_params(cfg, seed=0, resid_scale=0.03)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5)
    h[-1] = tree["embed"][7]
    prompt = (h, pt, np.arange(len(pt)), 8, img_start, n_img)
    mcfg = tiny_moe_llm_config(num_layers=6, hidden_size=512, num_heads=4, num_kv_heads=2,
                               num_experts=MOE_CROSS_EXPERTS, num_experts_per_tok=2, moe_intermediate_size=256,
                               shared_expert_intermediate_size=512, moe_capacity_factor=1.25, dtype=torch.bfloat16)
    mtree = moe_cross_params(mcfg, seed=0, resid_scale=0.003)
    rng, e = np.random.default_rng(7), MOE_CROSS_EXPERTS
    mh = h.copy()
    mh[:-1] *= np.float32(20.0)
    mh[:, -e:] = np.stack([rng.permutation(e) for _ in range(len(pt))])
    patch_sig = np.stack([rng.permutation(e) for _ in range(8)])
    vision = np.arange(img_start, img_start + n_img)
    mh[vision, -e:] = patch_sig[pt[vision]]
    mh[-1] = mtree["embed"][7]
    mprompt = (mh, pt, np.arange(len(pt)), 8, img_start, n_img)
    greedy = [dict(op="greedy", prompt=prompt, n=8)]
    jobs = [dict(kind="tp", cfg=cfg, ff=ff, params=tree, tensor=t, attn_impl="flash", steps=greedy) for t in (2, 4)]
    jobs += [dict(kind="seq", cfg=cfg, ff=ff, params=tree, seq=2, ring=ring, prompt=prompt) for ring in (False, True)]
    jobs.append(dict(kind="ep", cfg=mcfg, ff=ff, params=mtree, expert=2, attn_impl="flash",
                     steps=[dict(op="greedy", prompt=mprompt, n=8)]))
    return (cfg, ff, tree, prompt), (mcfg, mtree, mprompt), jobs


def _one_process(cfg, ff, tree, prompt, device, modes=("fused",)):
    """The one-process engine's results on ``device``: per mode (events,
    logits) and the fused run's 8 greedy tokens."""
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.parallel import workers
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    eng = CompressionEngine(_cast_floats(qwen2.params_from_numpy(tree, device), cfg.dtype), cfg, ff,
                            attn_impl="flash")
    h, pt, pos, pn, s0, n = prompt
    out = {}
    for mode in modes:
        res = eng.prefill(torch.from_numpy(h).to(device, cfg.dtype), pt, pos, pn, s0, n, mode=mode)
        out[mode] = workers.result_of(res)
        if mode == "fused":
            out["tokens"] = eng.generate(res, 8)
    return out


def phase_cross_parallel(chk: Checks) -> None:
    """Phase 18 (module docstring)."""
    from framefusion_tpu_torch.parallel import launch, workers

    (cfg, ff, tree, prompt), (mcfg, mtree, mprompt), jobs = tiny_parallel_setup()
    for dev in ("cpu", "cuda"):
        ref = _one_process(cfg, ff, tree, prompt, dev, modes=("fused", "segmented"))
        mref = _one_process(mcfg, ff, mtree, mprompt, dev)
        t0 = time.perf_counter()
        outs = launch.spawn(workers.run_jobs, 4, jobs, backend="gloo", device=dev, timeout_s=600)
        log(f"  {dev}: 4 gloo ranks, {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s; one process: events "
            f"{ref['fused']['events']}, segmented {ref['segmented']['events']}, tokens {ref['tokens']}")
        for j, job in enumerate(jobs):
            ranks = [o[j] for o in outs]
            if job["kind"] == "seq":
                label = f"cross_parallel {dev} seq 2 {'ring' if job['ring'] else 'gather'}"
                want = ref["segmented"]
                got = ranks[0]
                chk.expect(all(r["events"] == got["events"] for r in ranks), f"{label}: every rank's events equal")
                _par_events_ok(chk, label, got["events"], want["events"])
                rel = _rel(got["logits"], want["logits"])
                chk.expect(rel <= LOGIT_RTOL, f"{label}: logits differ by {rel:.3e} of their largest <= {LOGIT_RTOL}")
                continue
            want = mref if job["kind"] == "ep" else ref
            width = job.get("tensor", job.get("expert"))
            label = f"cross_parallel {dev} {job['kind']}{width}"
            got = ranks[0]["steps"][0]
            chk.expect(all(r["steps"][0]["events"] == got["events"] and r["steps"][0]["tokens"] == got["tokens"]
                           for r in ranks), f"{label}: every rank's events and tokens equal")
            _par_events_ok(chk, label, got["events"], want["fused"]["events"])
            rel = _rel(got["logits"], want["fused"]["logits"])
            chk.expect(rel <= LOGIT_RTOL, f"{label}: first-token logits differ by {rel:.3e} of their largest "
                                          f"<= {LOGIT_RTOL}")
            chk.expect(got["tokens"] == want["tokens"], f"{label}: greedy tokens equal ({got['tokens']})")
            ran = ranks[0]["launches"]
            names = ("flash_attn_fwd", "gemv_stacked", "gemv_gateup", "ragged_decode_attn")
            if dev == "cuda":
                chk.expect(all(ran[n] > 0 for n in names), f"{label}: A, C, D and G launched on every rank ({ran})")
            else:
                chk.expect(not any(ran.values()), f"{label}: no kernel launched on the CPU")
        del outs


def _ref_full(cfg, ff, prompt_args, n: int, *, int8_prefill: bool = False) -> dict:
    """The one-process run of a phase 19 model (``init_sharded_params`` with
    no mesh: the ranks' weights whole): the timed fused prefill's result,
    keys and (for a dense model) the segmented executor's, then the int8
    decode of ``n`` tokens from the prefill's caches."""
    from framefusion_tpu_torch.parallel import workers
    from framefusion_tpu_torch.parallel.sharding import init_sharded_params
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    t0 = time.perf_counter()
    params = init_sharded_params(cfg, PAR_SEED, None, device="cuda", int8=int8_prefill,
                                 quantize_lm_head=int8_prefill)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = CompressionEngine(params, cfg, ff, attn_impl="flash")
    eng.dense_prefill(prompt_args[0][:256], np.arange(256))  # the warm-up, as the ranks'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.prefill(*prompt_args)
    torch.cuda.synchronize()
    out = {"prefill": workers.result_of(res), "prefill_ms": (time.perf_counter() - t0) * 1e3, "build_s": build_s,
           "keys0": workers.keys_of(res, 0), "prune_layer": res.telemetry.tail_start_layer - 1}
    out["keys_prune"] = workers.keys_of(res, out["prune_layer"])
    if not cfg.is_moe:
        out["segmented"] = workers.result_of(eng.prefill(*prompt_args, mode="segmented"))
    if not int8_prefill:
        del eng, params
        torch.cuda.empty_cache()
        params = init_sharded_params(cfg, PAR_SEED, None, device="cuda", int8=True, quantize_lm_head=True)
        eng = CompressionEngine(params, cfg, ff, attn_impl="flash")
    graph = eng._start_decode(res, n, None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.run(n - 1)
    torch.cuda.synchronize()
    out.update(decode_ms_step=(time.perf_counter() - t0) * 1e3 / (n - 1), tokens=graph.out[:n].tolist(),
               decode_logits=graph.logits.float().cpu().numpy())
    graph.busy = False
    del graph, eng, params, res
    torch.cuda.empty_cache()
    return out


def _check_full(chk, label, ranks, ref, hk_local: int, *, heads_split: bool = True, gloo: bool = True) -> None:
    """Phase 19's checks of one full-width job's ranks against the one-process
    run; rank i holds KV heads [i * hk_local, (i + 1) * hk_local) when the
    heads are split, all of them otherwise."""
    active = [r for r in ranks if r["active"]]
    r0 = active[0]
    chk.expect(all(r["prefill"]["events"] == r0["prefill"]["events"] and r["tokens"] == r0["tokens"] for r in active),
               f"{label}: every rank's events and tokens equal")
    _par_events_ok(chk, label, r0["prefill"]["events"], ref["prefill"]["events"])
    for name in ("keys0", "keys_prune"):
        errs = [_rel(r[name], ref[name][:, (i if heads_split else 0) * hk_local:][:, :hk_local])
                for i, r in enumerate(active)]
        layer = "layer 0" if name == "keys0" else f"the prune layer ({ref['prune_layer']})"
        chk.expect(max(errs) <= LOGIT_RTOL, f"{label}: each rank's KV heads of {layer}'s cached keys (the merges' "
                                            f"keep set) within {max(errs):.3e} <= {LOGIT_RTOL}")
    rel = _rel(r0["prefill"]["logits"], ref["prefill"]["logits"])
    chk.expect(rel <= LOGIT_RTOL, f"{label}: first-token logits differ by {rel:.3e} of their largest <= {LOGIT_RTOL}")
    agree = next((j for j, (a, b) in enumerate(zip(r0["tokens"], ref["tokens"])) if a != b), len(ref["tokens"]))
    chk.expect(len(r0["tokens"]) == PAR_DECODE and bool(np.isfinite(r0["decode_logits"]).all()),
               f"{label}: the int8 decode gave {PAR_DECODE} tokens, finite logits; agreement with the one-process "
               f"decode before the first difference {agree} of {PAR_DECODE} (not gated: bf16 near-ties of a random "
               f"model)")
    log(f"  {label}: prefill {r0['prefill_ms']:.1f} ms (one process {ref['prefill_ms']:.1f}), collectives "
        f"{r0['prefill_collective_ms']:.1f} ms = {r0['prefill_collective_ms'] / r0['prefill_ms']:.3f} of it; int8 "
        f"decode {r0['decode_ms_step']:.2f} ms/step eager (gloo: no graph captured, DecodeGraph.replays "
        f"{r0['replays']}; one process, graph: {ref['decode_ms_step']:.3f}), "
        f"collectives {r0['decode_collective_ms_step']:.2f} ms/step = "
        f"{r0['decode_collective_ms_step'] / r0['decode_ms_step']:.3f}; host-staged gloo on one card, not a "
        f"multi-card speed; peak {max(r['max_memory_gb'] for r in active):.1f} GB a rank")
    same = all(r["prefill_calls"] == r0["prefill_calls"] and r["decode_calls"] == r0["decode_calls"] for r in active)
    log(f"  {label}: kernel launches by (kernel, call shape), {'the same on every rank' if same else 'rank 0'}: "
        f"prefill {r0['prefill_calls']}; decode {r0['decode_calls']}")
    chk.expect(same, f"{label}: every rank launched the same kernels at the same shapes")
    # Each rank's wrappers' counts, set to 0 before the prefill and before
    # the decode: every launch was recorded with its call's shape.
    recorded = all(_by_kernel(r[f"{run}_calls"]) == {k: n for k, n in r[f"{run}_launches"].items() if n}
                   for r in active for run in ("prefill", "decode"))
    chk.expect(recorded, f"{label}: on every rank the launches by call shape sum to each wrapper's own count "
                         f"(rank 0: prefill {r0['prefill_launches']}, decode {r0['decode_launches']})")
    if gloo:
        chk.expect(not any(r["captured"] or r["replays"] for r in active),
                   f"{label}: under gloo the decode ran its step eagerly (no graph, 0 replays)")


def _by_kernel(calls: dict) -> dict:
    """``KernelLog`` counts summed by kernel."""
    out: dict = {}
    for (kernel, _), n in calls.items():
        out[kernel] = out.get(kernel, 0) + n
    return out


def _par_rows(chk, kernels, gen, tag: str, r0: dict, cfg) -> None:
    """The kernel rows ``"path": tag`` at the shapes rank 0 launched."""
    from framefusion_tpu_torch.ops.quant import quantize_head

    calls = dict(r0["prefill_calls"])
    for k, v in r0["decode_calls"].items():
        calls[k] = calls.get(k, 0) + v
    events = r0["prefill"]["events"]
    live = next((e[3] for e in reversed(events) if e[1] != "prune"), events[-1][3])
    valid = r0["prefill"]["valid_len"]
    # A's launches by regime: with or without B behind them, one shape.
    a_calls: dict = {}
    for (kernel, key), count in calls.items():
        if kernel == "flash_attn_fwd":
            a_calls[key[1:5]] = a_calls.get(key[1:5], 0) + count
    for (s, hq, hk, masked), count in sorted(a_calls.items()):
        dead = max(0.0, 1.0 - live / s) if masked else 0.0
        label = f"{tag}: S {s}, Hq {hq} / Hk {hk}" + (
            f", key_valid with {dead:.1%} dead keys" if masked else ", no mask")
        regime, _ = _a_regime(chk, kernels, gen, s, hq, hk, dead, label)
        regime.update(path=tag, launches=count)
        torch.cuda.empty_cache()
    for (kernel, key), count in sorted(calls.items()):
        if kernel == "flash_attn_fwd":
            continue
        if kernel == "attn_importance_rows":
            _, s, hq, hk, _, num = key
            entry = _b_row(chk, kernels, gen, s, live, num, hq, hk, 14, tag)
            entry["launches"] = count
        elif kernel == "ragged_decode_attn":
            _, hq, hk, s_view = key
            entry = _g_row(chk, kernels, gen, min(valid + PAR_DECODE // 2, s_view), s_view, hq, hk, tag)
            entry["launches"] = count
        else:
            entry_kind, b, kdim, ns, wdtype = key
            if entry_kind == "head":
                head = quantize_head(torch.randn((kdim, ns[0]), generator=gen, device="cuda").mul_(0.02)
                                     .to(torch.bfloat16))
                entry = _head_row(chk, kernels, gen, head, b, tag)
                del head
            elif entry_kind.startswith("routed"):
                continue  # the expert-parallel rows (_ep_rows)
            else:
                if kernel == "gemv_gateup":
                    name, ns = "gateup", (ns[0], ns[0])
                elif entry_kind == "qkv":
                    name = "qkv"
                else:  # the row-split products: wo at K = Hq * hd / n, w_down at the MLP's width / n
                    name = "wo" if kdim < cfg.hidden_size else "w_down"
                (entry,) = _cd_rows(chk, kernels, gen, name, wdtype, kdim, list(ns), (b,), path=tag)
            entry["launches"] = count
            kernels[kernel]["shapes"].append(entry)
        torch.cuda.empty_cache()


def _ep_rows(chk, kernels, gen, r0: dict, mcfg, width: int) -> None:
    """C's and D's rows ``"path": "ep2"``: the routed rows of rank 0's
    decode over its own experts' stacks (the first E / n; a row whose
    expert lives on the other rank reads local expert 0 and adds zero, as
    ``qwen2.moe_decode_mlp`` runs it), at random top-k routings."""
    from framefusion_tpu_torch.ops.quant import quantize_weight

    e_local, k = mcfg.num_experts // width, mcfg.num_experts_per_tok
    n_l, d, mi = 4, mcfg.hidden_size, mcfg.moe_intermediate_size

    def stack(kdim, ndim):
        q = [quantize_weight(torch.randn((e_local, kdim, ndim), generator=gen, device="cuda").mul_(0.02)
                             .to(torch.bfloat16)) for _ in range(n_l)]
        return torch.stack([x["q8"] for x in q]), torch.stack([x["scale"] for x in q])

    (gq, gs), (uq, us), (dq, _) = stack(d, mi), stack(d, mi), stack(mi, d)
    sets = []
    for i in range(8):
        idx = torch.randperm(mcfg.num_experts, generator=gen, device="cuda")[:k]
        local = torch.where(idx < e_local, idx, torch.zeros_like(idx))
        sets.append(((n_l - 1 - i % n_l) * e_local + local).to(torch.int32))
    calls = r0["decode_calls"]
    for name, w, sc, kernel in (("gateup", [gq, uq], [gs, us], "gemv_gateup"), ("down", [dq], [None], "gemv_stacked")):
        row = _routed_row(chk, kernels, gen, name, w, sc, sets, "ep2")
        row["launches"] = sum(v for (kk, key), v in calls.items() if kk == kernel and key[0].startswith("routed"))
        kernels[kernel]["shapes"].append(row)
    del gq, uq, dq
    torch.cuda.empty_cache()


def phase_parallel(chk: Checks, kernels: dict, ctx: dict) -> None:
    """Phase 19 (module docstring)."""
    from framefusion_tpu_torch.config import FrameFusionConfig, qwen2_7b_config, qwen2_moe_a14b_config
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.parallel import launch, workers

    ctx.clear()
    torch.cuda.empty_cache()
    cfg = qwen2_7b_config(num_layers=PAR_LAYERS)
    mcfg = qwen2_moe_a14b_config(num_layers=EP_LAYERS)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    mff = FrameFusionConfig(*MOE_KNOBS)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    args = (torch.from_numpy(h).to("cuda", torch.bfloat16), pt, np.arange(len(pt)), 182, img_start, n_img)
    prompt = {"video": dict(seed=0)}
    ref = _ref_full(cfg, ff, args, PAR_DECODE)
    mref = _ref_full(mcfg, mff, args, PAR_DECODE, int8_prefill=True)
    log(f"  one process: Qwen2-7B ({PAR_LAYERS} of 28 layers) built in {ref['build_s']:.1f} s, fused prefill {ref['prefill_ms']:.1f} ms, events "
        f"{ref['prefill']['events']}, segmented {ref['segmented']['events']}, int8 decode {ref['decode_ms_step']:.3f} "
        f"ms/step; Qwen2-57B-A14B at {EP_LAYERS} layers int8 built in {mref['build_s']:.1f} s, fused "
        f"{mref['prefill_ms']:.1f} ms, events {mref['prefill']['events']}, decode {mref['decode_ms_step']:.3f} ms/step")
    full = dict(kind="full", cfg=cfg, ff=ff, seed=PAR_SEED, n=PAR_DECODE, prompt=prompt, axis="tensor")
    jobs = [dict(full, width=4, active=[0, 1, 2, 3]), dict(full, width=2, active=[0, 1]),
            dict(kind="seq_full", cfg=cfg, ff=ff, seed=PAR_SEED, prompt=prompt, width=2, active=[0, 1]),
            dict(full, cfg=mcfg, ff=mff, axis="expert", width=2, active=[0, 1], int8_prefill=True)]
    t0 = time.perf_counter()
    outs = launch.spawn(workers.run_jobs, 4, jobs, backend="gloo", device="cuda", timeout_s=900)
    log(f"  4 gloo ranks on the one card: {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s "
        f"({[round(o[j]['seconds'], 1) for j in range(len(jobs)) for o in outs[:1]]} s a job on rank 0)")
    by_job = [[o[j] for o in outs] for j in range(len(jobs))]
    # (a) tensor parallel
    _check_full(chk, "parallel tp4", by_job[0], ref, cfg.num_kv_heads // 4)
    _check_full(chk, "parallel tp2", by_job[1], ref, cfg.num_kv_heads // 2)
    # (b) sequence parallel
    seq = [r for r in by_job[2] if r["active"]]
    for mode in ("gather", "ring"):
        got = seq[0][mode]
        label = f"parallel seq2 {mode}"
        chk.expect(all(r[mode]["events"] == got["events"] for r in seq), f"{label}: every rank's events equal")
        _par_events_ok(chk, label, got["events"], ref["segmented"]["events"])
        rel = _rel(got["logits"], ref["segmented"]["logits"])
        chk.expect(rel <= LOGIT_RTOL, f"{label}: logits differ by {rel:.3e} of the segmented executor's largest "
                                      f"<= {LOGIT_RTOL}")
        log(f"  {label}: {got['ms']:.1f} ms, collectives {got['collective_ms']:.1f} ms (host-staged gloo)")
    # (c) expert parallel
    ep = [r for r in by_job[3] if r["active"]]
    _check_full(chk, "parallel ep2", by_job[3], mref, mcfg.num_kv_heads, heads_split=False)
    routed = {r_i: {k: v for k, v in r["decode_calls"].items() if k[1][0].startswith("routed")}
              for r_i, r in enumerate(ep)}
    log(f"  parallel ep2: routed C and D calls by rank: {routed}")
    chk.expect(all(sum(v.values()) > 0 for v in routed.values()), "parallel ep2: every rank ran routed C and D")
    del outs
    # (d) NCCL as a world of one
    one = launch.spawn(workers.run_jobs, 1, [dict(kind="nccl_one", cfg=qwen2_7b_config(num_layers=4), ff=ff,
                                                  seed=PAR_SEED, n=PAR_DECODE,
                                                  prompt={"video": dict(seed=0, n_frames=16)})],
                       backend="nccl", device="cuda", timeout_s=600)[0][0]
    a, m = one["alone"], one["mesh"]
    chk.expect(m["captured"] and a["captured"] and m["replays"] == a["replays"] == PAR_DECODE - 1
               and m["collectives_in_replays"] == 0 and m["collectives"] > 0,
               f"parallel nccl world of one: both decodes replayed a captured graph ({m['replays']} replays), the "
               f"mesh's all-reduces inside it ({m['collectives']} reduces recorded, none run outside the replays)")
    chk.expect(a["tokens"] == m["tokens"] and np.array_equal(a["logits"], m["logits"])
               and np.array_equal(a["prefill_logits"], m["prefill_logits"]) and a["events"] == m["events"],
               f"parallel nccl world of one: tokens and logits bitwise the engine's without a mesh ({m['tokens']})")
    if torch.cuda.device_count() >= 2:
        nccl = launch.spawn(workers.run_jobs, 2, [dict(full, width=2, active=[0, 1])], backend="nccl",
                            device="cuda", timeout_s=900)
        _check_full(chk, "parallel nccl tp2", [o[0] for o in nccl], ref, cfg.num_kv_heads // 2, gloo=False)
    else:
        log("  parallel nccl across ranks: not run: one card")
    # The kernel rows at the sharded shapes, timed here.
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    _par_rows(chk, kernels, gen, "tp4", by_job[0][0], cfg)
    _par_rows(chk, kernels, gen, "tp2", by_job[1][0], cfg)
    _ep_rows(chk, kernels, gen, ep[0], mcfg, 2)
    rows = [e for n in ("flash_attn_fwd", "attn_importance_rows", "gemv_stacked", "gemv_gateup", "ragged_decode_attn")
            for e in kernels[n]["regimes" if n == "flash_attn_fwd" else "shapes"] if e.get("path") in PAR_PATHS]
    chk.expect(all(r["launches"] for r in rows) and {r["path"] for r in rows} == set(PAR_PATHS),
               f"parallel: every tp2 / tp4 / ep2 row's shape ran on the ranks "
               f"({[(r['path'], r.get('shape', r.get('regime')), r['launches']) for r in rows]})")
    torch.cuda.empty_cache()


# Phases 20-21: training across ranks.
TRAIN_RANK_LAYOUTS = (("tp2dp2", "train", 2), ("tp4", "train", 4), ("pipe", "pipe", 2), ("moe", "train", 2))


def tiny_train_setup():
    """Phase 20's models (fp32, drawn on the CPU from seeds), batches and
    rank jobs."""
    from framefusion_tpu_torch.config import tiny_llm_config, tiny_moe_llm_config
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.parallel.workers import numpy_tree

    cfgs = {"tp2dp2": tiny_llm_config(num_layers=2, num_heads=8, num_kv_heads=4),
            "pipe": tiny_llm_config(num_layers=4), "moe": tiny_moe_llm_config(num_layers=2)}
    cfgs["tp4"] = cfgs["tp2dp2"]
    trees = {k: numpy_tree(qwen2.init_params(c, torch.Generator().manual_seed(20 + i)))
             for i, (k, c) in enumerate(cfgs.items())}
    trees["tp4"] = trees["tp2dp2"]
    rng = np.random.default_rng(20)
    batches = [rng.integers(0, 512, (4, 24)) for _ in range(3)]
    jobs = []
    for name, kind, width in TRAIN_RANK_LAYOUTS:
        job = dict(kind=kind, cfg=cfgs[name], params=trees[name], batches=batches, lr=TRAIN_LR)
        job.update(dict(stages=width, n_micro=2) if kind == "pipe" else dict(tensor=width))
        jobs.append(job)
    return cfgs, trees, batches, jobs


def _one_process_train(cfg, tree, batches):
    """The one-process step on the CPU: losses and final parameters (numpy)."""
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.parallel.train import make_optimizer, make_train_step
    from framefusion_tpu_torch.parallel.workers import numpy_tree

    step, init = make_train_step(cfg, "cpu", make_optimizer(TRAIN_LR))
    params, opt = init(qwen2.params_from_numpy(tree, device="cpu"))
    losses = []
    for b in batches:
        params, opt, loss = step(params, opt, torch.from_numpy(b))
        losses.append(float(loss))
    return losses, numpy_tree(params)


def _rank_shard(tree, cfg, kind, place: dict, width: int):
    """Rank ``place``'s shard of a whole numpy tree (a tensor or a stage
    split), as the ranks hold theirs."""
    from framefusion_tpu_torch.parallel import pipeline, sharding
    from framefusion_tpu_torch.parallel.train import tree_map
    from framefusion_tpu_torch.parallel.workers import numpy_tree

    whole = tree_map(torch.from_numpy, tree)
    if kind == "pipe":
        return numpy_tree(pipeline.shard_params_pipe(whole, cfg, sharding.ShardAxis("stage", place["stage"], width)))
    return numpy_tree(sharding.shard_params(whole, cfg, sharding.ShardAxis("tensor", place["tensor"], width)))


def _split_axis(cfg, kind):
    """Each leaf's split axis name, or None for a replicated one."""
    from framefusion_tpu_torch.parallel import pipeline, sharding
    from framefusion_tpu_torch.parallel.workers import named_leaves

    specs = pipeline.pipe_param_pspecs(cfg) if kind == "pipe" else sharding.param_pspecs(cfg)
    return {k: next((a for a in v if a), None) for k, v in named_leaves(specs).items()}


def _same_bits_where_replicated(outs, j, cfg, kind, key) -> bool:
    """Every leaf (``key`` holds each rank's leaves or their digests) the
    same bits on every rank holding the same part: on all of them for a
    replicated leaf, on those at the same place of its split axis."""
    from framefusion_tpu_torch.parallel.workers import named_leaves

    split = _split_axis(cfg, kind)
    axis = "stage" if kind == "pipe" else "tensor"
    named = [o[j][key] if key == "digests" else named_leaves(o[j][key]) for o in outs]
    for leaf in named[0]:
        for r, o in enumerate(outs):
            if split.get(leaf) and o[j]["place"][axis] != outs[0][j]["place"][axis]:
                continue
            a, b = named[r][leaf], named[0][leaf]
            if not (a == b if isinstance(a, str) else np.array_equal(a, b)):
                return False
    return True


def phase_cross_train_ranks(chk: Checks) -> None:
    """Phase 20 (module docstring)."""
    import concurrent.futures

    from framefusion_tpu_torch.parallel import launch, workers
    from framefusion_tpu_torch.parallel.workers import named_leaves

    t_phase = time.perf_counter()
    cfgs, trees, batches, jobs = tiny_train_setup()
    # The CPU ranks, the card's ranks and the NCCL world of one run side by side (each spawn is mostly start-up).
    nccl_job = dict(kind="nccl_train_one", cfg=cfgs["tp2dp2"], params=trees["tp2dp2"], batches=batches, lr=TRAIN_LR)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        spawns = {dev: pool.submit(launch.spawn, workers.run_jobs, 4, jobs, backend="gloo", device=dev, timeout_s=300)
                  for dev in ("cpu", "cuda")}
        spawns["nccl"] = pool.submit(launch.spawn, workers.run_jobs, 1, [nccl_job], backend="nccl", device="cuda",
                                     timeout_s=300)
        refs = {name: _one_process_train(cfgs[name], trees[name], batches) for name, _, _ in TRAIN_RANK_LAYOUTS}
        log(f"  one process (CPU): losses {[(k, [round(x, 5) for x in v[0]]) for k, v in refs.items()]}")
        ranks = {name: run.result() for name, run in spawns.items()}
    log(f"  the three spawns (4 CPU ranks, 4 ranks on the card, NCCL's one) side by side: "
        f"{time.perf_counter() - t_phase:.1f} s with the one-process steps")
    for dev in ("cpu", "cuda"):
        outs = ranks[dev]
        for j, (name, kind, width) in enumerate(TRAIN_RANK_LAYOUTS):
            label = f"cross_train_ranks {dev} {name}"
            losses, final = refs[name]
            loss_err = max(abs(a - b) / abs(b) for o in outs for a, b in zip(o[j]["losses"], losses))
            param_err = 0.0
            for o in outs:
                want = named_leaves(_rank_shard(final, cfgs[name], kind, o[j]["place"], width))
                param_err = max([param_err] + [float(np.abs(got - want[k]).max())
                                               for k, got in named_leaves(o[j]["params"]).items()])
            chk.expect(loss_err <= TRAIN_LOSS_RTOL, f"{label}: every rank's 3 losses within {loss_err:.2e} <= "
                                                    f"{TRAIN_LOSS_RTOL:.0e} of the one-process step's")
            chk.expect(param_err <= TRAIN_PARAM_TOL, f"{label}: every rank's parameters after 3 steps within "
                                                     f"{param_err:.2e} <= {TRAIN_PARAM_TOL:.1e} of its shard")
            chk.expect(_same_bits_where_replicated(outs, j, cfgs[name], kind, "params"),
                       f"{label}: the replicated leaves bitwise equal on every rank")
    one = ranks["nccl"][0][0]
    differ = [k for k, v in one["alone"]["digests"].items() if one["mesh"]["digests"][k] != v]
    chk.expect(one["alone"]["losses"] == one["mesh"]["losses"] and not differ,
               f"cross_train_ranks nccl world of one: losses and every leaf bitwise the step without a mesh (losses "
               f"{one['mesh']['losses']} / {one['alone']['losses']}; leaves that differ: {differ})")
    if torch.cuda.device_count() >= 2:
        nccl = launch.spawn(workers.run_jobs, 2, [dict(jobs[0], tensor=2)], backend="nccl", device="cuda",
                            timeout_s=300)
        losses = refs["tp2dp2"][0]
        err = max(abs(a - b) / abs(b) for o in nccl for a, b in zip(o[0]["losses"], losses))
        chk.expect(err <= TRAIN_LOSS_RTOL, f"cross_train_ranks nccl tp2: losses within {err:.2e}")
    else:
        log("  cross_train_ranks nccl across ranks: not run: one card")
    log(f"  cross_train_ranks: {time.perf_counter() - t_phase:.1f} s")


TRAIN_RANKS_SEED = 21


def _param_count(cfg) -> int:
    """A dense Qwen2 stack's parameters (biases, norms, untied head)."""
    d, hd = cfg.hidden_size, cfg.head_dim_
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    layer = d * qkv + qkv + cfg.num_heads * hd * d + 3 * d * cfg.intermediate_size + 2 * d
    return cfg.num_layers * layer + 2 * cfg.vocab_size * d + d
HOST_STAGED = "gloo ranks sharing one card, collectives staged through the host: not a multi-card speed"


def _train_report(label: str, ranks: list, tokens: int) -> list:
    """Logs a full-width run's numbers from its ranks: ms / step (median of
    steps 2+, the slowest rank), tokens/s, peak GB a rank, collectives.
    Returns rank 0's losses."""
    import statistics

    log(f"  {label}: seconds a rank: job {[round(r['seconds'], 1) for r in ranks]}, drawing the shard "
        f"{[round(r['init_s'], 1) for r in ranks]}, digests {[round(r['digest_s'], 1) for r in ranks]}")
    later = range(1, len(ranks[0]["ms"]))
    ms = statistics.median(max(r["ms"][i] for r in ranks) for i in later)
    calls = ranks[0]["calls"][1]
    coll_s = statistics.median(r["collective_s"][i] for r in ranks for i in later)
    share = statistics.median(r["collective_s"][i] * 1e3 / r["ms"][i] for r in ranks for i in later)
    peak = max(r["max_memory_gb"] for r in ranks)
    log(f"  {label}: losses {ranks[0]['losses']}; ms a step by rank 0 {[round(x, 1) for x in ranks[0]['ms']]} -> "
        f"{ms:.1f} ms/step, {tokens / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB a rank "
        f"({[round(r['max_memory_gb'], 2) for r in ranks]}), {calls} collectives a step, {coll_s:.2f} s in them "
        f"(share {share:.3f} of its step, medians of steps 2+ over the ranks; {HOST_STAGED})")
    return ranks[0]["losses"]


def phase_train_ranks(chk: Checks, ctx: dict) -> None:
    """Phase 21 (module docstring)."""
    from framefusion_tpu_torch.config import qwen2_7b_config, qwen2_moe_a14b_config
    from framefusion_tpu_torch.parallel import launch, workers
    from framefusion_tpu_torch.parallel.sharding import init_sharded_params
    from framefusion_tpu_torch.parallel.train import leaves, lm_loss, make_optimizer, make_train_step
    from framefusion_tpu_torch.parallel.workers import router_stats

    ctx.clear()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    def one_process_loss(cfg, batch):
        params = init_sharded_params(cfg, TRAIN_RANKS_SEED, None, device="cuda")
        ids = torch.from_numpy(np.random.default_rng(TRAIN_RANKS_SEED).integers(0, cfg.vocab_size, batch)).to("cuda")
        with torch.no_grad():
            loss = float(lm_loss(params, ids, cfg))
        del params
        torch.cuda.empty_cache()
        return loss

    def spawn(jobs, world):
        """Each job's ranks' results, the jobs run one after another in one
        spawn of ``world`` ranks."""
        t0 = time.perf_counter()
        # Expandable segments: four ranks' caching allocators share the card's 80 GB with less slack.
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            outs = launch.spawn(workers.run_jobs, world, jobs, backend="gloo", device="cuda", timeout_s=600)
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        log(f"  {[job['kind'] for job in jobs]} on {world} ranks: {time.perf_counter() - t0:.1f} s with the spawn")
        return [[o[j] for o in outs] for j in range(len(jobs))]

    base = dict(seed=TRAIN_RANKS_SEED, ids_seed=TRAIN_RANKS_SEED, steps=3, lr=1e-4)
    # (a) Qwen2-7B, 8 of 28 layers, TP 4; (b) 2 layers, TP 2 x DP 2; (c) the
    # pipeline, 4 layers, 4 stages, 4 microbatches: one spawn. The depths are
    # cut for the run's time limit: the host-staged collectives take 0.95-0.99
    # of each step.
    cfg, cfg2, cfg4 = (qwen2_7b_config(num_layers=n) for n in (8, 2, 4))
    shared = ("/embed", "/final_norm", "/lm_head")
    runs = spawn([dict(base, kind="train_full", cfg=cfg, tensor=4, batch=(1, 2048), digests=[]),
                  dict(base, kind="train_full", cfg=cfg2, tensor=2, batch=(2, 2048)),
                  dict(base, kind="pipe_full", cfg=cfg4, stages=4, n_micro=4, batch=(4, 1024), digests=shared)], 4)
    n = _param_count(cfg)
    state = n * 8 / 1e9
    stash = cfg.num_layers * 2048 * cfg.hidden_size * 2 / 1e9
    log(f"  train_ranks 7b tp4 reckoning: {n / 1e9:.3f} B params; params, gradients and two AdamW moments in bf16 "
        f"{state:.1f} GB in all, {state / 4:.1f} GB a rank; a rank adds the CUDA context ~0.5, the layer-input stash "
        f"{stash:.2f}, one layer's recomputation ~0.5 (fp32 scores {7 * 2048 ** 2 * 4 / 1e9:.2f} a copy) and the "
        f"vocabulary-slice loss ~1 GB: ~{state + 4 * (0.5 + stash + 1.5):.0f} GB on the card; fused AdamW (no "
        f"whole-list temporaries)")
    ranks = runs[0]
    losses = _train_report("train_ranks 7b tp4 (8 layers)", ranks, 2048)
    ref = one_process_loss(cfg, (1, 2048))
    chk.expect(all(math.isfinite(x) for x in losses), "train_ranks 7b tp4: every loss finite")
    chk.expect(abs(losses[0] - ref) <= TRAIN_BF16_LOSS_TOL,
               f"train_ranks 7b tp4: first loss {losses[0]:.5f} within {TRAIN_BF16_LOSS_TOL} of the "
               f"one-process no-grad forward's {ref:.5f}")
    chk.expect(losses[-1] < losses[0], "train_ranks 7b tp4: the loss falls over 3 steps")
    chk.expect(all(r["losses"] == ranks[0]["losses"] for r in ranks), "train_ranks 7b tp4: every rank's losses equal")
    ranks = runs[1]
    losses = _train_report("train_ranks 7b tp2 x dp2 (2 layers)", ranks, 2 * 2048)
    chk.expect(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
               f"train_ranks tp2 x dp2: losses finite and falling ({losses})")
    chk.expect(_same_bits_where_replicated([[r] for r in ranks], 0, cfg2, "train", "digests"),
               "train_ranks tp2 x dp2: the replicated leaves bitwise equal on the four ranks (the split ones on "
               "both data replicas)")
    ranks = runs[2]
    losses = _train_report("train_ranks pipeline s4 m4 (4 layers)", ranks, 4 * 1024)
    ref = one_process_loss(cfg4, (4, 1024))
    shares = [[w / s for w, s in zip(r["wait_s"], r["schedule_s"])] for r in ranks]
    bubble = float(np.mean([sh[i] for sh in shares for i in range(1, 3)]))
    log(f"  train_ranks pipeline: bubble share measured {bubble:.3f} (each stage's host time in receives over its "
        f"forward and backward schedule, steps 2-3, mean of the stages; by stage and step "
        f"{[[round(x, 3) for x in sh] for sh in shares]}; schedule s {[[round(x, 2) for x in r['schedule_s']] for r in ranks]}) "
        f"beside GPipe's (S - 1) / (M + S - 1) = {3 / 7:.3f}; {HOST_STAGED}")
    chk.expect(abs(losses[0] - ref) <= TRAIN_BF16_LOSS_TOL,
               f"train_ranks pipeline: first loss {losses[0]:.5f} within {TRAIN_BF16_LOSS_TOL} of the "
               f"one-process lm_loss {ref:.5f}")
    chk.expect(losses[-1] < losses[0], "train_ranks pipeline: the loss falls over 3 steps")
    chk.expect(all(r["digests"][k] == ranks[0]["digests"][k] for r in ranks for k in shared),
               "train_ranks pipeline: embed, final_norm and lm_head bitwise equal on every stage")
    # (d) Qwen2-57B-A14B's widths, 2 layers: one process, then TP 2.
    mcfg = qwen2_moe_a14b_config(num_layers=2)
    ids = torch.from_numpy(np.random.default_rng(TRAIN_RANKS_SEED).integers(0, mcfg.vocab_size, (1, 1024))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    step, init = make_train_step(mcfg, optimizer=make_optimizer(1e-4))
    params, opt = init(init_sharded_params(mcfg, TRAIN_RANKS_SEED, None, device="cuda"))
    one, ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, ids)
        one.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    stats_one = router_stats(params, ids, mcfg)
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    log(f"  train_ranks 57b one process (2 layers, {sum(t.numel() for t in leaves(params)) / 1e9:.3f} B params): "
        f"losses {one}; ms a step {[round(x, 1) for x in ms]}; peak {peak:.2f} GB; load_balancing_loss and drops a "
        f"layer {stats_one}")
    del params, opt, step, init
    torch.cuda.empty_cache()
    whole = [k for k, axis in _split_axis(mcfg, "train").items() if axis is None]
    (ranks,) = spawn([dict(base, kind="train_full", cfg=mcfg, tensor=2, batch=(1, 1024), digests=whole)], 2)
    losses = _train_report("train_ranks 57b tp2 (2 layers)", ranks, 1024)
    log(f"  train_ranks 57b tp2: load_balancing_loss and drops a layer {ranks[0]['router']}")
    chk.expect(all(math.isfinite(x) for x in one + losses), "train_ranks 57b: every loss finite")
    chk.expect(abs(losses[0] - one[0]) <= TRAIN_BF16_LOSS_TOL,
               f"train_ranks 57b: TP 2's first loss {losses[0]:.5f} within {TRAIN_BF16_LOSS_TOL} of one "
               f"process's {one[0]:.5f}")
    chk.expect(one[-1] < one[0] and losses[-1] < losses[0],
               f"train_ranks 57b: the loss falls over 3 steps in one process ({one[0]:.4f} -> {one[-1]:.4f}) and "
               f"at TP 2 ({losses[0]:.4f} -> {losses[-1]:.4f})")
    chk.expect(all(math.isfinite(s["lb_loss"]) and s["lb_loss"] > 0 for s in stats_one + ranks[0]["router"]),
               "train_ranks 57b: each layer's load_balancing_loss finite and positive (1 for a balanced router)")
    chk.expect(_same_bits_where_replicated([[r] for r in ranks], 0, mcfg, "train", "digests"),
               "train_ranks 57b tp2: the router, the shared gate and the norms bitwise equal on both ranks")
    log(f"  train_ranks: {time.perf_counter() - t_phase:.1f} s")


def kernels_table() -> dict:
    """The kernels line's entries, one a kernel of
    ``framefusion_tpu_torch.ops.kernels``, every number still to measure."""
    from framefusion_tpu_torch.ops import kernels as registry

    kernels = {}
    for name, (_, source) in registry.KERNELS.items():
        replaced = registry.replaces(name)
        # Every number is filled in by this run's phases (library_ms stays
        # null where no single PyTorch call computes the function).
        kernels[name] = dict(route="cuda", source=source, replaces=replaced if len(replaced) > 1 else replaced[0],
                             launches=None, main_path_launches=None, max_abs_err=None, ms=None, plain_ms=None,
                             bound_ms=None, bound_by=None, library_ms=None)
    # Kernel A at each of its main-path regimes, kernel C at each decode
    # shape (bf16 and int8): each with its own numbers and launches.
    kernels["flash_attn_fwd"]["regimes"] = []
    kernels["gemv_stacked"]["shapes"] = []
    kernels["gemv_gateup"]["shapes"] = []  # its rows at the batched decode's B
    # The towers of phases 11-16: Qwen2-VL-7B's, InternViT-300M's, SigLIP at 448 and 980 px, Qwen2.5-VL's.
    kernels["bidir_attn_fwd"]["shapes"] = []
    kernels["attn_importance_rows"]["shapes"] = []  # Qwen2-VL's 4 capture rows (11, 15, 16), one in 12-14
    kernels["ragged_decode_attn"]["shapes"] = []  # the decodes of phases 12-16
    return kernels


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card and never runs on the CPU",
              file=sys.stderr)
        return 1
    try:
        import framefusion_tpu_torch  # noqa: F401  (the port must be beside this script)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = Checks()
    kernels = kernels_table()
    no_library = {"attn_importance_rows", "gemv_gateup"}
    ctx: dict = {}
    phases = {"device": lambda: phase_device(chk), "kernels": lambda: phase_kernels(chk, kernels),
              "kernel_check": lambda: phase_kernel_check(chk),
              "cross": lambda: phase_cross(chk), "cross_moe": lambda: phase_cross_moe(chk),
              "cross_train": lambda: phase_cross_train(chk),
              "full": lambda: phase_full(chk, kernels, ctx),
              "decode": lambda: phase_decode(chk, kernels, ctx), "graph": lambda: phase_graph(chk, kernels, ctx),
              "cross_vision": lambda: phase_cross_vision(chk), "cross_qwen2vl": lambda: phase_cross_qwen2vl(chk),
              "cross_internvl": lambda: phase_cross_internvl(chk),
              "cross_families": lambda: phase_cross_families(chk),
              "cross_qwen25vl": lambda: phase_cross_qwen25vl(chk),
              "pixels": lambda: phase_pixels(chk, kernels), "checkpoint": lambda: phase_checkpoint(chk, kernels),
              "cross_baselines": lambda: phase_cross_baselines(chk),
              "baselines": lambda: phase_baselines(chk, kernels), "batch": lambda: phase_batch(chk, kernels, ctx),
              "spec_serve": lambda: phase_spec_serve(chk, kernels, ctx),
              "eval": lambda: phase_eval(chk), "scripts": lambda: phase_scripts(chk, kernels),
              "train": lambda: phase_train(chk), "probes": lambda: phase_probes(chk),
              "bench_modes": lambda: phase_bench_modes(chk),
              "qwen2vl": lambda: phase_qwen2vl(chk, kernels, ctx),
              "internvl": lambda: phase_internvl(chk, kernels, ctx),
              "nvila": lambda: phase_nvila(chk, kernels, ctx), "minicpmv": lambda: phase_minicpmv(chk, kernels, ctx),
              "qwen25vl": lambda: phase_qwen25vl(chk, kernels, ctx),
              "qwen25vl_72b": lambda: phase_qwen25vl_72b(chk, kernels, ctx),
              "moe_57b": lambda: phase_moe_57b(chk, kernels, ctx),
              "cross_parallel": lambda: phase_cross_parallel(chk),
              "parallel": lambda: phase_parallel(chk, kernels, ctx),
              "cross_train_ranks": lambda: phase_cross_train_ranks(chk),
              "train_ranks": lambda: phase_train_ranks(chk, ctx)}
    t_start = time.perf_counter()
    for phase, run in phases.items():
        log(f"== {phase} ({time.perf_counter() - t_start:.1f} s)")
        try:
            run()
        except Exception as exc:  # a failed phase is reported, then the run fails
            import traceback

            traceback.print_exc()
            chk.failures.append(f"phase {phase} raised {type(exc).__name__}: {exc}")
        torch.cuda.synchronize()
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    unmeasured = [f"{n}.{f}" for n, k in kernels.items() for f, v in k.items()
                  if v is None and not (f == "library_ms" and n in no_library)]
    unmeasured += [f"{n}.{e.get('regime', e.get('shape'))}.{f}"
                   for n in ("flash_attn_fwd", "gemv_stacked", "gemv_gateup", "bidir_attn_fwd", "attn_importance_rows",
                             "ragged_decode_attn")
                   for e in kernels[n]["regimes" if n == "flash_attn_fwd" else "shapes"] for f, v in e.items()
                   if v is None and not (f == "library_ms" and (n in no_library or "int8" in str(e.get("shape"))))]
    family_paths = ("internvl", "nvila", "minicpmv", "qwen25vl", "qwen25vl_72b")
    unmeasured += [f"{n}.{path} shape" for n, paths in (("bidir_attn_fwd", ("qwen2vl",) + family_paths),
                                                        ("attn_importance_rows",
                                                         ("qwen2vl",) + family_paths + PAR_PATHS[:2]),
                                                        ("flash_attn_fwd", family_paths + PAR_PATHS[:2]),
                                                        ("gemv_stacked", family_paths + ("moe_57b",) + PAR_PATHS),
                                                        ("gemv_gateup", family_paths + ("moe_57b",) + PAR_PATHS),
                                                        ("ragged_decode_attn", family_paths + PAR_PATHS[:2]))
                   for path in paths
                   if not any(e.get("path") == path for e in kernels[n]["regimes" if n == "flash_attn_fwd" else "shapes"])]
    unmeasured += [f"flash_attn_fwd.{REGIME_LONGVIDEO}"] if not any(
        e["regime"] == REGIME_LONGVIDEO and e.get("path") == "scripts" and e["launches"]
        for e in kernels["flash_attn_fwd"]["regimes"]) else []
    unmeasured += [f"{n}.batch_launches" for n in ("flash_attn_fwd", "attn_importance_rows", "gemv_stacked",
                                                   "gemv_gateup") if "batch_launches" not in kernels[n]]
    unmeasured += [f"{n}.spec_launches" for n in ("gemv_stacked", "gemv_gateup") if "spec_launches" not in kernels[n]]
    unmeasured += [f"{n}.checkpoint_launches" for n in ("flash_attn_fwd", "gemv_stacked", "gemv_gateup",
                                                       "bidir_attn_fwd", "ragged_decode_attn")
                   if "checkpoint_launches" not in kernels[n]]
    chk.expect(not unmeasured, f"every number of the kernels line was measured in this run (missing: {unmeasured})")
    if chk.failures:
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    print(json.dumps({"kernels": [dict(name=n, **v) for n, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
