#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dynamo_tpu_torch`).

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --kernels-only      # phases 1-3, then a summary
    python3 chip_smoke.py --mla-chunked-ttft  # phases 1-2, phase 13's
                                              # chunked deepseek-v2-lite TTFT
    python3 chip_smoke.py --mla-verify-profile  # phases 1-2, phase 13's
                                                # captured verify steps
    python3 chip_smoke.py --mla-prefill-profile [N]  # phases 1-2, phase
                                 # 13's profiled full prefill, N times
    python3 chip_smoke.py --window-profile    # phases 1-2, phase 11's
                                              # bf16 graph-window step
    python3 chip_smoke.py --observability     # phases 1-2 and 16
    python3 chip_smoke.py --trace-stress      # phases 1-2, then repeated
                                              # /debug/trace under load
    python3 chip_smoke.py --gemma             # phases 1-2, phase 3's Gemma
                                              # rows and the Gemma models
    python3 chip_smoke.py --phi3              # phases 1-2, phase 3's Phi-3
                                              # rows and the Phi-3 phase
    python3 chip_smoke.py --profile-lead      # phase 1, then profiler
                                              # sessions with and without
                                              # `traced`'s opening kernels
    python3 chip_smoke.py --lifecycle         # phases 1-2 and 17
    python3 chip_smoke.py --kvbm-qos          # phases 1-2 and 18
    python3 chip_smoke.py --frontend          # phases 1-2 and 19
    python3 chip_smoke.py --disagg            # phases 1-2 and 20
    python3 chip_smoke.py --fleet             # phases 1-2 and 21
    python3 chip_smoke.py --moe [full]        # phases 1-2, phase 13's MoE
                                              # models (full: every layer)

(`--kernels-only`, `--window-profile` and the `--mla-*` options time the
package beside the script, so a copy of it in an older checkout compares
trees.)

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and runs from
the root of a checkout; it exits non-zero, printing no result, without a
CUDA device or without the package beside it. Phases, each of which raises
on failure:

1. The card's name and power limit (nvidia-smi).
2. Build the attention kernels from dynamo_tpu_torch/csrc (nvcc, one per
   source in parallel), with its seconds, and the pair tile's kernels
   (prefill.cu's and chunk.cu's below head_dim 640) with their
   ptxas registers and spills and the HGMMA (wgmma) and HMMA (mma.sync)
   instructions of their SASS (`cuobjdump -sass`): it raises unless each
   holds HGMMA and no HMMA.
3. Each kernel at the shapes the main path gives it for Llama-3.1-8B
   (bf16, H=32, KV=8, D=128, page size 16; int8 pools of 1152-lane rows)
   against its plain PyTorch version on the same inputs (computed in f32,
   stored bf16), within atol=rtol=2e-2 and, per output row, a max error
   within 5e-2 of the plain row's RMS (see disagreement); with its time,
   the plain version's, the time of PyTorch's scaled_dot_product_attention
   over the same K/V gathered dense (int8 pools dequantized to bf16 first;
   gather and dequantization not timed; one call, or for the ragged kernel
   one per row kind, summed: a yardstick the port never calls), and the
   bound max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) worked out from the
   bytes and FLOPs this run's inputs need. Each function's time is its
   device time per call (calls queued behind a sleep kernel run back to
   back, CUDA events; median of three batches), since a call's host time
   can exceed a short kernel's; its call time (CUDA events around calls
   made back to back from the host, median of five batches) is reported
   beside it. The kernels:
   decode (8 slots on 128-page tables, and again as `decode_long` on a
   512-page table with one row at 8192 tokens, where the key spans widen
   past 256), prefill, chunk (the 256-token chunk at 512, and again at
   1792, the last chunk of a 2048-token prompt), ragged (8 decode rows and
   a 256-token chunk; again with rows of 5 queries, the speculative verify
   windows of K = 4, with the chunk and without one, C = 0, as the verify
   step launches it), the int8 variants of decode, chunk and ragged (the
   verify windows too), and decode at head_dim 64 (`decode_hd64`: the
   llama-3.2-1b-instruct draft model's B=1 step on its 129-page table).
   Rows that run the same blocks must be bit-identical: ragged's chunk rows
   (chunk.cu's pair tile, launched by ragged.cu) to
   chunk.cu's, its decode rows to decode.cu's (the same split plan: the
   same table width and row count), and a prefill lane at seq_len = S to
   chunk.cu's chunk at start 0 over the same K/V in pages. Each row
   carries its kernels' registers and spills from the build's ptxas
   output. This is the numerical check of the kernels on random inputs.
   Then the same inputs at the new families' shapes (FAMILY_SHAPES), each
   row named `kernel[shape]`: gemma-7b-it's head_dim 256 at group 1 (every
   entry point and pool kind, and the verify windows), gemma-2b-it's
   head_dim 256 at group 8, qwen2.5-7b-instruct's group 7 at head_dim
   128 (a verify window of 5 x 7 = 35 tile rows), qwen3-30b-a3b's
   group 8 at head_dim 128 (32/4 heads: 5 x 8 = 40 tile rows) and
   deepseek-v2-lite's MLA latent row, head_dim 640 at group 16 (one KV
   head for 16 query heads; every entry point, both pool kinds, the
   verify windows of 5 x 16 = 80 rows), each row with the backend
   PyTorch's dispatcher picks for its library call. The decode and ragged
   rows there run the latent decode rows (each row's horizon cut into
   spans, a block per span and query tile, merged by merge_latent_kernel):
   each reports its spans, blocks (those with keys to walk), longest span
   and the merge's own device time (`latent_decode`), and ragged's chunk
   rows must equal chunk.cu's, its decode rows decode.cu's, bit for bit.
   The chunk rows
   there run the latent chunk tile (each query tile's keys cut into spans,
   one block each, merged by the query tile's cluster): each reports its
   spans, blocks (those with keys to walk) and longest span, and the
   merge's own time (each block's global-timer stamps at the end of its
   key walk and at its exit; `latent_chunk`), and at phase 3's shape the
   time of every span count from 1 to 8 beside the clusters of that size
   the card holds at once; they are timed again at the served shapes,
   the ~88-token tail of the 600-token prompt at 512 and a 256-token
   chunk at 0 (`chunk[head_dim=640,group=16,C=88,start=512]`, ...), and
   two launches must give equal bits. The prefill rows there run the
   same clusters over each lane's query tiles (K passed as V, as the
   model passes MLA's latent rows): each reports the same plan fields
   (`latent_prefill`) and the time of every span count; they are timed
   again at the served one-lane buckets
   (`prefill[head_dim=640,group=16,S=128,lens=100]` and `S=256,lens=256`);
   two launches must give the same bits, and the 256-token lane those of
   chunk.cu's chunk at start 0. Last, the seven entry points at two
   windowed shapes (`windowed_kernel_checks`): Gemma-2-9B's local layers
   (GEMMA_SHAPE: 16/8 heads, head_dim 256, a 4096-key sliding window and
   the tanh cap at 50, q scaled so that the cap bends): decode rows at
   contexts up to 8192 (with the same call's time without the window
   beside it), two prefill lanes of 6000 and 4500 tokens, a 256-token
   chunk at 4864, the mixed step's descriptors; and Phi-3-mini's
   (PHI3_SHAPE: 32/32 heads, head_dim 96, group 1, a 2047-key window, no
   cap): decode rows at contexts up to 4096, two prefill lanes of 3800
   and 2600 tokens in the 4096 bucket, a 256-token chunk at 3008, the
   mixed step's descriptors; on bf16 and int8 pools, each bound counting
   only the keys inside the window, each library call flex_attention
   under torch.compile with the window as its block mask and the cap, if
   any, as its score_mod (the compiles untimed; a row whose call fails
   says why); the chunk rows (the pair tile) carry its span sweep
   (`pair_spans`: the plan, one span, and the time of every span count a
   measurement may ask for, each output within the tolerance of the
   plan's).
4. The engine for llama-3.1-8b-instruct at full width and depth, random
   bf16 weights from seed 0: a full prefill, a decode step, a chunked
   prefill, a mixed step (the decode row beside a 256-token chunk), a
   verify step (that row's window of K+1 = 5 tokens) and a mixed verify
   step (the window beside the chunk) through the kernels, every
   attention call of every layer held against the plain version on the
   same inputs (its f32 output, before rounding: see HeldAgainstPlain),
   and the full-depth logits against
   the same forwards through the plain attention. q is scaled down before
   attention so that softmax is not one-hot (see forward_checks). Run on
   bf16 pools and again on int8 pools (an engine sharing the weights).
5. The OpenAI server on 127.0.0.1:0 with the launch counts zeroed, on the
   eager engines (1-step synchronous decode, no graphs): four concurrent
   greedy requests of 32 tokens (chat, chat streamed, a completion, and a
   ~600-token prompt that takes the chunked path), then one request twice,
   which must give identical tokens, then the interference traffic
   (below); decode, prefill and chunk must have launched. Then two engines
   sharing the weights, with mixed_batch_tokens=256 on bf16 and on int8
   pools, each serving the interference traffic: the ~600-token prompt
   alone (the classic chunk path), then a streamed chat and, after its
   first token, the same prompt, which rides the mixed step. Each must
   count mixed steps, and launch its ragged kernel 32 times (once per
   layer) per mixed step. The streamed request's worst inter-token gap
   while the prompt prefills is reported for the classic and the mixed
   engines side by side.
6. Decode windows on CUDA graphs (engines sharing the weights, their
   greedy graphs captured by `Engine.warmup()`):
   - window parity: the JAX jetstream profile (8-step synchronous windows,
     no chunking) and the same with async scheduling serve phase 5's four
     greedy requests and two seeded sampled ones (temperature 0.8, top_p
     0.9); every token and logprob must equal an eager 1-step engine's
     (the same kernels on the same shapes: bit for bit). A difference is
     reported at its first token with the top-5 logprobs of both.
   - served windows: the OpenAI server on the jetstream engine, the four
     concurrent requests of phase 5: TTFT, mean ITL, worst gap and tokens
     per second of the streamed chat beside phase 5's eager numbers.
   - prefix caching: the vllm_tpu profile (1-step async windows, chunks of
     256, prefix caching) takes the ~600-token prompt, the same prompt
     again, then a prompt sharing its first 512 tokens: the second and
     third must hit the cache and launch the chunk kernel only for their
     suffix (one chunk each), give the eager engine's greedy tokens (its
     cache is off), and their TTFT is reported beside the first's.
7. int8 weights (`models.quant`): the 8B model's int8 weights drawn on the
   card by the engine's own loader (`quantization="w8a8"`, no checkpoint:
   `loader.random_quantized_params`), and a weight-only (`int8`) twin over
   the same q and scale tensors; their GiB and build seconds. The int8
   product (`quant.int_mm`: torch._int_mm, zero rows appended below 17) at
   8, 1 and 256 rows for wo, w_gate, w_down and lm_head must equal the
   exact integer product (f64 on the card, exact below 2^53) bit for bit;
   each quantized matmul at 8 rows against the bf16 matmul over its
   dequantized weight (relative L2 within QUANT_REL_L2), with both device
   times.
8. Quantized decode windows: a w8a8 engine on the jetstream profile
   (8-step graph windows), warmed up, against an eager 1-step w8a8 engine
   on phase 6's parity requests (tokens and logprobs bit for bit); then
   the OpenAI server on it with phase 5's four concurrent requests.
9. The trtllm_tpu profile (4-step async graph windows, chunks of 256,
   prefix caching), its EngineConfig parsed by the worker's parser from an
   engine-config file, on the w8a8 weights, warmed up: phase 6's prefix
   traffic (cache hits, suffix-only chunk launches, the tokens of a
   cache-off eager w8a8 engine).
10. `model_path`: a bf16 checkpoint in the HF layout at the 8B widths with
   2 layers (~2.9 GiB in two safetensors files, and its config.json),
   written under a temporary directory that is deleted afterwards, loaded
   by `Engine(EngineConfig(model_path=...))`: its ModelConfig must be the
   preset's at 2 layers, every parameter must equal its source tensor
   (transposed from HF's [out, in]) bit for bit; load seconds and GiB/s,
   and one greedy chat request served from it.
11. Where a steady step's time goes (torch.profiler device time by kernel
   family, kernels per decode step, idle share against the host clock): a
   decode step of 8 slots on bf16 and on int8 pools, eagerly and in 8-step
   graph windows (with graph replays per window and capture time), the
   same graph-window step with w8a8 and with weight-only int8 weights (bf16
   pools), and a mixed step (7 decode slots beside the chunks at 256, 512
   and 768 of a 1024-token prompt) on bf16 and on int8 pools.
12. Speculative decoding (K = 4, n-gram drafts unless said otherwise),
   each served phase counted from zero, on the 8B's random weights with
   wq scaled by Q_SCALE (`soft_attention`). With wq as drawn, attention
   scores have a deviation near 30 and softmax is close to one-hot, which
   makes the bf16 forward chaotic: a decode step over 40 rows (the verify
   step's 8 x 5) rounds its GEMMs otherwise than one over 8 rows, and the
   logits then differ by whole units and the argmax at most positions, so
   no stream of any speculating engine could match spec-off, nor any
   drafter's proposals the verify step's (`batch_shape_noise` measures
   both weight sets in every run: the logits of one state from an 8-row
   and a 40-row decode step and the verify step's row 0). With wq scaled,
   the scores' deviation is near 2 (as in phase 4) and the same
   comparison differs by a bf16 unit or two of the logits.
   (a) `spec_parity`: the jetstream profile (its greedy verify graph
       captured by warmup) against an eager 1-step spec-off engine on
       phase 6's parity requests, its two logprobs requests cut to 8
       tokens (while one is live a step demotes to plain decode); every
       stream must be equal, or differ first where the spec-off engine's
       top-2 gap is under NEAR_TIE (a bf16 near-tie: the verify step's
       40-row GEMMs round otherwise than the 8-row decode step's); the
       gap is that of the reference's own decode logits (it serves every
       request with 2 logprobs), or for a sampled request the least
       change of its temperature-scaled logits that changes its draw (the
       top-2 gap of the top-p and top-k masked logits plus its Gumbel
       noise, or the distance of the winner, or of a left-out token that
       would beat it, from the top-p set's edge: `sampled_gap`), from a
       chunked prefill of the prompt and the reference's tokens before
       the difference.
   (b) `serve_spec`: the OpenAI server on that engine with phase 5's four
       concurrent requests, the streamed chat and the completion without
       logprobs (they would demote every step), beside the graph-window
       jetstream engine on the same requests: TTFT, mean ITL, worst gap,
       tokens per second, acceptance and tokens per verify step. The
       server decodes every token id to one character here
       (`VisibleTokenizer`), so each token is its own SSE event.
   (c) where a steady verify step's time goes (as phase 11), in its graph
       and eagerly.
   (d) the same parity on int8 pools, with `ragged_int8` verify launches.
   (e) `mixed_batch_tokens=256` on bf16 and int8 pools: the ~600-token
       prompt beside the streamed chat (no logprobs); mixed verify steps
       must run, each one ragged launch per layer with the chunk.
   (f) `--drafter model`: a self-draft engine (the 8B drafting for itself,
       its weights shared) on the greedy parity requests, acceptance at
       least SELF_DRAFT_ACCEPT of drafted tokens, streams as in (a); then
       llama-3.2-1b-instruct (random weights from seed 1) drafting for the
       8B on all parity requests: acceptance, draft steps and the draft
       graph's device time per step against the eager step's.
13. The new families (FAMILY_MODELS), once the 8B's engines and weights
   are released, each at full width and depth with random bf16 weights
   from seed 0: gemma-7b-it (GeGLU, 1 + w norms, scaled embeddings,
   head_dim 256), qwen2.5-7b-instruct (attention biases, group 7) and
   qwen3-0.6b (qk_norm, tied head). Phase 4's forwards on bf16 pools (and
   int8 ones for gemma-7b-it), q scaled as there unless the model
   normalizes q and k itself; the OpenAI server on a warmed-up jetstream
   engine with phase 5's four concurrent requests; where a graph-window
   decode step's time goes (as phase 11; gemma-7b-it and qwen2.5); and
   engines with mixed_batch_tokens=256 serving phase 5's interference
   traffic (gemma-7b-it on bf16 and int8 pools, qwen2.5 on bf16 pools),
   so that every kernel and pool kind launches at head_dim 256 and every
   kernel at group 7. Then, once those are released, the two
   mixture-of-experts models at full width, cut in depth to pay for phase
   21 (MOE_MODELS: 12 of qwen3-30b-a3b's 48 layers, 8 of Mixtral's 32):
   qwen3-30b-a3b (128 experts, top 8, q/k norms, GQA group 8) with random
   bf16 weights from seed 0, and mixtral-8x7b-instruct-v0.1 (8 experts,
   top 2) with w8a8 weights drawn as int8 on the card by the engine's
   loader; each on bf16 pools, printing its parameters, weight and pool
   GiB and peak: phase 4's forwards, where the routing of the forward
   through the kernels is compared with the plain forward's (the first
   token and layer where a token's top-k experts differ, with the plain
   forward's margin between its k-th and (k+1)-th router logit: logits
   past LOGIT_REL_TOL are a fault unless that first difference is a
   near-tie of at most one bf16 unit, see forward_checks); the OpenAI
   server on a warmed-up jetstream engine with phase 5's four concurrent
   requests; where its graph-window decode step's time goes (as phase
   11), with the device time of the step's MoE blocks alone and the
   bound of reading every weight once; and for qwen3-30b-a3b a
   mixed_batch_tokens=256 engine serving the interference traffic and
   the ~600-token prompt's TTFT as one prefill with moe_capacity_factor
   0 and 1.25 (the prefill's capacity path), and two capacity-path
   prefills of it, which must give the same bits. Last, once those are
   released, deepseek-v2-lite (MLA_MODEL) at full width and depth (27
   layers: MLA with YaRN, pools of one 640-lane latent row, 64 experts
   of 1408, top 6, 2 shared) with random bf16 weights from seed 0: phase
   4's forwards on bf16 and int8 pools (routing compared as for the MoE
   models), the OpenAI server on a warmed-up jetstream engine with phase
   5's four concurrent requests, its graph-window decode step profiled
   (the MoE blocks' and the attention's shares, the bound of reading
   every weight once), mixed_batch_tokens=256 engines on bf16 and int8
   pools serving the interference traffic, the same with n-gram
   speculation (K = 4) on graph-window engines (verify windows alone and
   beside the chunks), each with one captured verify step profiled (its
   device time and the attention's share, `mla_verify_profile`), the
   capacity path's TTFT and bit identity, one profiled eager full
   prefill of a 256-token prompt (the device time of its kernels and of
   its 27 prefill launches, `mla_prefill_profile`, also run alone, N
   times back to back, by `--mla-prefill-profile [N]`: a trace that lost
   a prefill kernel fails, with `profile_drops`' account of where; the
   session opens with `traced`'s throwaway kernels, since kineto drops
   the first device records of a session, more as the process ages,
   which `--profile-lead` shows), and
   the TTFT of a 2048-token
   prompt prefilled in 256-token chunks (eight chunk launches a layer,
   the last at 1792) on bf16 and int8 pools, with the host side of one
   profiled prefill by op (`mla_chunked_ttft`, also run alone by
   `--mla-chunked-ttft`); so that every kernel launches at head_dim 640
   when served. Between the families and the MoE models, Gemma-2 and
   Gemma-3 (GEMMA_MODELS, `gemma_phase`): gemma-2-9b-it (5 of its 42
   layers, 3 of them local with a 4096-key window, caps 50 and 30) and
   gemma-3-1b-it (7 of its 26 layers, 6 local with 512 keys, per-layer
   rope) at full width, random bf16 weights from seed 0 (gemma-2-9b-it's
   wq scaled by 2^-4: WINDOWED_WQ_SCALE), 8 slots on 2560 pages of an
   8192 max length: phase 4's forwards past the window on both pool
   kinds; four greedy streams of 64 tokens from prompts of 4500-6000
   (1000-2000) tokens on a classic eager engine, the jetstream
   graph-window engine (token for token equal), a mixed engine, and on
   int8 pools an eager engine prefilling in 256-token chunks, a jetstream
   engine and a mixed engine, each held against a reference run of its
   pool kind (HELD, REFERENCE: the classic engine, or the int8 chunked
   one): the two runs' logprobs of either's 5 top tokens, on every
   state both saw (up to and including a stream's first difference),
   within BOUND_FACTOR times the same quantity between the same two paths
   through the plain attention (path_bounds: the largest over 16
   teacher-forced decode states of as many random prompts as the served
   streams, `path_states`); a mixed engine with
   n-gram speculation (no logprobs: they would demote it) equal to the
   classic one, or first different at a near-tie; TTFT, mean ITL and
   tokens per second of each, one
   prompt's TTFT alone (whole, and in 256-token chunks), and for
   gemma-2-9b-it a graph-window decode step profiled at 8 slots of
   4600-token prompts; every entry point must launch with the window.
   After them Phi-3 (PHI3_MODEL, `phi3_phase`): phi-3-mini-4k-instruct
   (32 layers, head_dim 96, 32/32 heads, a 2047-key window on every
   layer) at full width and PHI3_LAYERS (12) of its layers (32 before
   phase 18 and 20 before phase 19 took their time), random bf16 weights from seed 0 (wq
   scaled by 2^-4), 8 slots on 2048 pages of its 4096 context: the same
   forwards on both pool kinds at 3000 tokens; four greedy streams of
   2500-3800-token prompts on the classic eager engine, eager engines
   prefilling in 256-token chunks on both pool kinds, the jetstream
   graph-window engine
   (token for token equal), mixed engines on bf16 and int8 pools and the
   int8 jetstream engine, held as for Gemma, and the check's controls: the
   mixed engine again with each planted fault of PLANTED_FAULTS in its
   mixed steps' ragged call, which the check must fail (but the one key
   short of UNSEEN_FAULTS, recorded); the
   OpenAI server on the jetstream engine
   with phase 5's four concurrent requests; a graph-window decode step
   profiled at 8 slots of 3000-token prompts; then the same weights
   under longrope (`phi3_longrope_config`: from_hf_config of a 128k
   config.json dict written here, 48 short and 48 long factors from
   seed 0, original_max_pos 4096, a window wider than any context) at an
   8192 max length: the forwards at 6000 tokens on bf16 pools and two
   ~6000-token prompts on classic, graph-window and mixed engines
   (positions past 4096 in the prefill, the chunks and decode).
14. JSON-guided decoding (after phase 11, on the 8B's weights). The
   grammar kernel (`csrc/json_mask.cu`, both entry points) against its
   plain version on the card: B = 8 rows over V = 128256 tokens of a
   synthetic 16-byte-wide table made from the seed (pieces of 1-16 bytes,
   mostly JSON's alphabet, and specials and stop ids), states of every
   mode at depths 0, 1, 5 and 31 with random bits, some rows not guided;
   json_mask's logits and json_advance's states must equal the plain
   version's exactly; device and call ms, the plain version's call ms
   (host-bound: hundreds of small ops), the bound from the bytes and the
   transitions this run's data needs (operations at the card's INT32
   lane rate). Then the jetstream engine, warmed up (the greedy guided
   graphs too), serving four concurrent json_object chats at temperature
   1.0 with distinct seeds and a greedy one: every choice's text,
   whatever ended it, must fold through the grammar without a byte that
   breaks it, and every choice that stops must json.loads to a dict; a
   forced tool_choice must come back as a tool_calls choice whose
   arguments fold and parse (random weights seldom close an object, so
   its logit_bias favours the structural bytes); json_mask must launch
   inside graph replays and on the guided first tokens' prefill logits
   (more launches than json_advance). A guided 8-slot graph-window step
   is profiled as in phase 11 beside the unguided step (both with '}'
   banned by logit_bias, so that no object completes and the mask folds
   every step).
15. Multi-LoRA serving (lora_slots=4, lora_rank=16) on the 8B's weights:
   two random adapters written here as adapter.npz and registered at boot,
   a third as HF-PEFT safetensors registered through POST /v1/adapters;
   the server takes base and adapter requests (`<base>:<adapter>`)
   together in graph windows; base-slot greedy streams must equal a
   lora_slots=0 engine's token for token over the same batch shapes, and
   adapter streams must differ from the base; phase 4's forwards through
   the kernels with an adapter slot against the plain attention (logits
   within LOGIT_REL_TOL); greedy adapter streams with n-gram speculation
   (K = 4) against spec-off, as phase 12 holds them (wq and the adapters'
   q deltas scaled; equal or first different at a near-tie), at least one
   of them equal; the graph-window step with three adapters live profiled
   beside base-only traffic on the same lora_slots=4 engine (every step
   computes the deltas once lora_slots > 0, as in the JAX engine) and
   beside the lora_slots=0 engine's step.
16. The worker's observability plane, last on the 8B's weights, after a
   profiler run that starts CUPTI (its first start takes seconds and
   leaves launches slower, so every run serves in that state): two
   jetstream graph-window engines in turn, each warmed up, behind the
   worker with VisibleTokenizer, serving phase 5's four concurrent
   requests and OBS_STREAMS (16) streamed chats of 128 tokens,
   OBS_CONCURRENT (4) at a time, with `/metrics` scraped before and
   after; the plane's switches (DYNAMO_TPU_TRACE, DYNAMO_TPU_TIMELINE,
   DYNAMO_TPU_FLIGHT_RECORDS, read when an engine is built) off, then on
   (one pair: phase 17 takes the time of a second), TTFT, mean ITL and
   tokens per second of the streams and the live MFU/MBU printed for each (`observability_cost`). The first run
   with the plane on is checked (`observability`), and fails unless: the
   scrapes parse, their buckets are cumulative with +Inf equal to _count
   (this script's own check) and the OpenMetrics one carries exemplars
   and ends with # EOF; the server's TTFT count equals the client's
   requests, its ITL count the sum of their tokens less one each, its ISL
   and OSL sums the client's usage; MFU and MBU lie in (0, 1], and MBU
   within MBU_REL_TOL (10%) of this script's own reckoning from the
   loaded weights' and the pools' `nbytes` over the same counters; the
   device-memory gauge within 1% of torch.cuda.memory_allocated(); the
   device KV books sum to the pools' `nbytes` exactly; and a 1 s
   /debug/trace, taken on one more wave after the second scrape, holds
   decode.cu's `decode_kernel` by name. Every served phase before it
   (the OpenAI server of phases 5, 6, 8, 10, 12, 13, 14 and 15) prints
   its model's live MFU and MBU from one scrape (`utilization`). With
   `--trace-stress` (not in a full run): TRACE_STRESS_WAVES (24) waves of
   phase 16's four streams on one such engine, a 1 s /debug/trace in
   three of every four, each wave's seconds (`trace_stress`); a wave
   that outlasts OBS_WAVE_S (120 s) fails, as in phase 16.
17. The worker's lifecycle (`lifecycle_phase`), last on the 8B's weights:
   one jetstream graph-window worker (8-step windows, with chunks of 256
   and prefix caching) behind the OpenAI server with VisibleTokenizer, and
   first, for reference, an engine booted on the second weight version
   (the 8B drawn from LC_V2_SEED), freed before v2 is staged. Every run
   of the four greedy LC_PROMPTS (LC_TOKENS tokens) admits them together,
   one batched prefill. It fails unless: a request with `x-deadline: 0`
   gets 504 and takes no slot; with `engine.device_nan` armed the lead
   lane ends with finish "error" and no text, the other three equal the
   fault-free run, `dynamo_engine_integrity_faults_total` is 1 and the
   health stays healthy; a 1 s /debug/trace beside two streams with the
   derived deadline armed (the seams' EWMA x 20, at least 2 s) trips
   nothing (CUPTI was started in phase 16); `/internal/rollout` stages v2 (its GiB and seconds printed), a v1
   prefix-cache hit happens, a finish-mode flip with four v1 streams in
   flight arms, they finish with the v1 tokens, the four admissions held
   meanwhile decode v2's reference tokens on graph replays (decode
   launches above 0), a v1 prefix misses under v2, and a rollback gives
   the v1 tokens again (the flip's and the rollback's ms under the lock
   printed); with the deadline at LC_STEP_DEADLINE_S (1 s) and
   `engine.device_hang` queueing LC_HANG_S (3 s) of device spin, the
   watchdog trips, `/ready` answers 503 and `/live` 200 within 100 ms
   each while the card spins, `/v1/*` sheds 503, the engine resurrects
   in place (its seconds printed) and `/ready` returns to 200, and the
   four prompts give the v1 tokens on graph replays; `/internal/drain`
   with four streams in flight sheds a new request with 503 while the
   four finish with the v1 tokens (the drain's seconds printed); a second
   hang inside the quarantine window quarantines the worker (`/ready`
   503). The phase's seconds are printed.
18. The KVBM host tier and per-tenant QoS (`kvbm_qos_phase`), last on
   the 8B's weights, on eager engines (1-step, synchronous), the kernels'
   launches counted from zero over the phase. (a) long_shared_prefix's
   shape (`kvbm_host_tier`): KVBM_CONVS (6) conversations, each its own
   KVBM_PREFIX-token (1024) prefix and an 8-token turn, served one at a
   time for two turns (KVBM_TOKENS greedy tokens each) on a device pool
   of KVBM_DEVICE_PAGES (2.5 conversations: turn 2 always misses on the
   device) with KVBM_HOST_BLOCKS of pinned host tier (the working set and
   a conversation more; the gate on "auto"), then with the tier off and
   on a cache-off engine (turn 2), on bf16 pools and again on int8 pools.
   It fails unless the arenas are pinned, every turn-2 prompt onboards
   its whole prefix from the host tier, each launches the chunk kernel
   once a layer for its one suffix chunk, and the greedy tokens of the
   three engines are equal. Printed: turn-2 and turn-1 TTFT (engine
   clock), the host hit ratio, the KVBM's counters, the gate's numbers;
   and on the bf16 tier-on engine (`kvbm_rates`) the demote and onboard
   GB/s end to end (2 MiB blocks), the raw pinned host-to-device rate,
   a one-block onboard's fixed cost and a fit of the eager chunk's wall
   (the numbers behind `kvbm/cost_model.py`'s defaults). (b)
   `kvbm_integrity`: under DYNAMO_TPU_INTEGRITY=full, one byte of the
   first conversation's block at 256 tokens flipped in its pinned host
   copy: it must drop with one `kv_checksum` fault, the prefix onboard
   to it and recompute from it with the tier-off run's tokens; then
   every cached page demoted (the drain's `demote_all`), the engine
   resurrected, and the next conversation's whole prefix onboarded from
   the surviving host tier with the tier-off tokens. (c) multi_tenant_skew's
   shape (`tenant_skew`): on a mixed engine of QOS_SLOTS (4) slots behind
   the OpenAI server, the 8B's wq scaled by 2^-4 for it (as the windowed
   models serve: unscaled, two schedules part by whole nats; restored
   after), QOS_AGGRESSOR (8) streamed chats of
   QOS_AGGRESSOR_TOKENS greedy tokens tagged `x-tenant-id: aggressor`
   queued first; once the aggressor holds every slot and has streamed
   QOS_HEAD_START tokens a slot, QOS_GOOD (2) of QOS_TOKENS tagged `good`,
   equal weights, with QoS off and on: the good tenant's TTFT p95 printed
   beside the deferrals and preemptions. With QoS on the aggressor, over
   its budget and above its slot share, must lose a slot to a WFQ
   preemption by recompute (none with QoS off), and every stream, the
   preempted ones included, must equal the same stream with QoS off or
   first differ at a near-tie of the QoS-off run's top-2 logprobs
   (`tenant_differences`: the two schedules give the mixed steps other
   row counts); one request alone tagged `good` with QoS equals the same
   untagged without. decode,
   prefill, chunk and ragged must each launch in the phase. Its seconds
   are printed (the phase's budget, ~35 s, was paid by serving Phi-3 at
   PHI3_LAYERS of its 32 layers).
19. The frontend tier (`frontend_phase`), last on the 8B's weights (wq
   scaled by 2^-4 for it, as in 18(c); restored after), the kernels'
   launches counted from zero over the phase: an in-process
   `MiniNatsBroker`, two frontends started as `python -m
   dynamo_tpu_torch.frontend` on free ports (`fe_nats` with `--nats-url`:
   the NATS request plane and the KV event index; `fe_http` without: the
   HTTP plane, whose SSE relay journals streams and resumes them
   mid-stream), both with DYNAMO_TPU_MAX_INFLIGHT=4, and two workers in
   this process, each its own jetstream-profile engine (8-step graph
   windows, warmed up) with chunks of 256 and prefix caching, 8 slots and
   page 16, on the one model, each with its own server, the worker CLI's
   `--nats-url` wiring (`serving/worker.attach_nats_plane`: the request
   plane and the KV event publisher) and `heartbeat_loop` to both
   frontends. (a) FE_CONVS (4) conversations through `fe_nats`: a first
   turn of ~600 tokens (over the chunk: chunk.cu), then a second turn
   extending it; the frontend's `KVEventIndex` must have received the
   workers' stored-block events over NATS, every second turn must go to
   the worker that served its first (by the index: `kv_index_hits`), and
   only that worker's prefix cache hits rise. (b) FE_PROMPTS (8) greedy
   streamed chats of FE_TOKENS (32), each straight to a worker over HTTP
   SSE and over the NATS request plane, and through each frontend (the
   prefix caches emptied before each, so every run prefills alike:
   prefill.cu); each must equal the direct HTTP run or first differ at a
   near-tie of its top-2 logprobs (NEAR_TIE); TTFT, mean ITL and the
   time to the first event (the role chunk, sent as the worker queues the
   request: the request path alone, which no decode window quantizes) on
   the client's clock for each route. (c) a 64-token stream through `fe_http`
   with `worker.crash_mid_decode` armed through a worker's
   `/internal/faults` after FE_CRASH_AFTER tokens: the frontend resumes it
   on the peer from its journal, and the client's tokens must equal an
   uninterrupted run's (or first differ at a near-tie); the resume gap is
   the stream's widest gap between two tokens. (d) four requests held at
   the workers (`worker.read_stall`) fill `fe_nats`'s in-flight bound: a
   fifth gets 429; an expired `x-deadline` gets 504. The line prints the
   frontends' native router core (it fails unless loaded), routed-to-owner
   counts, each worker's prefix hits, the KV events received, the routes'
   TTFT, ITL and first event, the `router.pick` span's ms (`/debug/spans`), the resume
   gap, the launches (decode, prefill and chunk must each launch) and the
   phase's seconds, with the card line.
20. Disaggregated serving (`disagg_phase`), last on the 8B's weights (wq
   scaled by 2^-4 for (a) and (c), as in phase 19; restored after). (a)
   A prefill-role engine and a decode-role engine of the jetstream profile
   (8-step graph windows, warmed up: the prefill role captures nothing and
   runs one prefill_only, the decode role also its import scatter), each
   behind its own server, behind an in-process frontend (`dg_frontend`):
   first the handoff of one DG_RATE_TOKENS (1792)-token prompt's KV timed
   alone on each plane (`dg_rates`: the in-process gather and scatter;
   the TCP pull through host memory and its import), then DG_PROMPTS (4)
   greedy streamed chats of DG_TOKENS (32), one at a time, over `dcn` and
   then over `ici_inproc` (the prefill engine in `ici_registry`), and the
   same chats through a frontend to an aggregated jetstream engine; each
   disagg stream must equal the aggregated one or first differ at a
   near-tie, the planes' counts must be exactly those chats (nothing
   silently went `dcn`), prefill.cu must launch on the prefill role and
   decode.cu on the decode role (the prefill_only calls' launch deltas
   against the rest); TTFT and ITL per path, the KV bytes, GB/s and import
   seconds per plane. (b) A child process, `python -m
   dynamo_tpu_torch.jetstream --device cuda --disaggregation-mode prefill`
   on a full-depth DRAFT_MODEL (llama-3.2-1b-instruct) checkpoint the
   phase writes (`dg_checkpoint`), started at the phase's start, and a
   decode role in this process on the same checkpoint: one
   DG_RATE_TOKENS-token prompt's KV staged on the child, opened here and
   imported, timed alone (`dg_ipc_rate`), then DG_PROMPTS chats over CUDA
   IPC (`ici_device` count 4, `dcn` 0) equal to an aggregated engine's
   (near-tie rule), the child left holding no KV; then the leak drill,
   against a 1B prefill role of this process whose stage TTL is cut to
   DG_STAGED_TTL_S (2 s): a peer process (`DG_PEER`) prefills and stages
   a request there, maps its KV over CUDA IPC and is killed before its
   release; the stage ledger must show it leaked after the TTL, and a
   late /disagg/release must free the stage and the parked pages. The kernel
   library must not be rebuilt (its files unchanged). (c) The KVBM peer
   pull: a warm worker's turn 1 (~1400 tokens, chunked) demoted to its
   host tier (`drain_demote`), then turn 2 on a cold worker with
   `kvbm_peers` pointed at the warm worker's `HostTierSource` against a
   worker that recomputes: peer_onboarded_blocks_total > 0, turn-2 TTFT
   both ways, the streams equal or a near-tie apart. The line prints the
   native transport's status (it fails unless loaded), the peak device
   memory of this process and of the child, the launches and the seconds.
21. The fleet's control plane (`fleet_phase`), last on the 8B's weights
   (as the loader draws them; the mixed engines freed first). (a) The
   port's SLA profiler, `python -m dynamo_tpu_torch.profiler` for the 8B
   on `h100-sxm-1` at FL_SLA, which the 8B meets there: its Estimate
   (tp 1, the batch, TTFT and ITL). (b) tests/fake_k8s.FakeK8s with a
   DGDR whose template (`fl_template`) holds a frontend and one jetstream
   worker of the 8B (FL_PAGES pages, prefix caching and a KVBM host tier
   of FL_HOST_BLOCKS blocks, one tenant); the port's Controller renders
   and applies the DGD (the profiler's decision: `--tp 1`,
   `--max-num-seqs`, `limits.gpu`) and materializes it; the Deployments
   must run the port's modules on one `nvidia.com/gpu` (request = limit)
   with the tenants and host-tier env. A kubelet of one
   (tests/fake_kubelet.py) spawns each container's command, args and env
   as a child process (POD_IP 127.0.0.1; the worker binds 8000 as in its
   pod, the frontend another port that the worker's FRONTEND_URL is
   rewritten to) and puts the Pods in the fake store; the worker serves
   the 8B at full width and depth from the loader's seed-0 draw. (c)
   FL_CHAT_CHARS' four greedy streamed chats of FL_TOKENS through the
   spawned frontend, one at a time, then the same to an engine of this
   process built from the container's args and env by the worker's own
   parser (`fl_engine_config`) on the same weights: each stream's tokens
   and logprobs must equal the reference's or first differ at a near-tie;
   the worker's /worker/stats must show the max_num_seqs, host blocks and
   tenant the operator wrote; the served TTFT and ITL beside the
   roofline's estimate at the served point (tp 1, the batch, the prompt)
   and (a)'s, with their ratios: the ITL's within FL_ITL_RATIO, the
   TTFT's within FL_TTFT_RATIO (the window's wait the formula lacks). (d) The DGD's decode pool autoscales
   (planner v2, FL_STREAMS_PER_REPLICA streams a replica) from the live
   frontend's /metrics and history: `Controller.planner_tick` under
   FL_BURST concurrent streams must raise the Deployment's replicas to
   FL_BURST / FL_STREAMS_PER_REPLICA, ticks after the burst must lower
   them to 1, marking the worker's Pod as the drain victim, whose
   /internal/drain must reach the worker. (e) The worker's
   `kernel_launches` (/worker/stats) over (c) and (d), less its counts
   once it registered (its warmup's and captures'), must count
   prefill.cu, chunk.cu and decode.cu. Then the roofline's factors for the card (`fl_factors`,
   profiler/roofline.py): a FL_PREFILL_TOKENS-token whole prefill's FLOPs
   over its time, the bytes of a one-slot graph-window step over its time,
   FL_WIDE slots' FLOPs over their step, and the served ITL less the
   worker's one-slot step, beside the factors in the code. (f) The
   phase's seconds and the peak device memory of this process and of
   the worker.
22. A `kernels` JSON line (launches summed over the served phases, graph
   replays included; the verify windows, at decode_q = 5 with and without
   a chunk, decode at head_dim 64, the kernels at head_dim 256, at group
   7 and at group 8 counted as rows of their own: the head_dim 256 rows
   from the served gemma-7b-it phases' variant counts, the group 7 rows
   from the served qwen2.5 phases' launches, the group 8 rows from the
   served qwen3-30b-a3b phases' launches, the head_dim 640 rows from the
   served deepseek-v2-lite phases' variant counts, the Gemma rows from
   the served gemma-2-9b-it phase's windowed launches (`kernel[window]`),
   the Phi-3 rows from the served Phi-3 phase's launches at head_dim 96
   (`kernel[head_dim=96]`, the longrope runs included); phases 18's,
   19's, 20's and 21's launches (21's worker's counted in its process
   from its registration)
   included in the 8B's rows;
   `ms` and `library_ms` device times,
   `call_ms` and `library_call_ms` call times, as phase 3 measures them;
   `device_kernels`, the device kernels of the row's source that serve
   its head_dim and pool kind (ptxas' names: at head_dim 96 the prefill
   and chunk rows' are prefill_pair_kernel and chunk_pair_kernel); the
   grammar kernel's two rows from phase 14, their launches from its
   served phase, and no library call), the card line, and last the
   {"ok": true, ...} line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine import decode_graphs
from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.engine.tokenizer import ByteTokenizer, get_tokenizer
from dynamo_tpu_torch.lora import apply as lora_apply
from dynamo_tpu_torch.lora import registry as lora_registry
from dynamo_tpu_torch.models import llama, loader, quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca
from dynamo_tpu_torch.ops import cuda_guide
from dynamo_tpu_torch.ops import json_guide
from dynamo_tpu_torch.ops import moe
from dynamo_tpu_torch.serving.api import (ServingContext, make_server,
                                          spec_stats)
from dynamo_tpu_torch.runtime.native import transport_status
from dynamo_tpu_torch.serving.worker import BACKEND_PROFILES, build_parser

MODEL = "llama-3.1-8b-instruct"
H, KV, D, PS = 32, 8, 128, 16
NUM_PAGES, MAX_SEQS, MAX_SEQ_LEN, CHUNK = 1024, 8, 2048, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
TOL = 2e-2
ROW_TOL = 5e-2  # max |error| of an output row over the plain row's RMS
LOGIT_REL_TOL = 5e-2  # relative L2 of full-depth logits, kernels vs plain
Q_SCALE = 2 ** -4  # q scaling of phase 4's forwards (exact in bf16)
# relative L2 of a quantized matmul against the bf16 matmul over its
# dequantized weight (w8a8 adds the per-token activation rounding)
QUANT_REL_L2 = 2e-2
MAX_TOKENS = 32
INT8_W = att.kv_lane_width(KV, D, True)  # 1152 lanes per int8 pool row
# bytes of an int8 row the kernels read: its values and scales (1040 of
# INT8_W; the zero pad is never read)
INT8_ROW_BYTES = KV * D + 2 * KV
SPEC_K = 4  # drafts per verify window: windows of K + 1 = 5 queries
DRAFT_MODEL = "llama-3.2-1b-instruct"  # head_dim 64, the 8B's vocabulary
DRAFT_D = 64
NEAR_TIE = 0.05  # top-2 gap under which a first difference is a near-tie
SELF_DRAFT_ACCEPT = 0.5  # accepted / drafted tokens of the self-draft
# the grammar kernel's bound: integer operations of one byte's transition
# on the taken path of json_mask.cu's switch (compares of the mode and the
# byte's classes, the selects, the DEAD test and the loop): an estimate
# from the source, not counted from the kernel's SASS; and the card's rate
# for them: the data sheet's 67 TFLOP/s float32 outside the tensor cores
# is 128 float32 lanes an SM with an FMA counted as two, and an SM has 64
# INT32 lanes, so 67e12 / 4 integer lane operations a second
JSON_OPS_PER_BYTE = 12
INT32_OPS_PER_S = 67e12 / 4
LORA_SLOTS, LORA_RANK = 4, 16
LORA_SCALE = 0.08  # random adapters' sigma: a delta near half of q's size
SOURCES = {
    "decode": ("dynamo_tpu_torch/csrc/decode.cu",
               "dynamo_tpu/ops/pallas_attention.py:181 (_decode_kernel)"),
    "prefill": ("dynamo_tpu_torch/csrc/prefill.cu",
                "dynamo_tpu/ops/pallas_attention.py:421 (_prefill_kernel)"),
    "chunk": ("dynamo_tpu_torch/csrc/chunk.cu",
              "dynamo_tpu/ops/pallas_attention.py:554 (_chunk_kernel)"),
    "ragged": ("dynamo_tpu_torch/csrc/ragged.cu",
               "dynamo_tpu/ops/ragged_attention.py:73 (_ragged_kernel)"),
    "decode_int8": ("dynamo_tpu_torch/csrc/decode.cu",
                    "dynamo_tpu/ops/pallas_attention.py:181 (_decode_kernel,"
                    " int8 pools)"),
    "chunk_int8": ("dynamo_tpu_torch/csrc/chunk.cu",
                   "dynamo_tpu/ops/pallas_attention.py:554 (_chunk_kernel,"
                   " int8 pools)"),
    "ragged_int8": ("dynamo_tpu_torch/csrc/ragged.cu",
                    "dynamo_tpu/ops/ragged_attention.py:73 (_ragged_kernel,"
                    " int8 pools)"),
    "ragged_verify": ("dynamo_tpu_torch/csrc/ragged.cu",
                      "dynamo_tpu/ops/ragged_attention.py:73 (_ragged_kernel,"
                      " verify windows decode_q=5 beside a chunk)"),
    "ragged_verify_only": ("dynamo_tpu_torch/csrc/ragged.cu",
                           "dynamo_tpu/ops/ragged_attention.py:73 "
                           "(_ragged_kernel, verify windows decode_q=5, no "
                           "chunk)"),
    "ragged_int8_verify": ("dynamo_tpu_torch/csrc/ragged.cu",
                           "dynamo_tpu/ops/ragged_attention.py:73 "
                           "(_ragged_kernel, int8 pools, verify windows "
                           "decode_q=5 beside a chunk)"),
    "ragged_int8_verify_only": ("dynamo_tpu_torch/csrc/ragged.cu",
                                "dynamo_tpu/ops/ragged_attention.py:73 "
                                "(_ragged_kernel, int8 pools, verify windows "
                                "decode_q=5, no chunk)"),
    "decode_hd64": ("dynamo_tpu_torch/csrc/decode.cu",
                    "dynamo_tpu/ops/pallas_attention.py:181 (_decode_kernel,"
                    " head_dim 64: the draft model's B=1 step)"),
    "json_mask": ("dynamo_tpu_torch/csrc/json_mask.cu",
                  "no TPU kernel: json_guide.token_mask inside the jitted "
                  "decode window, dynamo_tpu/engine/engine.py:841"),
    "json_advance": ("dynamo_tpu_torch/csrc/json_mask.cu",
                     "no TPU kernel: json_guide.fold_bytes of the sampled "
                     "token in the window, dynamo_tpu/engine/engine.py:861"),
}
# the kernels line's rows that count one variant of a kernel's launches
# (cuda_attention.VARIANT_LAUNCHES)
VARIANTS = {
    "ragged_verify": f"ragged[decode_q={SPEC_K + 1},chunk]",
    "ragged_verify_only": f"ragged[decode_q={SPEC_K + 1},no_chunk]",
    "ragged_int8_verify": f"ragged_int8[decode_q={SPEC_K + 1},chunk]",
    "ragged_int8_verify_only":
        f"ragged_int8[decode_q={SPEC_K + 1},no_chunk]",
    "decode_hd64": f"decode[head_dim={DRAFT_D}]",
}
CLASSIC = ("decode", "prefill", "chunk")


_T0 = time.monotonic()
# a run that has not ended by then dumps every thread's stack to stderr and
# exits 1 (as it does on SIGTERM): a run stopped from outside at its time
# limit would not say where it was
WATCHDOG_S = 1170


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    # progress on stderr: the phase and the seconds since the start
    tag = obj.get("phase", "kernels" if "kernels" in obj else "")
    print(f"chip_smoke: {time.monotonic() - _T0:.1f} s {tag} "
          f"{obj.get('engine', obj.get('model', ''))}".rstrip(),
          file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, batches: int = 5) -> float:
    """Median over `batches` timed batches of `iters` calls each (CUDA
    events) of the time per call."""
    fn()  # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


SLEEP_CYCLES = 100_000_000  # ~50 ms of the card's clock


def device_ms(fn, iters: int, batches: int = 3) -> float:
    """Median over `batches` batches of `iters` calls each of the device
    time per call: the calls are queued behind a sleep kernel, so that the
    card runs them back to back once it wakes, and CUDA events time them
    from there, without the host's launch overhead between them. Raises if
    queueing a batch outlasted the sleep. (torch.profiler would give the
    same, but leaves the host slower at launching kernels afterwards,
    which phase 5 would feel.)"""
    fn()  # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        wake = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        wake.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        queued_ms = (time.monotonic() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued_ms >= wake.elapsed_time(start):
            raise AssertionError(f"queueing {iters} calls took {queued_ms} "
                                 f"ms, longer than the sleep before them")
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_label(mangled: str) -> str:
    """`name<head_dim, policy>` (what it has of them) of a kernel from its
    mangled dtt:: name."""
    n = re.match(r"_ZN3dtt(?:4json)?(\d+)", mangled)
    fn = mangled[n.end():n.end() + int(n.group(1))] if n else mangled
    args = re.findall(r"ILi(\d+)E", mangled)  # head_dim, if any
    args += [p for p in ("Bf16Tiles", "Int8Tiles") if p in mangled]
    # the decode blocks' tile: attend_narrow (16 rows) or attend_mma
    args += [t for p, t in (("Lb1E", "narrow"), ("Lb0E", "wide"))
             if p in mangled]
    # the grammar kernel's logits type
    args += [t for p, t in (("I13__nv_bfloat16E", "bf16"),
                            ("IfE", "float")) if p in mangled]
    return fn + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(log: str) -> dict:
    """{source file: {kernel: {"registers", "spill_stores", "spill_loads"}}}
    from the `nvcc -Xptxas -v` output of the build, kernels named by
    kernel_label."""
    usage, src, fn = {}, None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src, fn = ln[3:].strip(), None
            usage[src] = {}
            continue
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m and src:
            fn = kernel_label(m.group(1))
            usage[src][fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            usage[src][fn].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            usage[src][fn]["registers"] = int(m.group(1))
    return usage


# the pair tile's kernels (prefill.cu and chunk.cu below head_dim 640),
# whose S and P V must run on wgmma (HGMMA in their SASS, no HMMA)
PAIR_KERNELS = ("chunk_pair_kernel", "prefill_pair_kernel")


def sass_mma(lib_path: str) -> dict:
    """{kernel: {"hgmma": n, "hmma": n}}: the wgmma (HGMMA) and mma.sync
    (HMMA) instructions in each kernel's SASS in the built library
    (`cuobjdump -sass`), kernels named by kernel_label."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            fn = kernel_label(m.group(1))
            counts[fn] = {"hgmma": 0, "hmma": 0}
        elif fn and re.search(r"\bHGMMA\.", ln):
            counts[fn]["hgmma"] += 1
        elif fn and re.search(r"\bHMMA\.", ln):
            counts[fn]["hmma"] += 1
    return counts


def pair_tile_build(lib_path: str) -> dict:
    """The build line's record of the pair tile's kernels: ptxas registers
    and spills, and HGMMA / HMMA counts of their SASS; raises unless
    every one of them holds HGMMA and no HMMA."""
    usage = {k: v for src in ptxas_usage(ca.build_log).values()
             for k, v in src.items() if k.startswith(PAIR_KERNELS)}
    mma = {k: v for k, v in sass_mma(lib_path).items()
           if k.startswith(PAIR_KERNELS)}
    if not mma or any(v["hgmma"] == 0 or v["hmma"] for v in mma.values()):
        raise AssertionError(f"the pair tile's kernels must run on wgmma "
                             f"alone: {mma}")
    return {k: {**usage.get(k, {}), **mma[k]} for k in sorted(mma)}


def kernel_usage(name: str, head_dim: int = D) -> dict:
    """ptxas registers and spills of the device kernels behind entry point
    `name` (a row of phase 3, `decode_int8[head_dim=256]` for one of the
    families' shapes) at `head_dim`: its source's kernels for its pool
    kind, and any kernel there that takes no pool policy."""
    base = name.split("[")[0].split("_")[0]
    src = SOURCES[base][0].rsplit("/", 1)[-1]
    pool = "Int8" if "int8" in name else "Bf16"

    def wanted(label: str) -> bool:
        args = label[label.index("<") + 1:-1].split(", ") if "<" in label else []
        # the latent tile's kernels serve head_dim 640 only, and chunk.cu's
        # and prefill.cu's latent tiles only their own entry points
        own = label.startswith(("chunk_latent_kernel",
                                "prefill_latent_kernel"))
        return (all(a == str(head_dim) for a in args if a.isdigit())
                and all(a.startswith(pool) for a in args
                        if not a.isdigit() and a not in ("narrow", "wide"))
                and ("latent" not in label or head_dim == ca.LATENT_DIM)
                and (not own or base in ("chunk", "prefill")))

    usage = ptxas_usage(ca.build_log)
    got = {k: v for k, v in usage.get(src, {}).items() if wanted(k)}
    if base == "ragged" and ca.pair_tile_takes(head_dim):
        # its chunk rows run chunk.cu's pair tile
        got.update({k: v for k, v in usage.get("chunk.cu", {}).items()
                    if k.startswith("chunk_pair_kernel") and wanted(k)})
    return got


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": int(nbytes), "flops": int(flops),
            "bytes_ms": t_bytes, "flops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


SDPA_BACKEND = {"last": None}  # the backend the last sdpa call took


def sdpa(q, k, v, mask) -> torch.Tensor:
    """One library attention call over dense [N, H, Q|S, D] tensors; the
    backend PyTorch's dispatcher picks for them (its flash kernel stops at
    head_dim 256) is kept in SDPA_BACKEND."""
    try:
        choice = torch._fused_sdp_choice(q, k, v, mask)
        SDPA_BACKEND["last"] = torch.nn.attention.SDPBackend(choice).name
    except (AttributeError, RuntimeError, ValueError) as e:
        SDPA_BACKEND["last"] = f"unknown ({type(e).__name__})"
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def disagreement(out: torch.Tensor, ref: torch.Tensor):
    """(max_abs_err, max_row_rel_err, ok) of a kernel's output against its
    plain version's. ok: finite, allclose within atol=rtol=TOL, and every
    output row (the last dim, one head of one query) off by at most ROW_TOL
    times the plain row's RMS; a row the plain version leaves at zero must
    be exact zeros. The per-row bound catches a slip on rows whose values
    are small next to TOL, as a long context's averages are."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_err = err.amax(-1)
    rms = ref.pow(2).mean(-1).sqrt()
    rel = torch.where(rms > 0, row_err / rms.clamp_min(1e-30),
                      torch.where(row_err > 0, float("inf"), 0.0))
    max_rel = float(rel.max())
    ok = (bool(torch.isfinite(out).all())
          and torch.allclose(out, ref, atol=TOL, rtol=TOL)
          and max_rel <= ROW_TOL)
    return float(err.max()), max_rel, ok


def check(name, kernel, plain, library, cost, shapes, extra=None,
          head_dim: int = D, library_backend: str = None) -> dict:
    """Kernel vs plain on the same inputs; raises on disagreement. A row
    whose library call could not be made (library None) says why in
    `library_backend` and has no library times."""
    out_k = kernel()
    out_p = plain()
    torch.cuda.synchronize()
    max_abs, max_rel, ok = disagreement(out_k, out_p)
    lib = library is not None
    row = {"name": name, "shapes": shapes, "max_abs_err": max_abs,
           "max_row_rel_err": max_rel,
           "tolerance": f"atol=rtol={TOL}, row max/RMS <= {ROW_TOL}",
           "kernel_ms": device_ms(kernel, 20), "plain_ms": device_ms(plain, 3),
           "library_ms": device_ms(library, 20) if lib else None,
           "library_backend": library_backend or SDPA_BACKEND["last"],
           "kernel_call_ms": time_ms(kernel, 20),
           "library_call_ms": time_ms(library, 20) if lib else None,
           **cost,
           "ptxas": kernel_usage(name, head_dim), **(extra or {})}
    emit({"kernel_check": row})
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version: max_abs_err {max_abs}, max row "
                             f"error / RMS {max_rel}")
    return row


def visible(qpos: int, kv_len: int, window: int = 0) -> int:
    """Keys a query at qpos sees: tok <= qpos, tok < kv_len and, under a
    sliding window, qpos - window < tok."""
    lo = max(0, qpos - window + 1) if window else 0
    return max(min(qpos + 1, kv_len) - lo, 0)


def paged_cost(q_numel: int, rows, row_bytes: int, desc_ints: int,
               head_dim: int = D, heads: int = H, window: int = 0) -> dict:
    """The bound of a paged-attention call from what its inputs need: q
    read and the output written once (bf16), each distinct K and V row
    below some query's horizon (and, under a sliding window, inside some
    query's window) read once (`row_bytes` each: 2 * KV * D in bf16,
    KV * D values and 2 * KV scale bytes in int8), one int32 page id per
    page walked and `desc_ints` int32 descriptors; 4 * H * D FLOPs per
    visible (query, key) pair. rows: (page ids [W] on the CPU, first query
    position, queries, kv_len) per sequence."""
    ids, walked, pairs = [], 0, 0
    for pages, q_start, n_q, kv_len in rows:
        horizon = max(min(q_start + n_q, kv_len), 0)
        lo = min(max(0, q_start - window + 1) if window else 0, horizon)
        tok = torch.arange(lo, horizon)
        ids.append(pages[tok // PS].long() * PS + tok % PS)
        walked += -(-horizon // PS) - lo // PS
        pairs += sum(visible(q_start + j, kv_len, window)
                     for j in range(n_q))
    kv_rows = int(torch.unique(torch.cat(ids)).numel())
    return bound(2 * 2 * q_numel + 2 * kv_rows * row_bytes
                 + 4 * (walked + desc_ints), 4 * pairs * heads * head_dim)


def paged_library(q, kp, vp, tables, q_starts, kv_lens):
    """scaled_dot_product_attention over paged K/V gathered dense: q
    [N, Q, H, D], bf16 pools [P, ps, KV*D], tables [N, W]; query j of row
    n sees key tok iff tok <= q_starts[n] + j and tok < kv_lens[n] (keys
    past the longest kv_len are not gathered). The gather is not timed."""
    n, nq, h, d = q.shape
    kv = kp.shape[-1] // d
    s = int(kv_lens.max())
    kd = kp[tables.long()].reshape(n, -1, kv, d)[:, :s].permute(0, 2, 1, 3)
    vd = vp[tables.long()].reshape(n, -1, kv, d)[:, :s].permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(h // kv, 1).contiguous()
    vd = vd.repeat_interleave(h // kv, 1).contiguous()
    tok = torch.arange(s, device=q.device)
    qpos = q_starts[:, None] + torch.arange(nq, device=q.device)[None]
    mask = ((tok[None, None] <= qpos[:, :, None])
            & (tok[None, None] < kv_lens[:, None, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: sdpa(qt, kd, vd, mask)


def dequantized(pool: torch.Tensor, kv: int = KV, d: int = D
                ) -> torch.Tensor:
    """An int8 packed pool as a bf16 [P, ps, KV*D] pool."""
    return att.unpack_kv_rows(pool, kv, d).reshape(
        *pool.shape[:2], kv * d).to(torch.bfloat16)


def kernel_checks(dev) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = {}
    kp, vp = rnd(NUM_PAGES, PS, KV * D), rnd(NUM_PAGES, PS, KV * D)
    # int8 pools packed from the same values
    kp8 = att.pack_kv_rows(kp.reshape(-1, KV, D), INT8_W).reshape(
        NUM_PAGES, PS, INT8_W)
    vp8 = att.pack_kv_rows(vp.reshape(-1, KV, D), INT8_W).reshape(
        NUM_PAGES, PS, INT8_W)
    kq, vq = dequantized(kp8), dequantized(vp8)
    pools = {"": (kp, vp, kp, vp, 2 * KV * D, None),
             "_int8": (kp8, vp8, kq, vq, INT8_ROW_BYTES, KV)}

    perm = torch.randperm(NUM_PAGES - 1,
                          generator=torch.Generator().manual_seed(1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def decode_table(contexts, width):
        """A [MAX_SEQS, width] block table giving each sequence distinct
        pages, trash-padded."""
        table = torch.zeros((MAX_SEQS, width), dtype=torch.int32)
        used = 0
        for b, c in enumerate(contexts):
            n = -(-c // PS)
            table[b, :n] = perm[used:used + n] + 1
            used += n
        return table

    def check_decode(name, table, ctx, k, v, kl, vl, row_bytes, n_kv):
        table_d, ctx_d = table.to(dev), ctx.to(dev)
        return check(
            name,
            lambda: ca.paged_attention_decode(q, k, v, table_d, ctx_d,
                                              page_size=PS,
                                              num_kv_heads=n_kv),
            lambda: att.paged_attention_decode_ref(q, k, v, table_d, ctx_d,
                                                   page_size=PS,
                                                   num_kv_heads=n_kv),
            paged_library(q[:, None], kl, vl, table_d, ctx_d - 1, ctx_d),
            paged_cost(q.numel(), [(table[b], c - 1, 1, c) for b, c in
                                   enumerate(ctx.tolist())], row_bytes,
                       MAX_SEQS),
            {"q": [MAX_SEQS, H, D], "pools": list(k.shape),
             "block_table": list(table.shape), "context_lens": ctx.tolist(),
             "split_keys": ca.split_keys(table.shape[1], PS, MAX_SEQS, KV,
                                         sms)})

    # decode: the engine's batch of 8 slots, ragged contexts incl. ctx 0,
    # on its 128-page tables (8 spans of 256 keys)
    pmax = MAX_SEQ_LEN // PS
    ctx = torch.tensor([0, 1, 17, 100, 255, 600, 1024, 2048],
                       dtype=torch.int32)
    table = decode_table(ctx.tolist(), pmax)  # 256 of the 1023 pages
    table_d, ctx_d = table.to(dev), ctx.to(dev)
    q = rnd(MAX_SEQS, H, D)
    for sfx, (k, v, kl, vl, row_bytes, n_kv) in pools.items():
        rows["decode" + sfx] = check_decode("decode" + sfx, table, ctx, k, v,
                                            kl, vl, row_bytes, n_kv)
    # a 512-page table with one row at 8192 tokens: 8 spans of 1024 keys
    # (bf16 pools)
    ctx_l = torch.tensor([0, 1, 100, 255, 600, 1024, 2048, 8192],
                         dtype=torch.int32)
    rows["decode_long"] = check_decode(
        "decode_long", decode_table(ctx_l.tolist(), 512), ctx_l,
        *pools[""])  # 766 of the 1023 pages
    span = rows["decode_long"]["shapes"]["split_keys"]
    if span <= ca.SPLIT_KEYS:
        raise AssertionError(f"decode_long: the spans did not widen past "
                             f"{ca.SPLIT_KEYS} keys: {span}")

    # prefill: a batch of same-bucket prompts, one below its bucket
    n, s = 4, 256
    lens = torch.tensor([256, 200, 37, 1], dtype=torch.int32)
    qp, kk, vv = rnd(n, s, H, D), rnd(n, s, KV, D), rnd(n, s, KV, D)
    lens_d = lens.to(dev)
    i = torch.arange(s, device=dev)
    pmask = ((i[None, :] <= i[:, None])[None]
             & (i[None, None, :] < lens_d[:, None, None]))[:, None]
    qt = qp.transpose(1, 2).contiguous()
    kt = kk.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    vt = vv.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    pairs = sum(min(r + 1, int(L)) for L in lens.tolist() for r in range(s))
    # lane 0 (seq_len = S) through chunk.cu at start 0 over the same K/V
    # written to pages 1 .. S / PS: the same tile, bit-identical
    pk = torch.zeros((s // PS + 1, PS, KV * D), dtype=torch.bfloat16,
                     device=dev)
    pv = torch.zeros_like(pk)
    pk[1:] = kk[0].reshape(s // PS, PS, KV * D)
    pv[1:] = vv[0].reshape(s // PS, PS, KV * D)
    lane0 = ca.chunk_prefill_attention(
        qp[0], pk, pv, torch.arange(1, s // PS + 1, dtype=torch.int32,
                                    device=dev), 0, page_size=PS)
    lane0_equal = torch.equal(ca.prefill_attention(qp, kk, vv, lens_d)[0],
                              lane0)
    # q read and out written in full (padded rows are part of the output);
    # K/V only below seq_len, the rows the mask lets any query see
    rows["prefill"] = check(
        "prefill",
        lambda: ca.prefill_attention(qp, kk, vv, lens_d),
        lambda: att.prefill_attention_ref(qp, kk, vv, lens_d),
        lambda: sdpa(qt, kt, vt, pmask),
        bound(2 * 2 * qp.numel() + 2 * int(lens.sum()) * KV * D * 2 + 4 * n,
              4 * pairs * H * D),
        {"q": [n, s, H, D], "kv": [n, s, KV, D], "seq_lens": lens.tolist()},
        {"lane0_equals_chunk_cu": lane0_equal})
    if not lane0_equal:
        raise AssertionError("prefill: a lane at seq_len = S differs from "
                             "chunk.cu's chunk at start 0")

    # chunk: the third 256-token chunk of a 600-token prompt (start 512) on
    # its trash-padded page list (the trash tail repeats page 0)
    start, c = 512, CHUNK
    width = 1024 // PS + CHUNK // PS - 1
    pages = torch.zeros((width,), dtype=torch.int32)
    pages[:-(-600 // PS)] = perm[:-(-600 // PS)] + 1
    pages_d = pages.to(dev)
    qc = rnd(c, H, D)
    start_d = torch.tensor([start], device=dev)
    for sfx, (k, v, kl, vl, row_bytes, n_kv) in pools.items():
        rows["chunk" + sfx] = check(
            "chunk" + sfx,
            lambda: ca.chunk_prefill_attention(qc, k, v, pages_d, start,
                                               page_size=PS,
                                               num_kv_heads=n_kv),
            lambda: att.chunk_attention_ref(qc, k, v, pages_d, start,
                                            page_size=PS, num_kv_heads=n_kv),
            paged_library(qc[None], kl, vl, pages_d[None], start_d,
                          start_d + c),
            paged_cost(qc.numel(), [(pages, start, c, start + c)], row_bytes,
                       0),
            {"q": [c, H, D], "start": start, "pages": width,
             "pools": list(k.shape)})

    # the last 256-token chunk of a 2048-token prompt: how the tile scales
    # with the prefix (bf16 pools)
    start_l = MAX_SEQ_LEN - CHUNK
    width_l = MAX_SEQ_LEN // PS + CHUNK // PS - 1
    pages_l = torch.zeros((width_l,), dtype=torch.int32)
    pages_l[:MAX_SEQ_LEN // PS] = perm[:MAX_SEQ_LEN // PS] + 1
    pages_ld = pages_l.to(dev)
    start_ld = torch.tensor([start_l], device=dev)
    rows[f"chunk_start{start_l}"] = check(
        f"chunk_start{start_l}",
        lambda: ca.chunk_prefill_attention(qc, kp, vp, pages_ld, start_l,
                                           page_size=PS),
        lambda: att.chunk_attention_ref(qc, kp, vp, pages_ld, start_l,
                                        page_size=PS),
        paged_library(qc[None], kp, vp, pages_ld[None], start_ld,
                      start_ld + c),
        paged_cost(qc.numel(), [(pages_l, start_l, c, start_l + c)],
                   2 * KV * D, 0),
        {"q": [c, H, D], "start": start_l, "pages": width_l,
         "pools": list(kp.shape)})

    # ragged: the mixed step's shapes, 8 decode rows (slot 0 inactive: a
    # zero table row at context 1) beside the chunk above, descriptors
    # built as the engine builds them; decode rows of K+1 = 5 queries as
    # well (the mixed verify step's windows)
    rctx = torch.tensor([1, 1, 17, 100, 255, 600, 1024, 2048],
                        dtype=torch.int32)
    rctx_d = rctx.to(dev)  # row 0 (context 0 above) has no pages
    desc = att.ragged_descriptors(table_d, rctx_d, pages_d,
                                  start, c)
    cpu_desc = [t.cpu() for t in desc]
    for decode_q in (1, SPEC_K + 1):
        qr = rnd(MAX_SEQS * decode_q + c, H, D)
        tabs, kv_lens, q_starts = desc
        if decode_q > 1:  # windows ending at each row's context
            q_starts = torch.clamp(kv_lens - decode_q, min=0)
            q_starts[-1] = start
            kv_lens = torch.maximum(kv_lens, q_starts + decode_q)
            kv_lens[-1] = start + c
        spans = [(cpu_desc[0][r], int(q_starts[r]),
                  decode_q if r < MAX_SEQS else c, int(kv_lens[r]))
                 for r in range(MAX_SEQS + 1)]
        for sfx, (k, v, kl, vl, row_bytes, n_kv) in pools.items():
            name = "ragged" + sfx + ("" if decode_q == 1 else "_verify")
            kw = dict(page_size=PS, num_kv_heads=KV, num_decode=MAX_SEQS,
                      decode_q=decode_q)

            def kernel(k=k, v=v, q_starts=q_starts, kv_lens=kv_lens, kw=kw):
                return ca.ragged_paged_attention(qr, k, v, tabs, kv_lens,
                                                 q_starts, **kw)

            def plain(k=k, v=v, q_starts=q_starts, kv_lens=kv_lens, kw=kw):
                return att.ragged_paged_attention_ref(qr, k, v, tabs,
                                                      kv_lens, q_starts, **kw)

            nd = MAX_SEQS * decode_q
            dec_lib = paged_library(
                qr[:nd].reshape(MAX_SEQS, decode_q, H, D), kl, vl,
                tabs[:MAX_SEQS], q_starts[:MAX_SEQS], kv_lens[:MAX_SEQS])
            chk_lib = paged_library(qr[nd:][None], kl, vl, tabs[-1:],
                                    q_starts[-1:], kv_lens[-1:])
            # the same rows through chunk.cu and decode.cu: the same tile
            # blocks, so bit-identical (decode.cu's under the same split
            # plan: the same table width and row count)
            out = kernel()
            chk = ca.chunk_prefill_attention(
                qr[nd:], k, v, pages_d, start, page_size=PS,
                num_kv_heads=n_kv)
            extra = {"chunk_rows_equal_chunk_cu": torch.equal(out[nd:], chk),
                     "max_abs_diff_vs_chunk_cu":
                         float((out[nd:].float() - chk.float()).abs().max())}
            if decode_q == 1:
                dec = ca.paged_attention_decode(
                    qr[:nd], k, v, table_d, rctx_d,
                    page_size=PS, num_kv_heads=n_kv)
                same_plan = tabs.shape[1] == table_d.shape[1]
                equal = torch.equal(out[:nd], dec)
                extra.update(
                    max_abs_diff_vs_decode_cu=float(
                        (out[:nd].float() - dec.float()).abs().max()),
                    same_split_plan_as_decode_cu=same_plan,
                    decode_rows_equal_decode_cu=equal,
                    decode_rows_agree_with_decode_cu=(
                        equal if same_plan else disagreement(out[:nd],
                                                             dec)[2]))
            rows[name] = check(
                name, kernel, plain, lambda: (dec_lib(), chk_lib()),
                paged_cost(qr.numel(), spans, row_bytes,
                           2 * (MAX_SEQS + 1)),
                {"q": [nd + c, H, D], "num_decode": MAX_SEQS,
                 "decode_q": decode_q, "context_lens": rctx.tolist(),
                 "chunk_start": start, "tables": list(tabs.shape),
                 "pools": list(k.shape)}, extra)
            if not (extra["chunk_rows_equal_chunk_cu"]
                    and extra.get("decode_rows_agree_with_decode_cu", True)):
                raise AssertionError(f"{name}: its rows differ from "
                                     f"chunk.cu's or decode.cu's: {extra}")

    # the verify step: 8 windows of K+1 queries without a chunk (C = 0),
    # each ending at the context above, through verify_attention's
    # descriptors (the chunk row on the trash page at kv_len 0)
    k1 = SPEC_K + 1
    vpos = torch.clamp(rctx - k1, min=0)
    vpos_d = vpos.to(dev)
    qv = rnd(MAX_SEQS, k1, H, D)
    vdesc = att.ragged_verify_descriptors(table_d, vpos_d, k1)
    vspans = [(table[b], int(vpos[b]), k1, int(vpos[b]) + k1)
              for b in range(MAX_SEQS)]
    for sfx, (k, v, kl, vl, row_bytes, n_kv) in pools.items():
        name = "ragged" + sfx + "_verify_only"
        rows[name] = check(
            name,
            lambda k=k, v=v: att.verify_attention(
                qv, k, v, table_d, vpos_d, page_size=PS, num_kv_heads=KV),
            lambda k=k, v=v: att.verify_attention_ref(
                qv, k, v, table_d, vpos_d, page_size=PS, num_kv_heads=KV),
            paged_library(qv, kl, vl, table_d, vpos_d, vpos_d + k1),
            paged_cost(qv.numel(), vspans, row_bytes, 2 * (MAX_SEQS + 1)),
            {"q": [MAX_SEQS, k1, H, D], "num_decode": MAX_SEQS,
             "decode_q": k1, "chunk": 0, "positions": vpos.tolist(),
             "tables": list(vdesc[0].shape), "pools": list(k.shape)})

    # decode at head_dim 64: the draft model's B=1 step (llama-3.2-1b:
    # H=32, KV=8) at a 600-token context on its max_pages_per_seq + 1 =
    # 129-page table, over pools of the 1B's row width
    wd = MAX_SEQ_LEN // PS + 1
    kpd = rnd(256, PS, KV * DRAFT_D)
    vpd = rnd(256, PS, KV * DRAFT_D)
    dctx = torch.tensor([600], dtype=torch.int32)
    dtable = torch.zeros((1, wd), dtype=torch.int32)
    dtable[0, :-(-600 // PS)] = torch.randperm(
        255, generator=torch.Generator().manual_seed(3))[:-(-600 // PS)] + 1
    dtable_d, dctx_d = dtable.to(dev), dctx.to(dev)
    qd = rnd(1, H, DRAFT_D)
    rows["decode_hd64"] = check(
        "decode_hd64",
        lambda: ca.paged_attention_decode(qd, kpd, vpd, dtable_d, dctx_d,
                                          page_size=PS),
        lambda: att.paged_attention_decode_ref(qd, kpd, vpd, dtable_d,
                                               dctx_d, page_size=PS),
        paged_library(qd[:, None], kpd, vpd, dtable_d, dctx_d - 1, dctx_d),
        paged_cost(qd.numel(), [(dtable[0], 599, 1, 600)],
                   2 * KV * DRAFT_D, 1, head_dim=DRAFT_D),
        {"q": [1, H, DRAFT_D], "pools": list(kpd.shape),
         "block_table": list(dtable.shape), "context_lens": [600],
         "split_keys": ca.split_keys(wd, PS, 1, KV, sms)},
        head_dim=DRAFT_D)
    return rows


# Phase 3's rows at the new families' shapes: (label, H, KV, D, rows).
# deepseek-v2-lite's MLA latent row (head_dim 640, one KV head for 16
# query heads: the latent tile), every entry point and pool kind
LATENT_KERNELS = ("decode", "decode_int8", "prefill", "chunk", "chunk_int8",
                  "ragged", "ragged_int8", "ragged_verify",
                  "ragged_verify_only", "ragged_int8_verify",
                  "ragged_int8_verify_only")
# gemma-7b-it (head_dim 256, group 1: every entry point and pool kind),
# gemma-2b-it (head_dim 256, group 8), qwen2.5-7b-instruct (group 7,
# whose verify windows fill 5 x 7 = 35 of the tile's 64 rows) and
# qwen3-30b-a3b (group 8 at head_dim 128: verify windows of 5 x 8 = 40).
FAMILY_SHAPES = (
    ("head_dim=256", 16, 16, 256,
     ("decode", "decode_int8", "prefill", "chunk", "chunk_int8", "ragged",
      "ragged_int8", "ragged_verify", "ragged_verify_only")),
    ("head_dim=256,group=8", 8, 1, 256,
     ("decode", "prefill", "chunk", "ragged", "ragged_verify_only")),
    ("group=7", 28, 4, 128,
     ("decode", "prefill", "chunk", "ragged", "ragged_verify",
      "ragged_verify_only")),
    ("group=8", 32, 4, 128,
     ("decode", "prefill", "chunk", "ragged", "ragged_verify",
      "ragged_verify_only")),
    ("head_dim=640,group=16", 16, 1, 640, LATENT_KERNELS),
)


def shape_kernel_checks(dev, label: str, h: int, kv: int, d: int,
                        names) -> dict:
    """Phase 3 at one family's shape (FAMILY_SHAPES): the 8B's inputs
    (8 decode rows on 128-page tables, 4 prompts of a 256 bucket, the
    256-token chunk at 512, the mixed step's and the verify steps'
    descriptors) at H, KV and D, each row named `kernel[label]`, held
    against its plain version with its bound and library time."""
    g = torch.Generator(device=dev)
    g.manual_seed(10)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    int8_w = att.kv_lane_width(kv, d, True)
    kp, vp = rnd(NUM_PAGES, PS, kv * d), rnd(NUM_PAGES, PS, kv * d)
    kp8, vp8 = (att.pack_kv_rows(x.reshape(-1, kv, d), int8_w).reshape(
        NUM_PAGES, PS, int8_w) for x in (kp, vp))
    pools = {"": (kp, vp, kp, vp, 2 * kv * d),
             "_int8": (kp8, vp8, dequantized(kp8, kv, d),
                       dequantized(vp8, kv, d), kv * d + 2 * kv)}
    perm = torch.randperm(NUM_PAGES - 1,
                          generator=torch.Generator().manual_seed(1))
    rows, shapes = {}, {"H": h, "KV": kv, "D": d}

    def cost(q_numel, spans, row_bytes, desc):
        return paged_cost(q_numel, spans, row_bytes, desc, head_dim=d,
                          heads=h)

    def run(name, kernel, plain, library, bound_row, extra):
        if name in names:
            rows[name] = check(f"{name}[{label}]", kernel, plain, library,
                               bound_row, {**shapes, **extra}, head_dim=d)

    pmax = MAX_SEQ_LEN // PS
    ctx = [0, 1, 17, 100, 255, 600, 1024, 2048]
    table = torch.zeros((MAX_SEQS, pmax), dtype=torch.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // PS)
        table[b, :n] = perm[used:used + n] + 1
        used += n
    table_d = table.to(dev)
    ctx_d = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = rnd(MAX_SEQS, h, d)
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        run("decode" + sfx,
            lambda k=k, v=v: ca.paged_attention_decode(
                q, k, v, table_d, ctx_d, page_size=PS, num_kv_heads=kv),
            lambda k=k, v=v: att.paged_attention_decode_ref(
                q, k, v, table_d, ctx_d, page_size=PS, num_kv_heads=kv),
            paged_library(q[:, None], kl, vl, table_d, ctx_d - 1, ctx_d),
            cost(q.numel(), [(table[b], c - 1, 1, c)
                             for b, c in enumerate(ctx)], row_bytes,
                 MAX_SEQS),
            {"context_lens": ctx, "block_table": list(table.shape),
             **latent_decode_plan(q, pmax, ctx, None, 1, kv)})

    n, s = 4, 256
    lens = torch.tensor([256, 200, 37, 1], dtype=torch.int32, device=dev)
    qp, kk, vv = rnd(n, s, h, d), rnd(n, s, kv, d), rnd(n, s, kv, d)
    if d == ca.LATENT_DIM:
        vv = kk  # MLA's prefill passes the latent rows as K and as V
    run("prefill", lambda: ca.prefill_attention(qp, kk, vv, lens),
        lambda: att.prefill_attention_ref(qp, kk, vv, lens),
        prefill_library(qp, kk, vv, lens), prefill_cost(qp, kk, vv, lens),
        {"q": [n, s, h, d], "seq_lens": lens.tolist(), "k_is_v": vv is kk,
         **latent_prefill_plan(qp, kk, vv, lens, kv)})

    start, c = 512, CHUNK
    width = 1024 // PS + CHUNK // PS - 1
    pages = torch.zeros((width,), dtype=torch.int32)
    pages[:-(-600 // PS)] = perm[:-(-600 // PS)] + 1
    pages_d = pages.to(dev)
    start_d = torch.tensor([start], device=dev)
    qc = rnd(c, h, d)
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        run("chunk" + sfx,
            lambda k=k, v=v: ca.chunk_prefill_attention(
                qc, k, v, pages_d, start, page_size=PS, num_kv_heads=kv),
            lambda k=k, v=v: att.chunk_attention_ref(
                qc, k, v, pages_d, start, page_size=PS, num_kv_heads=kv),
            paged_library(qc[None], kl, vl, pages_d[None], start_d,
                          start_d + c),
            cost(qc.numel(), [(pages, start, c, start + c)], row_bytes, 0),
            {"q": [c, h, d], "start": start,
             **latent_chunk_plan(qc, k, v, pages_d, start, kv, sweep=True)})
    if d == ca.LATENT_DIM and "chunk" in names:
        # the served shapes of the latent chunk tile: the ~88-token tail
        # of the 600-token prompt at 512, a first chunk at 0
        for c2, s2 in ((600 - 512, 512), (CHUNK, 0)):
            q2 = rnd(c2, h, d)
            s2_d = torch.tensor([s2], device=dev)
            for sfx, (k, v, kl, vl, row_bytes) in pools.items():
                name = f"chunk{sfx}[{label},C={c2},start={s2}]"
                rows[name] = check(
                    name,
                    lambda k=k, v=v, q2=q2, s2=s2: ca.chunk_prefill_attention(
                        q2, k, v, pages_d, s2, page_size=PS,
                        num_kv_heads=kv),
                    lambda k=k, v=v, q2=q2, s2=s2: att.chunk_attention_ref(
                        q2, k, v, pages_d, s2, page_size=PS,
                        num_kv_heads=kv),
                    paged_library(q2[None], kl, vl, pages_d[None], s2_d,
                                  s2_d + c2),
                    cost(q2.numel(), [(pages, s2, c2, s2 + c2)], row_bytes,
                         0),
                    {**shapes, "q": [c2, h, d], "start": s2,
                     **latent_chunk_plan(q2, k, v, pages_d, s2, kv)},
                    head_dim=d)

    rctx = torch.tensor([1] + ctx[1:], dtype=torch.int32, device=dev)
    desc = att.ragged_descriptors(table_d, rctx, pages_d, start, c)
    for decode_q in (1, SPEC_K + 1):
        qr = rnd(MAX_SEQS * decode_q + c, h, d)
        tabs, kv_lens, q_starts = desc
        if decode_q > 1:  # windows ending at each row's context
            q_starts = torch.clamp(kv_lens - decode_q, min=0)
            q_starts[-1] = start
            kv_lens = torch.maximum(kv_lens, q_starts + decode_q)
            kv_lens[-1] = start + c
        tabs_h = tabs.cpu()
        spans = [(tabs_h[r], int(q_starts[r]),
                  decode_q if r < MAX_SEQS else c, int(kv_lens[r]))
                 for r in range(MAX_SEQS + 1)]
        nd = MAX_SEQS * decode_q
        plan = latent_decode_plan(qr, tabs.shape[1],
                                  kv_lens[:MAX_SEQS].tolist(),
                                  q_starts[:MAX_SEQS].tolist(), decode_q, kv)
        for sfx, (k, v, kl, vl, row_bytes) in pools.items():
            kw = dict(page_size=PS, num_kv_heads=kv, num_decode=MAX_SEQS,
                      decode_q=decode_q)
            same = latent_identities(
                lambda k=k, v=v, q_starts=q_starts, kv_lens=kv_lens, kw=kw:
                    ca.ragged_paged_attention(qr, k, v, tabs, kv_lens,
                                              q_starts, **kw),
                lambda k=k, v=v: ca.chunk_prefill_attention(
                    qr[nd:], k, v, pages_d, start, page_size=PS,
                    num_kv_heads=kv),
                (lambda k=k, v=v: ca.paged_attention_decode(
                    qr[:nd], k, v, table_d, rctx, page_size=PS,
                    num_kv_heads=kv)) if decode_q == 1 else None,
                nd, d)
            dec_lib = paged_library(
                qr[:nd].reshape(MAX_SEQS, decode_q, h, d), kl, vl,
                tabs[:MAX_SEQS], q_starts[:MAX_SEQS], kv_lens[:MAX_SEQS])
            chk_lib = paged_library(qr[nd:][None], kl, vl, tabs[-1:],
                                    q_starts[-1:], kv_lens[-1:])
            run("ragged" + sfx + ("" if decode_q == 1 else "_verify"),
                lambda k=k, v=v, q_starts=q_starts, kv_lens=kv_lens, kw=kw:
                    ca.ragged_paged_attention(qr, k, v, tabs, kv_lens,
                                              q_starts, **kw),
                lambda k=k, v=v, q_starts=q_starts, kv_lens=kv_lens, kw=kw:
                    att.ragged_paged_attention_ref(qr, k, v, tabs, kv_lens,
                                                   q_starts, **kw),
                lambda dec_lib=dec_lib, chk_lib=chk_lib: (dec_lib(),
                                                          chk_lib()),
                cost(qr.numel(), spans, row_bytes, 2 * (MAX_SEQS + 1)),
                {"num_decode": MAX_SEQS, "decode_q": decode_q,
                 "chunk_start": start, **plan, **same})

    k1 = SPEC_K + 1
    vpos = torch.clamp(rctx - k1, min=0)
    qv = rnd(MAX_SEQS, k1, h, d)
    vspans = [(table[b], int(vpos[b]), k1, int(vpos[b]) + k1)
              for b in range(MAX_SEQS)]
    vplan = latent_decode_plan(qv.reshape(-1, h, d), pmax,
                               (vpos + k1).tolist(), vpos.tolist(), k1, kv)
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        run("ragged" + sfx + "_verify_only",
            lambda k=k, v=v: att.verify_attention(
                qv, k, v, table_d, vpos, page_size=PS, num_kv_heads=kv),
            lambda k=k, v=v: att.verify_attention_ref(
                qv, k, v, table_d, vpos, page_size=PS, num_kv_heads=kv),
            paged_library(qv, kl, vl, table_d, vpos, vpos + k1),
            cost(qv.numel(), vspans, row_bytes, 2 * (MAX_SEQS + 1)),
            {"num_decode": MAX_SEQS, "decode_q": k1, "chunk": 0, **vplan})

    if d == ca.LATENT_DIM and "prefill" in names:
        # the served one-lane prefills of deepseek-v2-lite: the 128 bucket
        # of phase 13's ~100-token prompts, and a full 256-token bucket
        for s2, len2 in ((128, 100), (256, 256)):
            q2, k2 = rnd(1, s2, h, d), rnd(1, s2, kv, d)
            l2 = torch.tensor([len2], dtype=torch.int32, device=dev)
            name = f"prefill[{label},S={s2},lens={len2}]"
            rows[name] = check(
                name,
                lambda q2=q2, k2=k2, l2=l2: ca.prefill_attention(q2, k2, k2,
                                                                 l2),
                lambda q2=q2, k2=k2, l2=l2: att.prefill_attention_ref(
                    q2, k2, k2, l2),
                prefill_library(q2, k2, k2, l2),
                prefill_cost(q2, k2, k2, l2),
                {**shapes, "q": [1, s2, h, d], "seq_lens": [len2],
                 "k_is_v": True,
                 **latent_prefill_plan(q2, k2, k2, l2, kv)},
                head_dim=d)
    return rows


def prefill_library(q, k, v, lens):
    """scaled_dot_product_attention over the prefill's q [N, S, H, D] and
    k/v [N, S, KV, D] (K/V repeated to every head; not timed) with its
    causal and seq_len mask."""
    n, s, h, _ = q.shape
    kv = k.shape[2]
    i = torch.arange(s, device=q.device)
    mask = ((i[None, :] <= i[:, None])[None]
            & (i[None, None, :] < lens[:, None, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kv, 2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kv, 2).transpose(1, 2).contiguous()
    return lambda: sdpa(qt, kt, vt, mask)


def prefill_cost(q, k, v, lens, window: int = 0) -> dict:
    """The bound of a prefill call: q read and the output written in full
    (padding rows are part of the output), K and V rows only below
    seq_len (once where K is V: one tensor), the seq_lens; 4 * H * D
    FLOPs per visible (query, key) pair (under a sliding window, the
    keys inside it)."""
    n, s, h, d = q.shape
    kv = k.shape[2]
    pairs = sum(visible(r, int(L), window) for L in lens.tolist()
                for r in range(s))
    kv_tensors = 1 if v is k else 2
    return bound(2 * 2 * q.numel()
                 + kv_tensors * int(lens.sum()) * kv * d * 2 + 4 * n,
                 4 * pairs * h * d)


def latent_prefill_plan(q, k, v, lens, n_kv: int) -> dict:
    """At head_dim 640, prefill.cu's launch: its spans a query tile, its
    blocks (and those with keys to walk), its longest span, the merge's
    own time per block (the global timer at the end of a block's key walk
    and at its exit, mean and max, µs; with one span, the time to write
    its rows), the launch's span from the first walk's end to the last
    exit; whether two launches give equal bits and,
    for one lane at seq_len = S, whether it equals chunk.cu's chunk at
    start 0 over the same K/V in pages (raises if either differs); and
    the device ms of every span count from 1 to MAX_CHUNK_SPANS (the
    evidence for latent_prefill_spans' rule). {} below 640, or
    where the package beside the script has no such plan (an older
    tree)."""
    n, s, h, d = q.shape
    if d != ca.LATENT_DIM or not hasattr(ca, "latent_prefill_spans"):
        return {}
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    lens_h = lens.tolist()
    tiles = ca.prefill_span_keys(s, lens_h, h // n_kv, n_kv, sms)
    keys = [hi - lo for *_, spans in tiles for lo, hi in spans]
    clocks = torch.zeros((2 * len(keys) * n_kv,), dtype=torch.int64,
                         device=q.device)
    a = ca.prefill_attention(q, k, v, lens, clocks=clocks)
    got = {"two_launches_equal":
               torch.equal(ca.prefill_attention(q, k, v, lens), a)}
    if n == 1 and lens_h[0] == s and s % PS == 0:
        pk = torch.zeros((s // PS + 1, PS, n_kv * d), dtype=torch.bfloat16,
                         device=q.device)
        pv = torch.zeros_like(pk)
        pk[1:] = k[0].reshape(s // PS, PS, n_kv * d)
        pv[1:] = v[0].reshape(s // PS, PS, n_kv * d)
        pages = torch.arange(1, s // PS + 1, dtype=torch.int32,
                             device=q.device)
        got["lane_equals_chunk_cu"] = torch.equal(
            a[0], ca.chunk_prefill_attention(q[0], pk, pv, pages, 0,
                                             page_size=PS,
                                             num_kv_heads=n_kv))
    torch.cuda.synchronize()
    if not all(got.values()):
        raise AssertionError(f"prefill at S={s}, lens={lens_h}: {got}")
    stamps = clocks.reshape(-1, 2).double()
    merge_us = (stamps[:, 1] - stamps[:, 0]) / 1e3
    by_spans = {}
    for sp in range(1, ca.MAX_CHUNK_SPANS + 1):
        def call(sp=sp):
            return ca.prefill_attention(q, k, v, lens, spans=sp)
        by_spans[sp] = {"ms": device_ms(call, 20),
                        "blocks": sp * len(tiles) * n_kv,
                        "equals_plan": torch.equal(call(), a)}
    return {"latent_prefill": {
        "spans": ca.latent_prefill_spans(n, s, h // n_kv, n_kv, sms),
        "blocks": len(keys) * n_kv,
        "blocks_with_keys": sum(1 for x in keys if x > 0) * n_kv,
        "longest_span_keys": max(keys), "sms": sms,
        "merge_us_mean": float(merge_us.mean()),
        "merge_us_max": float(merge_us.max()),
        "walk_end_to_exit_ms": float(stamps[:, 1].max()
                                     - stamps[:, 0].min()) / 1e6,
        **got, "ms_by_spans": by_spans}}


def latent_decode_plan(q, width: int, kv_lens, q_starts, decode_q: int,
                       n_kv: int) -> dict:
    """At head_dim 640, the launch of the latent decode rows (decode.cu,
    ragged.cu's decode and verify rows) of q [rows * decode_q (+ C), H, D]
    over tables of `width` pages, from the descriptors (q_starts None:
    decode.cu): its spans a row on average, its blocks and those with keys
    to walk, the longest span, each row's span count, and the merge's own
    device time (merge_latent_kernel alone,
    `dtt_latent_merge`, over partials in the launch's layout with every
    span seen, µs). {} below 640, or where the package beside the script
    has no such plan (an older tree)."""
    h, d = q.shape[-2], q.shape[-1]
    if d != ca.LATENT_DIM or not hasattr(ca, "latent_decode_blocks"):
        return {}
    group, rows = h // n_kv, len(kv_lens)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n = ca.latent_decode_spans(width, PS, rows, decode_q, group, n_kv, sms)
    blocks = ca.latent_decode_blocks(width, PS, kv_lens, q_starts, decode_q,
                                     group, n_kv, sms)
    keys = [hi - lo for *_, lo, hi in blocks]
    q_tiles = -(-decode_q // ca.tile_positions(group, d))
    out = {"spans_per_row": n, "blocks": n * rows * q_tiles * n_kv,
           "blocks_with_keys": sum(1 for x in keys if x > 0) * n_kv,
           "longest_span_keys": max(keys), "sms": sms,
           "spans_by_row": [b[2] for b in blocks
                            if b[1] == 0 and b[3] == 0],
           "query_tiles_per_row": q_tiles}
    if n == 1:
        out["merge_us"] = "no merge: one span a row writes the rows"
        return {"latent_decode": out}
    n_rows = ca.latent_scratch_rows(rows, decode_q, group, n_kv, n)
    g = torch.Generator(device=q.device)
    g.manual_seed(5)
    part_o = torch.randn((n_rows, d), generator=g, device=q.device)
    part_ml = torch.zeros((n_rows, 2), device=q.device)
    part_ml[:, 1] = 1.0
    merged = torch.empty((rows * decode_q, h, d), dtype=torch.bfloat16,
                         device=q.device)
    spans = out["spans_by_row"]  # (first span, spans) of each row
    row_plan = torch.tensor([[sum(spans[:r]), k] for r, k in
                             enumerate(spans)], dtype=torch.int32,
                            device=q.device)
    lib = ca.build()

    def merge():
        rc = lib.dtt_latent_merge(
            ca._ptr(part_o), ca._ptr(part_ml), ca._ptr(row_plan),
            ca._ptr(merged), rows, decode_q, h, n_kv, ca._stream(merged))
        if rc:
            raise AssertionError(f"dtt_latent_merge failed: {rc}")

    out["merge_us"] = device_ms(merge, 50) * 1e3
    out["partials_mb"] = (part_o.numel() + part_ml.numel()) * 4 / 1e6
    return {"latent_decode": out}


def latent_identities(ragged, chunk_cu, decode_cu, nd: int, d: int) -> dict:
    """At head_dim 640, ragged's chunk rows against chunk.cu's output and,
    with decode_cu (decode_q = 1), its decode rows against decode.cu's on
    the same inputs: the same blocks under the same plans, so equal bits
    (raises if not). {} below 640, or in an older tree (before the latent
    decode rows)."""
    if d != ca.LATENT_DIM or not hasattr(ca, "latent_decode_blocks"):
        return {}
    out = ragged()
    got = {"chunk_rows_equal_chunk_cu": torch.equal(out[nd:], chunk_cu())}
    if decode_cu is not None:
        got["decode_rows_equal_decode_cu"] = torch.equal(out[:nd],
                                                         decode_cu())
    if not all(got.values()):
        raise AssertionError(f"ragged at head_dim 640: rows differ from "
                             f"chunk.cu's or decode.cu's: {got}")
    return got


def latent_chunk_plan(q, k_pages, v_pages, pages, start: int, n_kv: int,
                      sweep: bool = False) -> dict:
    """At head_dim 640, chunk.cu's launch: its spans a query tile, its
    blocks (and those with keys to walk), its longest span, the merge's
    own time per block (the global timer at the end of a block's key walk
    and at its exit, mean and max over the blocks, µs), the launch's span
    from the first walk's end to the last exit, and whether two launches
    give equal bits (raises if not); with `sweep`, the device ms of every
    span count from 1 to MAX_CHUNK_SPANS beside the clusters of that size
    the card runs at once (the evidence for chunk_spans' rule). {} below
    640, or where the package beside the script has no such plan (an
    older tree)."""
    c, h, d = q.shape
    if d != ca.LATENT_DIM or not hasattr(ca, "chunk_span_keys"):
        return {}
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tiles = ca.chunk_span_keys(c, start, h // n_kv, d, n_kv, sms)
    keys = [hi - lo for _, _, spans in tiles for lo, hi in spans]
    kw = dict(page_size=PS, num_kv_heads=n_kv)
    clocks = torch.zeros((2 * len(keys) * n_kv,), dtype=torch.int64,
                         device=q.device)
    a = ca.chunk_prefill_attention(q, k_pages, v_pages, pages, start,
                                   clocks=clocks, **kw)
    b = ca.chunk_prefill_attention(q, k_pages, v_pages, pages, start, **kw)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"chunk at C={c}, start={start}: two launches "
                             f"differ")
    stamps = clocks.reshape(-1, 2).double()
    merge_us = (stamps[:, 1] - stamps[:, 0]) / 1e3
    by_spans = {}
    if sweep:
        lib = ca.build()
        for n in range(1, ca.MAX_CHUNK_SPANS + 1):
            def call(n=n):
                return ca.chunk_prefill_attention(q, k_pages, v_pages, pages,
                                                  start, spans=n, **kw)
            by_spans[n] = {
                "ms": device_ms(call, 20),
                "blocks": n * len(tiles) * n_kv,
                "clusters_at_once": lib.dtt_chunk_max_clusters(
                    n, int(k_pages.dtype == torch.int8)),
                "equals_plan": torch.equal(call(), a)}
    return {"latent_chunk": {
        "spans": ca.chunk_spans(c, start, h // n_kv, d, n_kv, sms),
        "blocks": len(keys) * n_kv,
        "blocks_with_keys": sum(1 for x in keys if x > 0) * n_kv,
        "longest_span_keys": max(keys), "sms": sms,
        "merge_us_mean": float(merge_us.mean()),
        "merge_us_max": float(merge_us.max()),
        "walk_end_to_exit_ms": float(stamps[:, 1].max()
                                     - stamps[:, 0].min()) / 1e6,
        "two_launches_equal": True, "ms_by_spans": by_spans}}


class HeldAgainstPlain:
    """Attention functions that launch the kernels and hold every call's
    output against the plain version on the same inputs (the layer's own
    q/k/v and pool state), so a forward through the kernels checks each of
    its attention calls at every layer. The plain version's output is
    taken in f32, before its rounding to bf16 (q passed as f32: the same
    arithmetic, unrounded): two outputs rounded to bf16 apart can differ
    by a whole unit where their f32 values straddle a rounding boundary,
    and on MLA's 640-lane latent rows (normed c_kv lanes beside unnormed
    rope lanes) an element 6.5 times its row's RMS then puts one bf16
    unit past ROW_TOL of the RMS; against the f32 value the kernel's own
    rounding is at most half a unit."""

    def __init__(self):
        self.calls, self.failed = 0, []
        self.max_abs_err = self.max_row_rel_err = 0.0
        self.fns = att.AttentionFns(
            *(self._wrap(name, getattr(att.DISPATCH, name),
                         getattr(att.PLAIN, name))
              for name in att.AttentionFns._fields))

    def _wrap(self, name, kernel, plain):
        def fn(q, *args, **kw):
            out = kernel(q, *args, **kw)
            max_abs, max_rel, ok = disagreement(
                out, plain(q.float(), *args, **kw))
            self.calls += 1
            self.max_abs_err = max(self.max_abs_err, max_abs)
            self.max_row_rel_err = max(self.max_row_rel_err, max_rel)
            if not ok:
                self.failed.append((name, self.calls, max_abs, max_rel))
            return out
        return fn


def nudged(fns: att.AttentionFns) -> att.AttentionFns:
    """`fns` with every output scaled by 1 + 2^-8 in its dtype: about half
    of a bf16 output's elements move by one unit, the size of the
    kernels' own rounding differences."""
    def wrap(fn):
        def out(*args, **kw):
            return fn(*args, **kw) * (1 + 2 ** -8)
        return out
    return att.AttentionFns(*(wrap(f) for f in fns))


def q_scaled(fns: att.AttentionFns, factor: float) -> att.AttentionFns:
    """`fns` with q multiplied by `factor` before attention."""
    def wrap(fn):
        def scaled(q, *args, **kw):
            return fn(q * factor, *args, **kw)
        return scaled
    return att.AttentionFns(*(wrap(f) for f in fns))


def three_paths(engine: Engine, attn, adapter_slot: int = 0,
                n_prefill: int = 100, n_prompt: int = 600) -> dict:
    """Logits of a full prefill (n_prefill = 100 tokens in a 128 bucket,
    or past 128 in a bucket of a multiple of 256), one decode step after
    it (slot 0 live, seven slots on the trash page), a chunked prefill
    (n_prompt = 600 tokens in 256-token chunks), a mixed step (that
    decode row beside the prompt's last whole chunk again: its second at
    600), a verify step (slot 0's window of K+1 tokens at position
    n_prefill, the other slots without room) and a mixed verify step
    (that window beside the chunk), with `attn`; on a LoRA engine every
    row of the sequence under `adapter_slot`. Gemma's phase runs it past
    the model's sliding window."""
    model, dev, out = engine.model, engine.device, {}
    rows = torch.zeros((MAX_SEQS,), dtype=torch.int32, device=dev)
    rows[0] = adapter_slot
    one = dict(lora=engine.lora_stacks, adapter_slots=adapter_slot)
    batch = dict(lora=engine.lora_stacks, adapter_slots=rows)
    mixed = dict(batch, chunk_adapter_slot=adapter_slot)
    prompt = torch.randint(0, 256, (n_prompt,),
                           generator=torch.Generator().manual_seed(2))
    bucket = 128 if n_prefill <= 128 else -(-n_prefill // 256) * 256
    pages = engine.allocator.alloc(max(n_prompt, bucket) // PS + 1)
    mixed_at = (n_prompt // CHUNK - 1) * CHUNK  # the last whole chunk
    try:
        page_t = torch.tensor(pages, dtype=torch.int32, device=dev)
        tokens = torch.zeros((bucket,), dtype=torch.long)
        tokens[:n_prefill] = prompt[:n_prefill]
        out["prefill"] = llama.prefill(
            model, tokens.to(dev), n_prefill, engine.k_pages, engine.v_pages,
            page_t[:bucket // PS], page_size=PS, attn=attn, **one)
        tok = torch.zeros((MAX_SEQS,), dtype=torch.long, device=dev)
        pos = torch.zeros((MAX_SEQS,), dtype=torch.int32, device=dev)
        ctx = torch.ones((MAX_SEQS,), dtype=torch.int32, device=dev)
        table = torch.zeros((MAX_SEQS, engine.cfg.max_seq_len // PS),
                            dtype=torch.int32, device=dev)
        tok[0], pos[0] = int(prompt[n_prefill]), n_prefill
        ctx[0] = n_prefill + 1
        table[0, :bucket // PS] = page_t[:bucket // PS]
        out["decode"] = llama.decode_step(
            model, tok, pos, table, ctx, engine.k_pages, engine.v_pages,
            page_size=PS, attn=attn, **batch)[0]
        # a trash-padded page list
        width = -(-n_prompt // 1024) * 1024 // PS + CHUNK // PS - 1
        plist = torch.zeros((width,), dtype=torch.int32, device=dev)
        plist[:len(pages)] = page_t
        for start in range(0, n_prompt, CHUNK):
            take = min(CHUNK, n_prompt - start)
            chunk = torch.zeros((CHUNK,), dtype=torch.long)
            chunk[:take] = prompt[start:start + take]
            out["chunked_prefill"] = llama.prefill_chunk(
                model, chunk.to(dev), start, take, engine.k_pages,
                engine.v_pages, plist, page_size=PS, attn=attn, **one)
        again = prompt[mixed_at:mixed_at + CHUNK].to(dev)
        out["mixed_decode"], out["mixed_chunk"] = llama.mixed_step(
            model, tok, pos, table, ctx, again, mixed_at, CHUNK, plist,
            engine.k_pages, engine.v_pages, page_size=PS, attn=attn,
            **mixed)
        out["mixed_decode"] = out["mixed_decode"][0]
        window = torch.zeros((MAX_SEQS, SPEC_K + 1), dtype=torch.long,
                             device=dev)
        window[0] = prompt[n_prefill:n_prefill + 1 + SPEC_K].to(dev)
        room = torch.zeros((MAX_SEQS,), dtype=torch.bool, device=dev)
        room[0] = True
        out["verify"] = llama.decode_verify(
            model, window, pos, table, room, engine.k_pages, engine.v_pages,
            page_size=PS, attn=attn, **batch)[0]
        out["mixed_verify"], out["mixed_verify_chunk"] = \
            llama.mixed_verify_step(
                model, window, pos, table, room, again, mixed_at, CHUNK,
                plist, engine.k_pages, engine.v_pages, page_size=PS,
                attn=attn, **mixed)
        out["mixed_verify"] = out["mixed_verify"][0]
    finally:
        engine.allocator.free(pages)
    return out


# three_paths' MoE routing calls in order, `layers` per forward: (name,
# the rows whose outputs reach its logits) of each forward, and the
# forward whose routing each of its logits rests on last
def routing_segments():
    k1, n = SPEC_K + 1, MAX_SEQS * (SPEC_K + 1)
    chunk = [CHUNK] * (600 // CHUNK) + [600 % CHUNK]
    window = list(range(k1))
    return ([("prefill", list(range(100))), ("decode", [0])]
            + [(f"chunk{i}", list(range(c))) for i, c in enumerate(chunk)]
            + [("mixed", [0] + list(range(MAX_SEQS, MAX_SEQS + CHUNK))),
               ("verify", window),
               ("mixed_verify", window + list(range(n, n + CHUNK)))])


PATH_SEGMENT = {"prefill": "prefill", "decode": "decode",
                "chunked_prefill": f"chunk{600 // CHUNK}",
                "mixed_decode": "mixed", "mixed_chunk": "mixed",
                "verify": "verify", "mixed_verify": "mixed_verify",
                "mixed_verify_chunk": "mixed_verify"}


@contextlib.contextmanager
def routing_recorded(calls: list):
    """Record the router logits [T, X] of every MoE block (f32, on the
    host) while the block is active."""
    orig = moe.topk_combine

    def recorded(logits, *args, **kw):
        calls.append(logits.detach().float().cpu())
        return orig(logits, *args, **kw)

    moe.topk_combine = recorded
    try:
        yield
    finally:
        moe.topk_combine = orig


def bf16_unit(v: float) -> float:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 2.0 ** -133


def routing_divergence(plain: list, kernels: list, cfg):
    """Where the routing of the forward through the kernels first selects
    other experts than the plain forward's, over the rows that reach the
    logits (routing_segments): its forward, layer and row, and in the
    plain forward's router logits the margin between the k-th and the
    (k+1)-th largest, in bf16 units of the k-th (the router's product is
    bf16, so margins are whole units where the two share a binade); a
    margin of at most one unit is a near-tie, which one rounding of the
    layer's input can flip. None if the routing is identical."""
    k, layers = cfg.num_experts_per_tok, cfg.num_layers
    segments = routing_segments()
    if len(plain) != len(kernels) or len(plain) != layers * len(segments):
        raise AssertionError(f"{len(plain)} and {len(kernels)} routing "
                             f"calls, expected {layers * len(segments)}")
    for i, (a, b) in enumerate(zip(plain, kernels)):
        name, rows = segments[i // layers]
        sel_a = moe.top_k(a[rows], k)[1].sort(-1).values
        sel_b = moe.top_k(b[rows], k)[1].sort(-1).values
        differs = (sel_a != sel_b).any(-1)
        if not differs.any():
            continue
        row = rows[int(differs.nonzero()[0, 0])]
        top = torch.sort(a[row], descending=True).values
        kth, nxt = float(top[k - 1]), float(top[k])
        unit = bf16_unit(kth)
        return {"forward": name, "segment": i // layers,
                "layer": i % layers, "row": row,
                "rows_differing": int(differs.sum()),
                "plain_experts": sel_a[int(differs.nonzero()[0, 0])].tolist(),
                "kernel_experts": sel_b[int(differs.nonzero()[0, 0])].tolist(),
                "kth_logit": kth, "next_logit": nxt, "margin": kth - nxt,
                "margin_bf16_units": (kth - nxt) / unit,
                "near_tie": bool(kth - nxt <= unit)}
    return None


def near_tie_paths(routing) -> set:
    """The logits that rest on routing from the first near-tie on: a
    difference there is a flipped expert, not a kernel's error."""
    if not routing or not routing["near_tie"]:
        return set()
    order = [name for name, _ in routing_segments()]
    return {p for p, seg in PATH_SEGMENT.items()
            if order.index(seg) >= routing["segment"]}


def rel_l2(got: dict, ref: dict) -> dict:
    return {path: float((got[path].float() - ref[path].float()).norm()
                        / ref[path].float().norm()) for path in ref}


def forward_checks(engine: Engine, adapter_slot: int = 0,
                   n_prefill: int = 100, n_prompt: int = 600,
                   q_scale: float = None) -> dict:
    """The four forwards through the kernels against the plain attention,
    at full depth, on the engine's pools (bf16 or int8).

    With the random weights, wq's sigma 1/sqrt(head_dim) over 4096 inputs
    gives attention scores of standard deviation near 30: softmax is close
    to one-hot, and a forward at that scale cannot tell a kernel that
    weighs keys wrongly from a right one. So every forward here scales q
    by Q_SCALE before attention (the same shapes, pools and wrappers),
    which brings the scores' deviation near 2 and spreads softmax over
    many keys (a model with qk_norm normalizes q and k per head: its
    scores' deviation is near 1 as drawn, and q is left as it is). Then:
    - every attention call of the kernel forward is held against the plain
      version on the same inputs (HeldAgainstPlain);
    - its logits must be within LOGIT_REL_TOL (relative L2) of the plain
      forward's;
    - the plain forward with the 1/sqrt(D) scale left out (q scaled by
      Q_SCALE * sqrt(D)) must be farther than LOGIT_REL_TOL from it: the
      logits check can fail.
    On a LoRA engine the sequence runs under `adapter_slot`. On an MoE
    model the two forwards' routing is compared (routing_divergence): a
    bf16 difference of attention can flip one of a token's top-k experts
    where two router logits nearly tie, and the logits then differ by a
    whole expert's share. Logits that miss LOGIT_REL_TOL are a fault,
    unless the routing first differed at a near-tie (at most one bf16
    unit) no later than the forward they come from. n_prefill and
    n_prompt size the forwards (three_paths); `q_scale` (None: as above)
    is the q scaling, 1 where the weights' wq already carries Q_SCALE
    (phi3_phase)."""
    held = HeldAgainstPlain()
    sizes = dict(n_prefill=n_prefill, n_prompt=n_prompt)
    cfg = engine.model_cfg
    if q_scale is None:
        q_scale = 1.0 if cfg.qk_norm else Q_SCALE
    routes_plain, routes_kernels = [], []
    with routing_recorded(routes_plain):
        plain = three_paths(engine, q_scaled(att.PLAIN, q_scale),
                            adapter_slot, **sizes)
    with routing_recorded(routes_kernels):
        kernels = three_paths(engine, q_scaled(held.fns, q_scale),
                              adapter_slot, **sizes)
    unscaled = three_paths(engine, q_scaled(
        att.PLAIN, q_scale * cfg.cache_head_dim ** 0.5), adapter_slot,
        **sizes)
    row = {"model": cfg.name, "kv_cache_dtype": engine.kv_spec.dtype,
           "adapter_slot": adapter_slot, "q_scale": q_scale, **sizes,
           "attention_calls_held": held.calls,
           "attention_max_abs_err": held.max_abs_err,
           "attention_max_row_rel_err": held.max_row_rel_err,
           "attention_tolerance": f"atol=rtol={TOL}, row max/RMS <= "
                                  f"{ROW_TOL}",
           "failed_calls": held.failed[:5],
           "logits_rel_l2": rel_l2(kernels, plain),
           "logits_finite": all(bool(torch.isfinite(t).all())
                                for t in kernels.values()),
           "logits_tolerance": f"rel_l2 < {LOGIT_REL_TOL}",
           "logits_rel_l2_without_softmax_scale": rel_l2(unscaled, plain)}
    routing = None
    if cfg.is_moe:
        routing = routing_divergence(routes_plain, routes_kernels, cfg)
        row["routing_first_difference"] = routing or "none"
        # the control: how far the plain forward moves from itself when
        # its attention outputs move by about half a bf16 unit
        routes_nudged = []
        with routing_recorded(routes_nudged):
            control = three_paths(engine, q_scaled(nudged(att.PLAIN),
                                                   q_scale), adapter_slot)
        row["control_plain_nudged"] = {
            "logits_rel_l2": rel_l2(control, plain),
            "routing_first_difference": routing_divergence(
                routes_plain, routes_nudged, cfg) or "none"}
    excused = near_tie_paths(routing)
    row["logits_past_tolerance_after_near_tie"] = sorted(
        p for p in excused if row["logits_rel_l2"][p] >= LOGIT_REL_TOL)
    emit({"forward_check": row})
    # per layer: prefill, decode, the chunks, the mixed step, the verify
    # step and the mixed verify step
    expected = len(engine.model.layers) * (5 + -(-n_prompt // CHUNK))
    if held.failed or held.calls != expected:
        raise AssertionError(f"attention calls in the forward disagree with "
                             f"the plain version: {held.failed[:5]} "
                             f"({held.calls} calls)")
    if not row["logits_finite"] or any(
            e >= LOGIT_REL_TOL for p, e in row["logits_rel_l2"].items()
            if p not in excused):
        raise AssertionError(f"logits through the kernels differ from the "
                             f"plain forward: {row['logits_rel_l2']}, "
                             f"routing {routing}")
    if any(e < LOGIT_REL_TOL for e in
           row["logits_rel_l2_without_softmax_scale"].values()):
        raise AssertionError("the logits check cannot tell a wrong softmax "
                             "scale: " + str(row))
    return row


def post(url: str, body: dict, stream: bool,
         first: threading.Event = None):
    """POST; returns (status, payload, arrival times of the SSE events in
    seconds after the request, total seconds). `first` is set once a
    streamed response's first token event (the one after the role) has
    arrived."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        if not stream:
            return r.status, json.loads(r.read()), [], time.monotonic() - t0
        events, stamps = [], []
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
                stamps.append(time.monotonic() - t0)
                if first is not None and len(events) == 2:
                    first.set()
        return r.status, events, stamps, time.monotonic() - t0


class VisibleTokenizer(ByteTokenizer):
    """The byte tokenizer, but every token id decodes to one character, so
    that a streamed response carries one SSE event per token without
    logprobs (random weights emit ids >= 256, which bytes decode to
    nothing). The prompts encode as before."""

    def decode(self, ids) -> str:
        return "".join(chr(0x3400 + i % 0x5000) for i in ids)


@contextlib.contextmanager
def serving(engine: Engine, tokenizer=None, utilization: bool = True):
    """The OpenAI server for `engine` on 127.0.0.1:0 (with `tokenizer` in
    place of the model's, if given); yields its base URL, then (with
    `utilization`) scrapes its /metrics once and prints the model's live
    dynamo_engine_mfu and dynamo_engine_mbu (over all the engine's decode
    work so far), and stops server and engine thread on exit."""
    ctx = ServingContext(engine, engine.cfg.model)
    if tokenizer is not None:
        ctx.tokenizer = tokenizer
    srv = make_server(ctx, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        yield base
        if not utilization:
            return
        values = samples(scrape(base))
        emit({"phase": "utilization", "model": engine.cfg.model,
              "kv_cache_dtype": engine.kv_spec.dtype,
              "quantization": quant.mode_of(engine.model),
              "mfu": values[("dynamo_engine_mfu", ())],
              "mbu": values[("dynamo_engine_mbu", ())]})
    finally:
        srv.shutdown()
        ctx.close()
        thread.join(timeout=30)


COMMON = {"model": MODEL, "max_tokens": MAX_TOKENS, "temperature": 0.0,
          "ignore_eos": True}
CHAT = dict(COMMON, messages=[{"role": "user",
                               "content": "Port this kernel to Hopper."}])
# logprobs: every token gets its own SSE chunk, even one the byte tokenizer
# decodes to no text (random weights emit ids >= 256)
CHAT_STREAM = dict(CHAT, stream=True, logprobs=True,
                   stream_options={"include_usage": True})
LONG_TEXT = ("The paged KV cache keeps page zero as trash. " * 14)[:596]
# phase 5's four concurrent requests: (path, body, streamed)
FOUR_JOBS = {
    "chat": ("/v1/chat/completions", CHAT, False),
    "chat_stream": ("/v1/chat/completions", CHAT_STREAM, True),
    "completion": ("/v1/completions",
                   dict(COMMON, prompt="Hopper has 132 SMs and", logprobs=1),
                   False),
    "long_prompt": ("/v1/completions", dict(COMMON, prompt=LONG_TEXT), False),
}


def summarize(name: str, result, stream: bool) -> dict:
    """Usage and, for a stream, TTFT and inter-token gaps of one request;
    raises unless it returned MAX_TOKENS tokens."""
    status, payload, stamps, total = result
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status}")
    if stream:
        if payload[-1] != "[DONE]":
            raise AssertionError(f"{name}: SSE did not end with [DONE]")
        usage = json.loads(payload[-2])["usage"]
    else:
        usage = payload["usage"]
    if usage["completion_tokens"] != MAX_TOKENS:
        raise AssertionError(f"{name}: usage {usage}")
    out = {"prompt_tokens": usage["prompt_tokens"],
           "completion_tokens": usage["completion_tokens"], "total_s": total}
    if stream:
        # events: role, one per token, finish, usage, [DONE]
        tok = stamps[1:1 + MAX_TOKENS]
        gaps = [b - a for a, b in zip(tok, tok[1:])]
        out.update(ttft_s=tok[0], itl_mean_s=sum(gaps) / len(gaps),
                   itl_max_s=max(gaps),
                   tokens_per_s=(len(tok) - 1) / (tok[-1] - tok[0]))
    return out


def interference(base: str, stream_body: dict = CHAT_STREAM,
                 model: str = MODEL) -> dict:
    """The ~600-token prompt alone on the idle engine (the chunked path),
    then a streamed chat (`stream_body`) and, once its first token is out,
    the same prompt again, which prefills while the stream decodes; each
    request addressed to `model`."""
    long_job = (base + "/v1/completions",
                dict(COMMON, prompt=LONG_TEXT, model=model), False)
    stream_body = dict(stream_body, model=model)
    out = {"long_alone": summarize("long_alone", post(*long_job), False)}
    first, got = threading.Event(), {}
    stream = threading.Thread(target=lambda: got.update(stream=post(
        base + "/v1/chat/completions", stream_body, True, first)))
    stream.start()
    if not first.wait(timeout=600):
        raise AssertionError("the streamed request never produced a token")
    out["long_beside_stream"] = summarize("long_beside_stream",
                                          post(*long_job), False)
    stream.join(timeout=600)
    out["stream"] = summarize("stream", got["stream"], True)
    if out["long_alone"]["prompt_tokens"] <= CHUNK:
        raise AssertionError("the long prompt did not take the chunked path")
    return out


def stats(base: str) -> dict:
    return json.loads(urllib.request.urlopen(base + "/worker/stats",
                                             timeout=30).read())


def serve_checks(engine: Engine) -> dict:
    """Phase 5 on the classic engine: the classic kernels must launch."""
    jobs = FOUR_JOBS
    results = {}
    with serving(engine) as base:
        ca.reset_launch_counts()

        def run(name):
            path, body, stream = jobs[name]
            results[name] = post(base + path, body, stream)

        threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        again = [post(base + "/v1/completions", jobs["completion"][1], False)
                 for _ in range(2)]
        mixed_traffic = interference(base)
        launches = dict(ca.LAUNCHES)
        worker = stats(base)

    summary = {name: summarize(name, results[name], jobs[name][2])
               for name in jobs}
    lp = [r[1]["choices"][0]["logprobs"] for r in again]
    if (lp[0]["token_logprobs"] != lp[1]["token_logprobs"]
            or lp[0]["tokens"] != lp[1]["tokens"]):
        raise AssertionError("a repeated greedy request gave other tokens")
    summary["repeat_identical"] = True
    summary["repeat_matches_concurrent_run"] = (
        results["completion"][1]["choices"][0]["logprobs"]["token_logprobs"]
        == lp[0]["token_logprobs"])
    summary["interference"] = mixed_traffic
    summary["engine_metrics"] = worker["metrics"]
    missing = [k for k in CLASSIC if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    return {"requests": summary, "launches": launches}


def mixed_serve_checks(engine: Engine) -> dict:
    """Phase 5 on a mixed engine: the interference traffic must ride the
    mixed step, whose ragged kernel launches once per layer per step."""
    sfx = "_int8" if engine.kv_spec.quantized else ""
    with serving(engine) as base:
        ca.reset_launch_counts()
        traffic = interference(base, model=engine.cfg.model)
        launches = dict(ca.LAUNCHES)
        variants = dict(ca.VARIANT_LAUNCHES)
        worker = stats(base)
    mixed = worker["metrics"]["mixed_count"]
    want = ("prefill", "decode" + sfx, "chunk" + sfx, "ragged" + sfx)
    missing = [k for k in want if launches[k] == 0]
    if mixed == 0 or missing:
        raise AssertionError(f"mixed engine ({engine.kv_spec.dtype} pools):"
                             f" {mixed} mixed steps, kernels never launched:"
                             f" {missing} ({launches})")
    layers = engine.model_cfg.num_layers
    if launches["ragged" + sfx] != layers * mixed:
        raise AssertionError(f"ragged{sfx} launched {launches['ragged' + sfx]}"
                             f" times for {mixed} mixed steps of {layers} "
                             f"layers")
    return {"kv_cache": worker["kv_cache"], "mixed_count": mixed,
            "requests": traffic, "engine_metrics": worker["metrics"],
            "launches": launches, "variants": variants}


def kernel_family(name: str) -> str:
    low = name.lower()
    if "dtt::json" in name:
        return "grammar mask (port kernel)"
    if "dtt::" in name:
        return "attention (port kernels)"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, rope, sampling, KV writes)"


def profile_steps(engine: Engine, steps: int, long_prompt: int = 0,
                  request_kw=None, label: str = "",
                  prompt_len: int = 100) -> dict:
    """Where a steady decode step's time goes: `steps` engine steps timed
    on the host clock, then the same steps again under torch.profiler for
    device time by kernel family and the kernels launched, all per decode
    step (an engine step runs a window of num_scheduler_steps decode
    steps). Each pass drives the same traffic from an idle engine: with
    long_prompt 0, all 8 slots decoding after prompt_len-token prompts
    (100: Gemma's phase decodes past its window); otherwise
    (a mixed engine) 7 slots decoding beside a long_prompt-token prompt
    whose chunks after the first ride the measured mixed steps, and every
    measured step must be one. On a speculating engine every measured
    step must be one verify step (a replay of its graph, or eager).
    `request_kw(i)`: more GenRequest fields of decode request i (guided,
    an adapter, a logit_bias); `label` names the step in the result."""
    n_decode = MAX_SEQS - 1 if long_prompt else MAX_SEQS
    spec = engine.verify is not None
    # decode steps per engine step, and the graphs' books
    k = 1 if spec else engine.cfg.num_scheduler_steps
    graph_stats = engine.verify.stats if spec else engine.windows.stats
    units = "steps" if spec else "windows"
    tokens = (steps + 2) * (SPEC_K + 1 if spec else k) + 8
    counted = {}

    def drive(tag: str, measured) -> float:
        for i in range(n_decode):
            engine.add_request(GenRequest(
                f"profile-{tag}-{i}", [1 + j % 200 for j in
                                       range(prompt_len)],
                max_tokens=tokens, ignore_eos=True,
                **(request_kw(i) if request_kw else {})))
        while engine.pending:
            engine.step()
        engine.step()
        if long_prompt:
            engine.add_request(GenRequest(
                f"profile-{tag}-long", [1 + i % 200 for i in
                                        range(long_prompt)],
                max_tokens=2, ignore_eos=True))
            engine.step()  # starts the chunked prefill
            engine.step()  # the first mixed step
        mixed0 = engine.metrics.mixed_count
        decode0 = engine.metrics.decode_steps
        verify0 = engine.metrics.spec_verify_steps
        win0 = graph_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with measured:
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        mixed = engine.metrics.mixed_count - mixed0
        counted[tag] = engine.metrics.decode_steps - decode0
        counted["verify"] = engine.metrics.spec_verify_steps - verify0
        win = graph_stats()
        counted["windows"] = win[units] - win0[units]
        counted["replays"] = win["replays"] - win0["replays"]
        while engine.has_work:
            engine.step()
        if mixed != (steps if long_prompt else 0):
            raise AssertionError(f"{mixed} of the {steps} measured steps "
                                 f"were mixed steps (long prompt "
                                 f"{long_prompt})")
        if counted[tag] != steps * (1 if long_prompt else k):
            raise AssertionError(f"{counted[tag]} decode steps in {steps} "
                                 f"engine steps of {k}-step windows")
        if spec and counted["verify"] != steps:
            raise AssertionError(f"{counted['verify']} verify steps in "
                                 f"{steps} engine steps")
        return wall / counted[tag] * 1e3

    from torch.profiler import ProfilerActivity, profile

    wall_ms = drive("timed", contextlib.nullcontext())
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    drive("profiled", traced(prof))
    n_steps = counted["profiled"]
    families, kernels, n_kernels = {}, {}, 0
    for ev in device_events(prof):
        n_kernels += 1
        ms = ev.time_range.elapsed_us() / 1e3 / n_steps
        fam = kernel_family(ev.name)
        families[fam] = families.get(fam, 0.0) + ms
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ms
    busy = sum(families.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    graphs = graph_stats()
    return {"kv_cache_dtype": engine.kv_spec.dtype,
            "step": label or ("mixed" if long_prompt else
                              f"verify (K={SPEC_K})" if spec else "decode"),
            "decode_slots": n_decode, "long_prompt": long_prompt,
            "prompt_len": prompt_len,
            "window": 1 if long_prompt else k,
            "cuda_graphs": not graphs["eager"],
            "engine_steps": steps, "decode_steps": n_steps,
            "wall_ms_per_step": wall_ms,
            "tokens_per_s_per_slot": 1e3 / wall_ms,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "device_kernels_per_step": (n_kernels / n_steps if n_kernels
                                        else "not measured: the profiler "
                                             "saw no device kernel"),
            "graph_replays_per_window": (counted["replays"]
                                         / counted["windows"]
                                         if not graphs["eager"] else 0),
            "graphs_captured": graphs["graphs"],
            "capture_s": graphs["capture_s"],
            "lead_lost": lead_lost(prof),
            "by_family_ms_per_step": families,
            "top_kernels_ms_per_step": [[n[:80], t] for n, t in top]}


def parity_requests(tok) -> list:
    """Phase 5's four greedy requests (its texts, the completion with
    logprobs) and two seeded sampled ones, as fresh GenRequests."""
    chat = "Port this kernel to Hopper."
    greedy = [(chat, None), (chat, 5), ("Hopper has 132 SMs and", 1),
              (LONG_TEXT, None)]
    reqs = [GenRequest(f"greedy{i}", tok.encode(t), max_tokens=MAX_TOKENS,
                       ignore_eos=True, logprobs=lp)
            for i, (t, lp) in enumerate(greedy)]
    for i, t in enumerate(("Sample a story about the trash page.",
                           "Sample a poem about split keys.")):
        reqs.append(GenRequest(f"sampled{i}", tok.encode(t),
                               max_tokens=MAX_TOKENS, temperature=0.8,
                               top_p=0.9, seed=100 + i, ignore_eos=True))
    return reqs


def run_to_end(engine: Engine, reqs) -> dict:
    """Add `reqs` and step until idle: {rid: [(token, logprob, top)]}."""
    for r in reqs:
        engine.add_request(r)
    out = {}
    while engine.has_work:
        for ev in engine.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(
                    (ev.token_id, ev.logprob, ev.top_logprobs))
    return out


def first_difference(got: dict, want: dict):
    """(rid, index, detail) of the first token where two runs differ, or
    None."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                top = None
                if x[2] and y[2]:
                    top = max(abs(p - q) for (_, p), (_, q) in
                              zip(x[2], y[2]))
                return rid, i, {"got": x[:2], "want": y[:2],
                                "top_logprob_max_abs_diff": top}
        if len(a) != len(b):
            return rid, min(len(a), len(b)), {"lengths": [len(a), len(b)]}
    return None


def window_parity(reference: Engine, engines: dict, tok) -> dict:
    """Each engine's streams against the eager 1-step reference's."""
    want = run_to_end(reference, parity_requests(tok))
    row = {"reference": "eager 1-step synchronous", "requests": len(want),
           "tokens": sum(map(len, want.values()))}
    for name, eng in engines.items():
        t0 = time.monotonic()
        got = run_to_end(eng, parity_requests(tok))
        diff = first_difference(got, want)
        row[name] = {"equal": diff is None, "first_difference": diff,
                     "seconds": time.monotonic() - t0,
                     "graphs": eng.windows.stats(),
                     "decode_steps": eng.metrics.decode_steps}
        if diff is not None:
            emit({"window_parity": row})
            raise AssertionError(f"{name}: streams differ from the eager "
                                 f"1-step engine's at {diff}")
    emit({"window_parity": row})
    return row


def window_serve(engine: Engine) -> dict:
    """Phase 5's four concurrent requests on a graph-window engine,
    addressed to its model."""
    jobs = {k: (path, dict(body, model=engine.cfg.model), stream)
            for k, (path, body, stream) in FOUR_JOBS.items()}
    results = {}
    with serving(engine) as base:
        ca.reset_launch_counts()
        win0 = engine.windows.stats()

        def run(name):
            path, body, stream = jobs[name]
            results[name] = post(base + path, body, stream)

        threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches = dict(ca.LAUNCHES)
        variants = dict(ca.VARIANT_LAUNCHES)
        worker = stats(base)
    win = engine.windows.stats()
    summary = {name: summarize(name, results[name], jobs[name][2])
               for name in jobs}
    replays = win["replays"] - win0["replays"]
    missing = [k for k in ("decode", "prefill") if launches[k] == 0]
    if missing or replays == 0 or win["graphs"] > win0["graphs"] + 1:
        raise AssertionError(f"window engine: kernels never launched "
                             f"{missing}, {replays} graph replays, graphs "
                             f"{win0['graphs']} -> {win['graphs']} "
                             f"({launches})")
    return {"requests": summary, "launches": launches, "variants": variants,
            "graph_replays": replays, "windows": win["windows"]
            - win0["windows"], "decode_graphs": worker["decode_graphs"],
            "engine_metrics": worker["metrics"]}


def prefix_checks(engine: Engine, cache_off: Engine, tok) -> dict:
    """The ~600-token prompt, the same again, then a prompt sharing its
    first 512 tokens, one after another on the prefix-caching engine:
    TTFT (engine clock, add_request to the first token), chunk launches
    and the tokens, against the cache-off engine's tokens."""
    first = tok.encode(LONG_TEXT)
    tail = tok.encode(" and the pages past the shared prefix are this "
                      "prompt's own, filled by its suffix chunk.",
                      add_bos=False)
    prompts = {"first": first, "again": first, "shared": first[:512] + tail}
    layers = engine.model_cfg.num_layers
    rows, launches = {}, {}
    for rid, prompt in prompts.items():
        ca.reset_launch_counts()
        cached0 = engine.prefix_cache.stats()["cached_tokens_served"]
        t0 = time.monotonic()
        engine.add_request(GenRequest(rid, prompt, max_tokens=MAX_TOKENS,
                                      ignore_eos=True))
        toks, ttft = [], None
        while engine.has_work:
            for ev in engine.step():
                if ev.token_id >= 0:
                    ttft = ttft or time.monotonic() - t0
                    toks.append(ev.token_id)
        cached = engine.prefix_cache.stats()["cached_tokens_served"] - cached0
        chunks = -(-(len(prompt) - cached) // CHUNK)
        rows[rid] = {"prompt_tokens": len(prompt), "cached_tokens": cached,
                     "ttft_s": ttft, "tokens": toks,
                     "chunk_launches": ca.LAUNCHES["chunk"],
                     "expected_chunk_launches": layers * chunks}
        for name, n in ca.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n
        if ca.LAUNCHES["chunk"] != layers * chunks or len(toks) != MAX_TOKENS:
            raise AssertionError(f"prefix phase, {rid}: {rows[rid]}")
    st = engine.prefix_cache.stats()
    ref = run_to_end(cache_off, [GenRequest(rid, p, max_tokens=MAX_TOKENS,
                                            ignore_eos=True)
                                 for rid, p in prompts.items()])
    equal = {rid: [t for t, _, _ in ref[rid]] == rows[rid]["tokens"]
             for rid in prompts}
    if st["hits"] < 2 or not (rows["again"]["cached_tokens"]
                              and rows["shared"]["cached_tokens"] == 512):
        raise AssertionError(f"prefix phase: no cache hits: {st} {rows}")
    out = {"prefix_cache": st, "tokens_equal_cache_off": equal,
           "ttft_s": {rid: r["ttft_s"] for rid, r in rows.items()},
           "requests": {rid: {k: v for k, v in r.items() if k != "tokens"}
                        for rid, r in rows.items()},
           "launches": launches}
    if not all(equal.values()):
        emit({"phase": "prefix_cache", **out})
        raise AssertionError(f"prefix-cached greedy tokens differ from the "
                             f"cache-off engine's: {equal}")
    return out


def int_mm_checks(model) -> dict:
    """quant.int_mm (torch._int_mm; zero rows appended below
    quant.INT_MM_MIN_ROWS) on the model's own int8 weights at 8, 1 and 256
    rows against the exact integer product: f64 on the card, exact since
    every partial sum is an integer below 127 * 127 * 14336 < 2^53. Raises
    unless every int32 accumulation equals it."""
    dev = model.final_norm.device
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    rows = {}
    for name, w in (("wo", model.layers[0].wo),
                    ("w_gate", model.layers[0].w_gate),
                    ("w_down", model.layers[-1].w_down),
                    ("lm_head", model.lm_head)):
        k, n = w.q.shape
        for m in (8, 1, 256):
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            got = quant.int_mm(a, w.q)
            equal = got.dtype == torch.int32 and got.shape == (m, n)
            for c in range(0, n, 16384):  # f64 slices of at most 512 MiB
                exact = (a.double() @ w.q[:, c:c + 16384].double()).long()
                equal = equal and torch.equal(got[:, c:c + 16384].long(),
                                              exact)
            rows[f"{name}_{m}x{k}x{n}"] = bool(equal)
    emit({"phase": "int_mm_exact", "rows": rows,
          "min_rows": quant.INT_MM_MIN_ROWS})
    if not all(rows.values()):
        raise AssertionError(f"torch._int_mm differs from the exact integer "
                             f"product: {rows}")
    return rows


def quant_matmul_checks(w8a8, int8) -> dict:
    """Each quantized projection at 8 rows (a decode step's) against the
    bf16 matmul over its dequantized weight (q * scale in f32, cast to
    bf16): the relative L2 gap, within QUANT_REL_L2, and the device times
    of both (one call each, median of three batches)."""
    dev = w8a8.final_norm.device
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    out = {}
    for name, pick in (("wq", lambda m: m.layers[0].wq),
                       ("w_gate", lambda m: m.layers[0].w_gate),
                       ("w_down", lambda m: m.layers[0].w_down),
                       ("lm_head", lambda m: m.lm_head)):
        row = {}
        for mode, model in (("w8a8", w8a8), ("int8", int8)):
            w = pick(model)
            x = torch.randn((MAX_SEQS, w.q.shape[0]), generator=g,
                            device=dev).to(torch.bfloat16)
            deq = (w.q.float() * w.scale).to(torch.bfloat16)
            got, ref = quant.matmul(x, w), x @ deq
            torch.cuda.synchronize()
            rel = float((got.float() - ref.float()).norm()
                        / ref.float().norm())
            row[mode] = {"rel_l2": rel,
                         "finite": bool(torch.isfinite(got).all()),
                         "ms": device_ms(lambda: quant.matmul(x, w), 20),
                         "bf16_ms": device_ms(lambda: x @ deq, 20)}
            del deq
        out[f"{name}_{MAX_SEQS}x{w.q.shape[0]}x{w.q.shape[1]}"] = row
    emit({"phase": "quant_matmul", "tolerance": f"rel_l2 < {QUANT_REL_L2}",
          "rows": out})
    bad = [(k, m) for k, row in out.items() for m, r in row.items()
           if not (r["finite"] and r["rel_l2"] < QUANT_REL_L2)]
    if bad:
        raise AssertionError(f"quantized matmuls off the bf16 ones: {bad}")
    return out


def hf_config(cfg, layers: int) -> dict:
    """An HF config.json for `cfg` cut to `layers` layers."""
    factor, low, high, orig = cfg.rope_llama3_scaling
    return {"architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_scaling": {"rope_type": "llama3", "factor": factor,
                             "low_freq_factor": low,
                             "high_freq_factor": high,
                             "original_max_position_embeddings": orig},
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "eos_token_id": cfg.eos_token_id,
            "bos_token_id": cfg.bos_token_id, "torch_dtype": "bfloat16"}


def hf_tensors(cfg, layers: int, dev) -> dict:
    """HF-named bf16 tensors ([out, in]) at cfg's widths, from seed 7."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    e, f = cfg.hidden_size, cfg.intermediate_size
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def w(*shape):
        x = torch.randn(shape, generator=g, device=dev)
        return x.mul_(shape[-1] ** -0.5).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": w(cfg.vocab_size, e),
         "model.norm.weight": 1 + w(e), "lm_head.weight": w(cfg.vocab_size, e)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + w(e),
                  p + "post_attention_layernorm.weight": 1 + w(e),
                  p + "self_attn.q_proj.weight": w(hd, e),
                  p + "self_attn.k_proj.weight": w(kvd, e),
                  p + "self_attn.v_proj.weight": w(kvd, e),
                  p + "self_attn.o_proj.weight": w(e, hd),
                  p + "mlp.gate_proj.weight": w(f, e),
                  p + "mlp.up_proj.weight": w(f, e),
                  p + "mlp.down_proj.weight": w(e, f)})
    return t


def checkpoint_equal(model, src: dict) -> dict:
    """Every port parameter against its HF source tensor (transposed from
    [out, in]), bit for bit: {port name: equal}."""
    hf = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
          "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
          "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
          "w_down": "mlp.down_proj", "attn_norm": "input_layernorm",
          "mlp_norm": "post_attention_layernorm"}
    out = {"embed": torch.equal(model.embed,
                                src["model.embed_tokens.weight"]),
           "final_norm": torch.equal(model.final_norm,
                                     src["model.norm.weight"]),
           "lm_head": torch.equal(model.lm_head, src["lm_head.weight"].t())}
    for i, layer in enumerate(model.layers):
        for name, key in hf.items():
            t = src[f"model.layers.{i}.{key}.weight"]
            out[f"layers.{i}.{name}"] = torch.equal(
                getattr(layer, name), t if t.dim() == 1 else t.t())
    return out


def model_path_checks(cfg_kw: dict, model_cfg, dev) -> dict:
    """Phase 10: write a 2-layer checkpoint at the 8B widths, load it
    through the engine, compare every parameter, serve one request."""
    from safetensors.torch import save_file

    layers = 2
    src = hf_tensors(model_cfg, layers, dev)
    nbytes = sum(t.numel() * t.element_size() for t in src.values())
    path = tempfile.mkdtemp(prefix="dtt_ckpt_")
    try:
        t0 = time.monotonic()
        names = sorted(src)
        for s in range(2):
            save_file({n: src[n].cpu() for n in names[s::2]},
                      os.path.join(path, f"model-{s + 1:05d}-of-00002"
                                         ".safetensors"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config(model_cfg, layers), f)
        write_s = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine = Engine(EngineConfig(**dict(cfg_kw, model_path=path)))
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        want_cfg = dataclasses.replace(model_cfg, name=path,
                                       num_layers=layers)
        equal = checkpoint_equal(engine.model, src)
        del src
        with serving(engine) as base:
            ca.reset_launch_counts()
            served = summarize("chat", post(base + "/v1/chat/completions",
                                            CHAT, False), False)
            launches = dict(ca.LAUNCHES)
        row = {"layers": layers, "checkpoint_gib": nbytes / 2**30,
               "files": 2, "write_s": write_s, "load_s": load_s,
               "load_gib_per_s": nbytes / 2**30 / load_s,
               "model_config_is_the_preset_at_2_layers":
                   engine.model_cfg == want_cfg,
               "parameters_checked": len(equal),
               "parameters_equal": sum(equal.values()),
               "served": served, "launches": launches}
        emit({"phase": "model_path", **row})
        if not row["model_config_is_the_preset_at_2_layers"]:
            raise AssertionError(f"config.json mapped to {engine.model_cfg}")
        if not all(equal.values()):
            raise AssertionError(f"checkpoint parameters differ from their "
                                 f"source: {[k for k, v in equal.items() if not v]}")
        missing = [k for k in CLASSIC if k != "chunk" and launches[k] == 0]
        if missing:
            raise AssertionError(f"checkpoint engine: kernels never launched"
                                 f" {missing} ({launches})")
        del engine
        return row
    finally:
        shutil.rmtree(path, ignore_errors=True)
        torch.cuda.empty_cache()


def trtllm_engine(base_cfg: dict, model, tmp: str) -> Engine:
    """An engine with the trtllm_tpu profile, its EngineConfig parsed by the
    worker's parser from an engine-config file (the profile's required
    flag) that holds this script's sizes and the w8a8 mode."""
    path = os.path.join(tmp, "engine.json")
    keys = ("page_size", "num_pages", "max_num_seqs", "max_seq_len", "seed")
    with open(path, "w") as f:
        json.dump({**{k: base_cfg[k] for k in keys},
                   "quantization": "w8a8"}, f)
    args = build_parser("trtllm_tpu").parse_args(
        ["--model", MODEL, "--engine-config", path])
    cfg = EngineConfig.from_cli_args(args)
    profile = BACKEND_PROFILES["trtllm_tpu"]
    if any(getattr(cfg, k) != v for k, v in profile.items()):
        raise AssertionError(f"trtllm_tpu config {cfg} is not its profile "
                             f"{profile}")
    return Engine(cfg, params=model)


# phase 5's four requests for a speculating engine: the streamed chat and
# the completion without logprobs (a logprobs request demotes every step
# it is live in); with VisibleTokenizer every token is still an SSE event
CHAT_STREAM_PLAIN = dict(CHAT, stream=True,
                         stream_options={"include_usage": True})
SPEC_JOBS = dict(
    FOUR_JOBS,
    chat_stream=("/v1/chat/completions", CHAT_STREAM_PLAIN, True),
    completion=("/v1/completions",
                dict(COMMON, prompt="Hopper has 132 SMs and"), False))


def spec_parity_requests(tok, greedy_only: bool = False) -> list:
    """parity_requests with its two logprobs requests cut to 8 tokens (a
    logprobs request demotes the steps it is live in); `greedy_only`
    leaves out the two sampled ones."""
    reqs = [dataclasses.replace(r, max_tokens=8) if r.logprobs is not None
            else r for r in parity_requests(tok)]
    return [r for r in reqs if not greedy_only or r.temperature == 0.0]


def sampled_gap(engine: Engine, req: GenRequest, before: list) -> float:
    """The least change of the spec-off scaled logits (the logits over the
    temperature) that changes the draw of output token len(before) of the
    sampled request `req`: the draw takes the largest of the top-k and
    top-p masked scaled logits plus its Gumbel noise at that position, so
    it changes where the top-2 gap of those closes, where the winner
    falls out of the top-p set (its distance above the set's least scaled
    logit), or where a token left out of the set whose noisy score beats
    the winner's comes in (its distance below it); the least of these.
    (A flat distribution keeps tens of thousands of tokens in the top-p
    set, thousands of them within a bf16 unit of its edge.) The logits
    come from a chunked prefill of the prompt and `before` through
    `engine` (its pool kind's chunk kernel, which reads the K/V back from
    the pool as a decode step does; pages from its allocator, freed
    after)."""
    ids = list(req.prompt_token_ids) + list(before)
    n = len(ids)
    dev = engine.device
    pages = engine.allocator.alloc(-(-n // PS))
    try:
        plist = torch.zeros((-(-n // CHUNK) * CHUNK // PS,),
                            dtype=torch.int32)
        plist[:len(pages)] = torch.tensor(pages)
        plist = plist.to(dev)
        for start in range(0, n, CHUNK):
            take = min(CHUNK, n - start)
            chunk = torch.zeros((CHUNK,), dtype=torch.long)
            chunk[:take] = torch.tensor(ids[start:start + take])
            logits = llama.prefill_chunk(
                engine.model, chunk.to(dev), start, take, engine.k_pages,
                engine.v_pages, plist, page_size=PS)
    finally:
        engine.allocator.free(pages)
    state = smp.make_state([req.temperature], [req.top_p], [req.top_k],
                           device=dev)
    scaled = logits.float()[None] / req.temperature
    masked = (smp._mask_topk_topp(scaled, state) if state.any_topk_topp
              else scaled)
    key = smp.fold_in(int(req.seed) & ((1 << 63) - 1), n - 1)
    noise = smp.gumbel(torch.tensor([key], device=dev), scaled.shape[-1])
    top = (masked + noise)[0].topk(2)
    gaps = [float(top.values[0] - top.values[1])]
    kept = torch.isfinite(masked[0])
    if not bool(kept.all()):
        edge = scaled[0][kept].min()
        win = int(top.indices[0])
        gaps.append(float(scaled[0, win] - edge))
        rivals = ~kept & ((scaled + noise)[0] > top.values[0])
        if bool(rivals.any()):
            gaps.append(float(edge - scaled[0][rivals].max()))
    return min(gaps)


def spec_summary(engine: Engine) -> dict:
    """/worker/stats' spec section of `engine`, and its verify steps."""
    return {**spec_stats(engine),
            "verify_steps": engine.metrics.spec_verify_steps,
            "decode_steps": engine.metrics.decode_steps,
            "mixed_spec_steps": engine.metrics.mixed_spec_count}


def spec_parity(reference: Engine, engines: dict, reqs, name: str) -> dict:
    """Each speculating engine's streams against the spec-off reference's
    (`reqs()` gives fresh requests), token for token; a stream that
    differs must first differ at a near-tie: a spec-off top-2 gap under
    NEAR_TIE there. The reference serves every request with 2 logprobs
    (its tokens are the same either way), so a greedy stream's gap is
    that of its own decode step's logits; a sampled one's is
    sampled_gap's. Every engine must have run verify steps, and its
    launches are kept."""
    ref = run_to_end(reference, [
        dataclasses.replace(r, logprobs=max(2, r.logprobs or 0))
        for r in reqs()])
    want = {rid: [t for t, _, _ in toks] for rid, toks in ref.items()}
    by_rid = {r.request_id: r for r in reqs()}

    def gap(rid: str, i: int) -> float:
        req = by_rid[rid]
        if i >= len(want[rid]):
            return float("inf")
        if req.temperature > 0:
            return sampled_gap(reference, req, want[rid][:i])
        top = ref[rid][i][2]
        return top[0][1] - top[1][1]

    row = {"reference": "eager 1-step, speculation off",
           "requests": len(want), "tokens": sum(map(len, want.values()))}
    for label, eng in engines.items():
        ca.reset_launch_counts()
        eng.metrics = type(eng.metrics)()
        t0 = time.monotonic()
        got = {rid: [t for t, _, _ in toks]
               for rid, toks in run_to_end(eng, reqs()).items()}
        entry = {"seconds": time.monotonic() - t0,
                 "launches": dict(ca.LAUNCHES),
                 "variants": dict(ca.VARIANT_LAUNCHES),
                 "spec": spec_summary(eng)}
        diffs = {}
        for rid, toks in want.items():
            mine = got.get(rid, [])
            i = next((j for j, (a, b) in enumerate(zip(mine, toks))
                      if a != b), min(len(mine), len(toks)))
            if mine != toks:
                diffs[rid] = {"index": i, "got": mine[i:i + 1],
                              "want": toks[i:i + 1],
                              "spec_off_top2_gap": gap(rid, i)}
        entry.update(equal=not diffs, first_differences=diffs,
                     near_tie_limit=NEAR_TIE)
        row[label] = entry
        if any(d["spec_off_top2_gap"] >= NEAR_TIE for d in diffs.values()):
            emit({name: row})
            raise AssertionError(f"{label}: streams differ from spec-off "
                                 f"where it has no near-tie: {diffs}")
        if eng.metrics.spec_verify_steps == 0:
            emit({name: row})
            raise AssertionError(f"{label}: no verify step ran")
    emit({name: row})
    return row


def serve_spec(spec_engine: Engine, window_engine: Engine) -> dict:
    """SPEC_JOBS, four concurrent requests, on the speculating engine and
    on the graph-window engine, one after the other, each through the
    server with VisibleTokenizer."""
    out = {}
    for label, eng in (("spec", spec_engine), ("graph_windows",
                                               window_engine)):
        eng.metrics = type(eng.metrics)()
        results = {}
        with serving(eng, VisibleTokenizer()) as base:
            ca.reset_launch_counts()

            def run(job):
                path, body, stream = SPEC_JOBS[job]
                results[job] = post(base + path, body, stream)

            threads = [threading.Thread(target=run, args=(j,))
                       for j in SPEC_JOBS]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            launches = dict(ca.LAUNCHES)
            variants = dict(ca.VARIANT_LAUNCHES)
            worker = stats(base)
        out[label] = {"requests": {j: summarize(j, results[j],
                                                SPEC_JOBS[j][2])
                                   for j in SPEC_JOBS},
                      "launches": launches, "variants": variants,
                      "engine_metrics": worker["metrics"]}
        if label == "spec":
            out[label]["spec"] = worker["spec"]
            m = spec_engine.metrics
            out[label]["tokens_per_verify_step_per_slot"] = (
                1 + m.spec_accept_sum / m.spec_accept_count
                if m.spec_accept_count else "no speculating slot")
            if worker["spec"]["verify_graphs"]["replays"] == 0:
                raise AssertionError(f"serve_spec: no verify graph replay: "
                                     f"{worker['spec']}")
    return out


def mixed_spec_serve(engine: Engine) -> dict:
    """The interference traffic on a speculating mixed engine, the stream
    without logprobs: the long prompt's chunks must ride mixed verify
    steps, each one ragged launch per layer with the chunk."""
    sfx = "_int8" if engine.kv_spec.quantized else ""
    with serving(engine, VisibleTokenizer()) as base:
        ca.reset_launch_counts()
        traffic = interference(base, CHAT_STREAM_PLAIN,
                               model=engine.cfg.model)
        launches = dict(ca.LAUNCHES)
        variants = dict(ca.VARIANT_LAUNCHES)
        worker = stats(base)
    n = engine.metrics.mixed_spec_count
    with_chunk = variants.get(
        f"ragged{sfx}[decode_q={SPEC_K + 1},chunk]", 0)
    layers = engine.model_cfg.num_layers
    if n == 0 or with_chunk != layers * n:
        raise AssertionError(f"mixed spec ({engine.kv_spec.dtype} pools): "
                             f"{n} mixed verify steps, {with_chunk} ragged "
                             f"launches with the chunk ({variants})")
    return {"kv_cache": worker["kv_cache"], "mixed_spec_steps": n,
            "requests": traffic, "spec": worker["spec"],
            "launches": launches, "variants": variants}


def draft_step_times(draft) -> dict:
    """The draft model's B=1 step: device and call time of a replay of its
    graph, call time of the eager step, over the trash page from position
    0 (the capture's warm-up state; the engine is idle)."""

    def reset():
        draft.cursor.zero_()
        draft.table.zero_()
        draft.n_known.fill_(draft.feed.shape[0])

    graph = draft._graph if draft._graph is not None else draft.capture()
    reset()
    dev_ms = device_ms(graph.graph.replay, 20)
    reset()
    call_ms = time_ms(graph.graph.replay, 20)
    reset()
    with torch.inference_mode():
        eager_ms = time_ms(draft._body, 5)
    reset()
    return {"graph_device_ms": dev_ms, "graph_call_ms": call_ms,
            "eager_call_ms": eager_ms,
            "draft_layers": draft.model_cfg.num_layers,
            "draft_head_dim": draft.model_cfg.head_dim}


def soft_attention(model):
    """`model`'s weights with wq scaled by Q_SCALE (exact in bf16), every
    other tensor shared: attention scores of deviation near 2 instead of
    30 (see phase 12 in the module doc)."""
    twin = type(model)(model.cfg, "meta", model.dtype)
    src = dict(model.named_modules())
    for path, mod in twin.named_modules():
        for name, p in src[path].named_parameters(recurse=False):
            if name == "wq":
                p = torch.nn.Parameter(p.detach() * Q_SCALE,
                                       requires_grad=False)
            setattr(mod, name, p)
    return twin


def batch_shape_noise(engine: Engine, models: dict,
                      steps: int = 12) -> dict:
    """Per weight set: a greedy chain of `steps` decode states after a
    chat prompt (prefilled through `engine`'s pools, pages freed after),
    each state's logits from an 8-row decode step (the chain's), a
    40-row one and the verify step's row 0 (8 windows of K+1): the max
    |difference| from the 8-row logits, how many states change their
    argmax, and whether the verify row equals the 40-row step bit for
    bit. The other rows sit on the trash page."""
    dev, width = engine.device, MAX_SEQ_LEN // PS
    prompt = get_tokenizer(MODEL).encode("Port this kernel to Hopper.")
    out = {}
    for label, model in models.items():
        pages = engine.allocator.alloc(-(-(len(prompt) + steps) // PS))
        try:
            page_t = torch.tensor(pages, dtype=torch.int32, device=dev)
            tokens = torch.zeros((-(-len(prompt) // PS) * PS,),
                                 dtype=torch.long)
            tokens[:len(prompt)] = torch.tensor(prompt)
            t = int(llama.prefill(
                model, tokens.to(dev), len(prompt), engine.k_pages,
                engine.v_pages, page_t[:len(tokens) // PS],
                page_size=PS).argmax())
            row = {"max_abs_diff_40_rows": 0.0, "max_abs_diff_verify": 0.0,
                   "argmax_changes_40_rows": 0,
                   "verify_equals_40_rows": True, "logit_std": 0.0,
                   "states": steps}
            for i in range(steps):
                pos = len(prompt) + i

                def rows(b):
                    tok = torch.zeros((b,), dtype=torch.long, device=dev)
                    p = torch.zeros((b,), dtype=torch.int32, device=dev)
                    tab = torch.zeros((b, width), dtype=torch.int32,
                                      device=dev)
                    tok[0], p[0] = t, pos
                    tab[0, :len(pages)] = page_t
                    return tok, p, tab

                def decode(b):
                    tok, p, tab = rows(b)
                    return llama.decode_step(
                        model, tok, p, tab, p + 1, engine.k_pages,
                        engine.v_pages, page_size=PS)[0].float()

                d40 = decode(40)
                tok, p, tab = rows(MAX_SEQS)
                window = torch.zeros((MAX_SEQS, SPEC_K + 1),
                                     dtype=torch.long, device=dev)
                window[0, 0] = t
                ver = llama.decode_verify(
                    model, window, p, tab,
                    torch.zeros((MAX_SEQS,), dtype=torch.bool, device=dev),
                    engine.k_pages, engine.v_pages,
                    page_size=PS)[0, 0].float()
                d8 = decode(MAX_SEQS)  # last: the chain's KV is its own
                row["max_abs_diff_40_rows"] = max(
                    row["max_abs_diff_40_rows"],
                    float((d40 - d8).abs().max()))
                row["max_abs_diff_verify"] = max(
                    row["max_abs_diff_verify"], float((ver - d8).abs().max()))
                row["argmax_changes_40_rows"] += int(d40.argmax()
                                                     != d8.argmax())
                row["verify_equals_40_rows"] &= torch.equal(ver, d40)
                row["logit_std"] = max(row["logit_std"], float(d8.std()))
                t = int(d8.argmax())
        finally:
            engine.allocator.free(pages)
        out[label] = row
    emit({"phase": "batch_shape_noise", **out})
    return out


def spec_phases(engine: Engine, eager_cfg: dict, jet_cfg: dict,
                tok) -> dict:
    """Phase 12 (see the module doc): -> {"launches": [each served phase's
    LAUNCHES], "variants": [... VARIANT_LAUNCHES], "profiles": [...]}."""
    spec = dict(speculative_mode="ngram", num_speculative_tokens=SPEC_K)
    ref_cfg = dict(eager_cfg, prefill_chunk_tokens=0)
    phases = []
    model = soft_attention(engine.model)
    with torch.inference_mode():
        batch_shape_noise(engine, {"as_drawn": engine.model,
                                   "wq_scaled": model})

    def warm(name, eng):
        t0 = time.monotonic()
        eng.warmup()
        emit({"phase": "warmup", "engine": name,
              "seconds": time.monotonic() - t0,
              "verify_graphs": eng.verify.stats(),
              "draft": eng.draft.stats() if eng.draft is not None else None})

    # (a), (b), (c) on bf16 pools
    reference = Engine(EngineConfig(**ref_cfg), params=model)
    jet_spec = Engine(EngineConfig(**jet_cfg, **spec), params=model)
    warm("jetstream_spec", jet_spec)
    row = spec_parity(reference, {"jetstream_spec": jet_spec},
                      lambda: spec_parity_requests(tok), "spec_parity")
    phases.append(row["jetstream_spec"])
    st = row["jetstream_spec"]["spec"]
    if not (st["demotions"].get("logprobs") and st["verify_graphs"]["replays"]
            and row["jetstream_spec"]["variants"].get(
                f"ragged[decode_q={SPEC_K + 1},no_chunk]")):
        raise AssertionError(f"spec_parity: no logprobs demotion, graph "
                             f"replay or verify launch: {row}")
    window_engine = Engine(EngineConfig(**jet_cfg), params=model)
    window_engine.warmup()
    served = serve_spec(jet_spec, window_engine)
    del window_engine
    emit({"phase": "serve_spec", **served})
    phases.append(served["spec"])
    emit({"phase": "itl_spec_vs_graph_windows",
          "spec": served["spec"]["requests"]["chat_stream"],
          "graph_windows": served["graph_windows"]["requests"]["chat_stream"],
          "acceptance_rate": served["spec"]["spec"]["acceptance_rate"],
          "tokens_per_verify_step_per_slot":
              served["spec"]["tokens_per_verify_step_per_slot"]})
    eager_spec = Engine(EngineConfig(**ref_cfg, **spec), params=model)
    profiles = []
    with torch.inference_mode():
        for eng, steps in ((jet_spec, 4), (eager_spec, 10)):
            prof = profile_steps(eng, steps)
            emit({"phase": "profile", "weights": "none", **prof})
            profiles.append(prof)
    del eager_spec, jet_spec
    torch.cuda.empty_cache()

    # (d) int8 pools
    reference8 = Engine(EngineConfig(**ref_cfg, kv_cache_dtype="int8"),
                        params=model)
    jet_spec8 = Engine(EngineConfig(**jet_cfg, **spec, kv_cache_dtype="int8"),
                       params=model)
    warm("jetstream_spec_int8", jet_spec8)
    row = spec_parity(reference8, {"jetstream_spec_int8": jet_spec8},
                      lambda: spec_parity_requests(tok), "spec_parity_int8")
    phases.append(row["jetstream_spec_int8"])
    if not row["jetstream_spec_int8"]["variants"].get(
            f"ragged_int8[decode_q={SPEC_K + 1},no_chunk]"):
        raise AssertionError(f"spec_parity_int8: no ragged_int8 verify "
                             f"launch: {row}")
    del reference8, jet_spec8
    torch.cuda.empty_cache()

    # (e) the mixed verify step, bf16 and int8 pools
    for kv in ("auto", "int8"):
        eng = Engine(EngineConfig(**jet_cfg, **spec, kv_cache_dtype=kv,
                                  mixed_batch_tokens=CHUNK),
                     params=model)
        warm(f"mixed_spec_{kv}", eng)
        out = mixed_spec_serve(eng)
        emit({"phase": "serve_mixed_spec", **out})
        phases.append(out)
        del eng
        torch.cuda.empty_cache()

    # (f) the model drafter: the 8B drafting for itself, then the 1B
    selfd = Engine(EngineConfig(**jet_cfg, **spec, drafter="model",
                                draft_model=MODEL),
                   params=model, draft_params=model)
    warm("self_draft", selfd)
    row = spec_parity(reference, {"self_draft": selfd},
                      lambda: spec_parity_requests(tok, greedy_only=True),
                      "spec_parity_self_draft")
    phases.append(row["self_draft"])
    m = selfd.metrics
    accept = m.spec_accepted_tokens / max(m.spec_draft_tokens, 1)
    emit({"phase": "self_draft_acceptance", "acceptance_rate": accept,
          "limit": SELF_DRAFT_ACCEPT, "drafted": m.spec_draft_tokens,
          "accepted": m.spec_accepted_tokens,
          "draft_engine": selfd.draft.stats()})
    if accept < SELF_DRAFT_ACCEPT:
        raise AssertionError(f"self-draft acceptance {accept} < "
                             f"{SELF_DRAFT_ACCEPT}")
    del selfd
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    small = Engine(EngineConfig(**jet_cfg, **spec, drafter="model",
                                draft_model=DRAFT_MODEL),
                   params=model)
    emit({"phase": "draft_model", "model": DRAFT_MODEL,
          "seconds": time.monotonic() - t0,
          "weights_gib": quant.param_bytes(small.draft.model) / 2**30,
          "pool_pages": small.draft.num_pages})
    warm("draft_1b", small)
    row = spec_parity(reference, {"draft_1b": small},
                      lambda: spec_parity_requests(tok), "spec_parity_draft")
    phases.append(row["draft_1b"])
    if not row["draft_1b"]["variants"].get(f"decode[head_dim={DRAFT_D}]"):
        raise AssertionError(f"the 1B drafter never launched decode at "
                             f"head_dim {DRAFT_D}: {row}")
    emit({"phase": "draft_step", "model": DRAFT_MODEL,
          "draft_steps": small.draft.steps,
          "acceptance_rate": row["draft_1b"]["spec"]["acceptance_rate"],
          **draft_step_times(small.draft)})
    del small, reference
    torch.cuda.empty_cache()
    return {"launches": [p["launches"] for p in phases],
            "variants": [p["variants"] for p in phases],
            "profiles": profiles}


# ------------------------------------------------------------- phase 14 --


def grammar_table(v: int, seed: int) -> json_guide.VocabTable:
    """A synthetic 16-byte-wide vocab table made from `seed`: pieces of
    1-16 bytes (most of 1-3), 85% drawn from JSON's alphabet and the rest
    from any printable byte, 400 specials without bytes and 3 stop ids."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b'{}[]",:0123456789-.eE+tfnrulas \\/\n\t',
                          np.uint8)
    lens = rng.integers(1, 17, size=v)
    lens = np.where(rng.random(v) < 0.7, np.minimum(lens, 3), lens)
    json_bytes = alpha[rng.integers(0, len(alpha), size=(v, 16))]
    any_bytes = rng.integers(32, 256, size=(v, 16))
    tb = np.where(rng.random((v, 1)) < 0.85, json_bytes, any_bytes)
    tb = np.where(np.arange(16)[None] < lens[:, None], tb, -1)
    special = rng.choice(v, 403, replace=False)
    lens[special] = 0
    eos = np.zeros(v, bool)
    eos[special[:3]] = True
    return json_guide.VocabTable(tb.astype(np.int32), lens.astype(np.int32),
                                 eos)


def json_transitions(mode, depth, bits, active, table) -> int:
    """Byte transitions json_mask's threads make on these rows: each
    active row that is not complete folds each token with bytes that is
    not a stop token, one transition per byte until its length or the
    first that kills the automaton."""
    done = (mode == json_guide.AFTER_VALUE) & (depth == 0)
    rows = (active.bool() & ~done)[:, None]
    alive = rows & (table.token_len > 0)[None] & (table.eos == 0)[None]
    m, d, b = (t[:, None].expand(-1, table.vocab_size)
               for t in (mode, depth, bits))
    count = 0
    for i in range(json_guide.TABLE_WIDTH):
        run = alive & (i < table.token_len)[None]
        count += int(run.sum())
        m, d, b = json_guide.transition_torch(
            m, d, b, table.token_bytes[:, i].to(torch.int32)[None])
        alive = run & (m != json_guide.DEAD)
    return count


def grammar_kernel_checks(dev) -> dict:
    """Phase 14's kernel rows (see the module doc): json_mask and
    json_advance against their plain versions, exactly, on every mode at
    depths 0, 1, 5 and 31, then timed on one mixed batch."""
    b, v = MAX_SEQS, 128256
    t0 = time.monotonic()
    table = json_guide.DeviceTable(grammar_table(v, 0), dev)
    build_s = time.monotonic() - t0
    rng = np.random.default_rng(3)
    n_modes = json_guide.DEAD + 1
    states, checked = [], 0
    for depth in (0, 1, 5, 31):
        for m0 in range(0, n_modes, b):
            modes = (np.arange(m0, m0 + b) % n_modes).astype(np.int32)
            states.append((modes, np.full(b, depth, np.int32),
                           rng.integers(-2**31, 2**31, b).astype(np.int32),
                           rng.random(b) < 0.8))
    for mode, depth, bits, active in states:
        st = [torch.tensor(a, device=dev) for a in (mode, depth, bits)]
        act = torch.tensor(active, device=dev)
        logits = torch.randn(b, v, device=dev).to(torch.bfloat16)
        got, want = logits.clone(), logits.clone()
        cuda_guide.json_mask(got, *st, act, table)
        json_guide.mask_logits(want, *st, act, table)
        tokens = torch.tensor(rng.integers(0, v, b), device=dev)
        got_st = [t.clone() for t in st]
        want_st = [t.clone() for t in st]
        cuda_guide.json_advance(tokens, *got_st, act, table)
        json_guide.advance(tokens, *want_st, act, table)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and all(
                torch.equal(x, y) for x, y in zip(got_st, want_st))):
            raise AssertionError(f"the grammar kernel differs from its "
                                 f"plain version at modes {mode}, depth "
                                 f"{depth[0]}")
        checked += 1
    # a batch as a guided step sees it: the modes a JSON object passes
    # through, inside one container, every row guided
    mode = torch.tensor([json_guide.OBJ_KEY_OR_END, json_guide.STR_K,
                         json_guide.AFTER_KEY, json_guide.VALUE,
                         json_guide.STR_V, json_guide.NM_INT,
                         json_guide.AFTER_VALUE, json_guide.ARR_VAL_OR_END],
                        dtype=torch.int32, device=dev)
    depth = torch.tensor([1, 1, 1, 1, 1, 2, 2, 2], dtype=torch.int32,
                         device=dev)
    bits = torch.tensor([0, 0, 0, 0, 0, 2, 2, 2], dtype=torch.int32,
                        device=dev)
    act = torch.ones(b, dtype=torch.bool, device=dev)
    logits = torch.randn(b, v, device=dev).to(torch.bfloat16)
    out = logits.clone()
    cuda_guide.json_mask(out, mode, depth, bits, act, table)
    masked = int((out != logits).sum())
    trans = json_transitions(mode, depth, bits, act, table)
    table_bytes = v * (json_guide.TABLE_WIDTH + 4 + 1)
    tokens = torch.tensor(rng.integers(0, v, b), device=dev)
    adv_len = int(table.token_len[tokens].sum())
    usage = ptxas_usage(ca.build_log).get("json_mask.cu", {})

    def row(name, kernel, plain, nbytes, ops, shapes):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        r = {"name": name, "shapes": shapes, "max_abs_err": 0.0,
             "tolerance": "exact (integers and the -1e9 writes)",
             "kernel_ms": device_ms(kernel, 20),
             "kernel_call_ms": time_ms(kernel, 20),
             "plain_ms": time_ms(plain, 1, 3),
             "plain_timing": "call time (the plain version is hundreds of "
                             "small ops, host-bound)",
             "library_ms": None, "library_call_ms": None,
             "bytes": nbytes, "int_ops": ops, "bytes_ms": t_bytes,
             "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "ops_per_byte_transition": JSON_OPS_PER_BYTE,
             "ops_per_byte_basis": "estimate from the source, not counted "
                                   "from SASS",
             "int32_ops_per_s": INT32_OPS_PER_S, "ptxas": usage}
        emit({"kernel_check": r})
        return r

    st = (mode, depth, bits)
    mask_row = row(
        "json_mask", lambda: cuda_guide.json_mask(out, *st, act, table),
        lambda: json_guide.mask_logits(out, *st, act, table),
        table_bytes + b * 13 + 2 * masked, trans * JSON_OPS_PER_BYTE,
        {"B": b, "V": v, "width": json_guide.TABLE_WIDTH,
         "masked": masked, "transitions": trans,
         "states_checked": checked * b, "table_build_s": build_s})
    st_k = [t.clone() for t in st]
    st_p = [t.clone() for t in st]
    adv_row = row(
        "json_advance",
        lambda: cuda_guide.json_advance(tokens, *st_k, act, table),
        lambda: json_guide.advance(tokens, *st_p, act, table),
        b * (8 + 1 + 2 * 12) + b * (json_guide.TABLE_WIDTH + 4),
        adv_len * JSON_OPS_PER_BYTE, {"B": b, "bytes_folded": adv_len})
    return {"json_mask": mask_row, "json_advance": adv_row}


GUIDED = {"response_format": {"type": "json_object"}}
JSON_CHAT = dict(COMMON, max_tokens=64, temperature=1.0, ignore_eos=False,
                 messages=[{"role": "user",
                            "content": "Describe the H100 as JSON."}],
                 **GUIDED)
TOOLS = [{"type": "function", "function": {
    "name": "lookup", "description": "Look a kernel up.",
    "parameters": {"type": "object"}}}]
# random weights seldom close an object: the forced call's logit_bias
# favours '"' (34), ':' (58) and '}' (125), so the grammar writes a short
# object, {"":""} with whitespace where the weights prefer it
TOOL_CHAT = dict(COMMON, max_tokens=64, ignore_eos=False, tools=TOOLS,
                 tool_choice={"type": "function",
                              "function": {"name": "lookup"}},
                 logit_bias={"34": 100, "58": 90, "125": 80},
                 messages=[{"role": "user", "content": "Look up decode."}])
# the profiled steps: '}' banned, so no object completes and every step
# folds the full vocabulary
NO_CLOSE = {"logit_bias": {125: -100.0}}


def json_prefix_state(text: str) -> tuple:
    """The grammar's state after `text`'s UTF-8 bytes from the start of an
    object (DEAD once a byte breaks it): a guided choice's text, whatever
    ended it, must never reach DEAD."""
    state = (json_guide.START, 0, 0)
    for c in text.encode("utf-8"):
        state = json_guide.transition_scalar(*state, c)
        if state[0] == json_guide.DEAD:
            break
    return state


def guided_phases(engine: Engine, jet_cfg: dict) -> dict:
    """Phase 14's serving and profiles on the 8B (see the module doc)."""
    jet = Engine(EngineConfig(**jet_cfg), params=engine.model)
    t0 = time.monotonic()
    jet.warmup()
    emit({"phase": "warmup", "engine": "jetstream_guided",
          "seconds": time.monotonic() - t0, **jet.windows.stats()})
    if jet.windows.stats()["graphs"] != 4:
        raise AssertionError("warmup did not capture the guided graphs")
    jobs = {f"json{i}": dict(JSON_CHAT, seed=100 + i) for i in range(4)}
    jobs["json_greedy"] = dict(JSON_CHAT, temperature=0.0)
    results = {}
    with serving(jet) as base:
        ca.reset_launch_counts()
        win0 = jet.windows.stats()

        def run(name):
            results[name] = post(base + "/v1/chat/completions", jobs[name],
                                 False)

        threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        tool = post(base + "/v1/chat/completions", TOOL_CHAT, False)
        launches = dict(ca.LAUNCHES)
        worker = stats(base)
    replays = jet.windows.stats()["replays"] - win0["replays"]
    choices = {}
    for name, (status, payload, _, total) in results.items():
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status}")
        c = payload["choices"][0]
        text, finish = c["message"]["content"], c["finish_reason"]
        state = json_prefix_state(text)
        if state[0] == json_guide.DEAD:
            raise AssertionError(f"{name} ({finish}): {text!r} is no JSON "
                                 f"object's prefix")
        parsed = None
        if finish == "stop":
            parsed = json.loads(text)
            if not isinstance(parsed, dict):
                raise AssertionError(f"{name}: {text!r} is no JSON object")
        choices[name] = {"finish_reason": finish, "text": text[:120],
                         "completion_tokens":
                             payload["usage"]["completion_tokens"],
                         "parsed": parsed is not None,
                         "prefix_state": state, "seconds": total}
    status, payload, _, _ = tool
    call = payload["choices"][0]
    args = (call["message"]["tool_calls"][0]["function"]["arguments"]
            if status == 200 and call["finish_reason"] == "tool_calls"
            else None)
    if (args is None or json_prefix_state(args)[0] == json_guide.DEAD
            or not isinstance(json.loads(args), dict)):
        raise AssertionError(f"forced tool call: {payload}")
    # json_mask also masks each guided first token on the prefill logits
    if launches["json_advance"] == 0 or replays == 0 \
            or launches["json_mask"] <= launches["json_advance"] \
            or launches["decode"] == 0:
        raise AssertionError(f"guided serving: {replays} graph replays, "
                             f"launches {launches}")
    row = {"choices": choices,
           "stopped": sum(c["finish_reason"] == "stop"
                          for c in choices.values()),
           "tool_call": call["message"]["tool_calls"][0]["function"],
           "graph_replays": replays, "launches": launches,
           "decode_graphs": worker["decode_graphs"],
           "engine_metrics": worker["metrics"]}
    emit({"phase": "serve_guided", **row})
    with torch.inference_mode():
        for label, kw in (("decode, guided", dict(NO_CLOSE,
                                                  guided_json=True)),
                          ("decode", NO_CLOSE)):
            emit({"phase": "profile", "weights": "none",
                  **profile_steps(jet, 4, request_kw=lambda i, kw=kw: kw,
                                  label=label)})
    del jet
    release()
    return row


# ------------------------------------------------------------- phase 15 --


def adapter_tensors(cfg, name: str) -> dict:
    """The random rank-16 adapter `name` (ada, bob, cat: seeds 1-3)."""
    return lora_apply.random_adapter(cfg, LORA_RANK,
                                     seed=("ada", "bob", "cat").index(name)
                                     + 1, scale=LORA_SCALE)


def write_adapters(cfg, tmp: str) -> dict:
    """The three adapters at the model's widths: two as adapter.npz, the
    third as HF-PEFT safetensors -> {name: dir}."""
    from safetensors.numpy import save_file

    out = {}
    for name in ("ada", "bob", "cat"):
        tensors = adapter_tensors(cfg, name)
        path = os.path.join(tmp, name)
        if name != "cat":
            lora_registry.save_adapter_npz(path, tensors, LORA_RANK)
        else:
            os.makedirs(path)
            peft = {}
            for t in lora_apply.TARGETS:
                for li in range(cfg.num_layers):
                    pre = f"base_model.model.model.layers.{li}.self_attn." \
                          f"{t}_proj"
                    peft[f"{pre}.lora_A.weight"] = np.ascontiguousarray(
                        tensors[t + "a"][li].T)
                    peft[f"{pre}.lora_B.weight"] = np.ascontiguousarray(
                        tensors[t + "b"][li].T)
            save_file(peft, os.path.join(path, "adapter_model.safetensors"))
            with open(os.path.join(path, "adapter_config.json"), "w") as f:
                json.dump({"r": LORA_RANK, "lora_alpha": LORA_RANK}, f)
        out[name] = path
    return out


def lora_requests(tok, adapters) -> list:
    """Greedy requests of 32 tokens, `lora<i>` under adapters[i] (None:
    the base)."""
    texts = ("Port this kernel to Hopper.", "Hopper has 132 SMs and",
             "Sample a poem about split keys.", "The trash page is",
             LONG_TEXT[:200], "Adapters share one base.")
    return [GenRequest(f"lora{i}", tok.encode(texts[i]),
                       max_tokens=MAX_TOKENS, ignore_eos=True, adapter=a)
            for i, a in enumerate(adapters)]


def lora_phases(engine: Engine, eager_cfg: dict, jet_cfg: dict,
                tok) -> dict:
    """Phase 15 (see the module doc) -> {"launches": [...]}."""
    lcfg = dict(lora_slots=LORA_SLOTS, lora_rank=LORA_RANK)
    phases = []
    with tempfile.TemporaryDirectory(prefix="dtt_lora_") as tmp:
        t0 = time.monotonic()
        paths = write_adapters(engine.model_cfg, tmp)
        boot = f"ada={paths['ada']},bob={paths['bob']}"
        jet = Engine(EngineConfig(**jet_cfg, **lcfg, lora_adapters=boot),
                     params=engine.model)
        emit({"phase": "lora_engine", "seconds": time.monotonic() - t0,
              "stack_bytes": jet.lora.stacks.nbytes,
              "bytes_per_slot": jet.lora.stacks.nbytes // (LORA_SLOTS + 1),
              "registered": jet.lora.names()})
        t0 = time.monotonic()
        jet.warmup()
        emit({"phase": "warmup", "engine": "jetstream_lora",
              "seconds": time.monotonic() - t0, **jet.windows.stats()})
        models = [MODEL, f"{MODEL}:ada", f"{MODEL}:cat"] * 2
        results = {}
        with serving(jet) as base:
            added = post(base + "/v1/adapters", {
                "name": "cat", "path": paths["cat"], "load": True}, False)
            listed = json.loads(urllib.request.urlopen(
                base + "/v1/models", timeout=30).read())
            ca.reset_launch_counts()
            win0 = jet.windows.stats()

            def run(i):
                results[i] = post(base + "/v1/completions", dict(
                    COMMON, model=models[i],
                    prompt=f"Adapter {i} on the port:"), False)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(models))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            launches = dict(ca.LAUNCHES)
            worker = stats(base)
        replays = jet.windows.stats()["replays"] - win0["replays"]
        ids = {m["id"] for m in listed["data"]}
        texts = {i: r[1]["choices"][0]["text"] for i, r in results.items()
                 if r[0] == 200}
        if (added[0] != 200 or not added[1]["resident"]
                or ids != {MODEL, *(f"{MODEL}:{n}" for n in paths)}
                or len(texts) != len(models)
                or replays == 0
                or any(launches[k] == 0 for k in ("decode", "prefill"))):
            raise AssertionError(f"LoRA serving: {added[1]}, {ids}, "
                                 f"{replays} replays, {launches}")
        served = {"adapter_post": added[1], "models": sorted(ids),
                  "requests": len(texts), "graph_replays": replays,
                  "launches": launches, "lora": worker["lora"]}
        emit({"phase": "serve_lora", **served})
        phases.append(served)

        # base-slot streams against lora_slots=0 over the same batch
        # shapes (the adapters' rows there run as base rows)
        adapters = [None, "ada", "cat", None, "bob", "ada"]
        ca.reset_launch_counts()
        got = run_to_end(jet, lora_requests(tok, adapters))
        phases.append({"launches": dict(ca.LAUNCHES)})
        base_eng = Engine(EngineConfig(**jet_cfg), params=engine.model)
        base_eng.warmup()
        want = run_to_end(base_eng, lora_requests(tok, [None] * 6))
        same = {f"lora{i}": got[f"lora{i}"] == want[f"lora{i}"]
                for i in range(len(adapters))}
        bad = [rid for i, (rid, eq) in enumerate(same.items())
               if (adapters[i] is None) != eq]
        row = {"equal_to_lora_off": same, "adapters": adapters}
        emit({"phase": "lora_base_slot_parity", **row})
        if bad:
            raise AssertionError(f"base streams must equal lora_slots=0 and "
                                 f"adapter streams differ: {bad}")
        with torch.inference_mode():
            forward_checks(jet, adapter_slot=jet.lora.slot_of("ada"))
            for label, eng, kw in (
                    ("decode, 3 adapters", jet,
                     lambda i: {"adapter": (None, "ada", "bob",
                                            "cat")[i % 4]}),
                    ("decode, base only, lora_slots=4", jet, None),
                    ("decode, lora_slots=0", base_eng, None)):
                emit({"phase": "profile", "weights": "none",
                      **profile_steps(eng, 4, request_kw=kw, label=label)})
        del jet, base_eng
        release()

        # an adapter's greedy stream with n-gram speculation, on phase
        # 12's softened weights: wq and the adapters' q deltas (B of q)
        # scaled by Q_SCALE, so that q is scaled as a whole
        model = soft_attention(engine.model)
        ref = Engine(EngineConfig(**dict(eager_cfg, prefill_chunk_tokens=0),
                                  **lcfg), params=model)
        spec = Engine(EngineConfig(**jet_cfg, **lcfg,
                                   speculative_mode="ngram",
                                   num_speculative_tokens=SPEC_K),
                      params=model)
        for name in ("ada", "bob"):
            soft = adapter_tensors(engine.model_cfg, name)
            soft["qb"] = soft["qb"] * Q_SCALE
            for eng in (ref, spec):
                eng.lora.register(name, tensors=soft, rank=LORA_RANK)
        spec.warmup()
        reqs = lambda: lora_requests(tok, ["ada", "bob", None])  # noqa
        row = spec_parity(ref, {"lora_spec": spec}, reqs, "lora_spec_parity")
        phases.append(row["lora_spec"])
        if all(rid in row["lora_spec"]["first_differences"]
               for rid in ("lora0", "lora1")):
            raise AssertionError("no adapter's greedy stream is the same "
                                 "with speculation as without it")
        del ref, spec, model, eng
        release()
    return {"launches": [p["launches"] for p in phases]}


# Phase 13: the new families at full width and depth, random bf16 weights
# from seed 0, after the 8B's engines and weights are released: (model,
# the pools of its int8 forward check and its mixed engines, whether its
# graph-window decode step is profiled)
FAMILY_MODELS = (
    ("gemma-7b-it", ("auto", "int8"), True),
    ("qwen2.5-7b-instruct", ("auto",), True),
    ("qwen3-0.6b", (), False),
)
# Phase 13's MLA model, last: its pools hold one latent row of 640 lanes
# (576 padded), so every kernel runs at head_dim 640 and group 16
MLA_MODEL = "deepseek-v2-lite"
# the kernels line's rows at those shapes: (phase 3 label, kernel, the
# model whose served phases count its launches, the launch count's key: a
# variant, or at group 7 every launch of the kernel in qwen2.5's phases)
FAMILY_ROWS = (
    [("head_dim=256", k, "gemma-7b-it", f"{k}[head_dim=256]")
     for k in ("decode", "decode_int8", "prefill", "chunk", "chunk_int8",
               "ragged", "ragged_int8")]
    + [("group=7", k, "qwen2.5-7b-instruct", k)
       for k in ("decode", "prefill", "chunk", "ragged")]
    + [("group=8", k, "qwen3-30b-a3b", k)
       for k in ("decode", "prefill", "chunk", "ragged")]
    + [("head_dim=640,group=16", k, MLA_MODEL, key)
       for k, key in (
           ("decode", "decode[head_dim=640]"),
           ("decode_int8", "decode_int8[head_dim=640]"),
           ("prefill", "prefill[head_dim=640]"),
           ("chunk", "chunk[head_dim=640]"),
           ("chunk_int8", "chunk_int8[head_dim=640]"),
           ("ragged", "ragged[decode_q=1,chunk]"),
           ("ragged_int8", "ragged_int8[decode_q=1,chunk]"),
           ("ragged_verify", VARIANTS["ragged_verify"]),
           ("ragged_verify_only", VARIANTS["ragged_verify_only"]),
           ("ragged_int8_verify", VARIANTS["ragged_int8_verify"]),
           ("ragged_int8_verify_only",
            VARIANTS["ragged_int8_verify_only"]))])
# Phase 13's mixture-of-experts models, after the families: (model, its
# weights' quantization, whether a mixed engine serves it and its
# prompt's TTFT is taken with the capacity path off and on)
# (model, weights, mixed, layers served: the depth cut that pays for
# phase 21; `--moe full` serves every layer)
MOE_MODELS = (
    ("qwen3-30b-a3b", "none", True, 12),
    ("mixtral-8x7b-instruct-v0.1", "w8a8", False, 8),
)
MOE_CAPACITY = 1.25


def release() -> None:
    """Free what deleted engines held (an engine and its graphs reference
    each other, so only the cycle collector frees them)."""
    gc.collect()
    torch.cuda.empty_cache()


def family_phase(model: str, pools, profiled: bool, eager_cfg: dict,
                 jet_cfg: dict) -> dict:
    """Phase 13 for one model (see the module doc): -> {"launches": [each
    served phase's LAUNCHES], "variants": [... VARIANT_LAUNCHES],
    "peak_gib": the phase's peak device memory}."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    base = dict(eager_cfg, model=model)
    engine = Engine(EngineConfig(**base))
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    emit({"phase": "family_engine", "model": model,
          "seconds": time.monotonic() - t0, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "features": {k: getattr(cfg, k) for k in (
              "attention_bias", "qk_norm", "hidden_act",
              "rms_norm_unit_offset", "embed_scale", "tie_word_embeddings")},
          "params": loader.num_params(cfg),
          "weights_gib": quant.param_bytes(engine.model) / 2**30,
          "kv_pool_gib": engine.kv_spec.pool_bytes / 2**30})
    with torch.inference_mode():
        forward_checks(engine)
        if "int8" in pools:
            eng8 = Engine(EngineConfig(**base, kv_cache_dtype="int8"),
                          params=engine.model)
            forward_checks(eng8)
            del eng8
            release()
    served = []
    jet = Engine(EngineConfig(**dict(jet_cfg, model=model)),
                 params=engine.model)
    t0 = time.monotonic()
    jet.warmup()
    emit({"phase": "warmup", "engine": f"jetstream {model}",
          "seconds": time.monotonic() - t0, **jet.windows.stats()})
    row = window_serve(jet)
    emit({"phase": "family_serve_windows", "model": model, **row})
    served.append(row)
    if profiled:
        with torch.inference_mode():
            emit({"phase": "profile", "model": model, "weights": "none",
                  **profile_steps(jet, 4)})
    del jet
    release()
    for kv in pools:
        mixed = Engine(EngineConfig(**base, mixed_batch_tokens=CHUNK,
                                    kv_cache_dtype=kv), params=engine.model)
        row = mixed_serve_checks(mixed)
        emit({"phase": "family_serve_mixed", "model": model, **row})
        served.append(row)
        del mixed
        release()
    del engine
    release()
    return {"launches": [r["launches"] for r in served],
            "variants": [r["variants"] for r in served],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def moe_block_ms(engine: Engine) -> float:
    """Device time of one decode step's MoE blocks: `_mlp` of every layer
    on 8 rows (the routing, the dense dispatch over every expert, the
    combine), captured as one CUDA graph (as the decode step is) and its
    replays timed with CUDA events: the host launches ~15 kernels a layer,
    more than the sleep of device_ms covers. The dense path's time does
    not depend on the rows' values."""
    model, cfg = engine.model, engine.model_cfg
    g = torch.Generator(device=engine.device)
    g.manual_seed(3)
    h = torch.randn((MAX_SEQS, cfg.hidden_size), generator=g,
                    device=engine.device).to(model.dtype)

    def blocks():
        for layer in model.layers:
            llama._mlp(cfg, layer, h)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        blocks()  # warm up: cuBLAS's workspaces, the allocator's blocks
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with decode_graphs.capturing(graph, stream):
        blocks()
    return time_ms(graph.replay, 5)


def capacity_ttft(engine: Engine, eager_cfg: dict) -> dict:
    """TTFT of the ~600-token prompt as one prefill (a 1024-token bucket)
    on eager engines sharing the weights, moe_capacity_factor 0 (dense
    dispatch over every expert) and MOE_CAPACITY (each expert gathers
    its top-C tokens), in turns after one untimed prefill each: the
    median of three, host clock around `generate(max_tokens=1)`."""
    cfg = dict(eager_cfg, model=engine.cfg.model, prefill_chunk_tokens=0,
               quantization=engine.cfg.quantization)
    engines = {cf: Engine(EngineConfig(**cfg, moe_capacity_factor=cf),
                          model_cfg=engine.model_cfg, params=engine.model)
               for cf in (0.0, MOE_CAPACITY)}
    prompt = [1 + i % 200 for i in range(600)]
    times = {cf: [] for cf in engines}
    for rnd in range(4):
        for cf in (engines if rnd % 2 else reversed(list(engines))):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = engines[cf].generate(GenRequest(
                f"ttft-{cf}-{rnd}", prompt, max_tokens=1, ignore_eos=True))
            torch.cuda.synchronize()
            if len(out) != 1:
                raise AssertionError(f"capacity {cf}: {out}")
            if rnd:
                times[cf].append(time.monotonic() - t0)
    cap = moe.expert_capacity(1024, engine.model_cfg.num_experts,
                              engine.model_cfg.num_experts_per_tok,
                              MOE_CAPACITY)
    identical = capacity_prefill_identical(engines[MOE_CAPACITY], prompt)
    return {"prompt_tokens": len(prompt), "bucket": 1024,
            "capacity_rows_per_expert": cap,
            "capacity_prefill_bit_identical": identical,
            "ttft_s": {str(cf): statistics.median(t)
                       for cf, t in times.items()},
            "ttft_s_runs": {str(cf): t for cf, t in times.items()}}


def capacity_prefill_identical(engine: Engine, prompt) -> dict:
    """Two prefills of `prompt` (a 1024-token bucket) on an engine with
    moe_capacity_factor > 0, so that every layer's MoE block takes the
    capacity path: the logits must be the same bits (its add-back sums
    each token's experts in a fixed order; index_add_'s atomics did
    not)."""
    model, dev = engine.model, engine.device
    tokens = torch.zeros((1024,), dtype=torch.long)
    tokens[:len(prompt)] = torch.tensor(prompt)
    calls = []
    real = moe.moe_mlp_dropping

    def counted(*args, **kw):
        calls.append(kw["capacity"])
        return real(*args, **kw)

    pages = engine.allocator.alloc(1024 // PS)
    moe.moe_mlp_dropping = counted
    try:
        page_t = torch.tensor(pages, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            logits = [llama.prefill(model, tokens.to(dev), len(prompt),
                                    engine.k_pages, engine.v_pages, page_t,
                                    page_size=PS) for _ in range(2)]
    finally:
        moe.moe_mlp_dropping = real
        engine.allocator.free(pages)
    layers = engine.model_cfg.num_layers
    if len(calls) != 2 * layers:
        raise AssertionError(f"{len(calls)} capacity-path MoE blocks in two "
                             f"prefills of {layers} layers")
    if not torch.equal(logits[0], logits[1]):
        raise AssertionError("two capacity-path prefills differ: max "
                             + str(float((logits[0].float()
                                          - logits[1].float()).abs().max())))
    return {"prefills": 2, "capacity_blocks": len(calls),
            "capacity_rows_per_expert": calls[0], "identical": True}


def moe_phase(model: str, quantization: str, mixed: bool, eager_cfg: dict,
              jet_cfg: dict, layers=None) -> dict:
    """Phase 13 for one mixture-of-experts model (see the module doc) at
    `layers` of its layers (None: all): -> {"launches", "variants",
    "peak_gib", "seconds"} as family_phase."""
    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.monotonic()
    base = dict(eager_cfg, model=model, quantization=quantization)
    model_cfg = ModelConfig.from_model_name(model, dtype="bfloat16")
    if layers:
        model_cfg = dataclasses.replace(model_cfg, num_layers=layers)
    engine = Engine(EngineConfig(**base), model_cfg=model_cfg)
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    weight_bytes = quant.param_bytes(engine.model)
    emit({"phase": "moe_engine", "model": model,
          "seconds": time.monotonic() - t0, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "experts": cfg.num_experts, "experts_per_token":
              cfg.num_experts_per_tok, "expert_width": cfg.intermediate_size,
          "quantization": quant.mode_of(engine.model),
          "params": loader.num_params(cfg),
          "weights_gib": weight_bytes / 2**30,
          "kv_pool_gib": engine.kv_spec.pool_bytes / 2**30,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    with torch.inference_mode():
        forward_checks(engine)
    served = []
    jet = Engine(EngineConfig(**dict(jet_cfg, model=model,
                                     quantization=quantization)),
                 model_cfg=model_cfg, params=engine.model)
    t0 = time.monotonic()
    jet.warmup()
    emit({"phase": "warmup", "engine": f"jetstream {model}",
          "seconds": time.monotonic() - t0, **jet.windows.stats()})
    row = window_serve(jet)
    emit({"phase": "moe_serve_windows", "model": model, **row})
    served.append(row)
    with torch.inference_mode():
        prof = profile_steps(jet, 4)
        moe_ms = moe_block_ms(jet)
    busy = prof["device_busy_ms_per_step"]
    emit({"phase": "profile", "model": model,
          "weights": quant.mode_of(engine.model), **prof,
          "moe_block_ms_per_step": moe_ms,
          "moe_block_share": moe_ms / busy if busy != "not measured"
          else "not measured",
          "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del jet
    release()
    if mixed:
        eng = Engine(EngineConfig(**base, mixed_batch_tokens=CHUNK),
                     model_cfg=model_cfg, params=engine.model)
        row = mixed_serve_checks(eng)
        emit({"phase": "moe_serve_mixed", "model": model, **row})
        served.append(row)
        del eng
        release()
        with torch.inference_mode():
            emit({"phase": "moe_capacity_ttft", "model": model,
                  **capacity_ttft(engine, eager_cfg)})
        release()
    del engine
    release()
    out = {"launches": [r["launches"] for r in served],
           "variants": [r["variants"] for r in served],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.monotonic() - t_phase}
    emit({"phase": "moe_done", "model": model,
          "layers": model_cfg.num_layers, "seconds": out["seconds"]})
    return out


def moe_only(eager_cfg: dict, jet_cfg: dict, full: bool) -> None:
    """Phase 13's mixture-of-experts models alone, at MOE_MODELS' layers
    or (full) at all of them: the depth cut's seconds."""
    for model, q, mixed, layers in MOE_MODELS:
        moe_phase(model, q, mixed, eager_cfg, jet_cfg,
                  None if full else layers)


def mla_phase(eager_cfg: dict, jet_cfg: dict) -> dict:
    """Phase 13 for deepseek-v2-lite at full width and depth (MLA with
    YaRN, 64 experts of which 6 and 2 shared; see the module doc): ->
    {"launches", "variants", "peak_gib"} as family_phase."""
    model = MLA_MODEL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    base = dict(eager_cfg, model=model)
    engine = Engine(EngineConfig(**base))
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    weight_bytes = quant.param_bytes(engine.model)
    emit({"phase": "mla_engine", "model": model,
          "seconds": time.monotonic() - t0, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "kv_lora_rank": cfg.kv_lora_rank,
          "qk_nope_head_dim": cfg.qk_nope_head_dim,
          "qk_rope_head_dim": cfg.qk_rope_head_dim,
          "v_head_dim": cfg.v_head_dim,
          "cache_head_dim": cfg.cache_head_dim,
          "cache_kv_heads": cfg.cache_kv_heads,
          "rope_yarn_scaling": cfg.rope_yarn_scaling,
          "experts": cfg.num_experts,
          "experts_per_token": cfg.num_experts_per_tok,
          "shared_experts": cfg.num_shared_experts,
          "params": loader.num_params(cfg),
          "weights_gib": weight_bytes / 2**30,
          "kv_pool_gib": engine.kv_spec.pool_bytes / 2**30,
          "kv_lane_width": engine.kv_spec.lane_width,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    with torch.inference_mode():
        forward_checks(engine)
        eng8 = Engine(EngineConfig(**base, kv_cache_dtype="int8"),
                      params=engine.model)
        forward_checks(eng8)
        del eng8
        release()
    served = []
    jet = Engine(EngineConfig(**dict(jet_cfg, model=model)),
                 params=engine.model)
    t0 = time.monotonic()
    jet.warmup()
    emit({"phase": "warmup", "engine": f"jetstream {model}",
          "seconds": time.monotonic() - t0, **jet.windows.stats()})
    row = window_serve(jet)
    emit({"phase": "mla_serve_windows", "model": model, **row})
    served.append(row)
    with torch.inference_mode():
        prof = profile_steps(jet, 4)
        moe_ms = moe_block_ms(jet)
    busy = prof["device_busy_ms_per_step"]
    measured = busy != "not measured"
    attn_ms = prof["by_family_ms_per_step"].get("attention (port kernels)",
                                                0.0)
    # the step's bytes: every weight once (dense dispatch reads every
    # expert), and the 8 slots' K and V rows, at most their 100-token
    # prompts and the tokens profile_steps asks of them (under 0.2% of
    # the weights)
    ctx = 100 + (prof["engine_steps"] + 2) * prof["window"] + 8
    kv_bytes = (2 * MAX_SEQS * ctx * engine.kv_spec.lane_width * 2
                * cfg.num_layers)
    emit({"phase": "profile", "model": model, "weights": "none", **prof,
          "moe_block_ms_per_step": moe_ms,
          "moe_block_share": moe_ms / busy if measured else "not measured",
          "attention_ms_per_step": attn_ms,
          "attention_share": attn_ms / busy if measured else "not measured",
          "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del jet
    release()
    for kv in ("auto", "int8"):
        eng = Engine(EngineConfig(**base, mixed_batch_tokens=CHUNK,
                                  kv_cache_dtype=kv), params=engine.model)
        row = mixed_serve_checks(eng)
        emit({"phase": "mla_serve_mixed", "model": model, **row})
        served.append(row)
        del eng
        release()
    # n-gram speculation (K = 4) on mixed graph-window engines: verify
    # windows of 5 x 16 rows alone and beside the long prompt's chunks
    spec = dict(speculative_mode="ngram", num_speculative_tokens=SPEC_K)
    for kv in ("auto", "int8"):
        eng = Engine(EngineConfig(**dict(jet_cfg, model=model), **spec,
                                  kv_cache_dtype=kv,
                                  mixed_batch_tokens=CHUNK),
                     params=engine.model)
        t0 = time.monotonic()
        eng.warmup()
        emit({"phase": "warmup", "engine": f"mixed_spec_{kv} {model}",
              "seconds": time.monotonic() - t0,
              "verify_graphs": eng.verify.stats()})
        row = mixed_spec_serve(eng)
        emit({"phase": "mla_serve_mixed_spec", "model": model, **row})
        served.append(row)
        mla_verify_profile(eng)
        del eng
        release()
    emit({"phase": "moe_capacity_ttft", "model": model,
          **capacity_ttft(engine, eager_cfg)})
    release()
    with torch.inference_mode():
        emit({"phase": "mla_prefill_profile", "model": model,
              **mla_prefill_profile(engine)})
        emit({"phase": "mla_chunked_ttft", "model": model,
              **mla_chunked_ttft(engine, eager_cfg)})
    del engine
    release()
    return {"launches": [r["launches"] for r in served],
            "variants": [r["variants"] for r in served],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def mla_verify_profile(eng: Engine) -> None:
    """One captured verify step of deepseek-v2-lite on `eng` (a warmed-up
    n-gram spec engine; 8 windows of K + 1 after 100-token prompts): its
    device time and the attention kernels' share, as phase 11 profiles a
    step."""
    with torch.inference_mode():
        prof = profile_steps(eng, 4)
    busy = prof["device_busy_ms_per_step"]
    attn_ms = prof["by_family_ms_per_step"].get("attention (port kernels)",
                                                0.0)
    emit({"phase": "mla_verify_profile", "model": MLA_MODEL,
          "weights": "none", **prof, "attention_ms_per_step": attn_ms,
          "attention_share": (attn_ms / busy if busy != "not measured"
                              else "not measured")})


def mla_verify_only(jet_cfg: dict) -> None:
    """`--mla-verify-profile`: deepseek-v2-lite's weights (random, seed 0)
    and, on bf16 and int8 pools, phase 13's mixed n-gram spec engine,
    warmed up, with mla_verify_profile alone."""
    base = Engine(EngineConfig(**dict(jet_cfg, model=MLA_MODEL)))
    spec = dict(speculative_mode="ngram", num_speculative_tokens=SPEC_K)
    for kv in ("auto", "int8"):
        eng = Engine(EngineConfig(**dict(jet_cfg, model=MLA_MODEL), **spec,
                                  kv_cache_dtype=kv,
                                  mixed_batch_tokens=CHUNK),
                     params=base.model)
        eng.warmup()
        mla_verify_profile(eng)
        del eng
        release()


def mla_chunked_ttft(engine: Engine, eager_cfg: dict) -> dict:
    """TTFT of a 2048-token prompt prefilled in CHUNK-token chunks (eight
    chunk launches a layer, the last at 1792) on eager engines sharing
    `engine`'s weights (max_seq_len 4096, so that the prompt is admitted),
    bf16 and int8 pools in turns after one untimed run each: the median
    of three, host clock around `generate(max_tokens=1)`, and the chunk
    launches of one run; then one more run of each under torch.profiler:
    the device time of all its kernels and of the chunk kernel's, beside
    that run's wall (the profiler slows the host), and the host side of
    that run: its ops and CUDA runtime calls by self CPU time."""
    cfg = dict(eager_cfg, model=engine.cfg.model, max_seq_len=2 * MAX_SEQ_LEN,
               prefill_chunk_tokens=CHUNK)
    engines = {kv: Engine(EngineConfig(**cfg, kv_cache_dtype=kv),
                          params=engine.model) for kv in ("auto", "int8")}
    prompt = [1 + i % 200 for i in range(MAX_SEQ_LEN)]
    times = {kv: [] for kv in engines}
    launches = {}
    for rnd in range(4):
        for kv in (engines if rnd % 2 else reversed(list(engines))):
            ca.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = engines[kv].generate(GenRequest(
                f"chunked-{kv}-{rnd}", prompt, max_tokens=1, ignore_eos=True))
            torch.cuda.synchronize()
            if len(out) != 1:
                raise AssertionError(f"chunked TTFT {kv}: {out}")
            if rnd:
                times[kv].append(time.monotonic() - t0)
            launches[kv] = dict(ca.VARIANT_LAUNCHES)
    from torch.profiler import ProfilerActivity, profile

    profiled = {}
    for kv, eng in engines.items():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with prof:
            eng.generate(GenRequest(f"chunked-{kv}-profiled", prompt,
                                    max_tokens=1, ignore_eos=True))
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        busy = chunk_ms = 0.0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            if "chunk_latent_kernel" in ev.name or "chunk_kernel" in ev.name:
                chunk_ms += ms
        # the host side of the same run: its ops and CUDA runtime calls by
        # self time (where a slower TTFT with less device time must show)
        host = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
                       for ev in prof.key_averages()
                       if ev.self_cpu_time_total > 0),
                      key=lambda x: -x[1])
        profiled[kv] = {"wall_ms": wall * 1e3,
                        "device_busy_ms": busy or "not measured",
                        "chunk_kernel_ms": chunk_ms or "not measured",
                        "host_self_ms": sum(x[1] for x in host),
                        "host_top_self_ms": [[k[:70], ms, n]
                                             for k, ms, n in host[:25]]}
    layers = engine.model_cfg.num_layers
    for kv, name in (("auto", "chunk"), ("int8", "chunk_int8")):
        got = launches[kv].get(f"{name}[head_dim={engine.kv_spec.head_dim}]",
                               0)
        if got != layers * (MAX_SEQ_LEN // CHUNK):
            raise AssertionError(f"chunked TTFT {kv}: {got} {name} launches,"
                                 f" not {MAX_SEQ_LEN // CHUNK} a layer")
    del engines
    release()
    return {"prompt_tokens": MAX_SEQ_LEN, "chunk": CHUNK,
            "chunk_launches_per_layer": MAX_SEQ_LEN // CHUNK,
            "ttft_s": {kv: statistics.median(t) for kv, t in times.items()},
            "ttft_s_runs": times, "profiled_run": profiled}


# Kineto drops, as out of its window, the first device records of a
# profiler session, more as the process ages: none in a fresh process,
# tens after some minutes, alike for kernels back to back or 1 ms apart
# (`--profile-lead` shows it; kineto's log counts them "Out-of-range").
# A session that must see every kernel opens with PROFILE_LEAD throwaway
# kernels (LEAD_KERNEL, ~30 ms of launches) for those records to be, and
# leaves them out of its account.
PROFILE_LEAD = 1024
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's


@contextlib.contextmanager
def traced(prof):
    """`prof` running, its session opened by PROFILE_LEAD sleep kernels
    of 100 cycles each (on the card; a CPU trace has no device records),
    synchronized before the caller's work starts."""
    with prof:
        if torch.cuda.is_available():
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        yield prof


def lead_lost(prof) -> int:
    """How many of the session's PROFILE_LEAD opening kernels its trace
    lost (0 on a CPU trace)."""
    if not torch.cuda.is_available():
        return 0
    return PROFILE_LEAD - sum(LEAD_KERNEL in ev.name for ev in prof.events()
                              if ev.device_type
                              == torch.autograd.DeviceType.CUDA)


def device_events(prof):
    """The session's device events, its opening kernels left out."""
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and LEAD_KERNEL not in ev.name]


# `--profile-lead`: sessions of LEAD_PROBE_KERNELS small kernels, 0.3 ms
# apart, after each spell (busy: GEMMs back to back; idle: the card
# waits), one with no lead and one opened by `traced`
LEAD_PROBE_KERNELS = 300
LEAD_PROBE_SPELLS = (("busy", 0), ("idle", 25), ("busy", 25), ("idle", 35),
                     ("busy", 35), ("idle", 45), ("busy", 45))


def profile_lead_probe() -> int:
    """`--profile-lead`: what `traced` is for, over ~4 minutes of the
    process's age. Per session: the measured kernels its trace lost and
    where their launches fall among the session's (profile_drops), and
    the opening kernels lost. -> 1 if a session opened by the lead lost a
    measured kernel."""
    from torch.profiler import ProfilerActivity, profile

    tile = torch.randn(256, 256, device="cuda")
    big = torch.randn(4096, 4096, device="cuda")
    t_proc = time.monotonic()
    failed = 0
    for kind, seconds in LEAD_PROBE_SPELLS:
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            if kind == "busy":
                for _ in range(20):
                    big @ big
                torch.cuda.synchronize()
            else:
                time.sleep(0.1)
        for lead in (False, True):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            with traced(prof) if lead else prof:
                x = tile
                for _ in range(LEAD_PROBE_KERNELS):
                    x = torch.tanh(x)
                    time.sleep(0.0003)
                torch.cuda.synchronize()
            seen = sum("tanh" in ev.name for ev in device_events(prof))
            drops = profile_drops(prof, "tanh")
            row = {"phase": "profile_lead", "age_s": time.monotonic() - t_proc,
                   "after": f"{kind} {seconds} s", "lead": PROFILE_LEAD * lead,
                   "lead_lost": lead_lost(prof) if lead else 0,
                   "lost": LEAD_PROBE_KERNELS - seen,
                   "unanswered_launches": drops.get(
                       "kineto_unanswered_launches", "not read"),
                   "unanswered_at": drops.get("kineto_unanswered_at",
                                              "not read")}
            emit(row)
            failed += lead and row["lost"] > 0
    return 1 if failed else 0


def mla_prefill_profile(engine: Engine, raise_short: bool = True) -> dict:
    """One eager full prefill of a CHUNK-token prompt (its own bucket, one
    lane: the full-prefill path, not chunked) on `engine` (eager, the
    MLA model), after an unprofiled one: under torch.profiler (opened by
    `traced`), the device time of all its kernels and of the prefill
    kernel's launches (one a layer), beside the run's wall (the profiler
    slows the host) and how many opening kernels the trace lost. Where the
    trace holds other than one prefill kernel a layer, raises (unless not
    `raise_short`) with profile_drops' account of the trace."""
    from torch.profiler import ProfilerActivity, profile

    prompt = [1 + i % 200 for i in range(CHUNK)]
    engine.generate(GenRequest("prefill-warm", prompt, max_tokens=1,
                               ignore_eos=True))
    ca.reset_launch_counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with traced(prof):
        t0 = time.monotonic()
        engine.generate(GenRequest("prefill-profiled", prompt, max_tokens=1,
                                   ignore_eos=True))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = prefill_ms = 0.0
    prefill_kernels = 0
    for ev in device_events(prof):
        ms = ev.time_range.elapsed_us() / 1e3
        busy += ms
        if "prefill_latent_kernel" in ev.name or "prefill_kernel" in ev.name:
            prefill_ms += ms
            prefill_kernels += 1
    layers = engine.model_cfg.num_layers
    launches = ca.VARIANT_LAUNCHES.get(
        f"prefill[head_dim={engine.kv_spec.head_dim}]", 0)
    row = {"prompt_tokens": CHUNK, "prefill_launches": launches,
           "prefill_traced": prefill_kernels, "wall_ms": wall * 1e3,
           "device_busy_ms": busy or "not measured",
           "prefill_kernel_ms": prefill_ms or "not measured",
           "prefill_kernel_ms_per_launch": (prefill_ms / prefill_kernels
                                            if prefill_kernels
                                            else "not measured"),
           "prefill_share": (prefill_ms / busy if busy
                             else "not measured"),
           "lead_lost": lead_lost(prof)}
    if launches != layers or prefill_kernels not in (0, layers):
        row["drops"] = profile_drops(prof, "prefill_latent_kernel")
        if raise_short:
            raise AssertionError(f"MLA prefill profile: {launches} prefill "
                                 f"launches, {prefill_kernels} traced, not "
                                 f"{layers}: {row}")
    return row


def profile_drops(prof, kernel: str) -> dict:
    """Where a trace lost kernels: the device events and the CPU-side
    launch calls (cudaLaunchKernel, cuLaunchKernel, cudaLaunchKernelExC)
    in prof.events() and in the profiler's own kineto result before
    PyTorch parses it; in the kineto result, the launch calls that no
    device record answers (their correlation ids), by their place among
    the session's launches in time (the opening kernels of `traced` are
    the first PROFILE_LEAD); the traced `kernel` events' starts (us from
    the first device event) and the gaps between them."""
    def count(events, device, name, start):
        n, launch, starts = 0, 0, []
        for ev in events:
            if device(ev):
                n += 1
                if kernel in name(ev):
                    starts.append(start(ev))
            elif "LaunchKernel" in name(ev):
                launch += 1
        return n, launch, sorted(starts)

    cuda = torch.autograd.DeviceType.CUDA
    n, launch, starts = count(
        prof.events(), lambda e: e.device_type == cuda, lambda e: e.name,
        lambda e: e.time_range.start)
    out = {"device_events": n, "launch_calls": launch}
    try:
        raw = prof.profiler.kineto_results.events()
        rn, rlaunch, _ = count(raw, lambda e: e.device_type() == cuda,
                               lambda e: e.name(), lambda e: e.start_ns())
        answered = set()
        for e in raw:
            if e.device_type() == cuda:
                answered |= {e.correlation_id(), e.linked_correlation_id()}
        calls = sorted((e for e in raw if e.device_type() != cuda
                        and "LaunchKernel" in e.name()),
                       key=lambda e: e.start_ns())
        lost = [i for i, e in enumerate(calls)
                if e.correlation_id() not in answered]
        out.update(kineto_device_events=rn, kineto_launch_calls=rlaunch,
                   kineto_unanswered_launches=len(lost),
                   kineto_unanswered_at=lost[:16])
    except AttributeError as e:  # another torch version's result API
        out["kineto"] = f"not read: {e}"
    if starts:
        first = min(e.time_range.start for e in prof.events()
                    if e.device_type == cuda)
        out["kernel_starts_us"] = [t - first for t in starts]
        out["kernel_gaps_us"] = [b - a for a, b in zip(starts, starts[1:])]
    return out


def mla_prefill_only(eager_cfg: dict, repeats: int = 1) -> int:
    """`--mla-prefill-profile [N]`: deepseek-v2-lite's engine (random
    weights from seed 0) and mla_prefill_profile alone, N times back to
    back (each a profiler session right after the last); every run's row,
    then the count of runs whose trace lost prefill kernels. -> 1 if any
    did."""
    engine = Engine(EngineConfig(**dict(eager_cfg, model=MLA_MODEL)))
    short = 0
    with torch.inference_mode():
        for i in range(repeats):
            row = mla_prefill_profile(engine, raise_short=False)
            short += "drops" in row
            emit({"phase": "mla_prefill_profile", "model": MLA_MODEL,
                  "run": i, **row})
    emit({"phase": "mla_prefill_repeats", "runs": repeats,
          "short_traces": short})
    return 1 if short else 0


def mla_ttft_only(eager_cfg: dict) -> None:
    """`--mla-chunked-ttft`: deepseek-v2-lite's engine (random weights from
    seed 0) and mla_chunked_ttft alone."""
    engine = Engine(EngineConfig(**dict(eager_cfg, model=MLA_MODEL)))
    with torch.inference_mode():
        emit({"phase": "mla_chunked_ttft", "model": MLA_MODEL,
              **mla_chunked_ttft(engine, eager_cfg)})


# --------------------------------------- Gemma-2, Gemma-3 and Phi-3 --

# Phase 3's windowed rows, one set per model shape: the heads, a sliding
# window and a tanh cap (0: none), q's scale (Gemma: scores of tens, which
# the cap bends), decode contexts (8 rows), prefill lanes of one bucket
# of max_seq_len, a 256-token chunk's start, the pools' pages and the
# inputs' seed.
# Gemma-2-9B's local layers: 16 query heads on 8 KV heads of 256 lanes, a
# 4096-key window and the cap at 50.
GEMMA_WINDOW, GEMMA_CAP = 4096, 50.0
GEMMA_SHAPE = dict(
    label=f"head_dim=256,group=2,window={GEMMA_WINDOW},cap=50", h=16, kv=8,
    d=256, window=GEMMA_WINDOW, cap=GEMMA_CAP, q_scale=6.0,
    decode_ctx=(1, 100, 4000, 4097, 5000, 6000, 7000, 8192),
    prefill_lens=(6000, 4500), chunk_start=4864, pool_pages=2560,
    max_seq_len=8192, seed=20)
GEMMA_LABEL = GEMMA_SHAPE["label"]
# Phi-3-mini: 32 query heads on 32 KV heads of 96 lanes (group 1: a
# tile's 64 rows are 64 positions with 64 window bounds) and a 2047-key
# window on every layer, no cap: decode rows up to the 4096 context,
# prefill lanes past the window in the 4096 bucket, the chunk at 3008
PHI3_MODEL = "phi-3-mini-4k-instruct"
# the layers of its 32 that the Phi-3 phase serves (32 until phase 18
# took the time of 12 of them, 20 until phase 19 took that of 8 more)
PHI3_LAYERS = 12
PHI3_WINDOW = 2047
PHI3_SHAPE = dict(
    label=f"head_dim=96,group=1,window={PHI3_WINDOW}", h=32, kv=32, d=96,
    window=PHI3_WINDOW, cap=0.0, q_scale=1.0,
    decode_ctx=(1, 100, 1000, 2047, 2048, 3000, 3500, 4096),
    prefill_lens=(3800, 2600), chunk_start=3008, pool_pages=1536,
    max_seq_len=4096, seed=21)
PHI3_LABEL = PHI3_SHAPE["label"]
WINDOWED_KERNELS = ("decode", "decode_int8", "prefill", "chunk",
                    "chunk_int8", "ragged", "ragged_int8")
# the served Gemma models, after the families (model, its layers, the
# forward checks' prompt length, the served prompts' shortest and longest,
# profiled): every served prompt is longer than the model's window (4096;
# 512); gemma-2-9b-it at 5 of its 42 layers (11 until phase 19 took their
# time), gemma-3-1b-it at 7 of 26 (local and global layers in the preset's
# pattern: 3 local of 5, 6 of 7), so that the whole script stays under
# ~950 s on a slower host (1131 s at half depth on one)
GEMMA_MODELS = (("gemma-2-9b-it", 5, 4600, (4500, 6000), True),
                ("gemma-3-1b-it", 7, 1200, (1000, 2000), False))
GEMMA_STREAMS, GEMMA_TOKENS = 4, 64
# 8 slots (the profile's) of 4600-token prompts fit the pool's pages
GEMMA_SIZE = dict(max_seq_len=8192, num_pages=2560, max_num_seqs=MAX_SEQS)
# the engines a windowed model's streams are served on: EngineConfig
# fields over the classic eager engine's (whole-prompt prefills), graph
# windows (the jetstream profile) for the jetstream runs
GEMMA_RUNS = ("classic", "chunked_int8", "jetstream", "jetstream_int8",
              "mixed", "mixed_int8", "mixed_ngram")
MIXED = dict(prefill_chunk_tokens=CHUNK, mixed_batch_tokens=CHUNK)
WINDOWED_RUN_CFG = {
    "chunked": dict(prefill_chunk_tokens=CHUNK),
    "chunked_int8": dict(prefill_chunk_tokens=CHUNK, kv_cache_dtype="int8"),
    "mixed": MIXED,
    "mixed_int8": dict(MIXED, kv_cache_dtype="int8"),
    "mixed_ngram": dict(MIXED, speculative_mode="ngram",
                        num_speculative_tokens=SPEC_K),
}
# The served runs held against a reference run of their own pool kind:
# `classic` on bf16 pools (it prefills whole prompts, as `jetstream`, which
# must equal it token for token) and `chunked_int8` on int8 pools (it
# prefills in 256-token chunks). Two paths cannot give equal bits where
# their shapes differ (a decode row in a mixed step beside a chunk, cuBLAS
# at other row counts, int8 K/V against the prompt's bf16 K/V), and the
# random models' top logprobs then part by a bf16 unit or more, so their
# argmax streams part, at near-ties or past them: a run of
# RUN_PATH and its reference serve with TOP_LOGPROBS logprobs, and the two
# runs' logprobs of either's top tokens are bounded by the same two paths'
# through the plain attention (path_bounds); a run outside it
# (`mixed_ngram`: logprobs would demote its speculation) must give the
# reference's tokens or first differ at a near-tie.
REFERENCE = {"bf16": "classic", "int8": "chunked_int8"}
HELD = ("chunked", "mixed", "mixed_ngram", "jetstream_int8", "mixed_int8")
# each served run's path in path_states: its prompt's K/V from a whole
# prefill or from 256-token chunks, its decode rows in decode steps or, the
# mixed engines' beside a chunk, in mixed steps
RUN_PATH = {"classic": "whole", "jetstream": "whole",
            "jetstream_int8": "whole", "chunked": "chunks",
            "chunked_int8": "chunks", "mixed": "mixed",
            "mixed_int8": "mixed"}
# a held run's logprob difference may reach this many times its paths'
# plain one (path_bounds: the largest over BOUND_STEPS teacher-forced
# decode states of each served stream's count of slots; the served one is
# the largest over up to GEMMA_TOKENS states a stream)
BOUND_FACTOR = 2.0
BOUND_STEPS = 16
# path_states' mixed steps: their chunks walk a prompt of this many chunks
# of its own (its K/V on pages of its own), chunk i at (i % it) * CHUNK
BOUND_CHUNKS = 4
# the top logprobs a held run and its reference serve with (the engine's
# most): where the streams first differ the two runs' top tokens part,
# and a token only one run lists counts from the other's least listed
TOP_LOGPROBS = 5
# Phi-3 served after Gemma: the preset at its 4096 context (8 slots of
# 256 pages), four streams of 2500-3800-token prompts past the window,
# the forward checks and the profile at 3000-token prompts; then the same
# weights under longrope (phi3_longrope_config) at an 8192 max length, two
# ~6000-token prompts (on the mixed engine the second rides mixed steps
# beside the first's decode), so that positions cross original_max_pos
# (4096) in the prefill, the chunks and decode
PHI3_SIZE = dict(max_seq_len=4096, num_pages=2048, max_num_seqs=MAX_SEQS)
PHI3_RUNS = ("classic", "chunked", "chunked_int8", "jetstream",
             "jetstream_int8", "mixed", "mixed_int8")
PHI3_N_CHECK, PHI3_LENGTHS = 3000, (2500, 3800)
# The served windowed models without q/k norms (Phi-3, Gemma-2) carry wq
# scaled by Q_SCALE (their scores' deviation near 2, as phase 4's forwards
# give q; served_weights). As the loader draws them the scores' deviation
# is near 30: softmax is one-hot (Gemma-2's cap at 50 softens it), a bf16
# unit anywhere flips a head's key, and two paths, the plain ones too,
# part by whole nats (on the H100, Phi-3's plain decode row against the
# same row in a mixed step: 3.8 median over 64 states), more than a
# served run with zeroed attention rows moves from its reference: no
# bound from the plain paths could fail it. Scaled, the plain paths part
# by a bf16 unit or two of a logprob and such a fault by tenths.
WINDOWED_WQ_SCALE = Q_SCALE
LONGROPE_SIZE = dict(max_seq_len=8192, num_pages=1024, max_num_seqs=MAX_SEQS)
LONGROPE_RUNS = ("classic", "jetstream", "mixed")
LONGROPE_N_CHECK, LONGROPE_LENGTHS = 6000, (5800, 6200)
LONGROPE_ORIGINAL = 4096
# the library call's compiled function (torch.compile of flex_attention)
# and the seconds its compiles took
FLEX = {"fn": None, "compile_s": 0.0}


def flex_score_mod(score, b, h, q_idx, kv_idx):
    """Gemma's tanh cap on a scaled score (flex_attention's score_mod)."""
    return GEMMA_CAP * torch.tanh(score / GEMMA_CAP)


def flex_library(q, k, v, qpos, kv_lens, window: int, score_mod=None):
    """(call, what it is) of one torch.nn.attention.flex_attention call,
    compiled with torch.compile, over dense q [N, Q, H, D] and k/v
    [N, S, KV, D] (GQA left to flex_attention): query j of row n at
    qpos[n, j] sees key t iff t <= qpos[n, j], t < kv_lens[n] and
    qpos[n, j] - window < t (the block mask's mask_mod), each scaled
    score passed through `score_mod` (flex_score_mod: Gemma's cap); or
    (None, why) where it does not compile or run. A yardstick the port
    never calls; the compile is not timed (FLEX["compile_s"])."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        if FLEX["fn"] is None:
            FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
        n, nq = q.shape[:2]
        s = k.shape[1]

        def mask_mod(b, h, q_idx, kv_idx):
            p = qpos[b, q_idx]
            return ((kv_idx <= p) & (kv_idx < kv_lens[b])
                    & (kv_idx > p - window))

        block = create_block_mask(mask_mod, n, None, nq, s, device=q.device)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def call():
            return FLEX["fn"](qt, kt, vt, score_mod=score_mod,
                              block_mask=block, enable_gqa=True)

        t0 = time.monotonic()
        call()
        torch.cuda.synchronize()
        FLEX["compile_s"] += time.monotonic() - t0
        return call, "flex_attention (torch.compile)"
    except Exception as e:  # the row says why it has no library time
        return None, f"none: flex_attention failed ({type(e).__name__}: " \
                     f"{str(e).splitlines()[0][:200] if str(e) else ''})"


def flex_paged(q, kp, vp, tables, q_starts, kv_lens, **kw):
    """flex_library over paged K/V gathered dense (bf16 pools
    [P, ps, KV*D], tables [N, W], q [N, Q, H, D]); the gather is not
    timed."""
    n, nq, h, d = q.shape
    kv = kp.shape[-1] // d
    s = int(kv_lens.max())
    kd = kp[tables.long()].reshape(n, -1, kv, d)[:, :s]
    vd = vp[tables.long()].reshape(n, -1, kv, d)[:, :s]
    qpos = (q_starts[:, None]
            + torch.arange(nq, device=q.device)[None]).int()
    return flex_library(q, kd, vd, qpos, kv_lens.int(), **kw)


def both(*calls):
    """One library row of calls made back to back (None if any is)."""
    if any(c is None for c in calls):
        return None
    return lambda: [c() for c in calls]


def pair_span_sweep(call, plan: int, most: int) -> dict:
    """The pair tile's span sweep of a launch: its plan and the device ms
    of every span count from 1 to `most` (pair_max_spans), each output
    within TOL of the plan's."""
    want = call(plan)
    ms = {}
    for n in range(1, most + 1):
        got = call(n)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{n} spans disagree with the plan's "
                                 f"{plan}")
        ms[n] = device_ms(lambda n=n: call(n), 20)
    return {"plan": plan, "ms": ms}


def windowed_decode_plan(width: int, ctx, kv: int, d: int, window: int,
                         sms: int) -> dict:
    """The split plan of phase 3's windowed decode rows (decode.cu's, and
    ragged.cu's decode rows beside the chunk: the same plan) at contexts
    `ctx` on `width`-page tables, with the plan the table alone gave
    before windows had their own (window 0): per row the keys each span's
    block walks and its 64-key tiles, and the longest block's tiles, the
    key tiles in series that bound the launch."""
    def per_row(w):
        span, n = ca.split_plan(width, PS, len(ctx), kv, sms, w, 1, d)
        rows = []
        for c in ctx:
            spans = ca.decode_row_spans(width, PS, len(ctx), kv, sms, c - 1,
                                        c, w, 1, d)
            # the walk starts at the key tile of the window's first key
            first = max(0, c - window) // ca.KEY_TILE * ca.KEY_TILE
            tiles = [-(-(hi - max(lo, first)) // ca.KEY_TILE)
                     if hi > max(lo, first) else 0 for lo, hi in spans]
            rows.append({"context": c, "spans": spans, "key_tiles": tiles})
        return {"split_keys": span, "splits": n, "rows": rows,
                "longest_block_key_tiles": max(max(r["key_tiles"])
                                               for r in rows)}

    return {"window": window, "plan": per_row(window),
            "table_plan": per_row(0) | {"note": "the table's plan walked "
                                        "under the window, for comparison"}}


def windowed_kernel_checks(dev, shape: dict) -> dict:
    """Phase 3 at a windowed model's attention (`shape`: GEMMA_SHAPE,
    PHI3_SHAPE; q scaled by its q_scale): 8 decode rows at its contexts
    on tables of max_seq_len keys (with the same call's time without the
    window beside it), two prefill lanes of its lengths in one
    max_seq_len bucket, a 256-token chunk at its start (the window masks
    its first keys), the mixed step's descriptors (the decode rows beside
    that chunk), on bf16 and int8 pools; each row named
    `kernel[label]`, held against its plain version, its bound counting
    only the keys inside the window, its library call flex_attention with
    the window as its mask and the cap, if any, as its score_mod
    (flex_library)."""
    g = torch.Generator(device=dev)
    g.manual_seed(shape["seed"])

    def rnd(*dims, scale=1.0):
        return (torch.randn(dims, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    h, kv, d, w = shape["h"], shape["kv"], shape["d"], shape["window"]
    cap, qs, label = shape["cap"], shape["q_scale"], shape["label"]
    mods = dict(window=w, logit_cap=cap)
    lib_kw = dict(window=w, score_mod=flex_score_mod if cap else None)
    n_pages = shape["pool_pages"]
    int8_w = att.kv_lane_width(kv, d, True)
    kp, vp = rnd(n_pages, PS, kv * d), rnd(n_pages, PS, kv * d)
    kp8, vp8 = (att.pack_kv_rows(x.reshape(-1, kv, d), int8_w).reshape(
        n_pages, PS, int8_w) for x in (kp, vp))
    pools = {"": (kp, vp, kp, vp, 2 * kv * d),
             "_int8": (kp8, vp8, dequantized(kp8, kv, d),
                       dequantized(vp8, kv, d), kv * d + 2 * kv)}
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(3))
    rows = {}
    shapes = {"H": h, "KV": kv, "D": d, "window": w, "logit_cap": cap,
              "q_scale": qs}

    def cost(q_numel, spans, row_bytes, desc):
        return paged_cost(q_numel, spans, row_bytes, desc, head_dim=d,
                          heads=h, window=w)

    def run(name, kernel, plain, library, bound_row, extra):
        call, what = library
        rows[name] = check(f"{name}[{label}]", kernel, plain, call,
                           bound_row, {**shapes, **extra}, head_dim=d,
                           library_backend=what)

    pmax = shape["max_seq_len"] // PS
    ctx = list(shape["decode_ctx"])
    emit({"phase": "windowed_decode_plan", "label": label,
          **windowed_decode_plan(pmax, ctx, kv, d, w, ca._num_sms(dev))})
    table = torch.zeros((MAX_SEQS, pmax), dtype=torch.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // PS)
        table[b, :n] = perm[used:used + n] + 1
        used += n
    table_d = table.to(dev)
    ctx_d = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = rnd(MAX_SEQS, h, d, scale=qs)
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        run("decode" + sfx,
            lambda k=k, v=v: ca.paged_attention_decode(
                q, k, v, table_d, ctx_d, page_size=PS, num_kv_heads=kv,
                **mods),
            lambda k=k, v=v: att.paged_attention_decode_ref(
                q, k, v, table_d, ctx_d, page_size=PS, num_kv_heads=kv,
                **mods),
            flex_paged(q[:, None], kl, vl, table_d, ctx_d - 1, ctx_d,
                       **lib_kw),
            cost(q.numel(), [(table[b], c - 1, 1, c)
                             for b, c in enumerate(ctx)], row_bytes,
                 MAX_SEQS),
            {"context_lens": ctx, "block_table": list(table.shape),
             "split_plan": ca.split_plan(pmax, PS, MAX_SEQS, kv,
                                         ca._num_sms(dev), w, 1, d),
             # the same call without the window (Gemma: a global layer's)
             "no_window_ms": device_ms(
                 lambda k=k, v=v: ca.paged_attention_decode(
                     q, k, v, table_d, ctx_d, page_size=PS,
                     num_kv_heads=kv, logit_cap=cap), 20)})

    n, s = 2, shape["max_seq_len"]
    lens = torch.tensor(shape["prefill_lens"], dtype=torch.int32,
                        device=dev)
    qp = rnd(n, s, h, d, scale=qs)
    kk, vv = rnd(n, s, kv, d), rnd(n, s, kv, d)
    qpos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(n, 1)
    run("prefill", lambda: ca.prefill_attention(qp, kk, vv, lens, **mods),
        lambda: att.prefill_attention_ref(qp, kk, vv, lens, **mods),
        flex_library(qp, kk, vv, qpos, lens, **lib_kw),
        prefill_cost(qp, kk, vv, lens, window=w),
        {"q": [n, s, h, d], "seq_lens": lens.tolist()})

    start, c = shape["chunk_start"], CHUNK
    width = (start + c) // PS + CHUNK // PS - 1
    pages = torch.zeros((width,), dtype=torch.int32)
    pages[:(start + c) // PS] = perm[used:used + (start + c) // PS] + 1
    pages_d = pages.to(dev)
    start_d = torch.tensor([start], device=dev)
    qc = rnd(c, h, d, scale=qs)
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        run("chunk" + sfx,
            lambda k=k, v=v: ca.chunk_prefill_attention(
                qc, k, v, pages_d, start, page_size=PS, num_kv_heads=kv,
                **mods),
            lambda k=k, v=v: att.chunk_attention_ref(
                qc, k, v, pages_d, start, page_size=PS, num_kv_heads=kv,
                **mods),
            flex_paged(qc[None], kl, vl, pages_d[None], start_d,
                       start_d + c, **lib_kw),
            cost(qc.numel(), [(pages, start, c, start + c)], row_bytes, 0),
            {"q": [c, h, d], "start": start,
             "pair_spans": pair_span_sweep(
                 lambda n, k=k, v=v: ca.chunk_prefill_attention(
                     qc, k, v, pages_d, start, page_size=PS,
                     num_kv_heads=kv, spans=n, **mods),
                 ca.chunk_spans(c, start, h // kv, d, kv, ca._num_sms(dev)),
                 ca.pair_max_spans(start + c, w,
                                   ca.tile_positions(h // kv, d), d))})

    desc = att.ragged_descriptors(table_d, ctx_d, pages_d, start, c)
    tabs, kv_lens, q_starts = desc
    tabs_h = tabs.cpu()
    qr = rnd(MAX_SEQS + c, h, d, scale=qs)
    spans = [(tabs_h[r], int(q_starts[r]), 1 if r < MAX_SEQS else c,
              int(kv_lens[r])) for r in range(MAX_SEQS + 1)]
    for sfx, (k, v, kl, vl, row_bytes) in pools.items():
        kw = dict(page_size=PS, num_kv_heads=kv, num_decode=MAX_SEQS)
        dec_lib = flex_paged(qr[:MAX_SEQS, None], kl, vl, tabs[:MAX_SEQS],
                             q_starts[:MAX_SEQS], kv_lens[:MAX_SEQS],
                             **lib_kw)
        chk_lib = flex_paged(qr[MAX_SEQS:][None], kl, vl, tabs[-1:],
                             q_starts[-1:], kv_lens[-1:], **lib_kw)
        run("ragged" + sfx,
            lambda k=k, v=v, kw=kw: ca.ragged_paged_attention(
                qr, k, v, tabs, kv_lens, q_starts, **kw, **mods),
            lambda k=k, v=v, kw=kw: att.ragged_paged_attention_ref(
                qr, k, v, tabs, kv_lens, q_starts, **kw, **mods),
            (both(dec_lib[0], chk_lib[0]), dec_lib[1]),
            cost(qr.numel(), spans, row_bytes, 2 * (MAX_SEQS + 1)),
            {"num_decode": MAX_SEQS, "decode_q": 1, "chunk_start": start})
    emit({"phase": "windowed_library", "label": label,
          "flex_compile_s": FLEX["compile_s"]})
    return rows


def gemma_prompts(lo: int, hi: int, seed: int,
                  n: int = GEMMA_STREAMS) -> list:
    """n random prompts of lo to hi tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 256, size=int(k)).tolist()
            for k in rng.integers(lo, hi + 1, size=n)]


def timed_run(engine: Engine, prompts, logprobs=None) -> tuple:
    """The prompts as greedy requests of GEMMA_TOKENS tokens, added
    together, stepped until idle: ({rid: [(token, logprob, top)]},
    timing: TTFT of each stream, mean ITL (its last token's time less its
    first over the tokens between), tokens per second over the run)."""
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        engine.add_request(GenRequest(f"g{i}", p, max_tokens=GEMMA_TOKENS,
                                      ignore_eos=True, logprobs=logprobs))
    out, first, last = {}, {}, {}
    while engine.has_work:
        for ev in engine.step():
            if ev.token_id >= 0:
                now = time.monotonic()
                out.setdefault(ev.request_id, []).append(
                    (ev.token_id, ev.logprob, ev.top_logprobs))
                first.setdefault(ev.request_id, now)
                last[ev.request_id] = now
    wall = time.monotonic() - t0
    n_tok = sum(map(len, out.values()))
    return out, {
        "ttft_ms": [(first[r] - t0) * 1e3 for r in sorted(first)],
        "itl_ms_mean": [(last[r] - first[r]) * 1e3 / (len(out[r]) - 1)
                        for r in sorted(out)],
        "tokens": n_tok, "seconds": wall, "tokens_per_s": n_tok / wall}


def stream_agreement(got: dict, ref: dict, bound: float = None) -> dict:
    """got's greedy streams against ref's ({rid: [(token, logprob, top)]},
    ref served with TOP_LOGPROBS logprobs). Up to and including a
    stream's first difference both runs saw the same tokens; on each of
    those shared states the two runs' logprobs of both runs' top tokens
    are compared (top_difference), the largest |difference| the state's.
    With `bound` (got served with TOP_LOGPROBS logprobs too), the largest
    over the states must be within BOUND_FACTOR * bound, whether or not
    the streams differ; without, the streams must be equal or first
    differ at a near-tie (ref's top-2 gap there under NEAR_TIE). Streams
    of other lengths fail either way. -> {"ok", "equal",
    "first_difference" (rid, index, lengths), "ref_top2_gap" and
    "near_tie" there, "bound", "limit", "max_shared_diff" (and by stream),
    "shared_diff_spread", "shared_states", "lower_bounded"}"""
    first, gap, lower, by_rid, diffs = None, None, 0, {}, []
    for rid in sorted(ref):
        a, b = got.get(rid, []), ref[rid]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]),
                 None)
        if first is None and (i is not None or len(a) != len(b)):
            first = {"rid": rid, "index": min(len(a), len(b)) if i is None
                     else i, "lengths": [len(a), len(b)]}
            top = b[i][2] if i is not None else None
            if top and len(top) > 1:
                gap = top[0][1] - top[1][1]
        if bound is None:
            continue
        worst = 0.0
        for j in range(min(len(a), len(b)) if i is None else i + 1):
            if len(a[j][2] or ()) < 2:
                raise ValueError(f"{rid}: the run held to a bound was not "
                                 f"served with logprobs")
            d, n = top_difference(dict(a[j][2]), dict(b[j][2]))
            diffs.append(d)
            lower += n
            worst = max(worst, d)
        by_rid[rid] = worst
    lengths_ok = first is None or first["lengths"][0] == first["lengths"][1]
    near_tie = gap is not None and gap < NEAR_TIE
    row = {"equal": first is None, "first_difference": first,
           "ref_top2_gap": gap, "near_tie": near_tie, "bound": bound}
    if bound is None:
        return {**row, "ok": first is None or (lengths_ok and near_tie)}
    limit, worst = BOUND_FACTOR * bound, max(by_rid.values(), default=0.0)
    return {**row, "limit": limit, "max_shared_diff": worst,
            "max_shared_diff_by_stream": by_rid,
            "shared_diff_spread": spread(diffs),
            "shared_states": len(diffs), "lower_bounded": lower,
            "ok": lengths_ok and worst <= limit}


def top_difference(mine: dict, theirs: dict) -> tuple:
    """Two runs' top logprobs at one state ({token: logprob}, as many
    each): the largest |difference| of their logprobs over the tokens of
    either. A token only one run lists has at most the other's least
    listed logprob there, and counts from that: a lower bound. ->
    (difference, tokens lower-bounded)."""
    d, lower = 0.0, 0
    for x, y in ((mine, theirs), (theirs, mine)):
        cap = min(y.values())
        for tok, lp in x.items():
            if tok in y:
                d = max(d, abs(lp - y[tok]))
            else:
                d = max(d, lp - cap)
                lower += 1
    return d, lower


def spread(values) -> dict:
    """The median, 90th percentile, mean and largest of some values (0
    for none)."""
    v = np.sort(np.asarray(values, dtype=np.float64)) if len(values) else (
        np.zeros(1))
    return {"q50": float(np.quantile(v, 0.5)),
            "q90": float(np.quantile(v, 0.9)), "mean": float(v.mean()),
            "max": float(v[-1])}


def pool_of(run: str) -> str:
    """The pool kind a served run's engine holds its K/V in."""
    return "int8" if "int8" in run else "bf16"


def reference_of(run: str) -> str:
    """The run a served run is held against: its pool kind's REFERENCE."""
    return REFERENCE[pool_of(run)]


def bound_pair(run: str):
    """The paths whose plain difference bounds a held run's: '<the
    reference's path>_vs_<the run's>', or None for a run outside
    RUN_PATH."""
    if run not in RUN_PATH:
        return None
    return f"{RUN_PATH[reference_of(run)]}_vs_{RUN_PATH[run]}"


def held_agreement(run: str, outs: dict, bounds: dict) -> dict:
    """stream_agreement of served run `run` against its reference's
    streams (outs: {run: streams}) under the bound of its pair of paths
    on its pool kind (bounds: {pool kind: path_bounds})."""
    ref, pair = reference_of(run), bound_pair(run)
    bound = None if pair is None else bounds[pool_of(run)]["top"][pair]
    return {"reference": ref, "paths": pair,
            **stream_agreement(outs[run], outs[ref], bound)}


def served_logprobs(run: str):
    """The logprobs a windowed run serves with: TOP_LOGPROBS for a
    reference and for a held run of RUN_PATH, none for `jetstream` (held
    to equal tokens) and `mixed_ngram` (logprobs would demote its
    speculation)."""
    held = run in HELD and bound_pair(run) is not None
    return TOP_LOGPROBS if run in REFERENCE.values() or held else None


def path_states(engine: Engine, n_check: int, slots: int, steps: int,
                attn=att.PLAIN) -> dict:
    """Logits [steps, slots, V] (f32) of `slots` decode rows of random
    n_check-token prompts (seed 3), teacher-forced through `steps` steps
    (step i feeds each prompt's token n_check + i at that position) in
    the engine's MAX_SEQS-row batch, with `attn`, on each path of
    RUN_PATH: `whole` after whole prefills and in decode steps, `chunks`
    after CHUNK-token chunked prefills and in decode steps, `mixed` after
    the same chunks and in mixed steps, each beside a CHUNK-token chunk of
    another prompt (BOUND_CHUNKS chunks on pages of its own)."""
    model, dev = engine.model, engine.device
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, 256, (slots, n_check + steps), generator=gen)
    other = torch.randint(0, 256, (BOUND_CHUNKS * CHUNK,), generator=gen)
    bucket = 128 if n_check <= 128 else -(-n_check // 256) * 256
    per = max(n_check + steps, bucket) // PS + 1

    def page_list(pages, tokens):  # trash-padded, as three_paths'
        width = -(-tokens // 1024) * 1024 // PS + CHUNK // PS - 1
        plist = torch.zeros((width,), dtype=torch.int32, device=dev)
        plist[:len(pages)] = torch.tensor(pages, dtype=torch.int32,
                                          device=dev)
        return plist

    one = dict(lora=engine.lora_stacks, adapter_slots=0)
    batch = dict(lora=engine.lora_stacks,
                 adapter_slots=torch.zeros((MAX_SEQS,), dtype=torch.int32,
                                           device=dev))
    kv = (engine.k_pages, engine.v_pages)
    pages = [engine.allocator.alloc(per) for _ in range(slots)]
    other_pages = engine.allocator.alloc(BOUND_CHUNKS * CHUNK // PS)
    out = {}
    try:
        lists = [page_list(p, per * PS) for p in pages]
        other_list = page_list(other_pages, BOUND_CHUNKS * CHUNK)
        width = engine.cfg.max_seq_len // PS
        table = torch.zeros((MAX_SEQS, width), dtype=torch.int32, device=dev)
        for s in range(slots):
            n = min(width, len(lists[s]))
            table[s, :n] = lists[s][:n]
        for path in ("whole", "chunks", "mixed"):
            for s in range(slots):  # `mixed` decodes on `chunks`' K/V
                if path == "whole":
                    tokens = torch.zeros((bucket,), dtype=torch.long)
                    tokens[:n_check] = prompts[s, :n_check]
                    llama.prefill(model, tokens.to(dev), n_check, *kv,
                                  lists[s][:bucket // PS], page_size=PS,
                                  attn=attn, **one)
                elif path == "chunks":
                    for start in range(0, n_check, CHUNK):
                        take = min(CHUNK, n_check - start)
                        chunk = torch.zeros((CHUNK,), dtype=torch.long)
                        chunk[:take] = prompts[s, start:start + take]
                        llama.prefill_chunk(model, chunk.to(dev), start,
                                            take, *kv, lists[s],
                                            page_size=PS, attn=attn, **one)
            tok = torch.zeros((MAX_SEQS,), dtype=torch.long, device=dev)
            pos = torch.zeros((MAX_SEQS,), dtype=torch.int32, device=dev)
            ctx = torch.ones((MAX_SEQS,), dtype=torch.int32, device=dev)
            rows = []
            for i in range(steps):
                tok[:slots] = prompts[:, n_check + i].to(dev)
                pos[:slots], ctx[:slots] = n_check + i, n_check + i + 1
                if path == "mixed":
                    at = i % BOUND_CHUNKS * CHUNK
                    logits = llama.mixed_step(
                        model, tok, pos, table, ctx,
                        other[at:at + CHUNK].to(dev), at, CHUNK, other_list,
                        *kv, page_size=PS, attn=attn,
                        **dict(batch, chunk_adapter_slot=0))[0]
                else:
                    logits = llama.decode_step(model, tok, pos, table, ctx,
                                               *kv, page_size=PS, attn=attn,
                                               **batch)
                rows.append(logits[:slots].float())
            out[path] = torch.stack(rows)
    finally:
        for p in pages + [other_pages]:
            engine.allocator.free(p)
    return out


def path_bounds(engine: Engine, n_check: int, slots: int) -> dict:
    """The bounds of the held runs on `engine`'s pool kind: path_states
    through the plain attention (att.PLAIN) at BOUND_STEPS steps of
    `slots` rows; for each held run's pair of paths (bound_pair), the
    largest |difference| of the two paths' logprobs (log_softmax in f32,
    as the engine's) of either path's TOP_LOGPROBS top tokens over those
    states, the quantity stream_agreement bounds ("top"; its median, 90th
    percentile and mean beside it), and the largest over the whole
    vocabulary ("vocabulary"). Where the plain
    paths give equal bits (0), their served runs must too."""
    t0 = time.monotonic()
    with torch.inference_mode():
        lp = {k: torch.log_softmax(v, -1) for k, v in path_states(
            engine, n_check, slots, BOUND_STEPS).items()}
    pairs = sorted({bound_pair(r) for r in HELD if bound_pair(r)})
    out = {"states": BOUND_STEPS * slots, "seconds": time.monotonic() - t0,
           "top": {}, "vocabulary": {}, "top_spread": {}}
    for pair in pairs:
        ref, run = (lp[k] for k in pair.split("_vs_"))
        top = torch.cat([ref.topk(TOP_LOGPROBS, -1).indices,
                         run.topk(TOP_LOGPROBS, -1).indices], -1)
        d = (ref.gather(-1, top) - run.gather(-1, top)).abs().amax(-1)
        out["top"][pair] = float(d.max())
        out["top_spread"][pair] = spread(d.flatten().tolist())
        out["vocabulary"][pair] = float((ref - run).abs().max())
    return out


# the served check's controls: faults planted in the ragged call of every
# mixed step the engine takes, each as a served-path bug would be; the
# check must fail each but key_short, whose run shows what it cannot see
# (one key of a window of thousands moves a logprob by under a bf16 unit)
PLANTED_FAULTS = {
    "key_short": "decode rows read one key short (a context off by one)",
    "rows_rolled": "decode rows take the next row's output (a descriptor "
                   "off by one)",
    "chunk_shifted": "the chunk's rows read as if one page past its start",
    "rows_zero": "decode rows' outputs zero (garbage rows)",
}
UNSEEN_FAULTS = ("key_short",)


@contextlib.contextmanager
def planted_fault(kind: str):
    """While active, every llama.mixed_step runs the ragged kernel with
    fault `kind` of PLANTED_FAULTS planted around it."""
    if kind not in PLANTED_FAULTS:
        raise ValueError(f"no planted fault {kind!r}")
    orig = llama.mixed_step
    ragged = att.DISPATCH.ragged

    def faulty_ragged(q, k_pages, v_pages, block_tables, context_lens,
                      p_pages, p_start, **kw):
        b = kw["num_decode"]
        if kind == "key_short":
            context_lens = torch.where(context_lens > 1, context_lens - 1,
                                       context_lens)
        elif kind == "chunk_shifted":
            p_start += PS
        out = ragged(q, k_pages, v_pages, block_tables, context_lens,
                     p_pages, p_start, **kw)
        if kind == "rows_rolled":
            out = torch.cat([out[:b].roll(-1, 0), out[b:]])
        elif kind == "rows_zero":
            out = torch.cat([torch.zeros_like(out[:b]), out[b:]])
        return out

    def faulty(*args, **kw):
        return orig(*args, **dict(kw, attn=att.DISPATCH._replace(
            ragged=faulty_ragged)))

    llama.mixed_step = faulty
    try:
        yield
    finally:
        llama.mixed_step = orig


def ttft_alone(engine: Engine, prompt) -> float:
    """ms from add_request to the first token of one request on an idle
    engine."""
    t0 = time.monotonic()
    engine.add_request(GenRequest("ttft", prompt, max_tokens=1,
                                  ignore_eos=True))
    ms = None
    while engine.has_work:
        for ev in engine.step():
            if ev.token_id >= 0 and ms is None:
                ms = (time.monotonic() - t0) * 1e3
    return ms


def planted_fault_control(mixed: Engine, serve, outs: dict, bounds: dict,
                          kind: str) -> dict:
    """The served check's control: a fresh engine of `mixed`'s config and
    weights serves the streams again (serve: engine -> streams) under
    planted_fault(kind), and is held as `mixed` (held_agreement against
    classic in outs, bounds as windowed_phase's). -> {"fault", "agreement",
    "vocabulary_limit": the limit a bound over the whole vocabulary
    (path_bounds' "vocabulary") would set}; its launches are no served
    run's."""
    eng = Engine(mixed.cfg, model_cfg=mixed.model_cfg, params=mixed.model,
                 device=mixed.device)
    with planted_fault(kind):
        streams = serve(eng)
    steps = eng.metrics.mixed_count
    del eng
    release()
    if steps == 0:
        raise AssertionError("the control took no mixed step")
    row = held_agreement("mixed", dict(outs, mixed=streams), bounds)
    return {"fault": PLANTED_FAULTS[kind], "mixed_count": steps,
            "agreement": row, "vocabulary_limit": BOUND_FACTOR
            * bounds["bf16"]["vocabulary"][row["paths"]]}


def windowed_phase(model: str, n_check: int, lengths, eager_cfg: dict,
                   jet_cfg: dict, *, size: dict, runs, kernels,
                   profiled: bool = False, model_cfg=None, params=None,
                   int8_checks: bool = True, n_streams: int = GEMMA_STREAMS,
                   http: bool = False, controls=(),
                   q_scale: float = None) -> dict:
    """A windowed model (Gemma-2/3, Phi-3) at full width (and the depth
    of `model_cfg`), every
    served prompt longer than its window, all engines at `size` (the same
    slots: a decode step's shapes fix its bits), on `model_cfg` (None: the
    preset's) and `params` (None: random bf16 weights from seed 0):
    - phase 4's forwards (three_paths) at an n_check-token prefill (then
      its decode and verify rows) and an n_check + 100-token chunked
      prompt on bf16 pools and, with int8_checks, int8 pools, every
      attention call held against the plain version and the logits
      within LOGIT_REL_TOL (q scaled by `q_scale`: forward_checks');
    - path_bounds on each pool kind checked, at n_streams slots: the
      held runs' bounds;
    - n_streams greedy streams of GEMMA_TOKENS tokens from prompts of
      `lengths` tokens on each of `runs`: `classic`, an eager engine
      prefilling whole prompts, `chunked` and `chunked_int8` (its 256-token
      chunks, on bf16 and int8 pools), the `jetstream` graph-window engine
      (must equal classic token for token: the same kernels on the same
      shapes), `jetstream_int8`, `mixed` and `mixed_int8`
      (mixed_batch_tokens=256: chunks and mixed steps) and `mixed_ngram`
      (n-gram speculation beside them); each run of HELD held against its
      reference (held_agreement; served_logprobs says which serve with 2
      logprobs); TTFT, mean ITL and tokens per second of each; with
      `controls`, the mixed engine again with each planted fault of
      them (planted_fault_control), held as `mixed`: the check must fail
      every one but UNSEEN_FAULTS'; with
      `http`, the OpenAI server on the jetstream engine with phase 5's
      four concurrent requests (window_serve);
    - with a mixed run, one prompt's TTFT alone, whole and in 256-token
      chunks;
    - with `profiled`, where a graph-window decode step's time goes at 8
      slots past the window (n_check-token prompts);
    every kernel of `kernels` must launch with the window.
    -> {"launches", "variants", "row"}: each served run's counts, and
    the served runs' numbers."""
    classic_cfg = dict(eager_cfg, model=model, prefill_chunk_tokens=0,
                       **size)
    t0 = time.monotonic()
    engine = Engine(EngineConfig(**classic_cfg), model_cfg=model_cfg,
                    params=params)
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    weights = engine.model
    windows = [llama._attn_kwargs(cfg, l).get("window", 0)
               for l in range(cfg.num_layers)]
    longrope = cfg.rope_longrope_scaling
    emit({"phase": "windowed_engine", "model": cfg.name,
          "seconds": time.monotonic() - t0, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "vocab": cfg.vocab_size, "max_seq_len": size["max_seq_len"],
          "features": {k: getattr(cfg, k) for k in (
              "sliding_window", "sliding_window_pattern",
              "attn_logit_softcapping", "final_logit_softcapping",
              "query_pre_attn_scalar", "post_norms", "rope_theta",
              "rope_local_theta", "rope_scaling_factor", "qk_norm",
              "max_position_embeddings")},
          "longrope": None if longrope is None else {
              "original_max_pos": longrope[2], "factors": len(longrope[0]),
              "attention_factor": llama._longrope_args(cfg)[3]},
          "local_layers": sum(1 for x in windows if x),
          "params": loader.num_params(cfg),
          "weights_gib": quant.param_bytes(weights) / 2**30,
          "kv_pool_gib": engine.kv_spec.pool_bytes / 2**30})
    # the decode and verify rows read past the prefill: a longer prompt
    sizes = dict(n_prefill=n_check, n_prompt=n_check + 100)
    with torch.inference_mode():
        forward_checks(engine, **sizes, q_scale=q_scale)
        bounds = {"bf16": path_bounds(engine, n_check, n_streams)}
        if int8_checks:
            eng8 = Engine(EngineConfig(**classic_cfg, kv_cache_dtype="int8"),
                          model_cfg=model_cfg, params=weights)
            forward_checks(eng8, **sizes, q_scale=q_scale)
            bounds["int8"] = path_bounds(eng8, n_check, n_streams)
            del eng8
            release()

    prompts = gemma_prompts(*lengths, seed=31, n=n_streams)
    served, row = [], {"model": cfg.name,
                       "prompt_tokens": [len(p) for p in prompts],
                       "path_bounds": bounds, "bound_factor": BOUND_FACTOR}

    def serve(name, eng, logprobs=None):
        ca.reset_launch_counts()
        out, timing = timed_run(eng, prompts, logprobs)
        served.append({"launches": dict(ca.LAUNCHES),
                       "variants": dict(ca.VARIANT_LAUNCHES)})
        row[name] = {**timing, "launches": served[-1]["launches"]}
        return out

    outs = {"classic": serve("classic", engine,
                             logprobs=served_logprobs("classic"))}
    for name in runs:
        if name == "classic":
            continue
        if name.startswith("jetstream"):
            eng = Engine(EngineConfig(
                **dict(jet_cfg, model=model, **size),
                kv_cache_dtype="int8" if pool_of(name) == "int8" else "auto"),
                model_cfg=model_cfg, params=weights)
            t0 = time.monotonic()
            eng.warmup()
            emit({"phase": "warmup", "engine": f"{name} {cfg.name}",
                  "seconds": time.monotonic() - t0, **eng.windows.stats()})
            outs[name] = serve(name + "_run", eng,
                               logprobs=served_logprobs(name))
            row[name] = {"graphs": eng.windows.stats()}
            if name == "jetstream":
                row[name]["agreement"] = stream_agreement(outs[name],
                                                          outs["classic"])
                if http:
                    row["jetstream_http"] = window_serve(eng)
                    served.append({k: row["jetstream_http"][k]
                                   for k in ("launches", "variants")})
                if profiled:
                    with torch.inference_mode():
                        emit({"phase": "profile", "model": cfg.name,
                              "weights": "none",
                              **profile_steps(eng, 4, prompt_len=n_check)})
        else:
            eng = Engine(EngineConfig(**dict(classic_cfg,
                                             **WINDOWED_RUN_CFG[name])),
                         model_cfg=model_cfg, params=weights)
            outs[name] = serve(name, eng, logprobs=served_logprobs(name))
            row[name].update(mixed_count=eng.metrics.mixed_count,
                             mixed_spec_count=eng.metrics.mixed_spec_count,
                             spec_verify_steps=eng.metrics.spec_verify_steps)
            if name == "mixed":
                row["ttft_alone_ms"] = {"whole_prompt": ttft_alone(
                    engine, prompts[0]), "chunks_of_256": ttft_alone(
                    eng, prompts[0]), "prompt_tokens": len(prompts[0])}
            if name == "mixed":
                row["controls"] = {k: planted_fault_control(
                    eng, lambda e: timed_run(e, prompts, TOP_LOGPROBS)[0],
                    outs,
                    bounds, k) for k in controls}
        if name in HELD:
            row[name]["agreement"] = held_agreement(name, outs, bounds)
        del eng
        release()
    emit({"phase": "windowed_serve", **row})
    passed = {k: c for k, c in row.get("controls", {}).items()
              if c["agreement"]["ok"] and k not in UNSEEN_FAULTS}
    if passed:
        raise AssertionError(f"{cfg.name}: the served check passed "
                             f"planted faults: {passed}")
    if "jetstream" in runs and not row["jetstream"]["agreement"]["equal"]:
        raise AssertionError(f"{cfg.name}: graph windows differ from the "
                             f"eager engine: {row['jetstream']['agreement']}")
    bad = [k for k in runs if k in HELD and not row[k]["agreement"]["ok"]]
    if bad:
        raise AssertionError(f"{cfg.name}: {bad} streams leave their "
                             f"reference's past the bound or a near-tie: "
                             f"{ {k: row[k]['agreement'] for k in bad} }")
    eager = [k for k in runs if k in WINDOWED_RUN_CFG]
    if (any(row[k]["mixed_count"] == 0 for k in eager if "mixed" in k)
            or any(row[k]["spec_verify_steps"] == 0
                   for k in eager if "ngram" in k)):
        raise AssertionError(f"{cfg.name}: no mixed or verify steps ran: "
                             f"{row}")
    counts = {}
    for run in served:
        for k, n in run["variants"].items():
            counts[k] = counts.get(k, 0) + n
    missing = [k for k in kernels if not counts.get(f"{k}[window]")]
    if missing:
        raise AssertionError(f"{cfg.name}: windowed kernels never launched: "
                             f"{missing} ({counts})")
    del engine, weights
    release()
    return {"launches": [s["launches"] for s in served],
            "variants": [s["variants"] for s in served], "row": row}


def gemma_phase(model: str, layers: int, n_check: int, lengths,
                profiled: bool, eager_cfg: dict, jet_cfg: dict) -> dict:
    """One Gemma model's windowed_phase at `layers` of its layers and
    served_weights: 8 slots on GEMMA_SIZE's pages of an 8192 max length,
    every run of GEMMA_RUNS, the forwards on both pool kinds (q as the
    weights give it). -> {"launches", "variants", "peak_gib"} as
    family_phase."""
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(
        ModelConfig.from_model_name(model, dtype="bfloat16"),
        num_layers=layers)
    out = windowed_phase(model, n_check, lengths, eager_cfg, jet_cfg,
                         size=GEMMA_SIZE, runs=GEMMA_RUNS,
                         kernels=WINDOWED_KERNELS, profiled=profiled,
                         model_cfg=cfg, params=served_weights(cfg),
                         q_scale=1.0)
    return {"launches": out["launches"], "variants": out["variants"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def served_weights(cfg):
    """A windowed model's served weights: random bf16 weights from seed 0
    (the engine's own loader), wq scaled by WINDOWED_WQ_SCALE where the
    model has no q/k norm (with one, q's scale does not reach the
    scores)."""
    weights = loader.load_or_init(cfg, None, seed=0, quantization="none",
                                  device=torch.device("cuda"),
                                  dtype=torch.bfloat16)
    if not cfg.qk_norm:
        for layer in weights.layers:
            layer.wq.mul_(WINDOWED_WQ_SCALE)  # a power of 2: exact in bf16
    return weights


def phi3_longrope_config():
    """Phi-3-mini's widths under longrope, through the port's
    from_hf_config from the config.json dict of a 128k checkpoint written
    here: 48 short and 48 long factors from seed 0 (near 1, and 1 to 8;
    the real arrays are checkpoint data), original_max_pos 4096 of
    131072 positions, and a sliding window wider than any context of the
    phase (a window on every layer, as Phi-3's)."""
    p = ModelConfig.from_model_name(PHI3_MODEL)
    rng = np.random.default_rng(0)
    half = p.head_dim // 2
    hf = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
          "vocab_size": p.vocab_size, "hidden_size": p.hidden_size,
          "intermediate_size": p.intermediate_size,
          "num_hidden_layers": p.num_layers,
          "num_attention_heads": p.num_heads,
          "num_key_value_heads": p.num_kv_heads, "hidden_act": "silu",
          "rms_norm_eps": p.rms_norm_eps, "rope_theta": p.rope_theta,
          "max_position_embeddings": 131072,
          "original_max_position_embeddings": LONGROPE_ORIGINAL,
          "sliding_window": 262144, "tie_word_embeddings": False,
          "eos_token_id": p.eos_token_id, "bos_token_id": p.bos_token_id,
          "rope_scaling": {
              "type": "longrope",
              "short_factor": rng.uniform(1.0, 1.3, half).tolist(),
              "long_factor": rng.uniform(1.0, 8.0, half).tolist()}}
    cfg = ModelConfig.from_hf_config(hf, name=f"{PHI3_MODEL}-longrope")
    if (llama.unported_model_features(cfg)
            or cfg.rope_longrope_scaling[2] != LONGROPE_ORIGINAL
            or cfg.head_dim != p.head_dim):
        raise AssertionError(f"the longrope config is not Phi-3's: {cfg}")
    return cfg


def phi3_phase(eager_cfg: dict, jet_cfg: dict) -> dict:
    """Phi-3-mini (PHI3_MODEL: 32 layers, head_dim 96, 32/32 heads, a
    2047-key window on every layer) at full width and PHI3_LAYERS of its
    layers,
    served_weights (WINDOWED_WQ_SCALE says why): windowed_phase at
    PHI3_SIZE with PHI3_RUNS and the served check's controls, the
    forwards on both pool kinds (q as the weights give it), the OpenAI
    server on its jetstream
    engine, the graph-window step profiled; then the same weights under
    longrope
    (phi3_longrope_config) at LONGROPE_SIZE: the forwards on bf16 pools
    and two ~6000-token prompts on LONGROPE_RUNS, past original_max_pos.
    -> {"launches", "variants", "peak_gib"} as family_phase, over both."""
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(
        ModelConfig.from_model_name(PHI3_MODEL, dtype="bfloat16"),
        num_layers=PHI3_LAYERS)
    weights = served_weights(cfg)
    four_k = windowed_phase(PHI3_MODEL, PHI3_N_CHECK, PHI3_LENGTHS,
                            eager_cfg, jet_cfg, size=PHI3_SIZE,
                            runs=PHI3_RUNS, kernels=WINDOWED_KERNELS,
                            profiled=True, model_cfg=cfg, params=weights,
                            http=True, controls=tuple(PLANTED_FAULTS),
                            q_scale=1.0)
    longrope = windowed_phase(
        PHI3_MODEL, LONGROPE_N_CHECK, LONGROPE_LENGTHS, eager_cfg, jet_cfg,
        size=LONGROPE_SIZE, runs=LONGROPE_RUNS,
        kernels=("decode", "prefill", "chunk", "ragged"),
        model_cfg=dataclasses.replace(phi3_longrope_config(),
                                      num_layers=PHI3_LAYERS),
        params=weights, int8_checks=False, n_streams=2, q_scale=1.0)
    emit({"phase": "phi3_serve", "ttft_ms": {
        "phi3": four_k["row"]["jetstream_run"]["ttft_ms"],
        "phi3_longrope": longrope["row"]["classic"]["ttft_ms"]},
        "tokens_per_s": four_k["row"]["jetstream_run"]["tokens_per_s"],
        "itl_ms_mean": four_k["row"]["jetstream_run"]["itl_ms_mean"]})
    del weights
    release()
    return {"launches": four_k["launches"] + longrope["launches"],
            "variants": four_k["variants"] + longrope["variants"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# the kernels line's rows at Gemma-2-9B's shape, their launches the served
# gemma-2-9b-it phase's windowed launches, and at Phi-3's, the served
# Phi-3 phase's launches at head_dim 96
FAMILY_ROWS += [(GEMMA_LABEL, k, "gemma-2-9b-it", f"{k}[window]")
                for k in WINDOWED_KERNELS]
FAMILY_ROWS += [(PHI3_LABEL, k, PHI3_MODEL, f"{k}[head_dim=96]")
                for k in WINDOWED_KERNELS]


def gemma_only(eager_cfg: dict, jet_cfg: dict) -> None:
    """`--gemma`: phase 3's Gemma rows, then the Gemma models' phase."""
    dev = torch.device("cuda")
    rows = windowed_kernel_checks(dev, GEMMA_SHAPE)
    for model, layers, n_check, lengths, profiled in GEMMA_MODELS:
        gemma_phase(model, layers, n_check, lengths, profiled, eager_cfg,
                    jet_cfg)
    emit({"phase": "gemma_only", "kernel_ms": {
        r["name"]: r["kernel_ms"] for r in rows.values()}})


def phi3_only(eager_cfg: dict, jet_cfg: dict) -> None:
    """`--phi3`: phase 3's Phi-3 rows, then the Phi-3 phase."""
    dev = torch.device("cuda")
    rows = windowed_kernel_checks(dev, PHI3_SHAPE)
    out = phi3_phase(eager_cfg, jet_cfg)
    emit({"phase": "phi3_only", "peak_gib": out["peak_gib"], "kernel_ms": {
        r["name"]: r["kernel_ms"] for r in rows.values()}})


# ------------------------------------------------------------- phase 16 --

# phase 16's streamed requests: 128 tokens, every token its own SSE event
# (the server runs VisibleTokenizer)
OBS_STREAM = dict(CHAT, stream=True, max_tokens=128,
                  stream_options={"include_usage": True})
OBS_STREAMS, OBS_CONCURRENT = 16, 4
OBS_WAVE_S = 120  # a wave takes 1-2 s, 8-16 s with a 1 s trace in it
TRACE_STRESS_WAVES = 24
# the plane's switches, read when an engine (flight recorder, timeline) is
# built and at every span (tracing)
OBS_SWITCHES = ("DYNAMO_TPU_TRACE", "DYNAMO_TPU_TIMELINE",
                "DYNAMO_TPU_FLIGHT_RECORDS")
MBU_REL_TOL = 0.10  # the gauge against chip_smoke's own reckoning
DEVICE_BYTES_REL_TOL = 0.01  # the device gauge against memory_allocated
_SAMPLE_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)'
                        r'(?: # .*)?$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def scrape(base: str, accept: str = None) -> str:
    req = urllib.request.Request(base + "/metrics",
                                 headers={"Accept": accept} if accept
                                 else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def samples(page: str) -> dict:
    """{(name, ((label, value), ...)): value} of a /metrics page; raises
    on a line that is neither a comment nor a sample."""
    out = {}
    for line in page.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise AssertionError(f"unparseable /metrics line: {line!r}")
        labels = tuple(sorted(_LABEL_RE.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def exposition_errors(page: str) -> list:
    """chip_smoke's own check of a /metrics page: every line parses, and
    each histogram's buckets are cumulative with +Inf equal to _count."""
    values = samples(page)
    buckets = {}
    for (name, labels), v in values.items():
        if name.endswith("_bucket"):
            le = dict(labels)["le"]
            rest = tuple(kv for kv in labels if kv[0] != "le")
            buckets.setdefault((name[:-len("_bucket")], rest), []).append(
                (float("inf") if le == "+Inf" else float(le), v))
    errors = []
    for (name, rest), rows in buckets.items():
        rows.sort()
        counts = [c for _, c in rows]
        if counts != sorted(counts):
            errors.append(f"{name}{dict(rest)}: buckets not cumulative")
        if rows[-1][0] != float("inf") or \
                values.get((name + "_count", rest)) != counts[-1]:
            errors.append(f"{name}{dict(rest)}: +Inf != _count")
    return errors


def obs_stream_summary(result) -> dict:
    """Usage, TTFT, mean ITL and tokens per second of one 128-token
    stream (one SSE event per token)."""
    status, payload, stamps, _ = result
    if status != 200 or payload[-1] != "[DONE]":
        raise AssertionError(f"stream: HTTP {status}, {payload[-2:]}")
    usage = json.loads(payload[-2])["usage"]
    n = usage["completion_tokens"]
    if n != OBS_STREAM["max_tokens"]:
        raise AssertionError(f"stream: usage {usage}")
    tok = stamps[1:1 + n]
    return {"prompt_tokens": usage["prompt_tokens"],
            "completion_tokens": n, "ttft_s": tok[0],
            "itl_mean_s": (tok[-1] - tok[0]) / (n - 1),
            "tokens_per_s": (n - 1) / (tok[-1] - tok[0])}


def obs_wave(base: str, capture: bool = False) -> tuple:
    """OBS_CONCURRENT streamed chats of 128 tokens at once; with
    `capture`, a 1 s /debug/trace requested as they start (they last
    longer than the capture). -> (their summaries, the wave's seconds,
    the trace's bytes and client-side window or None)."""
    t0 = time.monotonic()
    out, got = [None] * OBS_CONCURRENT, {}

    def one(i):
        out[i] = post(base + "/v1/chat/completions", OBS_STREAM, True)

    def trace():
        t_req = time.monotonic() - t0
        with urllib.request.urlopen(base + "/debug/trace?duration_s=1",
                                    timeout=120) as r:
            got["zip"] = r.read()
        got["window_s"] = [t_req, time.monotonic() - t0]

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(OBS_CONCURRENT)]
    if capture:
        ts.insert(0, threading.Thread(target=trace, daemon=True))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=OBS_WAVE_S - (time.monotonic() - t0))
    if any(t.is_alive() for t in ts):
        raise AssertionError(f"phase 16: a wave (capture {capture}) did "
                             f"not end within {OBS_WAVE_S} s")
    return ([obs_stream_summary(r) for r in out], time.monotonic() - t0,
            got or None)


def obs_traffic(base: str) -> dict:
    """Phase 5's four concurrent requests, then OBS_STREAMS streamed chats
    of 128 tokens, OBS_CONCURRENT at a time. -> the client's usage sums
    and the streams' TTFT, mean ITL and tokens per second."""
    jobs = FOUR_JOBS
    results = {}

    def run(name):
        path, body, stream = jobs[name]
        results[name] = post(base + path, body, stream)

    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    usage = [summarize(n, results[n], jobs[n][2]) for n in jobs]
    streams, wall = [], 0.0
    for _ in range(OBS_STREAMS // OBS_CONCURRENT):
        wave, seconds, _ = obs_wave(base)
        streams += wave
        wall += seconds
    usage += streams
    return {"requests": len(usage),
            "prompt_tokens": sum(u["prompt_tokens"] for u in usage),
            "completion_tokens": sum(u["completion_tokens"] for u in usage),
            "itl_observations": sum(u["completion_tokens"] - 1
                                    for u in usage),
            "streams": {
                "ttft_mean_s": statistics.mean(u["ttft_s"] for u in streams),
                "itl_mean_s": statistics.mean(u["itl_mean_s"]
                                              for u in streams),
                "tokens_per_s": sum(u["completion_tokens"] for u in streams)
                / wall}}


def trace_kernels(data: bytes) -> tuple:
    """Device kernels of a /debug/trace zip's chrome trace, by name, and
    its events by category."""
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(data)) as z:
        events = json.loads(z.read("trace.json"))["traceEvents"]
    names, cats = {}, {}
    for ev in events:
        cats[str(ev.get("cat"))] = cats.get(str(ev.get("cat")), 0) + 1
        if ev.get("cat") == "kernel":
            names[ev["name"]] = names.get(ev["name"], 0) + 1
    return names, cats


def mbu_reckoning(engine: Engine, d_tok: int, d_time: float,
                  d_steps: int) -> float:
    """The decode phase's memory-bandwidth share from the loaded weights'
    and the pools' bytes on the card (not the roofline's counts) over the
    engine's counters: each step streams every weight once and each live
    row's KV; the context is the gauge's own fallback for an idle engine
    (half of max_seq_len)."""
    if engine.seqs:
        raise AssertionError("phase 16 scrapes an idle engine")
    w_bytes = sum(p.numel() * p.element_size()
                  for p in engine.model.parameters())
    kv_token = ((engine.k_pages.nbytes + engine.v_pages.nbytes)
                / (engine.cfg.num_pages * engine.cfg.page_size))
    tok_s = d_tok / d_time
    batch = max(d_tok / d_steps, 1.0)
    ctx = engine.cfg.max_seq_len / 2.0
    return (tok_s / batch) * (w_bytes + batch * kv_token * ctx) \
        / HBM_BYTES_PER_S


def obs_serve(engine: Engine, checked: bool) -> dict:
    """Phase 16's traffic on `engine` behind the worker, /metrics scraped
    before and after; `checked`: every check of the plane (see the module
    doc), the trace taken on one more wave after the second scrape."""
    m = engine.metrics
    with serving(engine, VisibleTokenizer(), utilization=False) as base:
        before_page = scrape(base)
        c0 = (m.output_tokens, m.decode_time_s, m.decode_steps)
        client = obs_traffic(base)
        page = scrape(base)
        allocated = torch.cuda.memory_allocated()
        c1 = (m.output_tokens, m.decode_time_s, m.decode_steps)
        om = scrape(base, "application/openmetrics-text")
        timeline = json.loads(urllib.request.urlopen(
            base + "/debug/timeline?format=summary", timeout=60).read())
        gap = engine.timeline.gap_digest
        host_gap = {"p50": gap.quantile_ms(0.5), "p99": gap.quantile_ms(0.99),
                    "count": gap.count}
        if checked:
            _, wave_s, trace = obs_wave(base, capture=True)
    now = samples(page)
    out = {"client": client, "host_gap_ms": host_gap,
           "mfu": now[("dynamo_engine_mfu", ())],
           "mbu": now[("dynamo_engine_mbu", ())],
           "timeline_phase_share": {k: v["share"] for k, v in
                                    timeline.get("phases", {}).items()}}
    if not checked:
        return out
    errors = exposition_errors(before_page) + exposition_errors(page) + [
        f"openmetrics: {e}" for e in exposition_errors(om)]
    if not om.endswith("# EOF\n") or " # {trace_id=" not in om:
        errors.append("openmetrics: no # EOF or no exemplar")
    was = samples(before_page)
    lbl = (("model", MODEL),)

    def delta(name):
        return now.get((name, lbl), 0.0) - was.get((name, lbl), 0.0)

    counts = {
        "ttft": (delta("dynamo_frontend_time_to_first_token_seconds_count"),
                 client["requests"]),
        "itl": (delta("dynamo_frontend_inter_token_latency_seconds_count"),
                client["itl_observations"]),
        "isl_sum": (delta("dynamo_frontend_input_sequence_tokens_sum"),
                    client["prompt_tokens"]),
        "osl_sum": (delta("dynamo_frontend_output_sequence_tokens_sum"),
                    client["completion_tokens"]),
        "requests": (delta("dynamo_frontend_requests_total"),
                     client["requests"]),
    }
    for k, (got, want) in counts.items():
        if got != want:
            errors.append(f"{k}: server {got} != client {want}")
    mfu, mbu = out["mfu"], out["mbu"]
    if not (0.0 < mfu <= 1.0 and 0.0 < mbu <= 1.0):
        errors.append(f"mfu {mfu}, mbu {mbu} outside (0, 1]")
    d_tok, d_time, d_steps = (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2])
    mbu_own = mbu_reckoning(engine, d_tok, d_time, d_steps)
    if abs(mbu - mbu_own) > MBU_REL_TOL * mbu_own:
        errors.append(f"mbu {mbu} vs reckoned {mbu_own}")
    in_use = now[("dynamo_memory_device_bytes",
                  (("device", "cuda:0"), ("kind", "in_use")))]
    if abs(in_use - allocated) > DEVICE_BYTES_REL_TOL * allocated:
        errors.append(f"device bytes {in_use} vs memory_allocated "
                      f"{allocated}")
    books = {dict(k[1])["tenant"]: v for k, v in now.items()
             if k[0] == "dynamo_memory_kv_pool_bytes"
             and dict(k[1]).get("tier") == "device"}
    pools = engine.k_pages.nbytes + engine.v_pages.nbytes
    if sum(books.values()) != pools:
        errors.append(f"KV books {books} sum to {sum(books.values())}, "
                      f"pools hold {pools}")
    kernels, cats = trace_kernels(trace["zip"])
    decode = {k: n for k, n in kernels.items() if "decode_kernel" in k}
    if not decode:
        errors.append(f"the trace holds no decode kernel: "
                      f"{sorted(kernels)[:10]}, events by category {cats},"
                      f" window {trace['window_s']}, wave {wave_s}")
    from dynamo_tpu_torch.profiler import roofline

    out.update(
        counts={k: {"server": g, "client": w}
                for k, (g, w) in counts.items()},
        mbu_reckoned=mbu_own,
        decode_counters={"tokens": d_tok, "seconds": d_time,
                         "steps": d_steps},
        device_bytes={"gauge": in_use, "memory_allocated": allocated},
        kv_books=books, kv_pools_nbytes=pools,
        roofline_vs_card={
            "param_count_bytes": roofline.param_count(engine.model_cfg)
            * roofline.BYTES,
            "weights_nbytes": sum(p.numel() * p.element_size()
                                  for p in engine.model.parameters()),
            "kv_bytes_per_token": roofline.kv_bytes_per_token(
                engine.model_cfg, engine.cfg.kv_cache_dtype),
            "pools_bytes_per_token": pools / (engine.cfg.num_pages
                                              * engine.cfg.page_size)},
        trace={"bytes": len(trace["zip"]), "decode_kernels": decode,
               "kernel_names": len(kernels), "events": cats,
               "window_s": trace["window_s"], "wave_s": wave_s},
        graphs=now[("dynamo_engine_jit_programs", ())],
        warmup_s=now[("dynamo_engine_warmup_seconds", ())])
    if errors:
        raise AssertionError(f"phase 16: {errors}")
    return out


def observability_phase(engine: Engine, jet_cfg: dict) -> dict:
    """Phase 16 (see the module doc): the same traffic with the plane's
    switches off, then on and checked, for the plane's served cost; each
    run on a fresh graph-window engine over the 8B's weights."""
    from torch.profiler import ProfilerActivity, profile

    # the profiler's first start in a process takes seconds (CUPTI's
    # initialization) and leaves kernel launches slower after it: start it
    # once here, so that every run serves in the same state
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    emit({"phase": "profiler_init", "seconds": time.monotonic() - t0})
    runs = []
    for plane in ("off", "on"):
        checked = len(runs) == 1  # the first run with the plane on
        saved = {k: os.environ.get(k) for k in OBS_SWITCHES}
        if plane == "off":
            os.environ.update({k: "0" for k in OBS_SWITCHES})
        try:
            eng = Engine(EngineConfig(**jet_cfg), params=engine.model)
            eng.warmup()
            if plane == "off" and (eng.flight.enabled or
                                   eng.timeline.enabled):
                raise AssertionError("phase 16: the switches were not read")
            runs.append((plane, obs_serve(eng, checked)))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        del eng
        release()
    emit({"phase": "observability", **runs[1][1]})
    emit({"phase": "observability_cost", "model": MODEL,
          "runs": [{"plane": plane, **r["client"]["streams"],
                    "mfu": r["mfu"], "mbu": r["mbu"]}
                   for plane, r in runs]})
    return dict(runs)

def trace_stress(jet_cfg: dict) -> None:
    """`--trace-stress`: TRACE_STRESS_WAVES waves of OBS_CONCURRENT
    128-token streams on the 8B's graph-window engine behind the worker,
    a 1 s /debug/trace in three of every four; each wave's seconds. The
    profiler's stop beside a CUDA graph replay on the scheduler thread
    hung both threads, one capture in three, before the worker took the
    profiler's start and stop between two engine steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass  # CUPTI's first start, as in phase 16
    eng = Engine(EngineConfig(**jet_cfg))
    eng.warmup()
    waves = []
    with serving(eng, VisibleTokenizer(), utilization=False) as base:
        for i in range(TRACE_STRESS_WAVES):
            capture = i % 4 != 3
            streams, seconds, got = obs_wave(base, capture)
            waves.append({"capture": capture, "seconds": seconds,
                          "trace_bytes": len(got["zip"]) if got else None,
                          "tokens_per_s": sum(s["tokens_per_s"]
                                              for s in streams)})
            emit({"phase": "trace_stress_wave", "wave": i, **waves[-1]})
    emit({"phase": "trace_stress", "waves": len(waves), "captures": sum(
        w["capture"] for w in waves), **{
        k: [min(w["seconds"] for w in waves if w["capture"] == c),
            max(w["seconds"] for w in waves if w["capture"] == c)]
        for k, c in (("capture_wave_s", True), ("plain_wave_s", False))}})


# ------------------------------------------------------------- phase 17 --

# phase 17's greedy completions: four prompts of one length (one batched
# prefill when they queue together), each token one character
# (VisibleTokenizer), so a response's text is its token ids
LC_PROMPTS = [f"Lifecycle probe {i}: drain, flip, trip and resurrect."[:48]
              .ljust(48, ".") for i in range(4)]
LC_TOKENS = 32
LC_PREFIX = "A prompt the prefix cache keeps across its pages. " * 3
LC_TRACE_TOKENS = 96
LC_V2_SEED = 1  # the second weight version: the 8B drawn from this seed
LC_STEP_DEADLINE_S = 1.0  # DYNAMO_TPU_STEP_DEADLINE_S for the hang drill
LC_HANG_S = 3.0  # engine.device_hang's device spin
LC_PROBE_S = 0.1  # /ready and /live must answer within this while it spins


def lc_body(prompt: str, max_tokens: int = LC_TOKENS, **kw) -> dict:
    return dict(model=MODEL, prompt=prompt, max_tokens=max_tokens,
                temperature=0.0, ignore_eos=True, **kw)


def lc_status(url: str, body: dict = None, headers=None) -> tuple:
    """(HTTP status, seconds) of a GET (no body) or POST, errors too."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
            return r.status, time.monotonic() - t0
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, time.monotonic() - t0


def lc_submit(engine: Engine, base: str, prompts) -> tuple:
    """Queue greedy completions of `prompts` so that they admit together
    (one batched prefill, as every run of them here): the scheduler held
    between two steps while they arrive, in order, and the prefix cache
    emptied first. -> (threads, results) for lc_collect."""
    results = [None] * len(prompts)

    def one(i):
        results[i] = post(base + "/v1/completions", lc_body(prompts[i]),
                          False)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    with engine.between_steps():
        if engine.prefix_cache is not None:
            engine.prefix_cache.evict(engine.cfg.num_pages)
        n0 = len(engine.pending)
        for i, t in enumerate(threads):
            t.start()
            deadline = time.monotonic() + 30
            while len(engine.pending) < n0 + i + 1:
                if time.monotonic() > deadline:
                    raise AssertionError("phase 17: a request never queued")
                time.sleep(0.001)
    return threads, results


def lc_collect(submitted: tuple) -> list:
    """[(text, finish_reason)] of lc_submit's completions."""
    threads, results = submitted
    for t in threads:
        t.join(timeout=120)
    out = []
    for r in results:
        if r is None or r[0] != 200:
            raise AssertionError(f"phase 17: a completion failed: {r}")
        choice = r[1]["choices"][0]
        out.append((choice["text"], choice["finish_reason"]))
    return out


def lc_wait(cond, timeout: float, what: str) -> float:
    """Seconds until cond() holds; raises after `timeout`."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"phase 17: {what} within {timeout} s")
        time.sleep(0.005)
    return time.monotonic() - t0


def lifecycle_phase(engine: Engine, jet_cfg: dict) -> dict:
    """Phase 17 (see the module doc): the worker's lifecycle on one
    graph-window worker over HTTP, on the 8B's weights."""
    from dynamo_tpu_torch.robustness import faults

    t_phase = time.monotonic()
    cfg = dict(jet_cfg, prefill_chunk_tokens=CHUNK,
               enable_prefix_caching=True)
    errors, out = [], {}
    # v2's greedy tokens from an engine booted on it, freed before v2 is
    # staged beside v1
    ref = Engine(EngineConfig(**dict(cfg, seed=LC_V2_SEED)))
    ref.warmup()
    with serving(ref, VisibleTokenizer(), utilization=False) as base:
        v2_ref = lc_collect(lc_submit(ref, base, LC_PROMPTS))
    del ref
    release()
    eng = Engine(EngineConfig(**cfg), params=engine.model)
    eng.warmup()
    wd, wm = eng.watchdog, eng.weights
    plane = faults.reset_plane()
    try:
        with serving(eng, VisibleTokenizer(), utilization=False) as base:
            # a spent x-deadline: 504 before any slot
            n0 = eng.metrics.num_requests
            code, _ = lc_status(base + "/v1/completions", lc_body("late"),
                                {"x-deadline": "0"})
            out["deadline"] = {"status": code,
                               "admitted": eng.metrics.num_requests - n0}
            if code != 504 or eng.metrics.num_requests != n0:
                errors.append(f"deadline: {out['deadline']}")

            # the NaN sentinel: the lead lane of a batched prefill
            v1_ref = lc_collect(lc_submit(eng, base, LC_PROMPTS))
            plane.configure({"engine.device_nan": {"times": 1}})
            got = lc_collect(lc_submit(eng, base, LC_PROMPTS))
            plane.clear()
            faults_n = samples(scrape(base)).get(
                ("dynamo_engine_integrity_faults_total",
                 (("sentinel", "logits"),)))
            out["integrity"] = {"lead": got[0], "others_equal":
                                got[1:] == v1_ref[1:], "faults": faults_n,
                                "health": wd.health}
            if (got[0] != ("", "error") or got[1:] != v1_ref[1:]
                    or faults_n != 1 or wd.health != "healthy"):
                errors.append(f"integrity: {out['integrity']}")

            # a 1 s /debug/trace beside two streams, the derived deadline
            # armed (no override): no trip
            trips0 = dict(wd.summary()["trips_total"])
            streams = [None, None]

            def stream_one(i):
                streams[i] = post(base + "/v1/completions",
                                  lc_body(LC_PROMPTS[i], LC_TRACE_TOKENS,
                                          stream=True), True)

            ts = [threading.Thread(target=stream_one, args=(i,),
                                   daemon=True) for i in range(2)]
            t0 = time.monotonic()
            for t in ts:
                t.start()
            with urllib.request.urlopen(base + "/debug/trace?duration_s=1",
                                        timeout=120) as r:
                trace_bytes = len(r.read())
            for t in ts:
                t.join(timeout=120)
            summ = wd.summary()
            out["profiler"] = {
                "seconds": time.monotonic() - t0, "trace_bytes": trace_bytes,
                "trips": summ["trips_total"], "deadline_s": summ["deadline_s"],
                "ewma_s": summ["ewma_s"], "derived": wd.derive_deadline
                and wd._deadline_override is None,
                "streams_ok": all(s is not None and s[0] == 200
                                  and s[1][-1] == "[DONE]" for s in streams)}
            if (summ["trips_total"] != trips0 or wd.health != "healthy"
                    or not out["profiler"]["derived"]
                    or not out["profiler"]["streams_ok"]):
                errors.append(f"profiler: {out['profiler']}")

            # the rollout: stage v2 beside v1
            ro = base + "/internal/rollout"
            staged = post(ro, {"action": "stage", "version": "v2",
                               "seed": LC_V2_SEED}, False)[1]
            # a prefix hit under v1
            hits0 = eng.prefix_cache.stats()["hits"]
            for _ in range(2):
                post(base + "/v1/completions", lc_body(LC_PREFIX, 4), False)
            v1_hits = eng.prefix_cache.stats()["hits"] - hits0
            # four v1 streams in flight, then a finish-mode flip: armed
            inflight = lc_submit(eng, base, LC_PROMPTS)
            lc_wait(lambda: len(eng.seqs) == len(LC_PROMPTS), 30,
                    "the v1 streams did not start")
            flip = post(ro, {"action": "flip"}, False)[1]
            launches0, replays0 = dict(ca.LAUNCHES), \
                eng.windows.stats()["replays"]
            held = lc_submit(eng, base, LC_PROMPTS)
            v1_got, v2_got = lc_collect(inflight), lc_collect(held)
            flip_ms = wm.last_swap_ms
            v2_launches = ca.LAUNCHES["decode"] - launches0["decode"]
            v2_replays = eng.windows.stats()["replays"] - replays0
            hits1 = eng.prefix_cache.stats()["hits"]
            post(base + "/v1/completions", lc_body(LC_PREFIX, 4), False)
            v2_hit = eng.prefix_cache.stats()["hits"] - hits1
            back = post(ro, {"action": "rollback"}, False)[1]
            rollback_ms = wm.last_swap_ms
            v1_again = lc_collect(lc_submit(eng, base, LC_PROMPTS))
            out["rollout"] = {
                "stage_gib": staged["bytes"] / 2**30,
                "stage_s": staged["seconds"], "flip": flip["state"],
                "flip_ms": flip_ms, "rollback_ms": rollback_ms,
                "inflight_on_v1": v1_got == v1_ref,
                "admissions_on_v2": v2_got == v2_ref,
                "v2_differs": v2_ref != v1_ref,
                "v2_decode_launches": v2_launches, "v2_replays": v2_replays,
                "rollback_on_v1": v1_again == v1_ref,
                "version": back["version"], "v1_prefix_hits": v1_hits,
                "v2_prefix_hits": v2_hit}
            r = out["rollout"]
            if (r["flip"] != "armed" or not r["inflight_on_v1"]
                    or not r["admissions_on_v2"] or not r["v2_differs"]
                    or r["v2_decode_launches"] <= 0 or r["v2_replays"] <= 0
                    or not r["rollback_on_v1"] or r["version"] != "v0"
                    or r["v1_prefix_hits"] < 1 or r["v2_prefix_hits"] != 0):
                errors.append(f"rollout: {r}")
            release()  # the rolled-back buffer

            # a hung device seam: DYNAMO_TPU_STEP_DEADLINE_S's value on the
            # live watchdog, then LC_HANG_S of device spin (once the trace's
            # exemption has run out)
            lc_wait(lambda: not wd.quiet(), 30, "the exemption did not end")
            wd._deadline_override = LC_STEP_DEADLINE_S
            plane.configure({"engine.device_hang": {"times": 1,
                                                    "delay_s": LC_HANG_S}})
            hung = threading.Thread(target=lambda: lc_status(
                base + "/v1/completions", lc_body(LC_PROMPTS[0])),
                daemon=True)
            t_hang = time.monotonic()
            hung.start()
            trip_s = lc_wait(lambda: wd.health != "healthy", 30,
                             "the watchdog did not trip")
            ready, live = lc_status(base + "/ready"), lc_status(
                base + "/live")
            shed = lc_status(base + "/v1/completions", lc_body("shed"))[0]
            spinning = time.monotonic() - t_hang < LC_HANG_S
            lc_wait(lambda: wd.health == "healthy", 60,
                    "the engine did not resurrect")
            ready_after = lc_status(base + "/ready")[0]
            hung.join(timeout=60)
            plane.clear()
            launches0, replays0 = dict(ca.LAUNCHES), \
                eng.windows.stats()["replays"]
            after = lc_collect(lc_submit(eng, base, LC_PROMPTS))
            out["hang"] = {
                "trip_s": trip_s, "ready": ready, "live": live,
                "probed_while_spinning": spinning, "v1_shed": shed,
                "resurrect_s": eng.last_resurrect_s,
                "ready_after": ready_after,
                "tokens_as_before": after == v1_ref,
                "decode_launches": ca.LAUNCHES["decode"]
                - launches0["decode"],
                "replays": eng.windows.stats()["replays"] - replays0,
                "trips": wd.summary()["trips_total"]}
            h = out["hang"]
            if (ready[0] != 503 or ready[1] > LC_PROBE_S or live[0] != 200
                    or live[1] > LC_PROBE_S or not spinning or shed != 503
                    or ready_after != 200 or not h["tokens_as_before"]
                    or h["decode_launches"] <= 0 or h["replays"] <= 0):
                errors.append(f"hang: {h}")

            # drain: new requests shed, in-flight streams finish
            inflight = lc_submit(eng, base, LC_PROMPTS)
            lc_wait(lambda: len(eng.seqs) == len(LC_PROMPTS), 30,
                    "the streams did not start")
            t0 = time.monotonic()
            drain = lc_status(base + "/internal/drain", {})[0]
            shed = lc_status(base + "/v1/completions", lc_body("late"))[0]
            drained = lc_collect(inflight)
            lc_wait(lambda: not eng.has_work, 60, "the engine did not drain")
            drain_s = time.monotonic() - t0
            out["drain"] = {"status": drain, "shed": shed,
                            "finished_as_before": drained == v1_ref,
                            "drain_s": drain_s}
            if drain != 200 or shed != 503 or drained != v1_ref:
                errors.append(f"drain: {out['drain']}")

            # a second trip inside the quarantine window: quarantined
            lc_wait(lambda: not wd.quiet(), 30, "the exemption did not end")
            plane.configure({"engine.device_hang": {"times": 1,
                                                    "delay_s": LC_HANG_S}})
            eng.add_request(GenRequest("quarantine", [1, 2, 3],
                                       max_tokens=LC_TOKENS,
                                       ignore_eos=True))
            lc_wait(lambda: wd.health == "quarantined", 30,
                    "the second trip did not quarantine")
            ready_q = lc_status(base + "/ready")[0]
            lc_wait(lambda: not eng.has_work, 60,
                    "the quarantined engine did not finish its request")
            out["quarantine"] = {"health": wd.health, "ready": ready_q,
                                 "trips": wd.summary()["trips_total"]}
            if ready_q != 503 or wd.health != "quarantined":
                errors.append(f"quarantine: {out['quarantine']}")
    finally:
        plane.clear()
        wd._deadline_override = None
    del eng, wd, wm
    release()
    out["seconds"] = time.monotonic() - t_phase
    emit({"phase": "lifecycle", "model": MODEL, **out})
    if errors:
        raise AssertionError(f"phase 17: {errors}")
    return out


# ------------------------------------------------------------- phase 18 --

# (a) the host tier, long_shared_prefix's shape: conversations of a
# KVBM_PREFIX-token prefix each, served one at a time, two turns; the
# device pool holds ~2.5 conversations (turn 2 always misses on the
# device), the host tier the working set and one conversation more
KVBM_CONVS, KVBM_PREFIX, KVBM_TAIL, KVBM_TOKENS = 6, 1024, 8, 2
KVBM_CONV_PAGES = KVBM_PREFIX // PS + 2
KVBM_DEVICE_PAGES = int(KVBM_CONV_PAGES * 2.5)
KVBM_HOST_BLOCKS = KVBM_CONV_PAGES * (KVBM_CONVS + 1)
H2D_PROBE_BYTES = 256 * 2**20  # one pinned host -> device copy
# the eager chunk's widths the gate's recompute side is fit on: two that
# the card's FLOPs bound (the attained share of the peak), and the
# engine's own (its fixed cost a chunk: at 256 the eager chunk is
# host-bound)
GATE_FIT_CHUNKS = (1024, 2048)
GATE_FIT_REPS = 3
# (b) the block whose host copy gets a flipped byte: this many entries
# into the host tier's LRU order, the first conversation's block at one
# chunk (the prefix recomputes from a chunk boundary)
KVBM_CORRUPT_AT = CHUNK // PS
# (c) multi_tenant_skew's shape: one aggressor's streams against a
# well-behaved tenant's, equal weights, on a mixed engine of QOS_SLOTS
# decode slots; the good tenant arrives once the aggressor holds every
# slot and has streamed QOS_HEAD_START tokens a slot, so that with QoS
# the aggressor is over budget and above its share while the good tenant
# queues: a WFQ preemption
QOS_TENANTS = [{"name": "aggressor", "weight": 1},
               {"name": "good", "weight": 1}]
QOS_AGGRESSOR, QOS_GOOD, QOS_SLOTS, QOS_TOKENS = 8, 2, 4, 24
QOS_AGGRESSOR_TOKENS, QOS_HEAD_START = 32, 4


def kvbm_prompts(turn: int) -> list:
    """Each conversation's prompt of `turn`: its own KVBM_PREFIX-token
    prefix (seeded by the conversation) and a KVBM_TAIL-token turn."""
    out = []
    for c in range(KVBM_CONVS):
        prefix = np.random.default_rng(1000 + c).integers(
            1, 100_000, KVBM_PREFIX).tolist()
        tail = np.random.default_rng(2000 + 10 * c + turn).integers(
            1, 100_000, KVBM_TAIL).tolist()
        out.append(prefix + tail)
    return out


def kvbm_run(engine: Engine, turns=(1, 2), convs=range(KVBM_CONVS)) -> dict:
    """Serve the conversations one at a time, turn by turn, greedy:
    {"tokens", "ttft_s", "cached", "chunk_launches"} by request id (TTFT
    on the engine's clock, add_request to the first token; `cached` the
    prompt tokens the prefix cache served, from the device or onboarded;
    the chunk kernel's launches for the request)."""
    chunk = "chunk_int8" if engine.kv_spec.quantized else "chunk"
    out = {"tokens": {}, "ttft_s": {}, "cached": {}, "chunk_launches": {}}
    pc = engine.prefix_cache
    for turn in turns:
        prompts = kvbm_prompts(turn)
        for c in convs:
            rid = f"t{turn}c{c}"
            n0 = ca.LAUNCHES[chunk]
            cached0 = pc.stats()["cached_tokens_served"] if pc else 0
            t0 = time.monotonic()
            engine.add_request(GenRequest(rid, prompts[c],
                                          max_tokens=KVBM_TOKENS,
                                          temperature=0.0, ignore_eos=True))
            toks, ttft = [], None
            while engine.has_work:
                for ev in engine.step():
                    if ev.token_id >= 0:
                        ttft = ttft or time.monotonic() - t0
                        toks.append(ev.token_id)
            out["tokens"][rid] = toks
            out["ttft_s"][rid] = ttft
            out["cached"][rid] = (pc.stats()["cached_tokens_served"]
                                  - cached0) if pc else 0
            out["chunk_launches"][rid] = ca.LAUNCHES[chunk] - n0
    return out


def synced_s(fn) -> tuple:
    """(fn's result, wall seconds until the card finished its work)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = fn()
    torch.cuda.synchronize()
    return got, time.monotonic() - t0


def kvbm_rates(engine: Engine) -> dict:
    """On a tier-on engine after its run: the demote of every sole-owned
    device page (their host copies dropped first, so that each is copied)
    and the onboard of the last conversation's prefix, as GB/s end to end
    (host work, gather or scatter, copies: card synchronized after); a
    one-block onboard's wall less its bytes at the raw rate (the gate's
    fixed cost); the raw pinned host -> device rate of one H2D_PROBE_BYTES
    copy (CUDA events, median of 5); and the eager chunk's wall at
    GATE_FIT_CHUNKS widths, fit as seconds = a fixed cost + FLOPs / (the
    attained share of the card's bf16 peak), and at the engine's CHUNK,
    whose wall less its FLOPs at that share is the fixed cost a chunk."""
    from dynamo_tpu_torch.profiler import roofline

    pc, kvbm = engine.prefix_cache, engine.kvbm
    block = kvbm.pool.block_nbytes
    prompt = kvbm_prompts(2)[KVBM_CONVS - 1]
    for h in list(pc._map):
        kvbm.pool.drop(h)
    n, demote_s = synced_s(lambda: pc.evict(pc.evictable()))
    (pages, _), onboard_s = synced_s(lambda: pc.lookup(prompt))
    engine.allocator.free(pages)
    src = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    h2d = H2D_PROBE_BYTES / statistics.median(times[1:])
    del src, dst
    pc.evict(pc.evictable())
    (one, _), one_s = synced_s(lambda: pc.lookup(prompt[:PS + 1]))
    engine.allocator.free(one)
    if len(one) != 1 or len(pages) != KVBM_PREFIX // PS:
        raise AssertionError(f"phase 18 rates: {n} demoted, {len(pages)} "
                             f"and {len(one)} onboarded")
    pc.evict(pc.evictable())
    fit = {}
    tokens = sum(kvbm_prompts(1), [])
    for c in (CHUNK,) + GATE_FIT_CHUNKS:
        chunk_pages = engine.allocator.alloc(c // PS)
        table = torch.tensor(chunk_pages, dtype=torch.int32, device="cuda")
        ids = torch.tensor(tokens[:c], device="cuda")
        walls = []
        for _ in range(GATE_FIT_REPS):
            _, s = synced_s(lambda: llama.prefill_chunk(
                engine.model, ids, 0, c, engine.k_pages, engine.v_pages,
                table, page_size=PS))
            walls.append(s)
        engine.allocator.free(chunk_pages)
        fit[c] = statistics.median(walls)
    (c0, c1) = GATE_FIT_CHUNKS
    per_token = (fit[c1] - fit[c0]) / (c1 - c0)
    flops_per_token = 2.0 * roofline.active_param_count(engine.model_cfg)
    return {"demoted_blocks": n, "onboarded_blocks": len(pages),
            "block_mib": block / 2**20,
            "demote_gbps": n * block / demote_s / 1e9,
            "onboard_gbps": len(pages) * block / onboard_s / 1e9,
            "demote_s": demote_s, "onboard_s": onboard_s,
            "h2d_pinned_gbps": h2d / 1e9,
            "onboard_one_block_s": one_s,
            "onboard_overhead_s": one_s - block / h2d,
            "chunk_wall_s": fit,
            "prefill_mfu": flops_per_token / per_token / BF16_FLOPS_PER_S,
            "chunk_fixed_s": fit[CHUNK] - CHUNK * per_token}


def kvbm_host_tier(engine: Engine, eager_cfg: dict) -> dict:
    """Phase 18 (a): long_shared_prefix's traffic with the host tier on,
    off (the prefix cache alone) and on a cache-off engine, on bf16 pools
    then int8 pools; the rates on the bf16 tier-on engine."""
    base = dict(eager_cfg, num_pages=KVBM_DEVICE_PAGES)
    cached = dict(base, enable_prefix_caching=True)
    layers = engine.model_cfg.num_layers
    out, errors = {}, []
    for pools in ("bf16", "int8"):
        kv = dict(kv_cache_dtype="int8") if pools == "int8" else {}
        t0 = time.monotonic()
        on = Engine(EngineConfig(**cached, kvbm_host_blocks=KVBM_HOST_BLOCKS,
                                 **kv), params=engine.model)
        alloc_s = time.monotonic() - t0
        got = {"on": kvbm_run(on)}
        st = on.kvbm.stats()
        row = {"pinned": on.kvbm.pool.pinned, "host_alloc_s": alloc_s,
               "host_gib": KVBM_HOST_BLOCKS * on.kvbm.pool.block_nbytes
               / 2**30, "gate": on.kvbm.gate.explain(KVBM_PREFIX // PS)}
        if pools == "bf16":
            row["rates"] = kvbm_rates(on)
        del on
        got["off"] = kvbm_run(Engine(EngineConfig(**cached, **kv),
                                     params=engine.model))
        got["cache_off"] = kvbm_run(Engine(EngineConfig(**base, **kv),
                                           params=engine.model), turns=(2,))
        release()
        turn2 = [f"t2c{c}" for c in range(KVBM_CONVS)]
        lookups = st["host_hits_total"] + st["host_misses_total"]
        suffix_chunks = {
            rid: -(-(KVBM_PREFIX + KVBM_TAIL - got["on"]["cached"][rid])
                   // CHUNK) for rid in turn2}
        row.update({
            "ttft_turn2_ms": {k: 1e3 * statistics.mean(
                got[k]["ttft_s"][r] for r in turn2) for k in got},
            "ttft_turn1_ms": 1e3 * statistics.mean(
                got["on"]["ttft_s"][f"t1c{c}"] for c in range(KVBM_CONVS)),
            "host_hit_ratio": st["host_hits_total"] / max(lookups, 1),
            "turn2_host_hits": sum(got["on"]["cached"][r] == KVBM_PREFIX
                                   for r in turn2),
            "chunk_launches_per_hit": [got["on"]["chunk_launches"][r]
                                       for r in turn2],
            "expected_chunk_launches": [layers * suffix_chunks[r]
                                        for r in turn2],
            "kvbm": {k: v for k, v in st.items() if k != "gate"},
            "tokens_equal": {
                "on_off": got["on"]["tokens"] == got["off"]["tokens"],
                "on_cache_off": all(got["on"]["tokens"][r]
                                    == got["cache_off"]["tokens"][r]
                                    for r in turn2)}})
        if (not row["pinned"] or row["turn2_host_hits"] != KVBM_CONVS
                or row["chunk_launches_per_hit"]
                != row["expected_chunk_launches"]
                or not all(row["tokens_equal"].values())
                or st["demoted_blocks_total"] <= 0):
            errors.append(f"{pools}: {row}")
        out[pools] = row
        out[pools + "_tokens"] = got["off"]["tokens"]
    return out, errors


def kvbm_integrity(engine: Engine, eager_cfg: dict, want: dict) -> dict:
    """Phase 18 (b): under DYNAMO_TPU_INTEGRITY=full, one byte of one
    demoted block's pinned host copy flipped: the block drops with one
    kv_checksum fault and the prefix recomputes from it, the tokens those
    of the tier-off run (`want`); then every cached page is demoted (the
    drain's demote), the engine resurrects, and the next conversation
    onboards its whole prefix from the surviving host tier."""
    cfg = dict(eager_cfg, num_pages=KVBM_DEVICE_PAGES,
               enable_prefix_caching=True, kvbm_host_blocks=KVBM_HOST_BLOCKS)
    old = os.environ.get("DYNAMO_TPU_INTEGRITY")
    os.environ["DYNAMO_TPU_INTEGRITY"] = "full"
    try:
        eng = Engine(EngineConfig(**cfg), params=engine.model)
    finally:
        if old is None:
            os.environ.pop("DYNAMO_TPU_INTEGRITY")
        else:
            os.environ["DYNAMO_TPU_INTEGRITY"] = old
    kvbm = eng.kvbm
    kvbm_run(eng, turns=(1,), convs=range(3))
    pool = kvbm.pool
    h = list(pool._entries)[KVBM_CORRUPT_AT]
    slot = pool._entries[h]
    pool.settle(slot)
    raw = pool.k_arena[slot].view(torch.uint8).view(-1)
    raw[raw.numel() // 3] ^= 0x5A
    got = kvbm_run(eng, turns=(2,), convs=(0,))
    wd = eng.watchdog.summary()
    st = kvbm.stats()
    demoted = kvbm.demote_all(eng.prefix_cache)
    held = len(pool)
    t0 = time.monotonic()
    eng.resurrect()
    resurrect_s = time.monotonic() - t0
    after = kvbm_run(eng, turns=(2,), convs=(1,))
    out = {"corrupted_block": KVBM_CORRUPT_AT,
           "kv_checksum_faults": wd["integrity_faults_total"].get(
               "kv_checksum", 0),
           "cached_after_fault": got["cached"]["t2c0"],
           "tokens_equal": got["tokens"]["t2c0"] == want["t2c0"],
           "removed_blocks": st["removed_blocks_total"],
           "drain_demoted": demoted, "host_blocks_held": held,
           "resurrect_s": resurrect_s,
           "after_resurrect_cached": after["cached"]["t2c1"],
           "after_resurrect_onboarded": kvbm.stats()[
               "onboarded_blocks_total"] - st["onboarded_blocks_total"],
           "after_resurrect_equal": after["tokens"]["t2c1"] == want["t2c1"],
           "health": eng.watchdog.health}
    del eng, kvbm, pool
    release()
    ok = (out["kv_checksum_faults"] == 1
          and out["cached_after_fault"] == KVBM_CORRUPT_AT * PS
          and out["tokens_equal"] and out["removed_blocks"] >= 1
          and out["after_resurrect_cached"] == KVBM_PREFIX
          and out["after_resurrect_equal"] and out["health"] == "healthy")
    return out, ([] if ok else [f"integrity: {out}"])


def tenant_stream(base: str, i: int, tenant,
                  max_tokens: int = QOS_TOKENS) -> tuple:
    """One streamed chat of `max_tokens` greedy tokens with 2 top
    logprobs, tagged with x-tenant-id when `tenant` is given: (seconds to
    the first token event, the streamed text, each token's top-2
    logprobs, the response id)."""
    body = dict(COMMON, max_tokens=max_tokens, stream=True, logprobs=True,
                top_logprobs=2, messages=[
                    {"role": "user",
                     "content": f"Tenant stream {i}: tell a story."}])
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"x-tenant-id": tenant} if tenant else {})})
    t0, ttft, text, tops, rid = time.monotonic(), None, [], [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            rid = rid or chunk.get("id")
            choice = chunk["choices"][0]
            if choice["delta"].get("content"):
                ttft = ttft or time.monotonic() - t0
                text.append(choice["delta"]["content"])
            for e in (choice.get("logprobs") or {}).get("content") or ():
                tops.append([a["logprob"] for a in e["top_logprobs"]])
    return ttft, "".join(text), tops, rid


def tenant_skew(engine: Engine, qos: bool) -> dict:
    """Phase 18 (c) on one mixed engine: the aggressor's QOS_AGGRESSOR
    streams queued first, then, once they hold every slot and have
    streamed QOS_HEAD_START tokens a slot, the good tenant's QOS_GOOD; the
    good tenant's TTFT, every stream's text, the QoS books, the
    preemptions, and one request alone tagged `good` (with QoS) or
    untagged (without)."""
    results = {}
    with serving(engine, VisibleTokenizer(), utilization=False) as base:
        def run(key, i, tenant, n=QOS_TOKENS):
            results[key] = tenant_stream(base, i, tenant, n)

        threads = []
        for i in range(QOS_AGGRESSOR):
            threads.append(threading.Thread(
                target=run, args=(("aggressor", i), i, "aggressor",
                                  QOS_AGGRESSOR_TOKENS), daemon=True))
            threads[-1].start()
        lc_wait(lambda: engine.metrics.num_requests >= QOS_AGGRESSOR, 60,
                "phase 18: the aggressor's streams did not arrive")
        lc_wait(lambda: engine.metrics.output_tokens
                >= QOS_SLOTS * QOS_HEAD_START, 60,
                "phase 18: the aggressor's streams did not start")
        for i in range(QOS_GOOD):
            threads.append(threading.Thread(
                target=run, args=(("good", i), QOS_AGGRESSOR + i, "good"),
                daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        worker = stats(base)
        alone = tenant_stream(base, 99, "good" if qos else None)
    victims = {e["victim_rid"] for rec in engine.flight.records()
               for e in rec.get("events", ()) if e.get("ev") == "qos_preempt"}
    good = sorted(results[("good", i)][0] for i in range(QOS_GOOD))
    return {"good_ttft_s": good,
            "good_ttft_p95_s": good[min(len(good) - 1,
                                        math.ceil(0.95 * len(good)) - 1)],
            "aggressor_ttft_p95_s": sorted(
                results[("aggressor", i)][0]
                for i in range(QOS_AGGRESSOR))[math.ceil(
                    0.95 * QOS_AGGRESSOR) - 1],
            "preempted": worker["metrics"].get("num_preempted"),
            "qos": worker.get("qos"), "alone": alone[1],
            "texts": {f"{k}{i}": r[1] for (k, i), r in results.items()},
            "tops": {f"{k}{i}": r[2] for (k, i), r in results.items()},
            "preempted_streams": sorted(
                f"{k}{i}" for (k, i), r in results.items()
                if r[3] in victims),
            "complete": all(len(r[1]) == (QOS_AGGRESSOR_TOKENS
                                          if k == "aggressor"
                                          else QOS_TOKENS)
                            for (k, _), r in results.items())}


def tenant_differences(on: dict, off: dict) -> dict:
    """Each stream of the QoS-on run against the same stream of the
    QoS-off run, where nothing was preempted: {stream: its first
    difference's index, the QoS-off run's top-2 logprob gap there, and
    whether QoS preempted it} for those that differ. The mixed steps'
    GEMMs round by their row counts, which the two schedules set
    otherwise, so a stream may part at a bf16 near-tie (a gap under
    NEAR_TIE), as phase 12's do; a difference elsewhere, or a length
    off, is a fault (a preemption's recompute seam among them)."""
    out = {}
    for key, want in off["texts"].items():
        got = on["texts"].get(key, "")
        if got == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        top = off["tops"][key][i] if i < len(off["tops"][key]) else []
        mine = on["tops"][key][i] if i < len(on["tops"][key]) else []
        out[key] = {"index": i, "lengths": [len(got), len(want)],
                    "off_top2_gap": (top[0] - top[1] if len(top) > 1
                                     and len(got) == len(want)
                                     else float("inf")),
                    "on_top2_gap": (mine[0] - mine[1] if len(mine) > 1
                                    else None),
                    "preempted": key in on["preempted_streams"]}
    return out


def kvbm_qos_phase(engine: Engine, eager_cfg: dict) -> dict:
    """Phase 18 (see the module doc) on the 8B's weights -> {"launches"}:
    the kernels' launches over the whole phase, counted from zero."""
    t_phase = time.monotonic()
    ca.reset_launch_counts()
    host, errors = kvbm_host_tier(engine, eager_cfg)
    integrity, errs = kvbm_integrity(engine, eager_cfg, host.pop(
        "bf16_tokens"))
    host.pop("int8_tokens")
    errors += errs
    mixed = dict(eager_cfg, max_num_seqs=QOS_SLOTS, mixed_batch_tokens=CHUNK)
    skew = {}
    # on wq scaled as the windowed models serve it (WINDOWED_WQ_SCALE):
    # as the loader draws it one bf16 unit flips a head's key and two
    # schedules part by whole nats; scaled, by a unit or two
    for layer in engine.model.layers:
        layer.wq.mul_(WINDOWED_WQ_SCALE)  # a power of 2: exact, undone below
    try:
        for qos in (False, True):
            tenants = json.dumps(QOS_TENANTS) if qos else None
            skew["on" if qos else "off"] = tenant_skew(
                Engine(EngineConfig(**mixed, tenants=tenants),
                       params=engine.model), qos)
            release()
    finally:
        for layer in engine.model.layers:
            layer.wq.div_(WINDOWED_WQ_SCALE)
    launches = dict(ca.LAUNCHES)
    on, off = skew["on"], skew["off"]
    books = on["qos"] or {}
    deferred = sum((books.get("deferred_total") or {}).values())
    preempted = (books.get("preempted_total") or {}).get("aggressor", 0)
    qos_row = {"good_ttft_p95_ms": {k: 1e3 * v["good_ttft_p95_s"]
                                    for k, v in skew.items()},
               "aggressor_ttft_p95_ms": {k: 1e3 * v["aggressor_ttft_p95_s"]
                                         for k, v in skew.items()},
               "deferrals": deferred, "preemptions": preempted,
               "engine_preemptions": {k: v["preempted"]
                                      for k, v in skew.items()},
               "qos": books, "tagged_equals_untagged":
               on["alone"] == off["alone"],
               "preempted_streams": on["preempted_streams"],
               "first_differences": tenant_differences(on, off),
               "near_tie_limit": NEAR_TIE,
               "complete": on["complete"] and off["complete"]}
    diffs = qos_row["first_differences"]
    qos_row["streams_equal"] = len(on["texts"]) - len(diffs)
    if (not qos_row["tagged_equals_untagged"] or not qos_row["complete"]
            or off["qos"] is not None or preempted == 0
            or on["preempted"] < preempted or off["preempted"] != 0
            or not on["preempted_streams"]
            or any(d["off_top2_gap"] >= NEAR_TIE for d in diffs.values())):
        errors.append(f"tenants: {qos_row}")
    missing = [k for k in ("decode", "prefill", "chunk", "ragged")
               if launches[k] == 0]
    if missing:
        errors.append(f"kernels never launched in phase 18: {missing}")
    out = {"host_tier": host, "integrity": integrity, "tenants": qos_row,
           "launches": launches, "seconds": time.monotonic() - t_phase}
    emit({"phase": "kvbm_qos", "model": MODEL, **out})
    if errors:
        raise AssertionError(f"phase 18: {errors}")
    return out


# ------------------------------------------------------------- phase 19 --

FE_CONVS, FE_FIRST_CHARS, FE_TURN_TOKENS = 4, 600, 16
FE_PROMPTS, FE_TOKENS = 8, 32
FE_STREAM_TOKENS, FE_CRASH_AFTER = 64, 24
FE_INFLIGHT, FE_STALL_S = 4, 3.0
FE_SLOTS = 8
FE_WORDS = ("page", "block", "prefix", "router", "worker", "cache", "token",
            "chunk", "event", "index", "stream", "journal")


def fe_first_turn(c: int) -> str:
    """Conversation c's first user message: ~FE_FIRST_CHARS byte tokens
    of seeded words, each conversation its own first page (its number
    leads) and its own page count (the KV event publisher keys a request
    by its first page and its page count)."""
    rng = np.random.default_rng(3000 + c)
    words = [f"{c}:"]
    while sum(len(w) + 1 for w in words) < FE_FIRST_CHARS + 24 * c:
        words.append(FE_WORDS[rng.integers(len(FE_WORDS))])
    return " ".join(words)


def fe_events(chunks, t0: float):
    """(seconds since t0, the moment the request was sent, parsed SSE data
    event) of a stream of byte chunks, as each event completes; [DONE]
    ends it."""
    buf = b""
    for chunk in chunks:
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            for line in block.split(b"\n"):
                if not line.startswith(b"data: "):
                    continue
                if line == b"data: [DONE]":
                    return
                yield time.monotonic() - t0, json.loads(line[6:])


def fe_summary(events) -> dict:
    """A streamed chat's text, each token's top-2 logprobs, TTFT and mean
    ITL on the client's clock, its widest gap between two tokens, and the
    time to its first event (the role chunk, which a worker sends as it
    queues the request: the request path's latency, before any window)."""
    stamps, text, tops, first = [], [], [], None
    for t, ev in events:
        first = t if first is None else first
        choice = (ev.get("choices") or [{}])[0]
        if (choice.get("delta") or {}).get("content"):
            stamps.append(t)
            text.append(choice["delta"]["content"])
        for e in (choice.get("logprobs") or {}).get("content") or ():
            tops.append([a["logprob"] for a in e["top_logprobs"]])
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return {"text": "".join(text), "tops": tops,
            "ttft_ms": 1e3 * stamps[0] if stamps else None,
            "first_event_ms": 1e3 * first if first is not None else None,
            "itl_ms": 1e3 * statistics.mean(gaps) if gaps else None,
            "widest_gap_ms": 1e3 * max(gaps) if gaps else None,
            "widest_gap_at": gaps.index(max(gaps)) + 1 if gaps else None}


def fe_http_stream(url: str, body: dict, headers=None) -> dict:
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        return fe_summary(fe_events(iter(lambda: r.read1(65536), b""), t0))


def fe_nats_stream(nc, worker_url: str, body: dict) -> dict:
    """Straight to a worker over the NATS request plane."""
    from dynamo_tpu_torch.serving import nats_plane

    t0 = time.monotonic()
    status, _, parts = nats_plane.nats_request(
        nc, nats_plane.worker_subject(worker_url), "/v1/chat/completions",
        body, timeout=600)
    if status != 200:
        raise AssertionError(f"phase 19: NATS status {status}")
    return fe_summary(fe_events(parts, t0))


def fe_difference(got: dict, ref: dict):
    """None when `got` streamed `ref`'s text; else where it first differs,
    the reference's top-2 logprob gap there, and whether that is a near
    tie (equal lengths and a gap under NEAR_TIE)."""
    a, b = got["text"], ref["text"]
    if a == b:
        return None
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    top = ref["tops"][i] if i < len(ref["tops"]) else []
    gap = top[0] - top[1] if len(top) > 1 else float("inf")
    return {"index": i, "lengths": [len(a), len(b)], "top2_gap": gap,
            "near_tie": len(a) == len(b) and gap < NEAR_TIE}


def fe_get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def fe_frontend(port: int, nats_url=None):
    """`python -m dynamo_tpu_torch.frontend` on 127.0.0.1:port, its log in
    a temporary file."""
    log = tempfile.TemporaryFile()
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--host",
           "127.0.0.1", "--port", str(port), "--heartbeat-ttl", "30"]
    if nats_url:
        cmd += ["--nats-url", nats_url]
    env = dict(os.environ, DYNAMO_TPU_MAX_INFLIGHT=str(FE_INFLIGHT))
    proc = subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def fe_log_tail(log) -> str:
    log.seek(0)
    return log.read().decode(errors="replace")[-3000:]


def fe_evict(ctxs) -> None:
    """Empty both workers' prefix caches between steps, so that a prompt
    served again prefills as it did the first time."""
    for ctx in ctxs:
        eng = ctx.engine
        with eng.between_steps():
            eng.prefix_cache.evict(eng.cfg.num_pages)


def fe_served_by(ctxs, fn):
    """(fn's result, the index of the one worker that took a request)."""
    before = [c.engine.metrics.num_requests for c in ctxs]
    got = fn()
    moved = [i for i, c in enumerate(ctxs)
             if c.engine.metrics.num_requests > before[i]]
    if len(moved) != 1:
        raise AssertionError(f"phase 19: {len(moved)} workers took one "
                             f"request")
    return got, moved[0]


def fe_body(messages, max_tokens: int, **kw) -> dict:
    return dict(COMMON, messages=messages, max_tokens=max_tokens,
                stream=True, logprobs=True, top_logprobs=2, **kw)


def fe_routing(fe_nats: str, ctxs) -> tuple:
    """Phase 19 (a): -> (row, errors)."""
    errors, owners, seconds, hits = [], [], [], []
    for c in range(FE_CONVS):
        msgs = [{"role": "user", "content": fe_first_turn(c)}]
        n0 = fe_get(fe_nats + "/internal/workers")["router"]["kv_index"][
            "events_applied"]
        first, w = fe_served_by(ctxs, lambda: fe_http_stream(
            fe_nats, fe_body(msgs, FE_TURN_TOKENS)))
        lc_wait(lambda: fe_get(fe_nats + "/internal/workers")["router"][
            "kv_index"]["events_applied"] > n0, 30,
                f"phase 19: conversation {c}'s KV events at the frontend")
        msgs2 = msgs + [
            {"role": "assistant", "content": first["text"]},
            {"role": "user", "content": f"Turn two of conversation {c}: "
                                        "go on, in more detail."}]
        h0 = [ctx.engine.prefix_cache.stats()["hits"] for ctx in ctxs]
        second, w2 = fe_served_by(ctxs, lambda: fe_http_stream(
            fe_nats, fe_body(msgs2, FE_TURN_TOKENS)))
        rose = [ctx.engine.prefix_cache.stats()["hits"] - h
                for ctx, h in zip(ctxs, h0)]
        owners.append([w, w2])
        hits.append(rose)
        seconds.append([first["ttft_ms"], second["ttft_ms"]])
        if w2 != w or rose[w] <= 0 or rose[1 - w] != 0:
            errors.append(f"conversation {c}: first on {w}, second on "
                          f"{w2}, prefix hits rose by {rose}")
    router = fe_get(fe_nats + "/internal/workers")["router"]
    row = {"owners": owners, "routed_to_owner": sum(a == b for a, b in
                                                    owners),
           "prefix_hits_rise": hits, "turn_ttft_ms": seconds,
           "kv_index": router["kv_index"],
           "kv_index_hits": router["kv_index_hits"],
           "ledger_hits": router["ledger_hits"]}
    if router["kv_index_hits"] < FE_CONVS:
        errors.append(f"second turns routed by the KV event index: "
                      f"{router['kv_index_hits']} of {FE_CONVS}")
    return row, errors


def fe_streams(routes: dict, ctxs) -> tuple:
    """Phase 19 (b): each prompt through each route in turn -> (row,
    errors)."""
    errors, runs = [], {name: [] for name in routes}
    for i in range(FE_PROMPTS):
        msgs = [{"role": "user", "content": f"Prompt {i} through the "
                 "frontend tier: say what the KV-aware router does."}]
        for name, call in routes.items():
            fe_evict(ctxs)
            runs[name].append(call(fe_body(msgs, FE_TOKENS)))
    row = {}
    for name, got in runs.items():
        diffs = [fe_difference(g, r) for g, r in zip(got, runs["direct_http"])]
        row[name] = {
            "ttft_ms": statistics.median(g["ttft_ms"] for g in got),
            "ttft_ms_each": [g["ttft_ms"] for g in got],
            "first_event_ms": statistics.median(
                g["first_event_ms"] for g in got),
            "first_event_ms_each": [g["first_event_ms"] for g in got],
            "itl_ms": statistics.mean(g["itl_ms"] for g in got),
            "tokens": [len(g["text"]) for g in got],
            "equal": sum(d is None for d in diffs),
            "first_differences": [d for d in diffs if d is not None]}
        if any(len(g["text"]) != FE_TOKENS for g in got) or any(
                d is not None and not d["near_tie"] for d in diffs):
            errors.append(f"{name}: {row[name]}")
    return row, errors


def fe_failover(fe_http: str, urls, ctxs) -> tuple:
    """Phase 19 (c): -> (row, errors)."""
    msgs = [{"role": "user", "content": "A long stream that a worker drops "
             "halfway: resume it on the peer from the journal."}]
    fe_evict(ctxs)
    ref = fe_http_stream(fe_http, fe_body(msgs, FE_STREAM_TOKENS))
    fe_evict(ctxs)
    status, _ = lc_status(urls[0] + "/internal/faults", {"faults": {
        "worker.crash_mid_decode": {"times": 1, "after": FE_CRASH_AFTER}}})
    n0 = [c.engine.metrics.num_requests for c in ctxs]
    got = fe_http_stream(fe_http, fe_body(msgs, FE_STREAM_TOKENS))
    took = [c.engine.metrics.num_requests - n for c, n in zip(ctxs, n0)]
    lc_status(urls[0] + "/internal/faults", {"faults": {}})
    diff = fe_difference(got, ref)
    row = {"faults_status": status, "tokens": len(got["text"]),
           "requests_by_worker": took, "equal": diff is None,
           "first_difference": diff,
           "resume_gap_ms": got["widest_gap_ms"],
           "resume_gap_at_token": got["widest_gap_at"],
           "itl_ms": got["itl_ms"], "uninterrupted_itl_ms": ref["itl_ms"],
           "uninterrupted_widest_gap_ms": ref["widest_gap_ms"]}
    ok = (status == 200 and took == [1, 1]
          and len(got["text"]) == FE_STREAM_TOKENS
          and (diff is None or diff["near_tie"]))
    return row, ([] if ok else [f"failover: {row}"])


def fe_admission(fe_nats: str, urls) -> tuple:
    """Phase 19 (d): -> (row, errors)."""
    held = [None] * FE_INFLIGHT
    body = dict(COMMON, messages=[{"role": "user", "content": "Hold."}],
                max_tokens=4)

    def one(i):
        held[i] = lc_status(fe_nats + "/v1/chat/completions", body)[0]

    lc_status(urls[0] + "/internal/faults", {"faults": {
        "worker.read_stall": {"times": FE_INFLIGHT,
                              "delay_s": FE_STALL_S}}})
    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(FE_INFLIGHT)]
    for t in threads:
        t.start()
    lc_wait(lambda: samples(scrape(fe_nats)).get(
        ("dynamo_frontend_queued_requests", ())) == FE_INFLIGHT, 10,
            "phase 19: the held requests in flight at the frontend")
    over = lc_status(fe_nats + "/v1/chat/completions", body)
    for t in threads:
        t.join(timeout=60)
    lc_status(urls[0] + "/internal/faults", {"faults": {}})
    late = lc_status(fe_nats + "/v1/chat/completions", body,
                     {"x-deadline": "0"})
    row = {"held": held, "fifth": over[0], "fifth_ms": 1e3 * over[1],
           "expired_deadline": late[0], "expired_deadline_ms":
           1e3 * late[1]}
    ok = held == [200] * FE_INFLIGHT and over[0] == 429 and late[0] == 504
    return row, ([] if ok else [f"admission: {row}"])


def fe_pick_ms(base: str) -> dict:
    """The `router.pick` spans' ms at a frontend (`/debug/spans`)."""
    spans = [(int(s["endTimeUnixNano"]) - int(s["startTimeUnixNano"]))
             / 1e6 for rs in fe_get(base + "/debug/spans?name=router.pick")[
                 "resourceSpans"] for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    return {"n": len(spans),
            "median_ms": statistics.median(spans) if spans else None,
            "max_ms": max(spans) if spans else None}


def fe_workers(engines, broker_url: str, frontends: str, stop,
               closers: list) -> tuple:
    """The two workers of phase 19, each with its server, the worker CLI's
    `--nats-url` wiring and heartbeats to every frontend; what stops them
    goes on `closers` (run in reverse). -> (contexts, URLs, heartbeat
    threads)."""
    from dynamo_tpu_torch.serving.worker import (attach_nats_plane,
                                                 heartbeat_loop)

    ctxs, urls, beats = [], [], []
    for eng in engines:
        ctx = ServingContext(eng, MODEL)
        ctx.tokenizer = VisibleTokenizer()
        srv = make_server(ctx, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        closers += [ctx.close, srv.shutdown]
        plane = attach_nats_plane(ctx, broker_url, url, url)
        if plane is None:
            raise AssertionError("phase 19: a worker's NATS plane is down")
        closers.append(plane.close)
        beats.append(threading.Thread(target=heartbeat_loop, args=(
            ctx, frontends, url, 1.0, stop), daemon=True))
        beats[-1].start()
        ctxs.append(ctx)
        urls.append(url)
    return ctxs, urls, beats


def frontend_phase(engine: Engine, jet_cfg: dict) -> dict:
    """Phase 19 (see the module doc) on the 8B's weights -> {"launches"}:
    the kernels' launches over the phase, counted from zero."""
    from dynamo_tpu_torch.serving import nats

    t_phase = time.monotonic()
    errors, out, closers = [], {}, []
    ctxs, beats, stop = [], [], threading.Event()
    broker = nats.MiniNatsBroker()
    closers.append(broker.close)
    ports = [fe_free_port() for _ in range(2)]
    fe_nats, fe_http = (f"http://127.0.0.1:{p}" for p in ports)
    # the frontends start while the workers warm up
    procs = [fe_frontend(ports[0], broker.url), fe_frontend(ports[1])]
    for layer in engine.model.layers:
        layer.wq.mul_(WINDOWED_WQ_SCALE)  # a power of 2: exact, undone below
    try:
        cfg = dict(jet_cfg, max_num_seqs=FE_SLOTS, prefill_chunk_tokens=CHUNK,
                   enable_prefix_caching=True)
        engines = [Engine(EngineConfig(**cfg), params=engine.model)
                   for _ in range(2)]
        t0 = time.monotonic()
        for e in engines:
            e.warmup()
        del e
        out["warmup_s"] = time.monotonic() - t0
        for (proc, log), base in zip(procs, (fe_nats, fe_http)):
            lc_wait(lambda: proc.poll() is not None or fe_up(base), 60,
                    "phase 19: a frontend to answer")
            if proc.poll() is not None:
                raise AssertionError(f"phase 19: the frontend at {base} "
                                     f"exited: {fe_log_tail(log)}")
        ctxs, urls, beats = fe_workers(engines, broker.url,
                                       f"{fe_nats},{fe_http}", stop, closers)
        del engines
        for base in (fe_nats, fe_http):
            lc_wait(lambda: len(fe_get(base + "/internal/workers")[
                "workers"]) == 2, 30, "phase 19: both workers registered")
        cores = {name: fe_get(base + "/internal/workers")["router"][
            "native_router"] for name, base in (("fe_nats", fe_nats),
                                                ("fe_http", fe_http))}
        out["native_router"] = cores
        if not all(cores.values()):
            errors.append(f"the native router core did not load: {cores}")
        ca.reset_launch_counts()
        out["routing"], errs = fe_routing(fe_nats, ctxs)
        errors += errs
        nc = nats.NatsClient(broker.url, name="chip-smoke-client")
        closers.append(nc.close)
        routes = {
            "direct_http": lambda b: fe_http_stream(urls[0], b),
            "direct_nats": lambda b: fe_nats_stream(nc, urls[0], b),
            "frontend_http": lambda b: fe_http_stream(fe_http, b),
            "frontend_nats": lambda b: fe_http_stream(fe_nats, b)}
        out["streams"], errs = fe_streams(routes, ctxs)
        errors += errs
        out["failover"], errs = fe_failover(fe_http, urls, ctxs)
        errors += errs
        out["admission"], errs = fe_admission(fe_nats, urls)
        errors += errs
        launches = dict(ca.LAUNCHES)
        out["kv_events"] = {
            "frontend_received": samples(scrape(fe_nats)).get(
                ("dynamo_frontend_kv_events_total", ())),
            "published": [c.kv_event_publisher.stats() for c in ctxs]}
        out["prefix_hits"] = [c.engine.prefix_cache.stats()["hits"]
                              for c in ctxs]
        out["router_pick"] = {"fe_nats": fe_pick_ms(fe_nats),
                              "fe_http": fe_pick_ms(fe_http)}
        for name, (proc, log) in zip(("fe_nats", "fe_http"), procs):
            if proc.poll() is not None:
                errors.append(f"{name} exited: {fe_log_tail(log)}")
    finally:
        stop.set()
        for close in reversed(closers):
            try:
                close()
            except Exception as e:
                errors.append(f"teardown: {type(e).__name__}: {e}")
        for t in beats:
            t.join(timeout=10)
        for proc, log in procs:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
            log.close()
        for layer in engine.model.layers:
            layer.wq.div_(WINDOWED_WQ_SCALE)
        del ctxs, closers
        release()
    missing = [k for k in ("decode", "prefill", "chunk") if launches[k] == 0]
    if missing:
        errors.append(f"kernels never launched in phase 19: {missing}")
    out.update(launches=launches, seconds=time.monotonic() - t_phase,
               card=card_line())
    emit({"phase": "frontend", "model": MODEL, **out})
    if errors:
        raise AssertionError(f"phase 19: {errors}")
    return out


def fe_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fe_up(base: str) -> bool:
    try:
        with urllib.request.urlopen(base + "/health", timeout=2) as r:
            return r.status == 200
    except OSError:
        return False


# ------------------------------------------------------------- phase 20 --

DG_PROMPTS, DG_TOKENS = 4, 32
# (a)'s handoff rates: a prompt of the length phase 3's chunk rows reach
DG_RATE_TOKENS = 1792
# (b): the prefill child's pages, and the stage TTL of the leak drill's
# prefill worker (it waits the TTL out)
DG_CHILD_PAGES, DG_STAGED_TTL_S = 1024, 2.0
DG_LEAK_RID = "dg-leak"
# (c): turn 1's user message (characters: byte tokens) and the host tier
DG_TURN1_CHARS, DG_HOST_BLOCKS = 1400, 256
DG_PEER = r"""
import json, sys, time, urllib.request
import torch
from dynamo_tpu_torch.transfer.kv_transfer import DeviceKVClient, device_uuid

url, rid = sys.argv[1], sys.argv[2]


def post(path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


dev = torch.device("cuda")
post("/disagg/prefill", {"request_id": rid,
                         "prompt_token_ids": list(range(1, 300)),
                         "device_uuid": device_uuid(dev)})
staged = post("/disagg/stage", {"request_id": rid})
k, v = DeviceKVClient(dev).pull(staged)
torch.cuda.synchronize()
print(json.dumps({"mapped": list(k.shape), "dtype": str(k.dtype),
                  "k_sum": float(k.float().sum())}), flush=True)
time.sleep(600)
"""


def dg_serve(ctx, closers) -> str:
    """`ctx`'s OpenAI server on 127.0.0.1:0 (stopped by `closers`)."""
    srv = make_server(ctx, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    closers.append(ctx.close)
    closers.append(srv.server_close)
    closers.append(srv.shutdown)
    return f"http://127.0.0.1:{srv.server_address[1]}"


def dg_frontend(workers, closers) -> str:
    """An in-process frontend with `workers` ((url, mode) pairs, which
    never expire) registered."""
    from dynamo_tpu_torch.serving import frontend as fe_mod

    fctx = fe_mod.FrontendContext(fe_mod.Router(heartbeat_ttl=float("inf")))
    fsrv = fe_mod.make_frontend_server(fctx, "127.0.0.1", 0)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    closers.append(fsrv.server_close)
    closers.append(fsrv.shutdown)
    base = f"http://127.0.0.1:{fsrv.server_address[1]}"
    for url, mode in workers:
        req = urllib.request.Request(
            base + "/internal/register", data=json.dumps({
                "url": url, "model": MODEL, "mode": mode,
                "stats": {"max_num_seqs": MAX_SEQS, "free_pages": 1000,
                          "total_pages": NUM_PAGES}}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).close()
    return base


def dg_post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def dg_chats(base: str, model: str) -> list:
    """DG_PROMPTS greedy streamed chats, one at a time (each alone in its
    batch, so the aggregated and the disaggregated schedules match)."""
    return [fe_http_stream(base, dict(
        fe_body([{"role": "user", "content": fe_first_turn(c)}], DG_TOKENS),
        model=model)) for c in range(DG_PROMPTS)]


def dg_compare(runs: list, refs: list, what: str, errors: list) -> list:
    """Each run against its reference by the near-tie rule."""
    diffs = [fe_difference(got, ref) for got, ref in zip(runs, refs)]
    bad = [d for d in diffs if d is not None and not d["near_tie"]]
    if bad:
        errors.append(f"{what}: tokens differ from the aggregated worker's "
                      f"past a near-tie: {bad}")
    return diffs


def dg_latency(runs: list) -> dict:
    return {"ttft_ms": statistics.median(r["ttft_ms"] for r in runs),
            "itl_ms": statistics.median(r["itl_ms"] for r in runs)}


def dg_rates(pre: Engine, dec: Engine) -> dict:
    """(a)'s handoff of one DG_RATE_TOKENS-token prompt's KV, each plane
    timed alone on idle engines (wall seconds until the card finished):
    ici_inproc's gather and in-place scatter, and dcn's pull (the gather,
    the device-to-host copy, the TCP stream and the parse) and import (the
    host-to-device copy and the scatter)."""
    from dynamo_tpu_torch.transfer.kv_transfer import KVSource, fetch_kv

    prompt = [(7 * j) % 251 + 1 for j in range(DG_RATE_TOKENS)]
    out = {}
    for plane in ("ici_inproc", "dcn"):
        rid = f"__dg_rate_{plane}"
        req = GenRequest(rid, prompt, max_tokens=4, temperature=0.0,
                         ignore_eos=True)
        first = pre.prefill_only(req)[0]
        if plane == "ici_inproc":
            (k, v, _), pull_s = synced_s(lambda: pre.export_kv_device(rid))
            pre.release_parked(rid)
        else:
            src = KVSource(pre, port=0)
            try:
                (k, v, _), pull_s = synced_s(
                    lambda: fetch_kv("127.0.0.1", src.port, rid))
            finally:
                src.close()
        _, import_s = synced_s(lambda: dec.import_kv(req, first, k, v))
        nbytes = int(k.nbytes + v.nbytes)
        del k, v
        dec.abort_request(rid)
        while dec.has_work:
            dec.step()
        out[plane] = {"kv_bytes": nbytes, "pull_s": pull_s,
                      "pull_gb_per_s": nbytes / pull_s / 1e9,
                      "import_s": import_s,
                      "import_gb_per_s": nbytes / import_s / 1e9}
    return out


def dg_inproc(engine: Engine, jet_cfg: dict, errors: list,
              closers: list) -> dict:
    """Phase 20 (a): the 8B's prefill and decode roles in this process
    behind a frontend, over dcn and ici_inproc, against an aggregated
    worker."""
    from dynamo_tpu_torch.transfer import ici_registry

    out = {}
    pre = Engine(EngineConfig(**jet_cfg, disaggregation_mode="prefill",
                              disaggregation_bootstrap_port=0),
                 params=engine.model)
    dec = Engine(EngineConfig(**jet_cfg, disaggregation_mode="decode",
                              disaggregation_transfer_backend="dcn"),
                 params=engine.model)
    agg = Engine(EngineConfig(**jet_cfg), params=engine.model)
    t0 = time.monotonic()
    for e in (pre, dec, agg):
        e.warmup()
    out["warmup_s"] = time.monotonic() - t0
    with torch.inference_mode():
        out["rates"] = dg_rates(pre, dec)
    # the prefill role's launches, apart from the decode role's: the roles
    # run one request at a time, so the prefill_only calls' deltas are the
    # prefill role's and the rest is the decode role's
    role_pre = dict.fromkeys(ca.LAUNCHES, 0)
    served_pre = pre.prefill_only

    def counted(req):
        before = dict(ca.LAUNCHES)
        try:
            return served_pre(req)
        finally:
            for name, n in ca.LAUNCHES.items():
                role_pre[name] += n - before.get(name, 0)

    pre.prefill_only = counted
    ca.reset_launch_counts()
    pre_url = dg_serve(ServingContext(pre, MODEL), closers)
    ici_registry.register(pre_url, pre)
    closers.append(lambda: ici_registry.unregister(pre_url))
    runs, planes = {}, {}
    for plane, backend in (("dcn", "dcn"), ("ici_inproc", "ici")):
        # one decode worker at a time on the one engine (one scheduler)
        dec.cfg = dataclasses.replace(
            dec.cfg, disaggregation_transfer_backend=backend)
        ctx = ServingContext(dec, MODEL, prefill_urls=[pre_url])
        ctx.tokenizer = VisibleTokenizer()
        mine = []
        try:
            dec_url = dg_serve(ctx, mine)
            base = dg_frontend([(pre_url, "prefill"), (dec_url, "decode")],
                               mine)
            runs[plane] = dg_chats(base, MODEL)
        finally:
            for close in reversed(mine):
                close()
        planes[plane] = dict(ctx.disagg_client.plane_counts)
    launches = dict(ca.LAUNCHES)
    agg_ctx = ServingContext(agg, MODEL)
    agg_ctx.tokenizer = VisibleTokenizer()
    base = dg_frontend([(dg_serve(agg_ctx, closers), "agg")], closers)
    runs["agg"] = dg_chats(base, MODEL)
    role_dec = {k: launches[k] - role_pre[k] for k in launches}
    out["launches"] = launches
    out["role_launches"] = {"prefill": role_pre, "decode": role_dec}
    if not role_pre["prefill"] or not role_dec["decode"]:
        errors.append(f"(a) the roles' kernels: prefill.cu on the prefill "
                      f"role, decode.cu on the decode role: "
                      f"{out['role_launches']}")
    want = {"dcn": {"ici_inproc": 0, "ici_device": 0, "dcn": DG_PROMPTS},
            "ici_inproc": {"ici_inproc": DG_PROMPTS, "ici_device": 0,
                           "dcn": 0}}
    out["planes"] = planes
    if planes != want:
        errors.append(f"(a) planes: {planes}, want {want}")
    out["latency"] = {k: dg_latency(r) for k, r in runs.items()}
    out["differences"] = {p: dg_compare(runs[p], runs["agg"], f"(a) {p}",
                                        errors)
                          for p in ("dcn", "ici_inproc")}
    out["parked_after"] = len(pre._parked)
    return out


def dg_checkpoint(dev) -> tuple:
    """DRAFT_MODEL at full width and depth as a local safetensors
    checkpoint (hf_tensors' seeded draw): (its directory, its bytes)."""
    from safetensors.torch import save_file

    cfg = ModelConfig.from_model_name(DRAFT_MODEL)
    src = hf_tensors(cfg, cfg.num_layers, dev)
    if cfg.tie_word_embeddings:
        del src["lm_head.weight"]  # the loader ties it to the embedding
    path = tempfile.mkdtemp(prefix="dtt_dg_")
    nbytes = sum(t.numel() * t.element_size() for t in src.values())
    names = sorted(src)
    for s in range(2):
        save_file({n: src[n].cpu() for n in names[s::2]},
                  os.path.join(path, f"model-{s + 1:05d}-of-00002"
                                     ".safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg, cfg.num_layers), f)
    del src
    return path, nbytes


def dg_child(ckpt: str, port: int):
    """The prefill role as its own process: `python -m
    dynamo_tpu_torch.jetstream --device cuda --disaggregation-mode
    prefill` on DRAFT_MODEL's checkpoint, its log in a temporary file."""
    log = tempfile.TemporaryFile()
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.jetstream",
           "--device", "cuda", "--disaggregation-mode", "prefill",
           "--disaggregation-bootstrap-port", "0",
           "--model", DRAFT_MODEL, "--model-path", ckpt,
           "--host", "127.0.0.1", "--port", str(port),
           "--page-size", str(PS), "--num-pages", str(DG_CHILD_PAGES),
           "--max-num-seqs", str(MAX_SEQS), "--max-seq-len", str(MAX_SEQ_LEN)]
    proc = subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def dg_peer(url: str):
    """A decode peer that stages DG_LEAK_RID on `url`, maps its KV over
    CUDA IPC, prints one JSON line and waits to be killed."""
    return subprocess.Popen(
        [sys.executable, "-c", DG_PEER, url, DG_LEAK_RID],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dg_line(proc, timeout: float) -> str:
    """The first JSON line `proc` prints, within `timeout`."""
    got = []

    def read():
        for line in proc.stdout:
            if line.startswith("{"):
                got.append(line)
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    return got[0] if got else ""


def dg_ipc_rate(child_url: str, dec: Engine) -> dict:
    """(b)'s CUDA IPC handoff of one DG_RATE_TOKENS-token prompt's KV,
    timed alone (wall seconds until the card finished): the stage RPC (the
    child's gather and export), opening the handles here, and the import's
    scatter into `dec`'s pools."""
    from dynamo_tpu_torch.transfer.kv_transfer import (DeviceKVClient,
                                                       device_uuid)

    rid = "__dg_rate_ici_device"
    prompt = [(7 * j) % 251 + 1 for j in range(DG_RATE_TOKENS)]
    first = dg_post(child_url + "/disagg/prefill", {
        "request_id": rid, "prompt_token_ids": prompt,
        "device_uuid": device_uuid(dec.device)})["first_token"]
    t0 = time.monotonic()
    staged = dg_post(child_url + "/disagg/stage", {"request_id": rid})
    stage_s = time.monotonic() - t0
    (k, v), open_s = synced_s(
        lambda: DeviceKVClient(dec.device).pull(staged))
    req = GenRequest(rid, prompt, max_tokens=4, temperature=0.0,
                     ignore_eos=True)
    _, import_s = synced_s(lambda: dec.import_kv(req, first, k, v))
    nbytes = int(k.nbytes + v.nbytes)
    del k, v
    dg_post(child_url + "/disagg/release", {"request_id": rid})
    dec.abort_request(rid)
    while dec.has_work:
        dec.step()
    return {"kv_bytes": nbytes, "stage_s": stage_s, "open_s": open_s,
            "import_s": import_s,
            "import_gb_per_s": nbytes / import_s / 1e9}


def dg_cross(proc, log, child_url: str, ckpt: str, jet_cfg: dict,
             errors: list, closers: list) -> dict:
    """Phase 20 (b): the prefill child and a decode role here over CUDA
    IPC, against an aggregated worker on the same checkpoint; then the
    leak drill against a prefill role of this process."""
    out = {}
    cfg = dict(jet_cfg, model=DRAFT_MODEL, model_path=ckpt)
    dec = Engine(EngineConfig(**cfg, disaggregation_mode="decode"))
    agg = Engine(EngineConfig(**cfg), params=dec.model)
    pre = Engine(EngineConfig(**cfg, disaggregation_mode="prefill",
                              disaggregation_bootstrap_port=0),
                 params=dec.model)
    for e in (dec, agg, pre):
        e.warmup()
    # the drill's prefill worker: its stage TTL shortened, a peer process
    # staging on it while the chats below run
    pre_ctx = ServingContext(pre, DRAFT_MODEL)
    pre_ctx.kv_device_source.staged_ttl_s = DG_STAGED_TTL_S
    pre_url = dg_serve(pre_ctx, closers)
    peer = dg_peer(pre_url)
    closers.append(lambda: (peer.kill(), peer.wait(timeout=30)))
    lc_wait(lambda: proc.poll() is not None or fe_up(child_url), 180,
            "phase 20: the prefill child to answer")
    if proc.poll() is not None:
        raise AssertionError(f"phase 20: the prefill child exited: "
                             f"{fe_log_tail(log)}")
    with torch.inference_mode():
        out["rate"] = dg_ipc_rate(child_url, dec)
    ctx = ServingContext(dec, DRAFT_MODEL, prefill_urls=[child_url])
    ctx.tokenizer = VisibleTokenizer()
    dec_url = dg_serve(ctx, closers)
    agg_ctx = ServingContext(agg, DRAFT_MODEL)
    agg_ctx.tokenizer = VisibleTokenizer()
    agg_url = dg_serve(agg_ctx, closers)
    runs = {"ici_device": dg_chats(dec_url, DRAFT_MODEL),
            "agg": dg_chats(agg_url, DRAFT_MODEL)}
    out["planes"] = dict(ctx.disagg_client.plane_counts)
    want = {"ici_inproc": 0, "ici_device": DG_PROMPTS, "dcn": 0}
    if out["planes"] != want:
        errors.append(f"(b) planes: {out['planes']}, want {want}")
    out["latency"] = {k: dg_latency(r) for k, r in runs.items()}
    out["differences"] = dg_compare(runs["ici_device"], runs["agg"],
                                    "(b) ici_device", errors)
    # the releases go out on threads of their own
    lc_wait(lambda: fe_get(child_url + "/worker/stats")["parked_kv"] == 0,
            30, "phase 20: the child's releases")
    stats = fe_get(child_url + "/worker/stats")
    out["child_native"] = stats["native"]
    out["child_peak_gib"] = max(
        d["peak_bytes_in_use"] for d in stats["memory"]["devices"]) / 2**30
    if stats["parked_kv"] or stats["staged_kv"] != {"live": 0,
                                                    "leaked": 0}:
        errors.append(f"(b) the child holds KV after the releases: "
                      f"{stats['parked_kv']} parked, {stats['staged_kv']}")
    # the leak drill: the peer staged and mapped its request's KV; killed
    # before its release, the stage turns leaked at the TTL, and a late
    # release frees it and the parked pages
    line = dg_line(peer, 120)
    out["peer"] = json.loads(line) if line else None
    peer.kill()
    peer.wait(timeout=30)
    if not line:
        errors.append("(b) the staging peer never mapped its KV")
        return out
    time.sleep(DG_STAGED_TTL_S)
    stats = lambda: fe_get(pre_url + "/worker/stats")  # noqa: E731
    before = stats()
    dg_post(pre_url + "/disagg/release", {"request_id": DG_LEAK_RID})
    after = stats()
    out["leak_drill"] = {
        "staged_kv_after_kill": before["staged_kv"],
        "parked_after_kill": before["parked_kv"],
        "staged_kv_after_release": after["staged_kv"],
        "parked_after_release": after["parked_kv"],
        "free_pages_after_release": after["free_pages"]}
    if (before["staged_kv"] != {"live": 0, "leaked": 1}
            or before["parked_kv"] != 1
            or after["staged_kv"] != {"live": 0, "leaked": 0}
            or after["parked_kv"] != 0
            or after["free_pages"] != pre.cfg.num_pages - 1):
        errors.append(f"(b) the leak drill: {out['leak_drill']}")
    return out


def dg_kvbm(engine: Engine, eager_cfg: dict, errors: list,
            closers: list) -> dict:
    """Phase 20 (c): a warm worker's host tier serves a cold worker through
    --kvbm-peers; turn 2's TTFT against a worker that recomputes."""
    cfg = dict(eager_cfg, enable_prefix_caching=True,
               kvbm_host_blocks=DG_HOST_BLOCKS, kvbm_gate="always")
    warm, cold, rec = (Engine(EngineConfig(**cfg), params=engine.model)
                       for _ in range(3))
    ctx_w = ServingContext(warm, MODEL)
    ctx_c = ServingContext(cold, MODEL, kvbm_peers=[
        f"127.0.0.1:{ctx_w.kvbm_source.port}"])
    ctx_r = ServingContext(rec, MODEL)
    urls = []
    for ctx in (ctx_w, ctx_c, ctx_r):
        ctx.tokenizer = VisibleTokenizer()
        urls.append(dg_serve(ctx, closers))
    rng = np.random.default_rng(2000)
    words = []
    while sum(len(w) + 1 for w in words) < DG_TURN1_CHARS:
        words.append(FE_WORDS[rng.integers(len(FE_WORDS))])
    msgs = [{"role": "user", "content": " ".join(words)}]
    turn1 = fe_http_stream(urls[0], fe_body(msgs, FE_TURN_TOKENS))
    demoted = ctx_w.drain_demote()
    msgs2 = msgs + [{"role": "assistant", "content": turn1["text"]},
                    {"role": "user", "content": "And the next page?"}]
    body = fe_body(msgs2, FE_TURN_TOKENS)
    runs = {"peer_pull": fe_http_stream(urls[1], body),
            "recompute": fe_http_stream(urls[2], body)}
    st = cold.kvbm.stats()
    out = {"demoted_pages": demoted,
           "peer_onboarded_blocks_total": st["peer_onboarded_blocks_total"],
           "turn2_ttft_ms": {k: r["ttft_ms"] for k, r in runs.items()},
           "difference": fe_difference(runs["peer_pull"], runs["recompute"])}
    if not out["peer_onboarded_blocks_total"]:
        errors.append(f"(c) no block onboarded from the peer: {st}")
    d = out["difference"]
    if d is not None and not d["near_tie"]:
        errors.append(f"(c) the peer-pulled turn 2 differs: {d}")
    return out


def disagg_phase(engine: Engine, eager_cfg: dict, jet_cfg: dict) -> dict:
    """Phase 20 (see the module doc) -> {"launches"}: (a)'s launches,
    counted from zero over its served requests."""
    t_phase = time.monotonic()
    errors, out, closers = [], {}, []
    libs = {p.name: p.stat().st_mtime for p in ca.BUILD_DIR.glob("*.so")}
    t0 = time.monotonic()
    ckpt, ckpt_bytes = dg_checkpoint(torch.device("cuda"))
    out["checkpoint"] = {"gib": ckpt_bytes / 2**30,
                         "write_s": time.monotonic() - t0}
    child_url = f"http://127.0.0.1:{fe_free_port()}"
    # the child starts while (a) and (c) run here
    proc, log = dg_child(ckpt, int(child_url.rsplit(":", 1)[1]))
    for layer in engine.model.layers:
        layer.wq.mul_(WINDOWED_WQ_SCALE)  # a power of 2: exact, undone below
    try:
        try:
            out["inproc"] = dg_inproc(engine, jet_cfg, errors, closers)
            out["kvbm_peer"] = dg_kvbm(engine, eager_cfg, errors, closers)
        finally:
            for layer in engine.model.layers:
                layer.wq.div_(WINDOWED_WQ_SCALE)
        out["cross_process"] = dg_cross(proc, log, child_url, ckpt,
                                        jet_cfg, errors, closers)
        out["native_transport"] = transport_status()
        if not out["native_transport"]["native_transport"]:
            errors.append(f"the native transport did not load: "
                          f"{out['native_transport']}")
        rebuilt = {p.name: p.stat().st_mtime for p in
                   ca.BUILD_DIR.glob("*.so")} != libs
        out["kernels_rebuilt"] = rebuilt
        if rebuilt:
            errors.append("the kernel library was rebuilt during phase 20")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for close in reversed(closers):
            try:
                close()
            except Exception as e:
                errors.append(f"teardown: {type(e).__name__}: {e}")
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
        out["child_log_tail"] = fe_log_tail(log)[-600:] if errors else ""
        log.close()
        shutil.rmtree(ckpt, ignore_errors=True)
        del closers
        release()
    launches = out["inproc"]["launches"]
    out.update(seconds=time.monotonic() - t_phase, card=card_line())
    emit({"phase": "disagg", "model": MODEL, "child_model": DRAFT_MODEL,
          **out})
    if errors:
        raise AssertionError(f"phase 20: {errors}")
    return {"launches": launches}


# ------------------------------------------------------------- phase 21 --

FL_NS, FL_DGD = "fleet", "fleet"
FL_SYSTEM = "h100-sxm-1"
# the SLA the profiler sizes the worker for (the 8B on one card meets it)
FL_SLA = {"isl": 2048, "osl": 256, "ttft": 1000, "itl": 50}
FL_PAGES, FL_HOST_BLOCKS = 1024, 64
FL_TENANTS = [{"name": "fleet", "weight": 1, "apiKeys": ["sk-fleet"]}]
FL_AUTH = {"Authorization": "Bearer sk-fleet"}
# the chats' user messages (bytes: tokens), under and over the 256-token
# chunk, so that prefill.cu and chunk.cu both serve them
FL_CHAT_CHARS, FL_TOKENS = (120, 600, 200, 900), 32
FL_BURST, FL_BURST_TOKENS = 8, 128
FL_STREAMS_PER_REPLICA, FL_MAX_REPLICAS = 2, 4
# the factors' measurements: a whole prompt's prefill, and graph-window
# decode steps at 1 slot and at FL_WIDE slots
FL_PREFILL_TOKENS, FL_WIDE, FL_WINDOWS = 1920, 256, 12
# the served streams' medians over the roofline's estimate at one live
# stream. ITL: the factors come from this path, so within the JAX
# profiler's factor-2 accuracy band. TTFT: the formula has no term for
# the first token's wait on its decode window nor for a chunked prefill
# (ROADMAP queue 3), so it runs an order of magnitude low (12.81 on an
# H100 80GB HBM3 at 700 W); the band holds that gap, and a change that
# moves it out of the band fails here until the queue's item is updated
FL_ITL_RATIO, FL_TTFT_RATIO = (0.5, 2.0), (4.0, 40.0)


def fl_template(fe_url: str) -> dict:
    """The DGD the DGDR renders: the frontend and one jetstream worker of
    the 8B (a small pool, prefix caching with the KVBM's host tier, one
    tenant), its decode pool autoscaled from the frontend's metrics."""
    from dynamo_tpu_torch.operator import materialize as mat

    return {
        "apiVersion": mat.API_VERSION, "kind": mat.DGD_KIND,
        "metadata": {"name": FL_DGD},
        "spec": {"services": {
            "Frontend": {"componentType": "frontend", "replicas": 1,
                         "tenants": FL_TENANTS},
            "DecodeWorker": {
                "componentType": "worker", "replicas": 1,
                "tenants": FL_TENANTS, "kvbmHostBlocks": FL_HOST_BLOCKS,
                "drainSeconds": 5,
                "extraPodSpec": {"mainContainer": {
                    "command": ["python3", "-m",
                                "dynamo_tpu_torch.jetstream"],
                    "args": ["--model", MODEL, "--page-size", str(PS),
                             "--num-pages", str(FL_PAGES),
                             "--max-seq-len", str(MAX_SEQ_LEN),
                             "--prefill-chunk-tokens", str(CHUNK),
                             "--enable-prefix-caching"]}},
                "autoscaling": {
                    "enabled": True, "role": "decode",
                    "minReplicas": 1, "maxReplicas": FL_MAX_REPLICAS,
                    "targetUtilization": 1.0, "expectedOsl": FL_TOKENS,
                    "scaleDownDelaySeconds": 5,
                    "forecastHorizonSeconds": 10,
                    "metricsUrl": fe_url + "/metrics",
                    "historyUrl": fe_url + "/debug/slo?history=1",
                    # demand in streams: FL_STREAMS_PER_REPLICA a replica
                    # (the forecast's token rate never binds)
                    "pool": {"tokensPerSPerReplica": 1e6,
                             "maxStreamsPerReplica": FL_STREAMS_PER_REPLICA},
                },
            },
        }},
    }


def fl_stream(url: str, body: dict) -> dict:
    """A greedy streamed chat with logprobs: each token's (text, logprob),
    its top-2 logprobs, TTFT and mean ITL on the client's clock (every
    token's event: the byte tokenizer decodes most of the random weights'
    tokens to nothing), and the usage."""
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **FL_AUTH})
    t0 = time.monotonic()
    stamps, lps, tops, usage = [], [], [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for t, ev in fe_events(iter(lambda: r.read1(65536), b""), t0):
            usage = ev.get("usage") or usage
            choice = (ev.get("choices") or [{}])[0]
            for e in (choice.get("logprobs") or {}).get("content") or ():
                stamps.append(t)
                lps.append([e["token"], e["logprob"]])
                tops.append([a["logprob"] for a in e["top_logprobs"]])
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return {"lps": lps, "tops": tops, "usage": usage,
            "ttft_ms": 1e3 * stamps[0] if stamps else None,
            "itl_ms": 1e3 * statistics.mean(gaps) if gaps else None}


def fl_body(chars: int, max_tokens: int, i: int) -> dict:
    rng = np.random.default_rng(4000 + i)
    words = [f"{i}:"]
    while sum(len(w) + 1 for w in words) < chars:
        words.append(FE_WORDS[rng.integers(len(FE_WORDS))])
    return dict(COMMON, messages=[{"role": "user", "content": " ".join(
        words)}], max_tokens=max_tokens, stream=True, logprobs=True,
                top_logprobs=2, stream_options={"include_usage": True})


def fl_difference(got: dict, ref: dict):
    """None when `got` streamed `ref`'s tokens with `ref`'s logprobs; else
    where it first differs, the reference's top-2 gap there, and whether
    that is a near-tie (equal lengths, a gap under NEAR_TIE)."""
    a, b = got["lps"], ref["lps"]
    if a == b:
        return None
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    top = ref["tops"][i] if i < len(ref["tops"]) else []
    gap = top[0] - top[1] if len(top) > 1 else float("inf")
    return {"index": i, "lengths": [len(a), len(b)], "top2_gap": gap,
            "near_tie": len(a) == len(b) and gap < NEAR_TIE}


def fl_engine_config(container: dict) -> EngineConfig:
    """The EngineConfig the worker container's command builds: its args
    through the worker's own parser, its env in place (the parser reads
    the DYNAMO_TPU_* defaults)."""
    env = {e["name"]: str(e["value"]) for e in container.get("env") or []
           if "value" in e}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        args = build_parser("jetstream").parse_args(container["args"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return EngineConfig.from_cli_args(args)


def fl_window_ms(engine: Engine, slots: int, prompt_len: int = 32) -> float:
    """ms per decode step of `engine`'s graph windows with `slots` live
    sequences after `prompt_len`-token prompts: FL_WINDOWS engine steps
    timed on the host clock, the card synchronized at both ends."""
    k = engine.cfg.num_scheduler_steps
    for i in range(slots):
        engine.add_request(GenRequest(
            f"fl-win-{i}", [1 + (i + j) % 200 for j in range(prompt_len)],
            max_tokens=(FL_WINDOWS + 3) * k, temperature=0.0,
            ignore_eos=True))
    while engine.pending:
        engine.step()
    engine.step()
    steps0 = engine.metrics.decode_steps
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(FL_WINDOWS):
        engine.step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    steps = engine.metrics.decode_steps - steps0
    while engine.has_work:
        engine.step()
    if steps != FL_WINDOWS * k:
        raise AssertionError(f"phase 21: {steps} decode steps in "
                             f"{FL_WINDOWS} windows of {k}")
    return wall / steps * 1e3


def fl_factors(engine: Engine, jet_cfg: dict, served_itl_ms: float) -> dict:
    """The roofline's factors for the card, from this run (see
    profiler/roofline.py): the whole-prompt prefill's FLOPs over its time
    (MFU_PREFILL), the weights' and context's bytes over a one-slot
    graph-window step (HBM_EFF), FL_WIDE slots' FLOPs over their step
    (MFU_DECODE), and the served streams' ITL (one live stream, as the
    one-slot step) less that step (DISPATCH_OVERHEAD_S)."""
    from dynamo_tpu_torch.profiler import roofline

    cfg = engine.model_cfg
    p_total = roofline.param_count(cfg)
    p_active = roofline.active_param_count(cfg)
    kvb = roofline.kv_bytes_per_token(cfg)
    out = {}
    one = Engine(EngineConfig(**dict(jet_cfg, max_num_seqs=1)),
                 params=engine.model)
    one.warmup()
    prompt = [1 + i % 200 for i in range(FL_PREFILL_TOKENS)]
    with torch.inference_mode():
        ttft_alone(one, prompt)
        prefill_s = ttft_alone(one, prompt) / 1e3
        one_ms = fl_window_ms(one, 1)
    l, nh, hd, n = cfg.num_layers, cfg.num_heads, cfg.head_dim, len(prompt)
    flops = 2.0 * p_active * n + 4.0 * l * nh * hd * n * n
    out["prefill"] = {"tokens": n, "seconds": prefill_s, "flops": flops}
    out["mfu_prefill"] = flops / (prefill_s * BF16_FLOPS_PER_S)
    ctx = 32 + 1.5 * FL_WINDOWS * one.cfg.num_scheduler_steps
    nbytes = p_total * roofline.BYTES + kvb * ctx
    out["decode_1"] = {"ms_per_step": one_ms, "bytes": nbytes}
    out["hbm_eff"] = nbytes / (one_ms / 1e3 * HBM_BYTES_PER_S)
    del one
    release()
    # pages for every slot's whole run, so that no window shortens
    wide = Engine(EngineConfig(**dict(jet_cfg, max_num_seqs=FL_WIDE,
                                      num_pages=FL_WIDE * 10 + 16)),
                  params=engine.model)
    wide.warmup()
    with torch.inference_mode():
        wide_ms = fl_window_ms(wide, FL_WIDE)
    out["decode_wide"] = {"slots": FL_WIDE, "ms_per_step": wide_ms}
    out["mfu_decode"] = (2.0 * p_active * FL_WIDE
                         / (wide_ms / 1e3 * BF16_FLOPS_PER_S))
    del wide
    release()
    out["served_itl_ms"] = served_itl_ms
    out["dispatch_s"] = (served_itl_ms - one_ms) / 1e3
    out["in_code"] = dataclasses.asdict(roofline.CARD_FACTORS)
    return out


def fl_profiler(errors: list) -> dict:
    """(a): the port's profiler CLI on the SLA."""
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.profiler", "--model",
           MODEL, "--system", FL_SYSTEM, "--json"] + [
               x for k, v in FL_SLA.items() for x in (f"--{k}", str(v))]
    done = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=300)
    if done.returncode:
        raise AssertionError(f"phase 21: the profiler failed: "
                             f"{done.stderr[-2000:]}")
    out = json.loads(done.stdout)
    best = out["best"]
    if not best or not best["meets_sla"] or best["tp"] != 1:
        errors.append(f"(a) the profiler found no tp=1 point meeting "
                      f"{FL_SLA}: {best}")
    return out


def fl_materialized(fake, ctrl, fe_url: str, errors: list) -> tuple:
    """(b): the DGDR through the controller -> (the frontend's and the
    worker's Deployments, the decision)."""
    from dynamo_tpu_torch.operator import materialize as mat
    from dynamo_tpu_torch.profiler.configurator import ANNOTATION

    fake.put_object("v1", FL_NS, "configmaps", {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "fleet-template"},
        "data": {"dgd.yaml": json.dumps(fl_template(fe_url))}})
    fake.put_object(mat.API_VERSION, FL_NS, mat.DGDR_PLURAL, {
        "apiVersion": mat.API_VERSION, "kind": mat.DGDR_KIND,
        "metadata": {"name": "fleet-request"},
        "spec": {"model": MODEL, "backend": "jetstream", "autoApply": True,
                 "profilingConfig": {
                     "config": {"configMapRef": {"name": "fleet-template",
                                                 "key": "dgd.yaml"}},
                     "sla": FL_SLA, "tpuSystem": FL_SYSTEM}}})
    ctrl.reconcile_once()  # DGDR -> DGD
    ctrl.reconcile_once()  # DGD -> children
    req = fake.get_object(mat.API_VERSION, FL_NS, mat.DGDR_PLURAL,
                          "fleet-request")
    dgd = fake.get_object(mat.API_VERSION, FL_NS, mat.DGD_PLURAL, FL_DGD)
    if (req.get("status") or {}).get("state") != "successful" or not dgd:
        raise AssertionError(f"phase 21: the DGDR: {req.get('status')}")
    decision = json.loads(dgd["metadata"]["annotations"][ANNOTATION])
    deps = {n: fake.get_object("apps/v1", FL_NS, "deployments",
                               f"{FL_DGD}-{n}")
            for n in ("frontend", "decodeworker")}
    fe_c, w_c = (deps[n]["spec"]["template"]["spec"]["containers"][0]
                 for n in ("frontend", "decodeworker"))
    env = {e["name"]: e.get("value") for e in w_c["env"]}
    checks = {
        "frontend_command": fe_c["command"] == [
            "python3", "-m", "dynamo_tpu_torch.frontend"],
        "worker_command": w_c["command"] == [
            "python3", "-m", "dynamo_tpu_torch.jetstream"],
        "gpu_limit": w_c["resources"]["limits"] == {"nvidia.com/gpu": "1"},
        "gpu_request": w_c["resources"]["requests"] == {
            "nvidia.com/gpu": "1"},
        "tp": w_c["args"][w_c["args"].index("--tp") + 1] == "1",
        "max_num_seqs": w_c["args"][w_c["args"].index(
            "--max-num-seqs") + 1] == str(decision["max_num_seqs"]),
        "tenants_env": json.loads(env.get("DYNAMO_TPU_TENANTS") or "[]")[
            0]["name"] == "fleet",
        "kvbm_env": env.get("DYNAMO_TPU_KVBM_HOST_BLOCKS") == str(
            FL_HOST_BLOCKS),
        "no_gang": "hostsPerReplica" not in dgd["spec"]["services"][
            "DecodeWorker"],
    }
    if not all(checks.values()):
        errors.append(f"(b) the materialized Deployments: {checks}")
    return deps, decision, checks


def fl_burst(ctrl, fake, fe_url: str, worker_url: str,
             errors: list) -> dict:
    """(d): the planner from the live frontend's metrics: up under a
    burst, down after it, the victim's pre-drain at the worker."""
    from dynamo_tpu_torch.operator.controller import DRAIN_VICTIM_ANNOTATION
    from dynamo_tpu_torch.planner.signals import parse_metrics_text

    def replicas():
        ctrl.reconcile_once()
        return fake.get_object("apps/v1", FL_NS, "deployments",
                               f"{FL_DGD}-decodeworker")["spec"]["replicas"]

    def inflight():
        return parse_metrics_text(scrape(fe_url))["inflight"]

    out = {"before": replicas()}
    runs = [None] * FL_BURST

    def one(i):
        runs[i] = fl_stream(fe_url, fl_body(120, FL_BURST_TOKENS, 100 + i))

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(FL_BURST)]
    for t in threads:
        t.start()
    lc_wait(lambda: inflight() >= FL_BURST, 60,
            "phase 21: the burst in flight at the frontend")
    out["inflight_at_tick"] = inflight()
    out["changed_up"] = ctrl.planner_tick(now=1000.0)
    out["during"] = replicas()
    for t in threads:
        t.join(timeout=300)
    out["burst_itl_ms"] = statistics.median(r["itl_ms"] for r in runs)
    out["burst_ttft_ms"] = statistics.median(r["ttft_ms"] for r in runs)
    out["burst_isl"] = int(statistics.median(
        r["usage"]["prompt_tokens"] for r in runs))
    lc_wait(lambda: inflight() == 0, 60, "phase 21: the burst's end")
    ctrl.planner_tick(now=1010.0)  # arms the scale-down delay
    steps = []
    for i in range(FL_MAX_REPLICAS):
        steps.append(ctrl.planner_tick(now=1020.0 + 10 * i))
    out["after"] = replicas()
    pod = fake.get_object("v1", FL_NS, "pods", f"{FL_DGD}-decodeworker-0")
    out["victim_marked"] = ((pod["metadata"].get("annotations") or {})
                            .get(DRAIN_VICTIM_ANNOTATION) == "true")
    out["worker_draining"] = fe_get(worker_url + "/worker/stats")["draining"]
    out["decisions"] = [
        {k: d[k] for k in ("t", "from_replicas", "to_replicas", "reason",
                           "inflight")}
        for d in ctrl.planner_debug_payload()["pools"][
            f"{FL_NS}/{FL_DGD}"]["decisions"]]
    want_up = -(-FL_BURST // FL_STREAMS_PER_REPLICA)
    if not (out["before"] == 1 and out["during"] == min(
            want_up, FL_MAX_REPLICAS) and out["after"] == 1
            and out["victim_marked"] and out["worker_draining"]):
        errors.append(f"(d) the planner: {out}")
    return out


def fleet_phase(engine: Engine, jet_cfg: dict) -> dict:
    """Phase 21 (see the module doc) on the 8B's weights -> {"launches"}:
    this process's reference engine's launches over its served chats and
    the materialized worker's own over its served chats and the burst
    (its /worker/stats, less its counts once it registered), each counted
    from zero."""
    from dynamo_tpu_torch.operator import materialize as mat
    from dynamo_tpu_torch.operator.controller import Controller
    from dynamo_tpu_torch.operator.k8s_client import K8sClient
    from dynamo_tpu_torch.profiler import roofline
    from dynamo_tpu_torch.profiler.systems import get_system
    # the test doubles, by path (a `tests` package elsewhere on the path
    # may shadow the checkout's)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    from fake_k8s import FakeK8s
    from fake_kubelet import run_pod

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    errors, out, closers, pods, launches = [], {}, [], [], {}
    ref = ref_ctx = None
    out["profiler"] = fl_profiler(errors)
    emit({"phase": "fleet_profiler", "estimate": out["profiler"]["best"],
          "sla": out["profiler"]["sla"], "system": FL_SYSTEM})
    fe_port = fe_free_port()
    fe_url = f"http://127.0.0.1:{fe_port}"
    worker_url = f"http://127.0.0.1:{mat.WORKER_PORT}"
    fake = FakeK8s().__enter__()
    closers.append(lambda: fake.__exit__(None, None, None))
    try:
        ctrl = Controller(K8sClient(fake.url), namespace=None)
        deps, decision, out["materialized"] = fl_materialized(
            fake, ctrl, fe_url, errors)
        out["decision"] = decision
        # the kubelet of one: the Service's DNS name to the frontend's port
        # here; the worker binds 8000 on the pod's IP, as in its pod
        services = {f"http://{FL_DGD}-frontend:{mat.FRONTEND_PORT}": fe_url}
        pods.append(run_pod(fake, deps["frontend"], cwd=here,
                            services=services,
                            env={"DYNAMO_PORT": str(fe_port)}))
        pods.append(run_pod(fake, deps["decodeworker"], cwd=here,
                            services=services))
        # this process's reference: the same engine config on the same
        # draw, served alike
        w_c = deps["decodeworker"]["spec"]["template"]["spec"][
            "containers"][0]
        ref = Engine(fl_engine_config(w_c), params=engine.model)
        t0 = time.monotonic()
        ref.warmup()
        out["reference_warmup_s"] = time.monotonic() - t0
        ref_ctx = ServingContext(ref, MODEL)
        ref_url = dg_serve(ref_ctx, closers)
        t0 = time.monotonic()

        def registered() -> bool:
            if not all(p.alive() for p in pods):
                return True
            try:
                return len(fe_get(fe_url + "/internal/workers")[
                    "workers"]) == 1
            except OSError:
                return False

        lc_wait(registered, 300,
                "phase 21: the materialized worker registered")
        if not all(p.alive() for p in pods):
            raise AssertionError(f"phase 21: a pod exited: "
                                 f"{[p.tail() for p in pods]}")
        out["worker_ready_after_reference_s"] = time.monotonic() - t0
        # the worker's counts before the served run: its warmup and graph
        # captures launched these, no served request
        child0 = fe_get(worker_url + "/worker/stats")["kernel_launches"]
        # (c) the chats: through the frontend to the worker, then the same
        # to the reference, one at a time
        ca.reset_launch_counts()
        bodies = [fl_body(c, FL_TOKENS, i)
                  for i, c in enumerate(FL_CHAT_CHARS)]
        served = [fl_stream(fe_url, b) for b in bodies]
        refs = [fl_stream(ref_url, b) for b in bodies]
        launches = dict(ca.LAUNCHES)
        diffs = [fl_difference(g, r) for g, r in zip(served, refs)]
        out["differences"] = diffs
        out["equal"] = sum(d is None for d in diffs)
        if any(len(s["lps"]) != FL_TOKENS for s in served) or any(
                d is not None and not d["near_tie"] for d in diffs):
            errors.append(f"(c) the worker's streams against this "
                          f"process's engine: {diffs}")
        stats = fe_get(worker_url + "/worker/stats")
        out["worker_stats"] = {
            "max_num_seqs": stats["max_num_seqs"],
            "kvbm_capacity_blocks": stats["kvbm"]["host_pool"][
                "capacity_blocks"],
            "qos_tenants": sorted(stats["qos"]["tokens_total"]),
            "decode_graphs": stats["decode_graphs"]}
        if (stats["max_num_seqs"] != decision["max_num_seqs"]
                or out["worker_stats"]["kvbm_capacity_blocks"]
                != FL_HOST_BLOCKS
                or "fleet" not in out["worker_stats"]["qos_tenants"]):
            errors.append(f"(c) the operator's settings at the engine: "
                          f"{out['worker_stats']}")
        cfg = engine.model_cfg
        isl = statistics.median(s["usage"]["prompt_tokens"]
                                for s in served)
        ttft = statistics.median(s["ttft_ms"] for s in served)
        itl = statistics.median(s["itl_ms"] for s in served)
        # the estimate at the served point: one live stream (the KV it
        # reads), and the engine's max_num_seqs (the sweep's batch)
        ests = {b: roofline.estimate(cfg, get_system(FL_SYSTEM), 1, b,
                                     int(isl), FL_TOKENS)
                for b in (1, decision["max_num_seqs"])}
        est = ests[1]
        out["served"] = {
            "prompt_tokens_median": isl, "ttft_ms": ttft, "itl_ms": itl,
            "ttft_ms_each": [s["ttft_ms"] for s in served],
            "itl_ms_each": [s["itl_ms"] for s in served],
            "reference_ttft_ms": statistics.median(r["ttft_ms"]
                                                   for r in refs),
            "reference_itl_ms": statistics.median(r["itl_ms"] for r in refs),
            "estimate_at_served_point": {
                str(b): {"isl": int(isl), "ttft_ms": e.ttft_s * 1e3,
                         "itl_ms": e.itl_s * 1e3} for b, e in ests.items()},
            "ttft_ratio": ttft / (est.ttft_s * 1e3),
            "itl_ratio": itl / (est.itl_s * 1e3),
            "sla_estimate": out["profiler"]["best"]}
        emit({"phase": "fleet_served", **out["served"],
              "equal": out["equal"], "differences": diffs,
              "worker_stats": out["worker_stats"]})
        for key, (lo, hi) in (("itl_ratio", FL_ITL_RATIO),
                              ("ttft_ratio", FL_TTFT_RATIO)):
            if not lo <= out["served"][key] <= hi:
                errors.append(f"(c) served over estimated {key} "
                              f"{out['served'][key]:.3f} outside "
                              f"[{lo}, {hi}]")
        # (d) the planner, then (e) the worker's own launches
        out["planner"] = fl_burst(ctrl, fake, fe_url, worker_url, errors)
        burst = roofline.estimate(cfg, get_system(FL_SYSTEM), 1, FL_BURST,
                                  out["planner"].pop("burst_isl"),
                                  FL_BURST_TOKENS)
        out["planner"]["burst_estimate_itl_ms"] = burst.itl_s * 1e3
        out["planner"]["burst_itl_ratio"] = (out["planner"]["burst_itl_ms"]
                                             / (burst.itl_s * 1e3))
        stats = fe_get(worker_url + "/worker/stats")
        child = {k: n - child0.get(k, 0)
                 for k, n in stats["kernel_launches"].items()}
        out["worker_launches"] = child
        out["worker_launches_before_serving"] = child0
        out["worker_peak_gib"] = max(
            [d["peak_bytes_in_use"] for d in stats["memory"]["devices"]]
            or [0]) / 2**30
        missing = [k for k in ("prefill", "decode", "chunk")
                   if child.get(k, 0) <= 0]
        if missing:
            errors.append(f"(e) kernels the worker never launched: "
                          f"{missing} ({child})")
        launches = {k: n + child.get(k, 0) for k, n in launches.items()}
        out["reference_launches"] = {k: launches[k] - child.get(k, 0)
                                     for k in launches}
        with torch.inference_mode():
            out["factors"] = fl_factors(engine, jet_cfg, itl)
        emit({"phase": "fleet_factors", **out["factors"],
              "card": card_line()})
        for p in pods:
            if not p.alive():
                errors.append(f"{p.name} exited: {p.tail()}")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for close in reversed(closers):
            try:
                close()
            except Exception as e:
                errors.append(f"teardown: {type(e).__name__}: {e}")
        tails = {p.name: p.tail(600) for p in pods}
        for p in pods:
            p.stop(timeout=20)
        if errors:
            out["pod_log_tails"] = tails
        ref = ref_ctx = None
        release()
    out.update(launches=launches, seconds=time.monotonic() - t_phase,
               card=card_line())
    emit({"phase": "fleet", "model": MODEL, **{
        k: v for k, v in out.items() if k not in ("profiler", "served",
                                                  "factors")}})
    if errors:
        raise AssertionError(f"phase 21: {errors}")
    return {"launches": launches}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--kernels-only"], ["--mla-chunked-ttft"],
                    ["--mla-verify-profile"], ["--mla-prefill-profile"],
                    ["--window-profile"], ["--observability"],
                    ["--trace-stress"], ["--gemma"], ["--phi3"],
                    ["--profile-lead"], ["--lifecycle"],
                    ["--kvbm-qos"], ["--frontend"], ["--disagg"],
                    ["--fleet"], ["--moe"], ["--moe", "full"]) and not (
                        len(args) == 2 and args[0] == "--mla-prefill-profile"
                        and args[1].isdigit()):
        print("usage: chip_smoke.py [--kernels-only | --mla-chunked-ttft | "
              "--mla-verify-profile | --mla-prefill-profile [N] | "
              "--window-profile | --observability | --trace-stress | "
              "--gemma | --phi3 | --profile-lead | --lifecycle | "
              "--kvbm-qos | --frontend | --disagg | --fleet | "
              "--moe [full]]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    t_all = time.monotonic()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card})
    if args == ["--profile-lead"]:
        return profile_lead_probe()

    t0 = time.monotonic()
    lib = ca.build()
    build_s = time.monotonic() - t0
    emit({"phase": "build", "seconds": build_s,
          "library_bytes": os.path.getsize(lib._name),
          "ptxas": ptxas_usage(ca.build_log),
          "pair_tile": pair_tile_build(lib._name)})

    base_cfg = dict(model=MODEL, page_size=PS, num_pages=NUM_PAGES,
                    max_num_seqs=MAX_SEQS, max_seq_len=MAX_SEQ_LEN,
                    prefill_chunk_tokens=CHUNK, enable_prefix_caching=False,
                    seed=0)
    # phases 4, 5 and the eager profiles: 1-step synchronous decode, eager
    eager_cfg = dict(base_cfg, num_scheduler_steps=1, async_scheduling=False,
                     enforce_eager=True)
    if args == ["--mla-chunked-ttft"]:
        mla_ttft_only(eager_cfg)
        return 0
    if args == ["--mla-verify-profile"]:
        mla_verify_only(dict(base_cfg, **BACKEND_PROFILES["jetstream"]))
        return 0
    if args[:1] == ["--mla-prefill-profile"]:
        return mla_prefill_only(eager_cfg, int((args + ["1"])[1]))
    jet_cfg = dict(base_cfg, **BACKEND_PROFILES["jetstream"])
    if args == ["--window-profile"]:
        # phase 11's 8-step graph-window decode step on bf16 pools alone,
        # twice: the first pass in a fresh process is its warm-up
        eng = Engine(EngineConfig(**jet_cfg))
        eng.warmup()
        with torch.inference_mode():
            for n in (1, 2):
                emit({"phase": "profile", "pass": n,
                      "weights": quant.mode_of(eng.model),
                      **profile_steps(eng, 4)})
        return 0
    if args == ["--observability"]:
        observability_phase(Engine(EngineConfig(**eager_cfg)), jet_cfg)
        return 0
    if args == ["--trace-stress"]:
        trace_stress(jet_cfg)
        return 0
    if args == ["--lifecycle"]:
        lifecycle_phase(Engine(EngineConfig(**eager_cfg)), jet_cfg)
        return 0
    if args == ["--kvbm-qos"]:
        kvbm_qos_phase(Engine(EngineConfig(**eager_cfg)), eager_cfg)
        return 0
    if args == ["--frontend"]:
        frontend_phase(Engine(EngineConfig(**eager_cfg)), jet_cfg)
        return 0
    if args == ["--disagg"]:
        disagg_phase(Engine(EngineConfig(**eager_cfg)), eager_cfg, jet_cfg)
        return 0
    if args == ["--fleet"]:
        fleet_phase(Engine(EngineConfig(**eager_cfg)), jet_cfg)
        return 0
    if args[:1] == ["--moe"]:
        moe_only(eager_cfg, jet_cfg, full=args[1:] == ["full"])
        return 0
    if args == ["--gemma"]:
        gemma_only(eager_cfg, jet_cfg)
        return 0
    if args == ["--phi3"]:
        phi3_only(eager_cfg, jet_cfg)
        return 0
    rows = kernel_checks(dev)
    family_rows = {label: shape_kernel_checks(dev, label, h, kv, d, names)
                   for label, h, kv, d, names in FAMILY_SHAPES}
    family_rows.update({shape["label"]: windowed_kernel_checks(dev, shape)
                        for shape in (GEMMA_SHAPE, PHI3_SHAPE)})
    if args:
        emit({"phase": "kernels_only", "kernel_ms": {
            row["name"]: row["kernel_ms"] for row in
            [*rows.values(), *(r for fam in family_rows.values()
                               for r in fam.values())]}})
        return 0

    t0 = time.monotonic()
    engine = Engine(EngineConfig(**eager_cfg))
    emit({"phase": "engine", "model": MODEL, "seconds": time.monotonic() - t0,
          "layers": engine.model_cfg.num_layers,
          "hidden": engine.model_cfg.hidden_size,
          "weights_gib": sum(p.numel() * p.element_size()
                             for p in engine.model.parameters()) / 2**30,
          "kv_pool_gib": engine.kv_spec.pool_bytes / 2**30})
    # the mixed engines share the weights; the int8 one also takes phase 4
    mixed = Engine(EngineConfig(**eager_cfg, mixed_batch_tokens=CHUNK),
                   params=engine.model)
    mixed8 = Engine(EngineConfig(**eager_cfg, mixed_batch_tokens=CHUNK,
                                 kv_cache_dtype="int8"), params=engine.model)
    emit({"phase": "engine_int8", "kv_pool_gib": mixed8.kv_spec.pool_bytes
          / 2**30, "lane_width": mixed8.kv_spec.lane_width})
    with torch.inference_mode():
        forward_checks(engine)
        forward_checks(mixed8)

    served = serve_checks(engine)
    emit({"phase": "serve", **served["requests"]})
    served_mixed = {"": mixed_serve_checks(mixed),
                    "_int8": mixed_serve_checks(mixed8)}
    classic_itl = served["requests"]["interference"]["stream"]
    for sfx, row in served_mixed.items():
        emit({"phase": "serve_mixed" + sfx, **row})
    emit({"phase": "itl_while_long_prompt_prefills",
          "classic": classic_itl,
          "mixed": served_mixed[""]["requests"]["stream"],
          "mixed_int8": served_mixed["_int8"]["requests"]["stream"]})

    # decode windows on CUDA graphs: the worker profiles' scheduling
    tok = get_tokenizer(MODEL)
    vllm_cfg = dict(base_cfg, **BACKEND_PROFILES["vllm_tpu"])
    graph_engines = {
        "jetstream": Engine(EngineConfig(**jet_cfg), params=engine.model),
        "jetstream_async": Engine(EngineConfig(**dict(
            jet_cfg, async_scheduling=True)), params=engine.model),
        "jetstream_int8": Engine(EngineConfig(**jet_cfg,
                                              kv_cache_dtype="int8"),
                                 params=engine.model),
        "vllm_tpu": Engine(EngineConfig(**vllm_cfg), params=engine.model),
    }
    for name, eng in graph_engines.items():
        t0 = time.monotonic()
        eng.warmup()
        emit({"phase": "warmup", "engine": name,
              "seconds": time.monotonic() - t0, **eng.windows.stats()})
    parity_ref = Engine(EngineConfig(**dict(eager_cfg,
                                            prefill_chunk_tokens=0)),
                        params=engine.model)
    window_parity(parity_ref, {k: graph_engines[k] for k in
                               ("jetstream", "jetstream_async")}, tok)
    del parity_ref
    served_windows = window_serve(graph_engines["jetstream"])
    emit({"phase": "serve_windows", **served_windows})
    emit({"phase": "itl_windows_vs_eager",
          "eager_1_step": served["requests"]["chat_stream"],
          "graph_windows_8_step":
              served_windows["requests"]["chat_stream"]})
    prefix = prefix_checks(graph_engines["vllm_tpu"], engine, tok)
    emit({"phase": "prefix_cache", **prefix})

    # int8 weights: the engine's loader draws them on the card (no
    # checkpoint, above 2e9 parameters); the weight-only twin shares them
    t0 = time.monotonic()
    jet_w8a8 = Engine(EngineConfig(**jet_cfg, quantization="w8a8"))
    torch.cuda.synchronize()
    q8 = jet_w8a8.model
    int8_weights = quant.with_mode(q8, "int8")
    emit({"phase": "quant_weights", "seconds": time.monotonic() - t0,
          "weights_gib": quant.param_bytes(q8) / 2**30,
          "bf16_weights_gib": quant.param_bytes(engine.model) / 2**30,
          "shared_with_weight_only": int8_weights.layers[0].wq.q.data_ptr()
          == q8.layers[0].wq.q.data_ptr()})
    with torch.inference_mode():
        int_mm_checks(q8)
        quant_matmul_checks(q8, int8_weights)

    # w8a8 in graph windows against eager 1-step, then served
    t0 = time.monotonic()
    jet_w8a8.warmup()
    emit({"phase": "warmup", "engine": "jetstream_w8a8",
          "seconds": time.monotonic() - t0, **jet_w8a8.windows.stats()})
    ref_w8a8 = Engine(EngineConfig(**dict(eager_cfg, prefill_chunk_tokens=0),
                                   quantization="w8a8"), params=q8)
    window_parity(ref_w8a8, {"jetstream_w8a8": jet_w8a8}, tok)
    del ref_w8a8
    served_w8a8 = window_serve(jet_w8a8)
    emit({"phase": "serve_windows_w8a8", **served_w8a8})
    emit({"phase": "itl_windows_w8a8_vs_bf16",
          "bf16": served_windows["requests"]["chat_stream"],
          "w8a8": served_w8a8["requests"]["chat_stream"]})

    # the trtllm_tpu profile on the w8a8 weights: prefix traffic against a
    # cache-off eager w8a8 engine
    with tempfile.TemporaryDirectory(prefix="dtt_cfg_") as tmp:
        trt = trtllm_engine(base_cfg, q8, tmp)
    t0 = time.monotonic()
    trt.warmup()
    emit({"phase": "warmup", "engine": "trtllm_tpu_w8a8",
          "seconds": time.monotonic() - t0, **trt.windows.stats()})
    off_w8a8 = Engine(EngineConfig(**eager_cfg, quantization="w8a8"),
                      params=q8)
    prefix_trt = prefix_checks(trt, off_w8a8, tok)
    emit({"phase": "trtllm_tpu_prefix_cache",
          "profile": BACKEND_PROFILES["trtllm_tpu"],
          "decode_graphs": trt.windows.stats(), **prefix_trt})
    # the int8 weights are drawn again (same seed) for the profiles
    del off_w8a8, trt, jet_w8a8, q8, int8_weights
    release()

    # a checkpoint written here and loaded by model_path, freed afterwards
    ckpt = model_path_checks(eager_cfg, engine.model_cfg, dev)

    # speculative decoding on the bf16 weights (phase 12); `eng` is the
    # warm-up loop's last graph engine
    del graph_engines, eng
    release()
    spec = spec_phases(engine, eager_cfg, jet_cfg, tok)

    # where a steady step's time goes (phase 11), last of the 8B's phases
    # (the profiler leaves the host slower at launching kernels): decode
    # steps on bf16 and int8 pools, eagerly (the mixed engines decode as
    # the classic one does while nothing prefills), then in graph windows
    # on both pool kinds and with w8a8 and weight-only int8 weights, each
    # graph-window engine built, warmed up, profiled and collected in turn
    # (its memory stays in PyTorch's cache: handed back to CUDA, the next
    # engine's first steps would time the allocator); then mixed steps
    def profile(eng, steps, long_prompt=0):
        with torch.inference_mode():
            emit({"phase": "profile", "weights": quant.mode_of(eng.model),
                  **profile_steps(eng, steps, long_prompt)})

    def profile_windows(eng):
        eng.warmup()
        profile(eng, 4)

    profile(engine, 10)
    profile(mixed8, 10)
    profile_windows(Engine(EngineConfig(**jet_cfg), params=engine.model))
    gc.collect()
    profile_windows(Engine(EngineConfig(**jet_cfg, kv_cache_dtype="int8"),
                           params=engine.model))
    gc.collect()
    jet_w8a8 = Engine(EngineConfig(**jet_cfg, quantization="w8a8"))
    profile_windows(jet_w8a8)
    int8_weights = quant.with_mode(jet_w8a8.model, "int8")
    del jet_w8a8
    gc.collect()
    profile_windows(Engine(EngineConfig(**jet_cfg, quantization="int8"),
                           params=int8_weights))
    del int8_weights
    gc.collect()
    profile(mixed, 3, 4 * CHUNK)
    profile(mixed8, 3, 4 * CHUNK)

    # JSON-guided decoding (phase 14) and multi-LoRA serving (phase 15),
    # the last phases on the 8B's weights
    rows.update(grammar_kernel_checks(dev))
    guided = guided_phases(engine, jet_cfg)
    lora = lora_phases(engine, eager_cfg, jet_cfg, tok)
    # the worker's observability plane (phase 16), its lifecycle (phase
    # 17), then the KVBM host tier and tenant QoS (phase 18), then the
    # frontend tier (phase 19), then disaggregation (phase 20), then the
    # fleet's control plane (phase 21, its worker a child process: the
    # mixed engines are freed first), last on the 8B
    observability_phase(engine, jet_cfg)
    lifecycle_phase(engine, jet_cfg)
    kvbm_qos = kvbm_qos_phase(engine, eager_cfg)
    fronted = frontend_phase(engine, jet_cfg)
    disagg = disagg_phase(engine, eager_cfg, jet_cfg)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del mixed, mixed8
    release()
    fleet = fleet_phase(engine, jet_cfg)

    # the new families (phase 13), once the 8B's engines and weights are
    # released
    peak_gib = max(peak_gib, torch.cuda.max_memory_allocated() / 2**30)
    del engine
    release()
    emit({"phase": "released_8b", "peak_gib": peak_gib,
          "allocated_gib": torch.cuda.memory_allocated() / 2**30})
    families = {model: family_phase(model, pools, profiled, eager_cfg,
                                    jet_cfg)
                for model, pools, profiled in FAMILY_MODELS}
    # Gemma-2 and Gemma-3, then Phi-3, after the families (their phases,
    # see above)
    families.update({model: gemma_phase(model, layers, n_check, lengths,
                                        profiled, eager_cfg, jet_cfg)
                     for model, layers, n_check, lengths, profiled
                     in GEMMA_MODELS})
    families[PHI3_MODEL] = phi3_phase(eager_cfg, jet_cfg)
    # the mixture-of-experts models (phase 13), after the families
    families.update({model: moe_phase(model, q, mixed, eager_cfg, jet_cfg,
                                      layers)
                     for model, q, mixed, layers in MOE_MODELS})
    # the MLA model, last (phase 13)
    families[MLA_MODEL] = mla_phase(eager_cfg, jet_cfg)
    emit({"phase": "family_memory",
          "peak_gib": {m: f["peak_gib"] for m, f in families.items()}})
    peak_gib = max([peak_gib] + [f["peak_gib"] for f in families.values()])

    # launches summed over the served phases, each counted from zero: the
    # classic engine, the mixed engines, the graph-window engines (bf16
    # and w8a8 weights), the prefix-caching ones (vllm_tpu, trtllm_tpu),
    # the checkpoint engine, the speculating engines, the guided and the
    # LoRA engines (graph replays included), phase 18's, phase 19's (the
    # workers behind the frontends), phase 20's (a) (the prefill and
    # decode roles) and phase 21's (the materialized worker, counted in
    # its process from its registration, and this process's reference);
    # the verify windows and head_dim 64 from the speculating engines'
    # variant counts
    launches = dict.fromkeys(ca.LAUNCHES, 0)
    for counts in [phase["launches"] for phase in (
            served, served_mixed[""], served_mixed["_int8"], served_windows,
            prefix, served_w8a8, prefix_trt, ckpt, guided, kvbm_qos,
            fronted, disagg, fleet)] + (
                spec["launches"] + lora["launches"]):
        for name, n in counts.items():
            launches[name] += n
    for counts in spec["variants"]:
        for name, variant in VARIANTS.items():
            launches[name] = launches.get(name, 0) + counts.get(variant, 0)
    for label, kernel, model, key in FAMILY_ROWS:
        name = f"{kernel}[{label}]"
        rows[name] = family_rows[label][kernel]
        launches[name] = sum(counts.get(key, 0) for counts in
                             families[model]["launches"]
                             + families[model]["variants"])
    kernels = []
    for name in [*SOURCES, *(f"{k}[{label}]" for label, k, _, _ in
                             FAMILY_ROWS)]:
        source, replaces = SOURCES[name.split("[")[0]]
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "call_ms": row["kernel_call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call_ms": row["library_call_ms"],
            "device_kernels": sorted(row["ptxas"])})
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel never launched when served: "
                             f"{launches}")
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.monotonic() - t_all,
          "peak_mem_gib": peak_gib})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
