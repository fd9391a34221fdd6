#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a), ``nvcc``
and PyTorch built for CUDA; imports nothing of JAX.  Phases, one JSON line
each; any failure exits non-zero before the result line:

  env      the card's name, nvidia-smi name + power limit, versions
  build    nvcc build of repro_torch/csrc/*.cu (one nvcc per source, in
           parallel) and ptxas' register / spill report
  slice    the port's launcher in-process: llama3.2-1b at full width
           (16 layers, d 2048, vocab 128256, bf16, random weights from seed
           0), 16 requests x 128 prompt tokens, 32 new tokens, --split auto
           (probe -> fit -> Eq. 4 -> masked payload -> OffloadEngine over a
           primary and an auxiliary group on the one card); checks
           decode_attention launches == layers x decode steps and
           masked_compact launches > 0
  kernels  every kernel of the main path against its plain PyTorch version
           on the card, at the batch sizes the slice ran (the probe and
           each group; S=168, H=32, Hkv=8, dh=64) plus a scalar length,
           cache_len 0 (exactly 0), lengths either side of each split
           boundary, a window smaller than one split, ragged long caches
           (S=4100, window 0 and 128) and an empty window, and a sweep over
           dh 64/80/128 x G 1/4/8; every call twice, bit-equal; bf16 within
           3e-2 and f32 within 1e-4; masked_compact bit for bit, bf16 and
           f32, at every slice's payload (d 2048 and 4096), S one tile -1,
           one tile and one tile +1, K > S, K = 0, B = S = 1, capacity ==
           kept, zero kept, overflow past K, an odd row width, long rows
           (S 32768 and 131072), both KV-hop shapes and views at storage
           offset 1 (the narrower copy paths); each call twice, bit-equal,
           and once more through the other base-finding branch; the
           decode_attention sweep also covers G 6 (nemotron), 7 (internvl2)
           and 16 (two head groups)
  prefill_attention  no model held: the prefill-attention kernel against
           chunked_attention on the card at the docqa cell's shape (B=1,
           S=2048, 48/8 heads of 128, causal), dh 64 with G 4, dh 80, a
           sliding window, a prefix resume (Sq 384, Sk 2048), non-causal
           cross-attention, padded queries and keys, and rows that see no
           key (exactly 0): its f32 result within 3e-5 of max|v| of the
           plain version's, its bf16 output at most one bf16 ulp from the
           plain bf16 output on all but 1e-3 of the elements, every call
           twice, bit-equal; then its time and chunked_attention's at the
           cell's shape beside the bound; the static slices (slice,
           dense_slices, moe_slice, ssm_slice) check its launches ==
           attention layers x prefills
  parity   a float32 copy of the same weights: kernel path vs plain path
           logits over 8 teacher-forced decode steps within 1e-3; greedy
           streams agree up to the plain path's first top-2 gap < 1e-3;
           macro_steps=8 and 0 streams identical (bf16, kernels on)
  trace    one group's generate() of 16 new tokens under torch.profiler
           (TRACE_NEW; the slices decode 32): device busy and
           idle share, the kernels that take the device time
  timing   each kernel, its plain version and the PyTorch library call at
           the main path's shapes, beside the bound: "ms" from CUDA events
           around a loop of calls (what a caller pays per call, host work
           included), "device_ms" from CUDA events around a loop the host
           enqueues while a device-side sleep holds the stream (the device
           work alone, back to back); loops cycle through more input sets
           than L2 holds; masked_compact also at llama3.2-1b's
           prefill->decode KV hop ([16,2048,512] bf16, lossless and top 72%),
           with the device ms of each base-finding branch
  continuous  with llama's params still loaded: ContinuousServingEngine
           (slots 8, max_len 512, K=8) over 24 requests (4 shared 64-token
           prefixes x 6 suffixes from request_stream(seed=0), prompts of
           72-256 tokens padded to 256, one exact duplicate, max_new 1-48)
           in seven modes: per-step, boundary, overlapped, overlapped with
           wave_steps=2, + PrefixCache(block 8, budget 256), + a
           PrefillWorker on the card (lossless hop), + kv_keep_rate 0.72
           (lossy); checks modes 1-6 stream-identical, decode_attention ==
           layers x model decode steps in each mode, masked_compact == 2 x
           the hops that shipped a KV tail; reports tokens/s, the dispatch,
           await and overlap walls, stalls, hits, hop bytes, peak memory
  continuous_checks  a lossless KV hop at llama's real tail restores the
           prefill cache bit for bit; the resumed prefill against the cold
           one (bf16, reported); decode_attention at the slot width over
           512 rows and masked_compact at the hop's [16,192,512] against
           their plain versions; the tail's .contiguous() copy timed; a
           float32 2-layer cut: continuous streams equal the plain static
           path's up to its first top-2 gap < 1e-3
  fleet_static  the launcher's static star with llama's params held:
           --topology star --nodes 3 --split auto, 16 x 128 tokens, 32 new
           (probe -> fit -> solve_star -> SplitVector -> each spoke's §VI
           payload -> OffloadEngine); checks decode_attention == layers x
           decode steps and masked_compact == the spokes that got requests;
           reports f*, solve_star's host ms, t_parallel / t_serial; then
           decode_attention at the probe's and each group's batch over 168
           rows and masked_compact at each spoke's payload [n,128,2048]
           against their plain versions
  fleet_reference  one ContinuousServingEngine (slots 4, per-step,
           max_len 296) over the fleet requests: 64 of the continuous
           traffic's shape (4 shared 64-token prefixes, prompts padded to
           256, max_new 1-32, 1,071 tokens): the streams the fleet
           phases are held to
  fleet_star / fleet_disagg / fleet_frontend  the launcher's
           serve_continuous over HeteroRuntime (slots 4 a group, K=8,
           overlapped admission, the launcher's 256 + 32 + 8 = 296 cache
           rows, --split auto: the live controller) on
           those requests: a star of 3 (waves of 16, solve_star re-solves);
           a star of 4 whose spoke 3 prefills, with a PrefixCache (256
           blocks of 8) and a 2-worker PrefillWorkerPool (KV hops on
           masked_compact); the star of 3 behind ServingFrontend (tenants
           interactive:0:2:0.5 and batch:1:1, queue depth 64).  Checks
           every uid once with the reference's stream, decode_attention ==
           layers x the model decode steps of every engine run (warmup
           included), masked_compact == 2 x the hops that shipped a KV
           tail, each solve_star result on the simplex (at least one),
           prefix hits > 0, none refused; reports each wave's split,
           counts and group walls, tokens/s, host syncs, solve_star's host
           ms, hop bytes, each tenant's TTFT and ITL p50/p99
  fleet_kernels  decode_attention at every (slots, cache rows) the fleet
           engines decoded at, with llama's heads, and masked_compact at
           every KV-tail shape [16, Rt, 512] the fleet hops shipped, against
           their plain versions
  dense_slices  the launcher on olmo-1b (16 layers, d 2048, 16/16 heads of
           128) and nemotron-4-15b (32 layers, d 6144, 48/8 heads of 128,
           squared-ReLU MLP, 31 GB) at full width and depth, 16 x 128
           tokens, 32 new, --split auto, one after the other; launches held
           as in the slice; then, no model held, decode_attention at each
           group's batch with their heads and masked_compact at their §VI
           payloads ([B,128,2048] and [B,128,6144]) against the plain
           versions

Then llama3.2-1b's params are freed and the MoE path runs:

  moe slice    the launcher in-process: moonshot-v1-16b-a3b at full width
           (48 layers, d 2048, 64 experts top-6 + 2 shared, vocab 163840,
           bf16, random weights from seed 0, 57.8 GB), the same 16 requests
           x 128 prompt tokens, 32 new tokens, --split auto; checks
           grouped_ffn launches == layers x (decode steps + prefills) and
           decode_attention launches == layers x decode steps; reports peak
           device memory
  moe kernels  grouped_ffn against its plain version at every (E, C, D, F)
           the slice ran (prefill and decode capacity of the probe and of
           each group), at ragged shapes (C 1 and 13, F 13 and 88, D 70,
           72 and 80) and with counts (0, C, ragged; rows past a count are
           exactly zero though buf's rows there are not), zero rows and
           empty experts exactly zero, every call twice, bit-equal, bf16
           within 5e-2 and f32 within 2e-4; decode_attention at moonshot's
           shape (G=1, dh=128)
  moe parity   a 2-layer float32 cut of the slice's weights at full width:
           kernel vs plain path logits over 8 teacher-forced decode steps
           within 1e-3 (a larger gap is excused only where a routing choice
           flipped at a top-k margin below 1e-6), the smallest router
           margin; macro_steps=8 and 0 streams identical (bf16, full depth)
  moe trace    one group's generate() of 8 new tokens under torch.profiler
  moe continuous  ContinuousServingEngine on moonshot's loaded params
           (slots 4, 6 requests x 128 tokens, max_new <= 8) per-step,
           boundary and overlapped: streams identical, grouped_ffn ==
           layers x (model decode steps + 6 B=1 prefills)
  moe timing   grouped_ffn at decode (C=8) and at the auxiliary group's
           prefill capacity, each of the slice's 48 layers with a buffer and
           counts made by routing random tokens through its router; beside
           it the plain version and the bf16 composition of three torch.bmm
           calls and silu*mul (composition_ms; no single PyTorch call
           computes this function, so library_ms is null), and the bound
           over every expert and over the routed experts and rows;
           decode_attention at moonshot's shape
  long cache   with no weights held: decode_attention, its plain version and
           SDPA at llama's heads over a full 32768-row cache and moonshot's
           over 8192 rows, as a share of the bytes bound

Then moonshot's params are freed and the SSM path runs:

  ssm_slice    the launcher in-process: falcon-mamba-7b at full width and
           depth (64 Mamba-1 layers, d 4096, d_inner 8192, N 16, vocab
           65024, bf16, random weights from seed 0, 14.0 GB), the same 16
           requests x 128 prompt tokens, 32 new tokens, --split auto;
           checks ssm_scan launches == layers x prefills x ceil(S/256),
           decode_attention launches == 0 and masked_compact launches > 0;
           reports r*, t_parallel / t_serial, tokens/s, peak memory
  ssm_kernels  ssm_scan against its plain version at every (B, S, di, N)
           the slice ran, at ragged shapes (S 1 and 300, di 100 and 101,
           N 3) and the pure-decay case, h0 non-zero, f32 within 1e-5 of
           max|h| (both run the recurrence in one order)
  ssm_parity   a 2-layer float32 cut of the slice's weights at full width:
           kernel vs plain path prefill logits and states and 8
           teacher-forced decode steps' logits within 1e-3; macro_steps=8
           and 0 streams identical (bf16, full depth)
  ssm_trace    one group's generate() under torch.profiler
  ssm_continuous  the same short continuous run on falcon-mamba's params:
           ssm_scan == layers x 6 B=1 prefills
  ssm_timing   ssm_scan and its plain version at the auxiliary group's
           prefill shape ([11,128,8192,16] f32), beside the bytes bound;
           no single PyTorch call computes the recurrence (library_ms null)
  hybrid   zamba2-2.7b at full width (54 Mamba-2 layers, d 2560, the
           shared attention block every 6 layers, H=Hkv=32, dh 80, bf16,
           4.85 GB), 4 requests x 128 prompt tokens, 16 new tokens, --split
           none; checks decode_attention launches == 9 x decode steps;
           decode_attention against its plain version at dh=80 (bf16 within
           3e-2, f32 within 1e-4); macro_steps=8 and 0 streams identical

Then the vlm and audio families and the int8 KV cache, each model's params
freed before the next loads:

  vlm_slice / audio_slice / int8_slice  the launcher's static path as in the
           slice (16 x 128 tokens, 32 new, K=8, --split auto, full width and
           depth, bf16) on internvl2-1b (24 layers, d 896, 14/2 heads, 256
           patch rows from request_stream's stubbed frontend ahead of each
           prompt: 424 cache rows), seamless-m4t-medium (12 encoder layers
           over 1024 stubbed frame rows, 12 decoder layers with self- and
           cross-attention, 16/16 heads, vocab 256206, untied head, 1.76
           GB) and llama3.2-1b with --kv-int8 (int8 K/V with f32 scales,
           dequantized to f32 for decode_attention); checks decode_attention
           == attention layers x decode steps (the audio decoder's cross
           calls counted: 2 x 12 a step), masked_compact == the spokes with
           requests, every decode_attention launch recorded by shape: f32
           on the int8 path, the cross calls over 1024 rows with a
           Python-int length
  vlm_continuous  internvl2-1b through ContinuousServingEngine (slots 4,
           256 + 128 + 16 + 8 = 408 cache rows) over 12 requests in 4
           image groups with shared 64-token prefixes (88 tokens): per-step,
           per-step with a PrefixCache (block 8, budget 256), overlapped
           (K=8) with a PrefixCache and a PrefillWorker (lossless KV hop);
           the three modes' streams identical, decode_attention == layers x
           model decode steps, masked_compact == 2 x the hops that shipped
           a KV tail, 8 prefix hits in the local mode (the prologue root
           included)
  families_kernels  with no model held: decode_attention against its plain
           version at every decode shape those paths launched (the vlm's
           G=7, the audio's self G=1 and its cross over 1024 rows with a
           Python-int length, the int8 route's f32), bf16 within 3e-2 and
           f32 within 1e-4; masked_compact bit for bit at each spoke's §VI
           payload ([n,128,896], [n,128,1024], [n,128,2048]) and every KV
           tail the vlm's hops shipped; the f32 route and the cross shape
           timed beside their bound and SDPA

Then the training path, no model held before each loads:

  train_slice  llama3.2-1b at full width and depth (16 layers, d 2048, vocab
           128256, bf16, random weights from seed 0) through make_train_step
           at the train launcher's defaults: batch 8, seq 64,
           synthetic_lm_batches seed 0, lr 1e-3, warmup 2, 20 steps; checks
           every leaf's gradient finite and non-zero, a microbatches=2 step
           and a remat step at the full-batch loss within 1e-2 relative, the
           loss finite at every step and the last below the first, no kernel
           launched, save_checkpoint + restore_checkpoint of the bf16 params
           and the AdamW state bit-equal; reports ms a step (CUDA events),
           tokens/s, peak memory, the first and last loss; then ``python -m
           repro_torch.launch.train --steps 3`` must exit 0
  train_moe    moonshot-v1-16b-a3b at full width, depth cut to 2 layers
           (~1.85 B params), 5 steps at batch 4, seq 64: grouped_ffn ==
           layers x steps, == 2 x layers x steps in 2 remat steps, every
           leaf's gradient non-zero (the experts' w_gate, w_up, w_down
           reported); each train phase also times forward + backward alone
  train_ssm    falcon-mamba-7b at full width, depth cut to 4 layers (~0.69 B
           params), 5 steps at batch 2, seq 256: ssm_scan == ssm_scan_bwd ==
           layers x chunks x steps, every leaf's gradient non-zero
  train_kernels  the differentiable ops' outputs and gradients against
           torch.autograd through the plain versions: grouped_ffn at the
           train buffer (bf16, counts full / ragged / zero, within 3e-2 of
           max|g|), ssm_scan + ssm_scan_bwd at [2,256,8192,16] and ragged
           shapes (S 1, odd di x N, G or g absent; f32 within 1e-5 of
           max|g|); every kernel call twice, bit-equal; ssm_scan_bwd's device
           ms beside its bytes bound and the plain reverse loop's time

Then the mesh paths: ranks spawned on the one card (``torch.multiprocessing``,
spawn), one process each, over gloo (NCCL takes one rank per card); the
kernels built above, the ranks only load them; this process holds no model:

  mesh_dense   llama3.2-1b at full width and depth (bf16, seed 0) on a
           (data=1, model=2) mesh: heads, MLP width and vocab split over
           the two ranks.  The continuous phase's 24 requests per-step and
           with macro_steps=8 (slots 8, max_len 512).  Checks on each rank
           decode_attention == layers x model decode steps and both ranks'
           streams identical; the prefill logits of 4 prompts within 5e-2
           of max|logit| of the one-rank model (bf16: each layer's partial
           sums round apart on two ranks); reports the greedy streams that
           agree with the one-rank continuous run, ms a model decode step
           and tokens/s beside the one-rank run's, the all_reduce count a
           step and the host wall inside the collectives
  mesh_seq     the same model, its depth cut to 8 layers (the script's time
           limit), on (data=2, model=2), four ranks, 3 slots:
           the batch does not divide "data", so it spills onto the sequence
           (``seq_shard_layout``): the sequence-sharded cache_update and
           splice_blocks, decode_attention with lse on each rank's rows,
           merged across "data".  12 of the requests, local and
           disaggregated (a mesh-wide PrefillWorker with a PrefixCache:
           each rank compacts its own rows of a KV hop on masked_compact).
           Checks the launches (masked_compact == 2 x the KV tails each
           rank compacted, none on the local arm), both arms' streams
           identical on every rank, decode_s == t_dispatch_s + t_await_s
           exactly, the boundary wall in t_splice_s (disaggregated) or
           t_slot_write_s (local)
  mesh_profile ``profile_engine_programs`` on mesh_seq's engine: the four
           programs, zero collective bytes on splice and slot_write
  mesh_moe     moonshot-v1-16b-a3b at full width, 4 of its 48 layers (the
           depth cut), expert-parallel on (data=1, model=2): 32 experts a
           rank, the shared experts split on their width; 6 requests,
           slots 4, K=8.  Checks grouped_ffn launched with counts on both
           ranks, layers x (model decode steps + prefills); reports the
           streams that agree with the one-rank run.  Its float32 2-layer
           copy: prefill and 4 teacher-forced decode steps' logits within
           1e-3 of the one-rank model's (moe_parity's rule)
  mesh_ssm     falcon-mamba-7b at full width and depth (64 layers, d_inner
           8192: 4096 channels a rank) on (data=1, model=2): each Mamba
           layer's conv, scan and gate on the rank's channels, x_proj and
           out_proj on its d_inner rows (one all_reduce each); the
           ssm_continuous traffic (6 requests of 128 tokens, slots 4,
           K=8).  Checks ssm_scan == layers x prefills on both ranks, every
           launch on [1, 128, 4096, 16], both ranks' streams identical, one
           decode step's all_reduces == 130; reports the streams that agree
           with the one-rank ssm_continuous run, ms a model decode step and
           tokens/s beside its, the host wall inside the collectives
  mesh_hybrid  zamba2-2.7b at full width on (1, 2), its depth cut to 18
           of 54 layers (MESH_LAYERS, the script's time limit): Mamba-2 on
           40 heads a rank (dt and B/C of its d_inner rows in one
           all_reduce), the shared block's 16 heads and their KV cache; the
           hybrid slice's 4 requests of 128 tokens, 16 new, slots 4.
           decode_attention == 3 x model decode steps, 44 all_reduces a
           step
  mesh_vlm     internvl2-1b at full width, 12 of its 24 layers (MESH_LAYERS),
           on (data=2, model=2) with 3 slots: the batch spills onto the
           sequence, so the 256
           prologue rows sit in the sequence-sharded cache; vlm_continuous'
           12 requests per-step with a PrefixCache (block 8: the prologue
           root) and overlapped with a PrefillWorker and a PrefixCache (each
           rank compacts its own KV tail rows).  Checks both arms' streams
           identical, 8 prefix hits each, KV tails on the disaggregated arm
           only, masked_compact == 2 x the tails, 50 all_reduces a step
           (its vocab of 151655 rows, which "model" does not divide, on
           448 of the 896 D columns: the embedding's gather and the
           logits' sum)
  mesh_audio   seamless-m4t-medium at full width and depth on (1, 2): the
           encoder's and the decoder's heads split (8 a rank), the cross
           cache of 1024 rows on the rank's heads; 6 requests of 128
           tokens with their frame embeddings, slots 4.  decode_attention
           == 24 x model decode steps (self and cross), 38 all_reduces a
           step.  Each family phase also serves its reduced() float32 copy
           on the same mesh: greedy streams within the parity rule of the
           one-rank plain path
  mesh_dcut    JAX's param_spec fallback, Case D: internvl2-1b at full
           width and depth on (data=1, model=4), whose 14 / 2 heads the
           axis divides neither, so wq/wk/wv take 224 of their 896 D rows
           (q, k and v partial sums, one all_reduce), wo 224 of its D
           columns (gathered along D), the tied table and frontend_proj
           224 D columns; the cache sequence-sharded over "model"; the
           vlm's 12 requests overlapped (K=8) with a PrefillWorker and a
           PrefixCache, mesh_vlm's second arm (each rank compacts its KV
           tail rows), 4 slots.  Checks every leaf's bytes against
           param_spec, the launches, every rank's streams identical, 8
           prefix hits, 122 all_reduces a step; the reduced() f32 copy
           with 6 / 2 heads of 32 and a 509-row vocab (Case D too)
  mesh_gqa16   JAX's param_spec fallback, Case Q: llama3.2-1b at full width
           on (data=1, model=16), its depth cut to one layer (MESH_LAYERS)
           (16 ranks on the card over gloo, 60-90 ms a call), the weights
           built once on the host and each rank loading its shard from
           the file: 2 query heads a rank,
           wk/wv on 128 of their 2048 D rows, the MLP on 512 of 8192, 8016
           vocab rows; a decode gathers the 32 query heads in the
           all_reduce that sums k and v, attends over the rank's 32 of 512
           cache rows with lse, keeps its 2 heads.  The first 8 of
           mesh_dense's requests, at most 16 new tokens each (16 decode
           steps), 4 slots, K=8, beside the one-rank run on the same
           weights.  Checks the held shapes, every leaf against
           param_spec, the launches, the ranks' streams, the all_reduces a
           step (5 a layer + 2: 7), and a reduced() f32 copy with 32 / 8
           heads of 16 (Case Q), one layer, over the short traffic of
           mesh_ssm within the parity rule
  mesh_nccl    the mesh_dense path at world size 1 over NCCL: streams
           identical to the one-rank continuous run; NCCL's own all_reduce
           and broadcast right
  mesh_kernels with no model held: decode_attention with lse (and a
           per-slot start) against its plain version at every shard shape
           the mesh phases launched, each slot one of: the whole shard,
           wholly past cache_len (length at s0), wholly before the window,
           a window starting inside it, a length inside it, a length at s0
           + S_loc; bf16 within 3e-2, f32 within 1e-4, lse within 1e-4 and
           -inf exactly at the empty windows (output 0 there); every call
           twice, bit-equal, and bit-equal to the call without lse;
           grouped_ffn at every local-expert shape with counts;
           masked_compact bit for bit (both branches) at every KV tail a
           rank compacted; ssm_scan bit for bit at every shape a rank
           launched (the fallback cuts' shapes among them: mesh_gqa16's 32
           query heads over a rank's 32 rows, mesh_dcut's 14 over 102);
           the lse call's device ms at mesh_seq's and mesh_gqa16's shard
           shapes beside its bound and the call without lse, and
           ssm_scan's at falcon-mamba's rank shape beside its bound

The float32 2-layer copy of llama's weights runs through mesh_dense and
mesh_seq: its greedy streams agree with the one-rank plain path up to the
first top-2 gap < 1e-3 (the parity phase's rule).

Then training across ranks, four ranks on (data=2, model=2) over gloo
(before mesh_kernels, which also covers their launch shapes): the params
and AdamW state cut by shard_params(fsdp=True) (FSDP over "data", the
serving cuts over "model"), each rank's batch rows, 3 steps of
make_train_step(layout=); every step's collective calls and bytes by kind
on every rank equal to _train_collectives' formula, the ranks' losses
identical, every leaf's whole gradient finite and non-zero; ms a step
(CUDA events), forward + backward ms, tokens/s, peak memory a rank, the
host seconds inside collectives against the wall:

  mesh_train   llama3.2-1b at full width and depth, batch 8 x 64 (4 rows a
           rank), train_slice's first batches and schedule: losses within
           1e-2 relative of train_slice's, no kernel launched; a float32
           2-layer cut of the same weights, the one-rank plain step
           (rank 0) against the mesh step, losses within 1e-4
  mesh_train_moe  moonshot-v1-16b-a3b at full width, 2 layers, batch 4 x
           64: each rank's 32 experts on grouped_ffn with counts ==
           layers x steps, then 2 remat steps at 2 x layers x steps (the
           experts' gradients reported)
  mesh_train_ssm  falcon-mamba-7b at full width, 4 layers, batch 2 x 256:
           ssm_scan == ssm_scan_bwd == layers x chunks x steps, every
           launch at [1, 256, 4096, 16]
  mesh_train_launcher  ``torch.distributed.run --nproc-per-node 4 -m
           repro_torch.launch.train --mesh 2x2 --dist-backend gloo --steps
           1`` exits 0 and prints mesh=

mesh_kernels then also holds ssm_scan_bwd bit for bit against
ssm_scan_bwd_ref at the rank shape, and times ssm_scan, ssm_scan_bwd and
grouped_ffn at every rank shape beside their bounds.

Then the per-kernel summary line (the mesh paths in ``launches_by_path``),
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Every phase also prints its seconds.
Float32 matmuls run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

L2_BYTES = 50e6                  # H100 L2 cache

H100_PEAK_FLOPS_F32 = 67e12      # f32 outside the tensor cores (data sheet)

ARCH = "llama3.2-1b"
DENSE_ARCHS = ("olmo-1b", "nemotron-4-15b")
MOE_ARCH = "moonshot-v1-16b-a3b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "zamba2-2.7b"
VLM_ARCH, AUDIO_ARCH = "internvl2-1b", "seamless-m4t-medium"
REQUESTS, PROMPT_LEN, MAX_NEW, MACRO = 16, 128, 32, 8
HYBRID_REQUESTS, HYBRID_MAX_NEW = 4, 16
# the traced generate()'s new tokens: llama's and falcon-mamba's, moonshot's
# (the traces' per-step shares need two macro-steps; their event walks cost
# seconds a step)
TRACE_NEW, MOE_TRACE_NEW = 16, 8
S_MAIN = PROMPT_LEN + MAX_NEW + 8   # the engines' cache length
S_SPLIT = 2000                      # a cache that decode_attention splits
KV_HOP = (16, 2048, 512)            # llama3.2-1b's K (or V) tail of one
                                    # prefill->decode hop: [layers, Rt, Hkv*dh]
# the continuous path: llama3.2-1b's traffic (slots, cache rows, requests,
# the shared prefix, the padded prompt, the shortest prompt, the most new
# tokens) and the short MoE / SSM runs (slots, requests, most new tokens)
CONT_SLOTS, CONT_MAX_LEN, CONT_REQUESTS = 8, 512, 24
CONT_PREFIX, CONT_P, CONT_MIN_PROMPT, CONT_MAX_NEW = 64, 256, 72, 48
SIDE_SLOTS, SIDE_REQUESTS, SIDE_MAX_NEW = 4, 6, 8
SIDE_MAX_NEWS = [SIDE_MAX_NEW, 3, 1, 6, SIDE_MAX_NEW, 5]
# the fleet paths (HeteroRuntime): slots per group, requests, most new tokens
FLEET_SLOTS, FLEET_REQUESTS, FLEET_MAX_NEW = 4, 64, 32
FLEET_MAX_LEN = CONT_P + FLEET_MAX_NEW + 8     # the launcher's cache rows
FLEET_TENANTS = "interactive:0:2:0.5,batch:1:1"
# the vlm's short continuous run: requests, most new tokens, padded prompt
VLM_CONT_REQUESTS, VLM_CONT_MAX_NEW, VLM_CONT_P = 12, 16, 128
FFN_TOL = {"bfloat16": 5e-2, "float32": 2e-4}   # tests/test_kernels.py:129
SCAN_TOL = 1e-5     # relative to max|h|: both versions sum in one order
# the training path: llama3.2-1b at the train launcher's defaults (steps,
# batch, seq, lr); moonshot's and falcon-mamba's cuts (layers, steps, batch,
# seq); losses of a microbatched and a remat step against the full-batch
# loss (bf16, relative); gradients against the plain versions' (of max|g|)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 64, 1e-3
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 5, 4, 64
MOE_REMAT_STEPS = 2
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 5, 2, 256
TRAIN_TOL = 1e-2
DRYRUN_JOBS = 4          # the dry run's processes, beside the card's phases
DRYRUN_TIMEOUT_S = 1000  # from its start, before the first phase
ROOFLINE_REPS = {"decode": 20, "train": 5}
# PERF.md §6's bound column (ms, chip run 2, PR 20): costs.py must give it
SECTION6_BOUNDS = {"decode_attention": 0.00100, "masked_compact": 0.00298,
                   "grouped_ffn": 0.218, "ssm_scan": 0.665,
                   "ssm_scan_bwd": 0.401}
# The timing phases' groups: the slice's requests at the split its solver
# gave when PERF.md §6's rows were timed (11 to the auxiliary group), fixed
# there, so the rows keep §6's shapes whatever split the solver now reads
# from its timed probe.
TIMED_GROUPS = {"primary": REQUESTS - 11, "auxiliary": 11}
BOUND_RTOL = 5e-3        # three figures
GRAD_TOL = {"bfloat16": 3e-2, "float32": 1e-5}

# nvidia-smi's name + power limit, stamped on every line after env so each
# number stands beside the card it came from
_CARD = {}


def emit(obj) -> None:
    print(json.dumps({**obj, **_CARD}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
def phase_env(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _CARD["card"] = card
    emit({"phase": "env", "device": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "tf32": False})
    return name, card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    info = dict(_build.build_info)
    ptxas = [ln.strip() for ln in str(info.pop("ptxas", "")).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info.get("seconds"), "cached": info.get("cached"),
          "library": str(Path(path).relative_to(ROOT)), "ptxas": ptxas})


# ---------------------------------------------------------------------------
def _decode_case(torch, gen, B, S, H, Hkv, dh, dtype, cache_len, dev):
    q = torch.randn((B, 1, H, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, dh), generator=gen, device=dev).to(dtype)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
    return q, k, v, cl


def _batch_sizes(slice_summary):
    """The batch sizes the slice's engines ran: the probe's and each group's."""
    from repro_torch.launch.serve import PROBE_REQUESTS
    return sorted({PROBE_REQUESTS, *(n for n in slice_summary["n_group"] if n)})


def _split_boundary_lens(S, rows, B):
    """Cache lengths one row either side of each split boundary (and S), B
    of them: the ragged ends of the split-K grid."""
    lens = sorted({min(max(r + d, 1), S) for r in range(rows, S + rows, rows)
                   for d in (-1, 0, 1)})
    return (lens * B)[:B] if len(lens) < B else lens[:B - 1] + [S]


def _check_decode_attention(torch, dev, gen, main_bs, H, Hkv, dh, phase,
                            S_main=S_MAIN, edge_cases=True, main_dtype=None,
                            int_len=False):
    """decode_attention against its plain version at [B,1,H,dh] for every
    batch size the path ran, over a cache of ``S_main`` rows (per-slot
    lengths that include 1 and S; with ``int_len`` every row, the length
    handed to the kernel as a Python int, as the audio decoder's
    cross-attention hands it); with ``edge_cases`` also a scalar length,
    cache_len 0 (exactly 0 out), lengths either side of the split
    boundaries, a window smaller than one split, ragged long caches with
    and without a window, and an empty window; every case twice, bit-equal.
    Returns the largest main-path error in ``main_dtype`` (default bf16:
    f32 for the int8 cache's route)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      num_splits)

    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    main_dtype = main_dtype or torch.bfloat16
    results, main_err = [], 0.0
    cases = []
    for B in main_bs:
        lens = torch.randint(1, S_main + 1, (B,), generator=gen, device=dev)
        lens[0], lens[-1] = 1, S_main
        cases.append((B, S_main, 0, S_main if int_len else lens, True))
    Bm = max(main_bs)
    if edge_cases:
        cases += _decode_edge_cases(Bm, H, Hkv)
    for B, S, win, lens, main in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, cl = _decode_case(torch, gen, B, S, H, Hkv, dh, dtype,
                                       lens, dev)
            arg = lens if int_len and main else cl
            got = decode_attention_cuda(q, k, v, arg, window=win)
            again = decode_attention_cuda(q, k, v, arg, window=win)
            want = ref.decode_attention_ref(q, k, v, cl, window=win)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tag = (f"decode_attention B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
                   f"window={win} {dtype}")
            require(got.dtype == dtype and bool(torch.isfinite(got).all()),
                    f"{tag}: bad output")
            require(err <= tol[dtype], f"{tag}: max_abs_err {err} > {tol[dtype]}")
            require(torch.equal(got, again), f"{tag}: two calls differ")
            empty = cl.reshape(-1).expand(B) <= 0
            require(not bool(got[empty].any()), f"{tag}: cache_len 0 gave non-zero")
            if main and dtype == main_dtype:
                main_err = max(main_err, err)
            results.append({"B": B, "S": S, "window": win, "H": H, "Hkv": Hkv,
                            "dh": dh, "splits": num_splits(B, Hkv, S, H // Hkv),
                            "dtype": str(dtype)[6:], "int_len": isinstance(arg, int),
                            "max_abs_err": err, "bit_equal_twice": True})
    emit({"phase": phase, "kernel": "decode_attention",
          "tolerance": {"bfloat16": 3e-2, "float32": 1e-4}, "cases": results})
    return main_err


def _decode_edge_cases(Bm, H, Hkv):
    """(B, S, window, lengths, main) of the edge cases: a scalar length,
    cache_len 0, lengths either side of the split boundaries, a window
    smaller than one split, ragged long caches and an empty window."""
    from repro_torch.kernels.decode_attention import num_splits
    cases = [(Bm, S_MAIN, 0, PROMPT_LEN + 1, True),                 # scalar len
             (Bm, S_MAIN, 0, [0] * Bm, False)]                      # cache_len 0
    _, rows = num_splits(4, Hkv, S_SPLIT, H // Hkv)                 # several splits
    cases.append((4, S_SPLIT, 0, _split_boundary_lens(S_SPLIT, rows, 4), False))
    cases.append((8, S_SPLIT, 0, _split_boundary_lens(S_SPLIT, rows, 8), False))
    cases.append((8, S_SPLIT, max(1, rows // 2 - 1),                # window < split
                  _split_boundary_lens(S_SPLIT, rows, 8), False))
    _, rows_long = num_splits(4, Hkv, 4100, H // Hkv)
    cases.append((4, 4100, 0, [1, 777, 4099, 4100], False))       # ragged long
    cases.append((4, 4100, 128, [1, 777, 4099, 4100], False))
    cases.append((4, 4100, 0, [rows_long - 1, rows_long + 1, 3 * rows_long, 4100],
                  False))
    cases.append((3, 300, 16, [0, 5, 300], False))                # empty window
    return cases


def _sweep_decode_attention(torch, dev, gen):
    """decode_attention against its plain version at every head width the
    port's configs use (dh 64, 80, 128) and G 1, 4, 6 (nemotron), 7
    (internvl2), 8 and 16 (two head groups of MAX_G), with and without a
    window, bf16 and f32, twice each, bit-equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    worst = {}
    for dh in (64, 80, 128):
        for G in (1, 4, 6, 7, 8, 16):
            for win in (0, 40):
                for dtype in (torch.bfloat16, torch.float32):
                    q, k, v, cl = _decode_case(torch, gen, 3, 300, 4 * G, 4, dh,
                                               dtype, [0, 150, 300], dev)
                    got = decode_attention_cuda(q, k, v, cl, window=win)
                    again = decode_attention_cuda(q, k, v, cl, window=win)
                    want = ref.decode_attention_ref(q, k, v, cl, window=win)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    tag = f"decode_attention sweep dh={dh} G={G} window={win} {dtype}"
                    require(err <= tol[dtype], f"{tag}: max_abs_err {err}")
                    require(torch.equal(got, again), f"{tag}: two calls differ")
                    require(not bool(got[0].any()), f"{tag}: cache_len 0 gave non-zero")
                    key = f"dh{dh}_G{G}_{str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "kernels", "kernel": "decode_attention", "sweep": "dh x G",
          "B": 3, "S": 300, "Hkv": 4, "G": [1, 4, 6, 7, 8, 16],
          "lens": [0, 150, 300], "windows": [0, 40], "max_abs_err": worst})


def _mc_cases(B_main, tile):
    """masked_compact's checked cases: (name, B, S, D, K, mask kind, kept or
    None): the §VI payload of every slice (llama and moonshot d 2048,
    falcon-mamba d 4096), S one tile -1, one tile and one tile +1 of the
    plan's tile at the payload, K > S, K = 0, B = S = 1, capacity == kept,
    zero kept, overflow past K, an odd row width, long rows (S 32768; S
    131072, where the plan takes the count pass) and both KV-hop shapes."""
    return [("main-path", B_main, PROMPT_LEN, 2048, PROMPT_LEN, "keep72", None),
            ("payload-d4096", B_main, PROMPT_LEN, 4096, PROMPT_LEN, "keep72", None),
            ("tile-1", 3, tile - 1, 2048, tile - 1, "keep72", None),
            ("tile", 3, tile, 2048, tile, "keep72", None),
            ("tile+1", 3, tile + 1, 2048, tile + 1, "keep72", None),
            ("K>S", 3, 100, 64, 300, "keep72", None),
            ("K=0", 3, PROMPT_LEN, 2048, 0, "keep72", None),
            ("B=S=1", 1, 1, 2048, 1, "all", None),
            ("capacity-equals-kept", 5, PROMPT_LEN, 2048, 92, None, 92),
            ("zero-kept", 5, PROMPT_LEN, 2048, PROMPT_LEN, None, 0),
            ("overflow", 5, PROMPT_LEN, 2048, 32, None, 92),
            ("long-odd-width", 3, 1000, 5, 300, "keep72", None),
            ("long-row", 2, 32768, 64, 20000, "keep72", None),
            ("longest-row", 1, 131072, 64, 60000, "keep72", None),
            ("kv-hop-lossless", *KV_HOP, KV_HOP[1], "all", None),
            ("kv-hop-lossy", *KV_HOP, None, "make_mask", None)]


def _check_masked_compact(torch, dev, gen, B_main):
    """masked_compact against its plain version at every case of
    ``_mc_cases`` and on views at storage offset 1 (tokens and mask not
    16-byte aligned: the uint16, uint32 and uint8 copy paths), bf16 and f32;
    each with the plan's branch twice (bit-equal) and the other base-finding
    branch once, all bit for bit.  Returns the main path's largest error."""
    from repro_torch.kernels import masked_compact as mc
    from repro_torch.kernels import ref

    tile = mc.masked_compact_plan(B_main, PROMPT_LEN, 2048 * 2, PROMPT_LEN).tile
    cases = [(*c, dtype, 0) for c in _mc_cases(B_main, tile)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("offset-1", 3, 130, 2048, PROMPT_LEN, "keep72", None, dtype, 1)
              for dtype in (torch.bfloat16, torch.float32, torch.uint8)]
    results, main_err = [], 0.0
    for name, B, S, D, K, kind, kept, dtype, offset in cases:
        toks, mask, k = _mc_case(torch, gen, dev, B, S, D, kind or "all", dtype)
        K = k if K is None else K
        if kind is None:           # exactly ``kept`` rows of each batch row
            order = torch.rand((B, S), generator=gen, device=dev).argsort(dim=1)
            mask = order < kept
        if offset:                 # the same values at storage offset 1
            toks = torch.cat([toks.new_zeros(1), toks.flatten()])[1:].view(B, S, D)
            mask = torch.cat([mask.new_zeros(1), mask.flatten()])[1:].view(B, S)
        esize = toks.element_size()
        plan = mc.masked_compact_plan(B, S, D * esize, K)
        other = mc.masked_compact_plan(B, S, D * esize, K, long_rows=not plan.long_rows)
        got = mc.masked_compact_cuda(toks, mask, K)
        again = mc.masked_compact_cuda(toks, mask, K)
        branch = mc.masked_compact_cuda(toks, mask, K, plan=other)
        want = ref.masked_compact_ref(toks, mask, K)
        torch.cuda.synchronize()
        tag = f"masked_compact {name} B={B} S={S} D={D} K={K} {dtype}"
        err = float((got[0].float() - want[0].float()).abs().max()) if got[0].numel() else 0.0
        for what, res in (("plan", got), ("second call", again), ("other branch", branch)):
            require(all(torch.equal(a, b) for a, b in zip(res, want)),
                    f"{tag}: {what} differs from the plain version "
                    f"(out max_abs_err {err})")
        if name == "main-path":
            main_err = max(main_err, err)
        results.append({"case": name, "B": B, "S": S, "D": D, "K": K,
                        "dtype": str(dtype)[6:], "offset": offset,
                        "kept": int(mask.sum()), "plan": dataclasses.asdict(plan),
                        "exact": True, "bit_equal_twice": True,
                        "other_branch_exact": True, "max_abs_err": err})
        del toks, mask, got, again, branch, want
    emit({"phase": "kernels", "kernel": "masked_compact", "tolerance": "exact",
          "cases": results})
    return main_err


def phase_kernel_checks(torch, dev, slice_summary):
    """Each kernel against its plain version at the shapes the slice gave
    it (the probe's and each group's batch) and at edge cases; returns the
    largest main-path error of each kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    main_err = _check_decode_attention(torch, dev, gen, _batch_sizes(slice_summary),
                                       32, 8, 64, "kernels")
    _sweep_decode_attention(torch, dev, gen)

    mc_err = _check_masked_compact(torch, dev, gen, groups["auxiliary"])
    return {"decode_attention": main_err, "masked_compact": mc_err}


# ---------------------------------------------------------------------------
def _expected_launches(cfg, s, prompt_len):
    """Kernel launches the slice summary ``s`` implies for ``cfg``: decode
    attention in every attention layer of every decode step (the hybrid's
    shared block once per block of Mamba layers, the audio decoder's self-
    and cross-attention both), grouped_ffn in every MoE layer of every
    prefill and decode step, ssm_scan in every Mamba-1 layer of every
    prefill, once per 256-token chunk; an MLAConfig's latent attention in
    every layer of every decode step."""
    from repro_torch.configs.base import is_mla
    from repro_torch.models.moe import DROPLESS_TOKENS, SORTED_ROWS_PER_EXPERT

    L, steps, prefills = cfg.num_layers, s["decode_steps"], s["prefills"]
    attn_layers = {"ssm": 0, "hybrid": L // max(cfg.hybrid_attn_every, 1),
                   "audio": 2 * L}
    scan = cfg.family == "ssm" and cfg.mamba_version == 1
    mla = is_mla(cfg)
    # an MLAConfig: latent decode attention, no MoE in its first_k_dense
    # layers, the dropless MoE's B=1 prefill on the sorted route where its
    # rows an expert reach SORTED_ROWS_PER_EXPERT (bf16), else in chunks of
    # DROPLESS_TOKENS; its decode steps (a few rows an expert) never sorted
    sorted_prefill = mla and cfg.dtype == "bfloat16" and \
        prompt_len * cfg.experts_per_token \
        >= SORTED_ROWS_PER_EXPERT * cfg.num_experts
    chunks = 0 if sorted_prefill else -(-prompt_len // DROPLESS_TOKENS) \
        if mla else 1
    moe_layers = L - cfg.first_k_dense if mla else L
    return {"decode_attention": 0 if mla else attn_layers.get(cfg.family, L) * steps,
            "mla_decode_attention": L * steps if mla else 0,
            "grouped_ffn": moe_layers * (steps + prefills * chunks)
            if cfg.num_experts else 0,
            "grouped_ffn_sorted": moe_layers * prefills if sorted_prefill else 0,
            "ssm_scan": L * prefills * -(-prompt_len // 256) if scan else 0,
            "ssm_scan_bwd": 0}


def _prefill_attention_layers(cfg):
    """Whole-sequence attention calls of one prefill that take the
    prefill_attention kernel on the card (bf16, a head width it holds):
    every attention layer (the hybrid's shared block once per block of
    Mamba layers, the audio model's encoder layers and its decoder's self-
    and cross-attention), none on the SSM."""
    from repro_torch.kernels.prefill_attention import HEAD_DIMS
    if cfg.dtype != "bfloat16" or cfg.head_dim not in HEAD_DIMS:
        return 0
    L = cfg.num_layers
    return {"ssm": 0, "hybrid": L // max(cfg.hybrid_attn_every, 1),
            "audio": cfg.encoder_layers + 2 * L}.get(cfg.family, L)


def phase_slice(torch, arch=ARCH, *, phase="slice", split="auto",
                requests=REQUESTS, max_new=MAX_NEW, extra=()):
    """The port's launcher in-process on ``arch`` (``extra``: more
    arguments, e.g. a star topology); the launch counts are set to 0 just
    before and read just after, and held against what the run's layers,
    steps and prefills imply.  Returns (summary, counts)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config(arch)
    argv = ["--arch", arch, "--requests", str(requests), "--prompt-len",
            str(PROMPT_LEN), "--max-new", str(max_new), "--macro-steps",
            str(MACRO), "--split", split, "--device", "cuda", *extra]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    s = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = s["tokens"]
    require(toks.shape == (requests, max_new), f"tokens shape {toks.shape}")
    require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            "token ids out of range")
    want = _expected_launches(cfg, s, PROMPT_LEN)
    want["prefill_attention"] = _prefill_attention_layers(cfg) * s["prefills"]
    for kname, n in want.items():
        require(counts[kname] == n,
                f"{arch}: {kname} launched {counts[kname]} times, expected "
                f"{n} ({cfg.num_layers} layers, {s['decode_steps']} decode "
                f"steps, {s['prefills']} prefills)")
    comp = s.get("compression")
    if split != "none":
        require(counts["masked_compact"] > 0, "masked_compact never launched")
        require(comp["kept_tokens_compacted"] == comp["kept_tokens"],
                "masked_compact's count disagrees with the mask")
    groups = dict(zip(s["group_names"], s["n_group"])) if "n_group" in s else None
    emit({"phase": phase, "arch": arch, "argv": argv, "r_star": s.get("r_star"),
          "f_star": s.get("f_star"), "solve_star_ms": s.get("solve_star_ms"),
          "r": s["r"], "groups": groups, "t_group_s": s.get("t_group_s"),
          "t_parallel_s": s.get("t_parallel_s"),
          "t_serial_s": s.get("t_serial_s"), "t_offload_s": s.get("t_offload_s"),
          "probe_s": s.get("probe_s"), "tokens_per_s": s["tokens_per_s"],
          "serve_wall_s": s["wall_s"], "main_wall_s": wall,
          "decode_steps": s["decode_steps"], "prefills": s["prefills"],
          "ms_per_decode_step_by_engine": s["ms_per_decode_step"],
          "launches": counts, "expected_launches": want,
          "peak_memory_bytes": peak, "allocated_before_bytes": before,
          "payload_bytes_per_item": s.get("payload_bytes_per_item"),
          "compression": comp})
    return s, counts


# ---------------------------------------------------------------------------
def _macro_streams_equal(torch, dev, cfg, params, prompts, max_new):
    """macro_steps=8 and 0 give identical greedy streams (kernels on)."""
    from repro_torch.serving.engine import ServingEngine

    streams = {}
    for k in (MACRO, 0):
        eng = ServingEngine(cfg, params, max_len=PROMPT_LEN + max_new + 8,
                            macro_steps=k, device=dev)
        streams[k] = eng.generate(prompts, max_new).tokens
    same = bool((streams[MACRO] == streams[0]).all())
    require(same, f"{cfg.name}: macro_steps=8 and macro_steps=0 streams differ")
    return same


def phase_parity(torch, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (ServingEngine, make_prefill_step,
                                            make_serve_step, seed_cache)

    cfg = get_config(ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, 0, device=dev)           # the slice's weights
    params32 = tree_map(lambda t: t.float(), params)
    prompts = _prompts(cfg)
    B = 4
    tokens = torch.as_tensor(prompts[:B], device=dev)
    with torch.no_grad():
        last, pre = make_prefill_step(cfg32, use_kernels=False)(
            params32, {"tokens": tokens})
        caches = []
        for _ in range(2):
            c = M.init_cache(cfg32, B, S_MAIN, device=dev)
            caches.append(seed_cache(cfg32, c, pre, PROMPT_LEN))
        del pre
        plain = make_serve_step(cfg32, use_kernels=False)
        kern = make_serve_step(cfg32, use_kernels=True)
        tok = last.argmax(dim=-1).to(torch.int32)
        stream, gaps, tf_err = [tok], [_top2_gap(torch, last)], []
        for i in range(MAX_NEW - 1):
            lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lp, _ = plain(params32, caches[0], tok[:, None], lengths)
            if i < 8:
                lk, _ = kern(params32, caches[1], tok[:, None], lengths)
                tf_err.append(float((lk - lp).abs().max()))
            tok = lp.argmax(dim=-1).to(torch.int32)
            stream.append(tok)
            gaps.append(_top2_gap(torch, lp))
        plain_stream = torch.stack(stream, dim=1).cpu().numpy()
        gaps = torch.stack(gaps, dim=1).cpu().numpy()
        del caches
    require(max(tf_err) <= 1e-3, f"teacher-forced logits differ by "
            f"{max(tf_err)} > 1e-3 between kernel and plain paths")

    eng = ServingEngine(cfg32, params32, max_len=S_MAIN, macro_steps=MACRO,
                        use_kernels=True, device=dev)
    kern_stream = eng.generate(prompts[:B], MAX_NEW).tokens
    first_mismatch, first_low_gap = [], []
    for b in range(B):
        diff = np.nonzero(kern_stream[b] != plain_stream[b])[0]
        low = np.nonzero(gaps[b] < 1e-3)[0]
        m = int(diff[0]) if diff.size else None
        g = int(low[0]) if low.size else None
        first_mismatch.append(m)
        first_low_gap.append(g)
        require(m is None or (g is not None and m >= g),
                f"request {b}: kernel stream leaves the plain stream at "
                f"{m} before any top-2 gap < 1e-3 (first at {g})")
    del eng
    overlap = _check_offload_streams(torch, dev, cfg32, params32, prompts)
    del params32

    same = _macro_streams_equal(torch, dev, cfg, params, prompts, MAX_NEW)
    emit({"phase": "parity", "dtype": "float32", "requests": B,
          "teacher_forced_max_abs": tf_err, "tolerance": 1e-3,
          "first_mismatch": first_mismatch, "first_top2_gap_below_1e-3": first_low_gap,
          "min_top2_gap": float(gaps.min()),
          "macro_8_equals_0": same, "macro_check_dtype": "bfloat16",
          "offload_streams": overlap})
    return cfg, params, prompts


def _prompts(cfg):
    """The launcher's prompts: request_stream(seed=0), padded or cut to
    PROMPT_LEN tokens."""
    from repro_torch.data.pipeline import request_stream
    reqs = request_stream(cfg.vocab_size, n=REQUESTS, mean_prompt=PROMPT_LEN, seed=0)
    return np.stack([np.pad(r.prompt[:PROMPT_LEN],
                            (0, max(0, PROMPT_LEN - len(r.prompt))))
                     for r in reqs]).astype(np.int32)


def _check_offload_streams(torch, dev, cfg, params, prompts):
    """OffloadEngine's dispatch-all-then-await path (jit=True: one CUDA
    stream per group, completion polled with Event.query) merges to the
    one-group result; float32 prefill logits within 1e-4."""
    import repro_torch.core as C
    from repro_torch.models import model as M

    def task(b):
        with torch.no_grad():
            out = M.forward(params, cfg, {"tokens": b["tokens"]}, mode="prefill")
        return {"logits": out.logits[:, -1]}

    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    whole = task(batch)["logits"]
    eng = C.OffloadEngine(task, C.NodeGroup("primary", [dev], C.JETSON_NANO),
                          C.NodeGroup("auxiliary", [dev], C.JETSON_XAVIER),
                          C.WIFI_5GHZ, payload_bytes_per_item=1e4, jit=True)
    rep = eng.run(batch, 0.7)
    torch.cuda.synchronize()
    err = float((rep.outputs["logits"] - whole).abs().max())
    require(rep.outputs["logits"].shape == whole.shape and err <= 1e-4,
            f"OffloadEngine(jit=True) merge differs from one group by {err}")
    require(rep.t_parallel_s > 0.0 and min(rep.t_group_s) > 0.0,
            "OffloadEngine(jit=True) did not stamp every group's completion")
    return {"n_group": rep.n_group, "t_group_s": rep.t_group_s,
            "t_parallel_s": rep.t_parallel_s, "max_abs_err": err}


def phase_trace(torch, dev, cfg, params, prompts, B, max_new=TRACE_NEW):
    """Where one group's generate() spends its time: device busy share and
    the kernels that take it, from a torch.profiler trace of a warm run of
    ``max_new`` new tokens."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, max_len=S_MAIN, macro_steps=MACRO, device=dev)
    warm = eng.generate(prompts[:B], max_new)
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts[:B], max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.device_time_total, n + 1)
    busy_s = sum(us for us, _ in per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    launches = sum(n for _, n in per_kernel.values())
    emit({"phase": "trace", "arch": cfg.name, "B": B, "prompt_len": PROMPT_LEN,
          "max_new": max_new,
          "macro_steps": MACRO, "untraced_prefill_s": warm.prefill_s,
          "untraced_decode_s": warm.decode_s,
          "untraced_ms_per_decode_step": 1e3 * warm.t_per_macro_step_s / MACRO,
          "traced_wall_s": wall, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall if busy_s else None,
          "device_launches": launches, "decode_steps": steps,
          "device_launches_per_decode_step_prefill_included": launches / steps,
          "top_kernels": [{"name": name[:90], "device_ms": us / 1e3, "calls": n}
                          for name, (us, n) in top]})


def _top2_gap(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


# ---------------------------------------------------------------------------
def _time_ms(torch, fn, arg_sets, iters=200, warmup=10):
    """Mean ms per call: CUDA events around a loop that cycles through
    ``arg_sets`` (more bytes than L2 holds, so each call finds its inputs
    cold, as the serving path does)."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, arg_sets, iters=50, need_ahead=True):
    """Mean device ms per call: CUDA events around ``iters`` calls that the
    host enqueues while a device-side sleep holds the stream, so the events
    bracket the calls' device work back to back and not the host's launch
    cost.  The host was ahead when the start event had not fired by the
    time the last call was enqueued; otherwise the sleep grows and the loop
    runs again.  Every kernel's ``device_ms`` comes from here (the profiler
    lost the events of the ctypes-launched kernels after earlier traces).
    Returns None where the host never got ahead and ``need_ahead`` is
    false (a plain version whose launches fill the launch queue)."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    per_call_s = (time.perf_counter() - t0) / 3      # host enqueue cost, or more
    torch.cuda.synchronize()
    cycles = int(2e9 * (2.0 * iters * per_call_s + 1e-3))   # ~2e9 SM cycles a second
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    require(not need_ahead, "_device_ms: the host never got ahead of the device")
    return None


def _sets_for(bytes_per_set: float) -> int:
    return max(2, math.ceil(4 * L2_BYTES / max(bytes_per_set, 1.0)))


def _bound(n_bytes, n_ops, peak_flops=None):
    """(bound_ms, bound_by): the larger of bytes over the H100's memory rate
    and operations over ``peak_flops`` (default: the bf16 tensor-core
    peak)."""
    from repro_torch.core.profiler import H100_HBM_BW, H100_PEAK_FLOPS_BF16
    t_bytes = n_bytes / H100_HBM_BW
    t_ops = n_ops / (peak_flops or H100_PEAK_FLOPS_BF16)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_decode_attention(torch, dev, gen, gname, B, H, Hkv, dh, S=S_MAIN,
                           cache_len=None, dtype=None, int_len=False):
    """decode_attention, its plain version and SDPA at [B,1,H,dh] against a
    cache of S rows (bf16 unless ``dtype``; f32 is the int8 cache's
    dequantized route), by default the slice's, halfway through decode;
    ``int_len``: the kernel is handed cache_len as a Python int, as the
    audio decoder's cross-attention hands it."""
    import torch.nn.functional as F
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      num_splits)

    dtype = dtype or torch.bfloat16
    esize = torch.empty((), dtype=dtype).element_size()
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}[dtype]
    # cache_len halfway through the slice's decode unless given
    cl_mid = cache_len or PROMPT_LEN + MAX_NEW // 2 + 1
    per_set = 2 * B * S * Hkv * dh * esize
    sets = [_decode_case(torch, gen, B, S, H, Hkv, dh, dtype,
                         [cl_mid] * B, dev) for _ in range(_sets_for(per_set))]

    def sdpa(q, k, v, cl):
        mask = (torch.arange(S, device=dev)[None] < cl[:, None])[:, None, None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    q, k, v, cl = sets[0]
    lib_err = float((sdpa(q, k, v, cl).float()
                     - ref.decode_attention_ref(q, k, v, cl).float()).abs().max())
    require(lib_err <= tol, f"library attention disagrees by {lib_err}")
    kernel = (lambda q, k, v, cl: decode_attention_cuda(q, k, v, cl_mid)) \
        if int_len else decode_attention_cuda
    err = float((kernel(q, k, v, cl).float()
                 - ref.decode_attention_ref(q, k, v, cl).float()).abs().max())
    require(err <= tol, f"decode_attention {gname}: max_abs_err {err} > {tol}")
    fns = {"": kernel,
           "plain_": lambda *a: ref.decode_attention_ref(*a),
           "library_": sdpa}
    times = {f"{p}ms": _time_ms(torch, fn, sets) for p, fn in fns.items()}
    iters = {"": 100, "plain_": 10, "library_": 50}   # a few hundred launches
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=iters[p],
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    cost = costs.decode_attention(B, H, Hkv, dh, B * cl_mid, esize)
    n_bytes, n_ops = cost["bytes"], cost["flops"]
    bound_ms, bound_by = _bound(n_bytes, n_ops, None if dtype == torch.bfloat16
                                else H100_PEAK_FLOPS_F32)
    return {"kernel": "decode_attention", "group": gname, "B": B, "S": S,
            "cache_len": cl_mid, "int_len": int_len,
            "dtype": str(dtype)[6:], "max_abs_err": err, "H": H, "Hkv": Hkv,
            "dh": dh, "G": H // Hkv, "splits": num_splits(B, Hkv, S, H // Hkv),
            **times,
            "library": "scaled_dot_product_attention(enable_gqa=True, "
                       "bool length mask)",
            "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
            "bound_by": bound_by, "sets": len(sets)}


def _mc_case(torch, gen, dev, B, S, D, kind, dtype=None):
    """(tokens [B,S,D], mask [B,S] bool, K): ``kind`` "keep72" keeps a
    random 72% of the rows with K = S (the §VI payload), "all" keeps every
    row with K = S (the lossless KV hop), "make_mask" keeps the top 72% by
    row norm with K = round(0.72 S) (the lossy KV hop)."""
    from repro_torch.core.masking import make_mask, norm_scores
    from repro_torch.launch.serve import KEEP_RATE as KEEP
    dtype = dtype or torch.bfloat16
    if dtype.is_floating_point:
        toks = torch.randn((B, S, D), generator=gen, device=dev).to(dtype)
    else:
        toks = torch.randint(0, 128, (B, S, D), generator=gen, device=dev).to(dtype)
    if kind == "all":
        return toks, torch.ones((B, S), dtype=torch.bool, device=dev), S
    if kind == "make_mask":
        return toks, make_mask(norm_scores(toks), KEEP), max(1, round(KEEP * S))
    return toks, torch.rand((B, S), generator=gen, device=dev) < KEEP, S


def _time_masked_compact(torch, dev, gen, gname, B, S, D, kind):
    """masked_compact and its plain version on bf16 [B,S,D] inputs of
    ``kind`` (see ``_mc_case``), beside the bytes bound; where the wrapper
    takes a plan, the device time of each base-finding branch (short rows:
    every block counts the mask before its tile; long rows: a count pass
    into a workspace first) is timed too."""
    from repro_torch.core.profiler import H100_HBM_BW
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels import masked_compact as mc

    esize = 2
    sets = [_mc_case(torch, gen, dev, B, S, D, kind)
            for _ in range(_sets_for(B * S * D * esize))]
    fns = {"": lambda *a: mc.masked_compact_cuda(*a),
           "plain_": lambda *a: ref.masked_compact_ref(*a)}
    times = {f"{p}ms": _time_ms(torch, fn, sets) for p, fn in fns.items()}
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=50 if not p else 20,
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    K = sets[0][2]
    plan = None
    if hasattr(mc, "masked_compact_plan"):
        plan = mc.masked_compact_plan(B, S, D * esize, K)
        for branch in (False, True):
            forced = mc.masked_compact_plan(B, S, D * esize, K, long_rows=branch)
            times[f"device_ms_{'long' if branch else 'short'}_rows"] = _device_ms(
                torch, lambda *a: mc.masked_compact_cuda(*a, plan=forced), sets, iters=50)
        plan = dataclasses.asdict(plan)
    kept = int(torch.clamp(sets[0][1].sum(dim=1), max=K).sum())
    n_bytes = costs.masked_compact(B, S, D, K, esize, kept)["bytes"]
    return {"kernel": "masked_compact", "group": gname, "B": B, "S": S, "D": D,
            "K": K, "dtype": "bfloat16", "mask": kind, "kept_rows": kept,
            "plan": plan, **times, "library_ms": None,
            "library": "none: no single PyTorch call compacts rows",
            "bytes": n_bytes, "operations": 0,
            "bound_ms": 1e3 * n_bytes / H100_HBM_BW, "bound_by": "bytes",
            "share_of_bound": 1e3 * n_bytes / H100_HBM_BW / times["device_ms"],
            "sets": len(sets)}


def phase_timing(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = [_time_decode_attention(torch, dev, gen, gname, B, 32, 8, 64)
            for gname, B in TIMED_GROUPS.items()]

    B = TIMED_GROUPS["auxiliary"]
    rows.append(_time_masked_compact(torch, dev, gen, "auxiliary", B,
                                     PROMPT_LEN, 2048, "keep72"))
    for gname, kind in (("kv_hop_lossless", "all"), ("kv_hop_lossy", "make_mask")):
        rows.append(_time_masked_compact(torch, dev, gen, gname, *KV_HOP, kind))
    for row in rows:
        emit({"phase": "timing", **row})
    return rows


# ---------------------------------------------------------------------------
# The MoE path: moonshot-v1-16b-a3b
# ---------------------------------------------------------------------------
def _ffn_case(torch, gen, E, C, D, F, dtype, dev):
    """buf ~ N(0, 1), like the normed activations the MoE layer scatters,
    and expert weights at moe_init's scales."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return (normal((E, C, D), 1.0), normal((E, D, F), D ** -0.5),
            normal((E, D, F), D ** -0.5), normal((E, F, D), F ** -0.5))


def _ffn_counts(torch, gen, kind, E, C, dev):
    """counts [E] int32: None, all zero, all C, or ragged in [0, C] with an
    expert at 0 (its buf rows stay non-zero: its output must be 0 all the
    same), one at C and one at 1."""
    if kind is None:
        return None
    if kind == "zero":
        return torch.zeros((E,), dtype=torch.int32, device=dev)
    if kind == "full":
        return torch.full((E,), C, dtype=torch.int32, device=dev)
    c = torch.randint(0, C + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    c[0], c[-1] = 0, C
    if E > 2:
        c[1] = 1
    return c


def phase_moe_kernel_checks(torch, dev, cfg, slice_summary):
    """grouped_ffn against its plain version at every capacity the slice
    and the continuous path ran, at edge cases and with counts (0, C, ragged: rows at or past a
    count are exactly 0, though buf's rows there are not), twice each,
    bit-equal; decode_attention's checks at moonshot's head shape (G=1,
    dh=128).  Returns the largest main-path error of each kernel (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda, tensor_core_path
    from repro_torch.models.moe import _capacity

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    bs = _batch_sizes(slice_summary)
    # the slice's prefill and decode, and the continuous path's B=1
    # admission prefill and its decode at the slot width
    caps = sorted({_capacity(n * PROMPT_LEN, cfg) for n in bs + [1]}
                  | {_capacity(n, cfg) for n in bs + [SIDE_SLOTS]})
    cases = [("main-path", E, C, D, F, None) for C in caps]
    cases += [("ragged", 3, 1, 72, 88, None), ("ragged", 3, 13, 72, 88, None),
              ("ragged", 3, 1, 80, 88, None), ("ragged", 3, 13, 80, 88, None),
              ("ragged-scalar-loads", 2, 13, 70, 13, None),
              ("zero-rows", 8, 16, D, F, None), ("all-empty", E, caps[0], D, F, None),
              ("counts-zero", E, caps[0], D, F, "zero"),
              ("counts-full", E, caps[-1], D, F, "full"),
              ("counts-ragged", E, caps[0], D, F, "ragged"),
              ("counts-ragged", E, caps[-1], D, F, "ragged"),
              ("counts-ragged", 3, 13, 72, 88, "ragged"),
              ("counts-ragged", 4, 300, 64, 136, "ragged"),
              ("counts-ragged-scalar-loads", 2, 13, 70, 13, "ragged")]
    results, ffn_err = [], 0.0
    for name, e, C, d, f, kind in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            buf, wg, wu, wd = _ffn_case(torch, gen, e, C, d, f, dtype, dev)
            if name == "zero-rows":
                buf[:, 5:] = 0          # empty capacity slots
                buf[2] = 0              # an expert that received no row
            elif name == "all-empty":
                buf.zero_()
            counts = _ffn_counts(torch, gen, kind, e, C, dev)
            got = grouped_ffn_cuda(buf, wg, wu, wd, counts)
            again = grouped_ffn_cuda(buf, wg, wu, wd, counts)
            want = ref.grouped_ffn_ref(buf, wg, wu, wd, counts)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tag = f"grouped_ffn {name} E={e} C={C} D={d} F={f} {dname}"
            require(got.dtype == dtype and got.shape == buf.shape
                    and bool(torch.isfinite(got).all()), f"{tag}: bad output")
            require(err <= FFN_TOL[dname],
                    f"{tag}: max_abs_err {err} > {FFN_TOL[dname]}")
            require(torch.equal(got, again), f"{tag}: two calls differ")
            row = {"case": name, "E": e, "C": C, "D": d, "F": f, "dtype": dname,
                   "path": "tensor_cores" if tensor_core_path(dtype, d, f)
                   else "cuda_cores", "max_abs_err": err,
                   "out_mean_abs": float(got.float().abs().mean()),
                   "bit_equal_twice": True}
            empty = (buf == 0).all(dim=-1)
            if counts is not None:
                empty |= torch.arange(C, device=dev)[None, :] >= counts[:, None]
                row["counts"] = counts.tolist()[:8]
            if bool(empty.any()):
                exact = bool((got[empty] == 0).all())
                require(exact, f"{tag}: zero rows or rows past the count gave "
                        "non-zero rows")
                row["zero_rows"] = int(empty.sum())
                row["zero_rows_exact"] = exact
            if name == "main-path" and dtype == torch.bfloat16:
                ffn_err = max(ffn_err, err)
            results.append(row)
            del buf, wg, wu, wd, got, again, want
    emit({"phase": "moe_kernels", "kernel": "grouped_ffn", "tolerance": FFN_TOL,
          "cases": results})

    att_err = _check_decode_attention(torch, dev, gen, bs, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      "moe_kernels")
    return {"grouped_ffn": ffn_err, "decode_attention": att_err}


def phase_moe_parity(torch, dev, cfg, params, prompts):
    """A 2-layer float32 cut of the slice's weights at full width: kernel
    path against plain path over 8 teacher-forced decode steps, with the
    router's top-k margins recorded; then macro_steps 8 and 0 at full depth
    in bf16 give identical streams."""
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                            seed_cache)

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:2].float(), params["blocks"])
    B, K = 4, cfg.experts_per_token
    tokens = torch.as_tensor(prompts[:B], device=dev)
    log = []                         # (sorted expert ids [T,K], min margin)
    orig = moe_mod.moe_apply

    def spy(p, x, c, **kw):          # records each MoE call's routing
        _, ids, _, probs = moe_mod.route(x.reshape(-1, x.shape[-1]), p["router"], c)
        top = torch.topk(probs, K + 1, dim=-1).values
        log.append((ids.sort(dim=-1).values, float((top[:, -2] - top[:, -1]).min())))
        return orig(p, x, c, **kw)

    errs, margins, flips = [], [], []
    with torch.no_grad():
        last, pre = make_prefill_step(cfg2, use_kernels=False)(p32, {"tokens": tokens})
        caches = [seed_cache(cfg2, M.init_cache(cfg2, B, S_MAIN, device=dev),
                             pre, PROMPT_LEN) for _ in range(2)]
        del pre
        plain = make_serve_step(cfg2, use_kernels=False)
        kern = make_serve_step(cfg2, use_kernels=True)
        tok = last.argmax(dim=-1).to(torch.int32)
        moe_mod.moe_apply = spy
        try:
            for i in range(8):
                lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32,
                                     device=dev)
                log.clear()
                lp, _ = plain(p32, caches[0], tok[:, None], lengths)
                plain_log = list(log)
                log.clear()
                lk, _ = kern(p32, caches[1], tok[:, None], lengths)
                errs.append(float((lk - lp).abs().max()))
                margins += [m for _, m in plain_log + log]
                flips += [{"step": i, "layer": j, "margin": min(a[1], b[1])}
                          for j, (a, b) in enumerate(zip(plain_log, log))
                          if not torch.equal(a[0], b[0])]
                tok = lp.argmax(dim=-1).to(torch.int32)
        finally:
            moe_mod.moe_apply = orig
        del caches, p32
    for i, err in enumerate(errs):
        excused = any(f["step"] <= i and f["margin"] < 1e-6 for f in flips)
        require(err <= 1e-3 or excused,
                f"MoE teacher-forced step {i}: logits differ by {err} > 1e-3 "
                f"between kernel and plain paths with no routing flip at a "
                f"margin below 1e-6 (flips: {flips})")

    same = _macro_streams_equal(torch, dev, cfg, params, prompts[:B], MAX_NEW)
    emit({"phase": "moe_parity", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "requests": B, "teacher_forced_max_abs": errs,
          "tolerance": 1e-3, "min_router_margin": min(margins),
          "routing_flips": flips, "macro_8_equals_0": same,
          "macro_check_dtype": "bfloat16", "macro_check_layers": cfg.num_layers})


def _routed_buffer(torch, moe_mod, cfg, router, T, C, gen, dev, dtype):
    """(buf [E,C,D] in dtype, counts [E] int32): T random tokens (unit normal,
    like the normed activations the layer routes) through a layer's real
    router and moe_apply's dispatch, so the rows and experts in use are the
    ones such a batch routes."""
    E, D = cfg.num_experts, cfg.d_model
    xt = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    _, ids, _, _ = moe_mod.route(xt, router, cfg)
    _, sorted_ids, pos, keep, src, counts = moe_mod.dispatch(ids, E, C)
    buf = torch.zeros((E, C, D), dtype=dtype, device=dev)
    buf.index_put_((sorted_ids, torch.where(keep, pos, 0)),
                   xt[src].masked_fill(~keep[:, None], 0), accumulate=True)
    return buf, counts.clamp(max=C).to(torch.int32)


def phase_moe_timing(torch, dev, cfg, params):
    """grouped_ffn at decode (B tokens) and at the auxiliary group's prefill
    (B x 128 tokens), each layer's buffer and counts made by routing random
    tokens through that layer's router, cycling through the slice's 48
    layers (1.1 GB of experts a layer, far past L2).  Beside the kernel:
    its plain version and the bf16 composition of three torch.bmm calls and
    silu*mul over every row; two bounds, one over every expert's weights
    and one over the experts and rows these inputs route (``bound_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
    from repro_torch.models import moe as moe_mod

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    experts = params["blocks"]["moe"]
    B = TIMED_GROUPS["auxiliary"]

    def composition(buf, wg, wu, wd, counts=None):
        return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)

    rows = []
    for step, T in (("decode", B), ("prefill", B * PROMPT_LEN)):
        C = moe_mod._capacity(T, cfg)
        sets = []
        with torch.no_grad():
            for i in range(cfg.num_layers):
                buf, counts = _routed_buffer(torch, moe_mod, cfg,
                                             experts["router"][i], T, C, gen, dev,
                                             experts["w_gate"].dtype)
                sets.append((buf, experts["w_gate"][i], experts["w_up"][i],
                             experts["w_down"][i], counts))
        got, want = grouped_ffn_cuda(*sets[0]), ref.grouped_ffn_ref(*sets[0])
        err = float((got.float() - want.float()).abs().max())
        require(err <= FFN_TOL["bfloat16"], f"grouped_ffn {step} on routed "
                f"buffers: max_abs_err {err} > {FFN_TOL['bfloat16']}")
        comp_err = float((composition(*sets[0]).float() - want.float()).abs().max())
        used = sum(int((c > 0).sum()) for *_, c in sets) / len(sets)
        routed_rows = sum(int(c.sum()) for *_, c in sets) / len(sets)
        fns = {"": grouped_ffn_cuda, "plain_": ref.grouped_ffn_ref,
               "composition_": composition}
        times = {f"{p}ms": _time_ms(torch, fn, sets, iters=96, warmup=4)
                 for p, fn in fns.items()}
        iters = {"": 48, "plain_": 12, "composition_": 48}
        times.update({f"{p}device_ms": _device_ms(torch, fn, sets, iters=iters[p],
                                                  need_ahead=not p)
                      for p, fn in fns.items()})
        every = costs.grouped_ffn(E, C, D, Fd, 2)          # all rows and experts
        all_ms, all_by = _bound(every["bytes"], every["flops"])
        routed = costs.grouped_ffn(E, C, D, Fd, 2, routed_rows=routed_rows,
                                   experts_used=used, counts=True)
        n_bytes, n_ops = routed["bytes"], routed["flops"]
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        rows.append({"kernel": "grouped_ffn", "step": step, "group": "auxiliary",
                     "B": B, "tokens": T, "E": E, "C": C, "D": D, "F": Fd,
                     "dtype": "bfloat16", "experts_used_mean": used,
                     "routed_rows_mean": routed_rows, "max_abs_err": err, **times,
                     "library_ms": None,
                     "library": "none: no single PyTorch call computes this function",
                     "composition": "torch.bmm x3 + silu*mul over all rows, bf16",
                     "composition_max_abs_err": comp_err,
                     "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_counts": "routed experts and rows",
                     "bound_all_experts_ms": all_ms, "bound_all_experts_by": all_by,
                     "sets": len(sets)})
        del sets, got, want
    rows.append(_time_decode_attention(torch, dev, gen, "auxiliary", B,
                                       cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim))
    for row in rows:
        emit({"phase": "moe_timing", "arch": cfg.name, **row})
    return rows


def phase_long_cache_timing(torch, dev, B, heads):
    """decode_attention, its plain version and SDPA at a long full cache,
    while no model's weights are held: ``heads`` maps a config's name to
    (H, Hkv, dh, cache length)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for arch, (H, Hkv, dh, S) in heads.items():
        row = _time_decode_attention(torch, dev, gen, "long-cache", B, H, Hkv,
                                     dh, S=S, cache_len=S)
        row["heads_of"] = arch
        rows.append(row)
        emit({"phase": "long_cache_timing", **row,
              "share_of_bound": row["bound_ms"] / row["device_ms"]})
    return rows


# ---------------------------------------------------------------------------
# prefill attention: the kernel against chunked_attention, no model held
# ---------------------------------------------------------------------------
# the cell's shape (nemotron-4-15b's heads, a 2,048-token prompt, B=1)
PREFILL_SHAPE = (1, 2048, 48, 8, 128)
# tolerances against chunked_attention at the same bf16 inputs (both sum in
# f32 and differ only in rounding order, exp2 for exp and the hi/lo P): the
# f32 results within PREFILL_F32_TOL of max|v| (p's hi/lo pair keeps ~16
# bits, 2^-17 of p; the rest is ~1e-6); the bf16 outputs, rounded once from
# those, at most one bf16 ulp apart on all but PREFILL_ULP_SHARE of the
# elements (a rounding boundary between the two f32 results) and never
# further apart than PREFILL_BF16_TOL
PREFILL_F32_TOL = 3e-5
PREFILL_ULP_SHARE = 1e-3
PREFILL_BF16_TOL = 2e-2


def _prefill_cases():
    """(name, B, Sq, Sk, H, Hkv, dh, causal, window, padded queries, padded
    keys): the cell's shape, dh 64 with G 4 (llama3.2-1b), dh 80 (zamba2),
    a sliding window, a prefix resume, non-causal cross-attention (the audio
    decoder's over 1,500 encoder rows, G 1), padded queries and keys, ragged
    ends (S not a multiple of either tile) and a call whose first query
    rows see no key (their rows exactly 0)."""
    B, S, H, Hkv, dh = PREFILL_SHAPE
    return [("cell", B, S, S, H, Hkv, dh, True, 0, 0, 0),
            ("dh64-G4", 2, 700, 700, 32, 8, 64, True, 0, 0, 0),
            ("dh80", 1, 513, 513, 32, 32, 80, True, 0, 0, 0),
            ("window", 1, 1500, 1500, H, Hkv, dh, True, 256, 0, 0),
            ("resume", B, 384, S, H, Hkv, dh, True, 0, 0, 0),
            ("cross", 2, 100, 1500, 16, 16, 64, False, 0, 0, 0),
            ("padded", 2, 333, 333, H, Hkv, dh, True, 0, 45, 45),
            ("no-key-rows", 1, 200, 200, H, Hkv, dh, True, 0, 0, 0)]


def _prefill_positions(torch, dev, Sq, Sk, padq, padk, name):
    """q and kv positions as the model hands them: a prompt (or a resumed
    tail at Sk - Sq..), padded queries -1 and padded keys 2**30 at the end;
    ``no-key-rows`` shifts the keys 64 past the queries' start, so the
    first 64 queries attend nothing."""
    qpos = torch.arange(Sk - Sq, Sk, device=dev)
    kpos = torch.arange(Sk, device=dev)
    if name == "no-key-rows":
        kpos = kpos + 64
    if padq:
        qpos[-padq:] = -1
    if padk:
        kpos[-padk:] = 2 ** 30
    return qpos, kpos


def _bf16_ulps(torch, a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (the order of their bit patterns; +0 and -0 are 0 apart)."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(a) - order(b)).abs()


def _check_prefill_attention(torch, dev, gen):
    """The kernel against chunked_attention at every case of
    ``_prefill_cases``: its f32 result (``out_dtype``) against the plain
    version's f32, its bf16 output against the plain bf16 output by ulps,
    every call twice, bit-equal, rows with no key exactly 0.  Returns the
    cell's largest bf16 error."""
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.models.attention import chunked_attention

    results, main_err = [], 0.0
    for name, B, Sq, Sk, H, Hkv, dh, causal, win, padq, padk in _prefill_cases():
        q = torch.randn((B, Sq, H, dh), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).bfloat16()
        qpos, kpos = _prefill_positions(torch, dev, Sq, Sk, padq, padk, name)
        kw = dict(causal=causal, window=win, q_positions=qpos, kv_positions=kpos)
        got = prefill_attention_cuda(q, k, v, **kw)
        again = prefill_attention_cuda(q, k, v, **kw)
        got32 = prefill_attention_cuda(q, k, v, out_dtype=torch.float32, **kw)
        want = chunked_attention(q, k, v, **kw)
        want32 = chunked_attention(q, k, v.float(), **kw)
        torch.cuda.synchronize()
        tag = (f"prefill_attention {name} B={B} Sq={Sq} Sk={Sk} H={H} "
               f"Hkv={Hkv} dh={dh} causal={causal} window={win}")
        require(got.dtype == torch.bfloat16 and got.shape == q.shape
                and bool(torch.isfinite(got32).all()), f"{tag}: bad output")
        require(torch.equal(got, again), f"{tag}: two calls differ")
        vmax = float(v.float().abs().max())
        err32 = float((got32 - want32).abs().max())
        err = float((got.float() - want.float()).abs().max())
        ulps = _bf16_ulps(torch, got, want)
        beyond = float((ulps > 1).float().mean())
        require(err32 <= PREFILL_F32_TOL * vmax,
                f"{tag}: f32 max_abs_err {err32} > {PREFILL_F32_TOL} x {vmax}")
        require(beyond <= PREFILL_ULP_SHARE and err <= PREFILL_BF16_TOL,
                f"{tag}: {beyond:.2e} of the elements more than one bf16 ulp "
                f"apart, max_abs_err {err}")
        empty = ~_prefill_mask(torch, qpos, kpos, causal, win).any(dim=1)
        require(not bool(got[:, empty].any()) and not bool(got32[:, empty].any()),
                f"{tag}: a row with no key is not 0")
        if name == "cell":
            main_err = err
        results.append({"case": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H,
                        "Hkv": Hkv, "dh": dh, "causal": causal, "window": win,
                        "padded_queries": padq, "padded_keys": padk,
                        "rows_without_keys": int(empty.sum()),
                        "max_abs_err_f32": err32, "max_abs_v": vmax,
                        "max_abs_err": err, "max_ulps": int(ulps.max()),
                        "share_beyond_one_ulp": beyond, "bit_equal_twice": True})
        del q, k, v, got, again, got32, want, want32
    emit({"phase": "kernels", "kernel": "prefill_attention",
          "tolerance": {"f32_of_max_abs_v": PREFILL_F32_TOL,
                        "share_beyond_one_bf16_ulp": PREFILL_ULP_SHARE,
                        "bf16_max_abs": PREFILL_BF16_TOL},
          "cases": results})
    return main_err


def _prefill_mask(torch, qpos, kpos, causal, window):
    """chunked_attention's mask [Sq, Sk]."""
    m = (kpos[None, :] < 2 ** 30).expand(qpos.shape[0], -1)
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window:
        m = m & ((qpos[:, None] - kpos[None, :]) < window)
    return m


def _time_prefill_attention(torch, dev, gen):
    """The kernel and chunked_attention at the cell's shape (a causal
    prompt), beside the bound from ``costs.prefill_attention``."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.models.attention import chunked_attention

    B, S, H, Hkv, dh = PREFILL_SHAPE
    pos = torch.arange(S, device=dev)
    kw = dict(causal=True, window=0, q_positions=pos, kv_positions=pos)
    cost = costs.prefill_attention(B, S, S, H, Hkv, dh, True, 0)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))
            for _ in range(_sets_for(cost["bytes"]))]
    fns = {"": lambda q, k, v: prefill_attention_cuda(q, k, v, **kw),
           "plain_": lambda q, k, v: chunked_attention(q, k, v, **kw)}
    times = {f"{p}ms": _time_ms(torch, fn, sets, iters=50 if not p else 5,
                                warmup=3)
             for p, fn in fns.items()}
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets,
                                              iters=50 if not p else 5,
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    bound_ms, bound_by = _bound(cost["bytes"], cost["flops"])
    return {"kernel": "prefill_attention", "group": "cell", "B": B, "S": S,
            "H": H, "Hkv": Hkv, "dh": dh, "G": H // Hkv, "causal": True,
            "dtype": "bfloat16", **times, "library_ms": None,
            "library": "none timed: no library attention is run beside the port",
            "bytes": cost["bytes"], "operations": cost["flops"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / times["device_ms"],
            "tflops": cost["flops"] / times["device_ms"] / 1e9,
            "sets": len(sets)}


def phase_prefill_attention(torch, dev):
    """The kernel's checks and its timing at the cell's shape, no model
    held.  Returns ({kernel: the cell's bf16 error}, timing rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    err = _check_prefill_attention(torch, dev, gen)
    row = _time_prefill_attention(torch, dev, gen)
    emit({"phase": "timing", **row})
    torch.cuda.empty_cache()
    return {"prefill_attention": err}, [row]


# ---------------------------------------------------------------------------
# moonlight-16b-a3b: latent attention over the latent cache, the prefill
# kernel's q/k 192 / v 128 instance and the dropless MoE
# ---------------------------------------------------------------------------
MLA_ARCH = "moonlight-16b-a3b"
MLA_H, MLA_LATENT, MLA_ROPE, MLA_V = 16, 512, 64, 512   # V: a row's first 512
MLA_DK, MLA_DV = 192, 128       # the expanded prefill's q/k and v widths
MLA_PREFILL = "prefill_attention.qk192_v128"     # the instance's kernels row
MLA_SORTED = "grouped_ffn_sorted"       # the dropless MoE's prefill route
# the longdoc cell: slots a group, cache rows a slot, prompt tokens
MLA_CELL_B, MLA_CELL_S, MLA_CELL_P = 64, 7272, 7168
# the decode kernel's bf16 output against the plain version in f32, of
# max|v|: one bf16 rounding of the output (2^-9 of it) and the f32 sums'
# order over 16 heads' shared rows
MLA_TOL = 8e-3


def _mla_decode_cases(num_splits, more=False):
    """(name, B, S, heads, lengths or an int): the cell's decode, with
    lengths on each split's first and last row, 1 and S; with ``more``
    also one split, 4 heads, an empty slot and one int length."""
    B, S = MLA_CELL_B, MLA_CELL_S
    splits, rows = num_splits(B, S)
    edges = [1, S, rows, rows + 1, rows - 1, S - 1]
    edges += [min(S, i * rows + d) for i in range(1, splits) for d in (0, 1)]
    cases = [("cell", B, S, MLA_H, edges)]
    if more:
        cases += [("one-split", 3, 200, MLA_H, [200, 7, 1]),
                  ("heads4", 5, 3000, 4, [2999, 1500, 64, 65, 3000]),
                  ("empty-slot", 4, 1000, MLA_H, [0, 1000, 512, 33]),
                  ("int-length", 2, 900, MLA_H, 700)]
    return cases


def _check_mla_decode(torch, dev, gen, more=False):
    """mla_decode_attention against ``ref.mla_decode_attention_ref`` in f32
    at ``_mla_decode_cases``, every call twice, bit-equal, an empty slot
    exactly 0.  Returns the cell's largest error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mla_decode_attention import (
        mla_decode_attention_cuda, num_splits)
    scale = 1.0 / math.sqrt(MLA_DK)
    results, main_err = [], 0.0
    for name, B, S, heads, lens in _mla_decode_cases(num_splits, more):
        q = torch.randn((B, heads, MLA_LATENT + MLA_ROPE), generator=gen,
                        device=dev).bfloat16()
        lat = torch.randn((B, S, MLA_LATENT + MLA_ROPE), generator=gen,
                          device=dev).bfloat16()
        if isinstance(lens, int):
            cl = lens
        else:
            pick = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            pick[:len(lens)] = torch.tensor(lens[:B], device=dev)
            cl = pick.to(torch.int32)
        got = mla_decode_attention_cuda(q, lat, cl, scale=scale)
        again = mla_decode_attention_cuda(q, lat, cl, scale=scale)
        want = ref.mla_decode_attention_ref(q, lat.float(), cl, scale=scale,
                                            v_dim=MLA_V)
        torch.cuda.synchronize()
        tag = f"mla_decode_attention {name} B={B} S={S} H={heads}"
        require(got.shape == (B, heads, MLA_V)
                and bool(torch.isfinite(got.float()).all()), f"{tag}: bad output")
        require(torch.equal(got, again), f"{tag}: two calls differ")
        vmax = float(lat[..., :MLA_V].float().abs().max())
        err = float((got.float() - want).abs().max())
        ulps = _bf16_ulps(torch, got, want.bfloat16())
        require(err <= MLA_TOL * vmax,
                f"{tag}: max_abs_err {err} > {MLA_TOL} x {vmax}")
        if not isinstance(cl, int):
            require(not bool(got[cl == 0].any()), f"{tag}: an empty slot is not 0")
        if name == "cell":
            main_err = err
        results.append({"case": name, "B": B, "S": S, "H": heads,
                        "splits": num_splits(B, S)[0], "max_abs_err": err,
                        "max_abs_v": vmax, "max_ulps": int(ulps.max()),
                        "share_beyond_one_ulp": float((ulps > 1).float().mean()),
                        "bit_equal_twice": True})
        del q, lat, got, again, want
    emit({"phase": "kernels", "kernel": "mla_decode_attention",
          "tolerance": {"of_max_abs_v": MLA_TOL}, "cases": results})
    return main_err


def _time_mla_decode(torch, dev, gen):
    """The kernel and its plain version at the cell's decode a third into
    the answers, beside the bound from ``costs.mla_decode_attention``."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.mla_decode_attention import (
        mla_decode_attention_cuda, num_splits)
    B, S, W = MLA_CELL_B, MLA_CELL_S, MLA_LATENT + MLA_ROPE
    lens = MLA_CELL_P + 32
    cost = costs.mla_decode_attention(B, MLA_H, W, MLA_V, B * lens, 2)
    cl = torch.full((B,), lens, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(MLA_DK)
    sets = [(torch.randn((B, MLA_H, W), generator=gen, device=dev).bfloat16(),
             torch.randn((B, S, W), generator=gen, device=dev).bfloat16())
            for _ in range(_sets_for(cost["bytes"]))]
    fns = {"": lambda q, lat: mla_decode_attention_cuda(q, lat, cl, scale=scale),
           "plain_": lambda q, lat: ref.mla_decode_attention_ref(
               q, lat, cl, scale=scale, v_dim=MLA_V)}
    times = {f"{p}ms": _time_ms(torch, fn, sets, iters=100 if not p else 5,
                                warmup=3) for p, fn in fns.items()}
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets,
                                              iters=100 if not p else 5,
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    bound_ms, bound_by = _bound(cost["bytes"], cost["flops"])
    row = {"kernel": "mla_decode_attention", "group": "cell", "B": B, "S": S,
           "rows_a_slot": lens, "H": MLA_H, "splits": num_splits(B, S)[0],
           "dtype": "bfloat16", **times, "library_ms": None,
           "library": "none timed: no library latent attention is run "
                      "beside the port",
           "bytes": cost["bytes"], "operations": cost["flops"],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / times["device_ms"],
           "tb_per_s": cost["bytes"] / times["device_ms"] / 1e9,
           "sets": len(sets)}
    del sets
    return row


def _check_mla_prefill(torch, dev, gen, more=False):
    """The prefill kernel's q/k 192, v 128 instance against
    chunked_attention at the cell's prompt (with ``more`` also a ragged and
    a padded prompt), as ``_check_prefill_attention`` holds the others.
    Returns the cell's largest bf16 error."""
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.models.attention import chunked_attention
    cases = [("cell", MLA_CELL_P, 0)]
    if more:
        cases += [("ragged", 333, 0), ("padded", 500, 45)]
    results, main_err = [], 0.0
    for name, S, pad in cases:
        q = torch.randn((1, S, MLA_H, MLA_DK), generator=gen, device=dev).bfloat16()
        k = torch.randn((1, S, MLA_H, MLA_DK), generator=gen, device=dev).bfloat16()
        v = torch.randn((1, S, MLA_H, MLA_DV), generator=gen, device=dev).bfloat16()
        qpos, kpos = _prefill_positions(torch, dev, S, S, pad, pad, name)
        kw = dict(causal=True, window=0, q_positions=qpos, kv_positions=kpos)
        got = prefill_attention_cuda(q, k, v, **kw)
        again = prefill_attention_cuda(q, k, v, **kw)
        got32 = prefill_attention_cuda(q, k, v, out_dtype=torch.float32, **kw)
        want = chunked_attention(q, k, v, **kw)
        want32 = chunked_attention(q, k, v.float(), **kw)
        torch.cuda.synchronize()
        tag = f"prefill_attention dh={MLA_DK} dv={MLA_DV} {name} S={S}"
        require(got.shape == (1, S, MLA_H, MLA_DV)
                and bool(torch.isfinite(got32).all()), f"{tag}: bad output")
        require(torch.equal(got, again), f"{tag}: two calls differ")
        vmax = float(v.float().abs().max())
        err32 = float((got32 - want32).abs().max())
        err = float((got.float() - want.float()).abs().max())
        ulps = _bf16_ulps(torch, got, want)
        beyond = float((ulps > 1).float().mean())
        require(err32 <= PREFILL_F32_TOL * vmax,
                f"{tag}: f32 max_abs_err {err32} > {PREFILL_F32_TOL} x {vmax}")
        require(beyond <= PREFILL_ULP_SHARE and err <= PREFILL_BF16_TOL,
                f"{tag}: {beyond:.2e} of the elements more than one bf16 ulp "
                f"apart, max_abs_err {err}")
        if name == "cell":
            main_err = err
        results.append({"case": name, "S": S, "padded": pad,
                        "max_abs_err_f32": err32, "max_abs_v": vmax,
                        "max_abs_err": err, "max_ulps": int(ulps.max()),
                        "share_beyond_one_ulp": beyond, "bit_equal_twice": True})
        del q, k, v, got, again, got32, want, want32
    emit({"phase": "kernels", "kernel": MLA_PREFILL,
          "tolerance": {"f32_of_max_abs_v": PREFILL_F32_TOL,
                        "share_beyond_one_bf16_ulp": PREFILL_ULP_SHARE,
                        "bf16_max_abs": PREFILL_BF16_TOL},
          "cases": results})
    return main_err


def _time_mla_prefill(torch, dev, gen):
    """The instance and chunked_attention at the cell's prompt, beside the
    bound from ``costs.prefill_attention``."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.models.attention import chunked_attention
    S = MLA_CELL_P
    pos = torch.arange(S, device=dev)
    kw = dict(causal=True, window=0, q_positions=pos, kv_positions=pos)
    cost = costs.prefill_attention(1, S, S, MLA_H, MLA_H, MLA_DK, True, 0,
                                   dv=MLA_DV)
    shapes = ((1, S, MLA_H, MLA_DK), (1, S, MLA_H, MLA_DK), (1, S, MLA_H, MLA_DV))
    sets = [tuple(torch.randn(sh, generator=gen, device=dev).bfloat16()
                  for sh in shapes) for _ in range(_sets_for(cost["bytes"]))]
    fns = {"": lambda q, k, v: prefill_attention_cuda(q, k, v, **kw),
           "plain_": lambda q, k, v: chunked_attention(q, k, v, **kw)}
    times = {f"{p}ms": _time_ms(torch, fn, sets, iters=20 if not p else 2,
                                warmup=2) for p, fn in fns.items()}
    times.update({f"{p}device_ms": _device_ms(torch, fn, sets,
                                              iters=20 if not p else 2,
                                              need_ahead=not p)
                  for p, fn in fns.items()})
    bound_ms, bound_by = _bound(cost["bytes"], cost["flops"])
    row = {"kernel": MLA_PREFILL, "group": "cell", "B": 1, "S": S, "H": MLA_H,
           "Hkv": MLA_H, "dh": MLA_DK, "dv": MLA_DV, "causal": True,
           "dtype": "bfloat16", **times, "library_ms": None,
           "library": "none timed: no library attention is run beside the port",
           "bytes": cost["bytes"], "operations": cost["flops"],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / times["device_ms"],
           "tflops": cost["flops"] / times["device_ms"] / 1e9,
           "sets": len(sets)}
    del sets
    return row


def _sorted_prefill(torch, dev, cfg, params):
    """Two requests of the longdoc cell's prompt (7,168 tokens, 4 new
    tokens) through ContinuousServingEngine (2 slots, overlapped): every
    MoE layer of each prefill on the sorted route, each decode step on the
    capacity kernel (``_expected_launches``).  Returns (launch counts, the
    first MoE layer's tokens xt [7168, D] and router choices [7168, 6] as
    the prefill handed them to the sorted route)."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServeRequest
    gen = torch.Generator()
    gen.manual_seed(32)
    reqs = [ServeRequest(uid=i, prompt=torch.randint(
        0, cfg.vocab_size, (MLA_CELL_P,), generator=gen,
        dtype=torch.int32).numpy(), max_new=4) for i in range(2)]
    seen, real = [], moe._sorted_experts

    def spy(p, xt, gate_vals, expert_ids, c):
        if not seen:
            seen.append((xt.clone(), expert_ids.clone()))
        return real(p, xt, gate_vals, expert_ids, c)

    moe._sorted_experts = spy
    try:
        outs, stats, counts, wall, peak = _run_engine(
            torch, dev, cfg, params, reqs, slots=2, max_len=MLA_CELL_P + 16,
            macro_steps=MACRO)
    finally:
        moe._sorted_experts = real
    steps = _model_decode_steps(stats, MACRO)
    want = _expected_launches(cfg, {"decode_steps": steps, "prefills": 2},
                              MLA_CELL_P)
    for kname, n in want.items():
        require(counts[kname] == n, f"mla_longdoc: {kname} launched "
                f"{counts[kname]} times, expected {n} ({steps} decode steps, "
                "2 prefills of 7,168 tokens)")
    require(stats.total_tokens == 8 and seen, "mla_longdoc: "
            f"{stats.total_tokens} tokens, sorted route seen: {bool(seen)}")
    emit({"phase": "mla_longdoc", "arch": cfg.name, "slots": 2,
          "requests": 2, "prompt": MLA_CELL_P,
          **_stats_row(stats, wall, peak, counts, MACRO),
          "expected_launches": want})
    return counts, seen[0]


def _check_sorted_ffn(torch, dev, cfg, params, xt, ids):
    """grouped_ffn_sorted at the cell's prefill (T·K = 43,008 rows, E 64, D
    2,048, F 1,408), the rows and offsets the router gave the first MoE
    layer in ``_sorted_prefill``, that layer's weights: against its plain
    version within ``FFN_TOL`` (the capacity kernel's: both keep h at
    about 16 bits and round the output once to bf16, the f32 sums in
    another order), twice bit-equal; one MoE layer's prefill on the card
    with no host sync (``torch.cuda.set_sync_debug_mode("error")``); its
    time beside ``costs.grouped_ffn_sorted``'s bound and beside the
    capacity kernel's over the same tokens in the capacity route's chunks
    of 2,048.  Returns (max_abs_err, timing row)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.grouped_ffn import (grouped_ffn_cuda,
                                                 grouped_ffn_sorted_cuda)
    from repro_torch.models import moe
    E, K, D, F = (cfg.num_experts, cfg.experts_per_token, cfg.d_model,
                  cfg.d_ff)
    T = xt.shape[0]
    blocks = params["blocks"]["moe"]["moe"]

    def layer(i):
        return {k: (v[i] if torch.is_tensor(v) else
                    {n: t[i] for n, t in v.items()}) for k, v in blocks.items()}

    def sorted_set(i, x, choice):
        sort_idx, _, cnt = moe.sort_choices(choice, E)
        offsets = torch.zeros((E + 1,), dtype=torch.int32, device=dev)
        offsets[1:] = torch.cumsum(cnt, 0)
        p = layer(i)
        return (x[sort_idx // K].contiguous(), p["w_gate"], p["w_up"],
                p["w_down"], offsets)

    sets = [sorted_set(0, xt, ids)]
    got = grouped_ffn_sorted_cuda(*sets[0])
    again = grouped_ffn_sorted_cuda(*sets[0])
    want = ref.grouped_ffn_sorted_ref(*sets[0])
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    require(got.shape == (T * K, D) and bool(torch.isfinite(got.float()).all()),
            "grouped_ffn_sorted: bad output")
    require(err <= FFN_TOL["bfloat16"], f"grouped_ffn_sorted at the cell's "
            f"prefill: max_abs_err {err} > {FFN_TOL['bfloat16']}")
    require(torch.equal(got, again), "grouped_ffn_sorted: two calls differ")
    counts = sets[0][4].diff()
    used = int((counts > 0).sum())
    emit({"phase": "kernels", "kernel": MLA_SORTED, "tolerance": FFN_TOL,
          "cases": [{"case": "cell", "rows": T * K, "E": E, "D": D, "F": F,
                     "experts_used": used, "rows_min": int(counts.min()),
                     "rows_max": int(counts.max()), "max_abs_err": err,
                     "out_max_abs": float(want.float().abs().max()),
                     "bit_equal_twice": True}]})
    del got, again, want

    with torch.no_grad():       # one MoE layer's prefill: no host sync
        x = xt[None]
        moe.moe_apply(layer(0), x, cfg, use_kernels=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe.moe_apply(layer(0), x, cfg, use_kernels=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    # timing: three more MoE layers' weights (cold in L2), the same tokens
    n_layers = blocks["w_gate"].shape[0]
    sets += [sorted_set(i, xt, ids) for i in range(1, min(4, n_layers))]
    cost = costs.grouped_ffn_sorted(T * K, E, D, F, 2, experts_used=used)
    bound_ms, bound_by = _bound(cost["bytes"], cost["flops"])
    row = {"kernel": MLA_SORTED, "group": "cell", "rows": T * K, "E": E,
           "D": D, "F": F, "dtype": "bfloat16", "experts_used": used,
           "ms": _time_ms(torch, grouped_ffn_sorted_cuda, sets, iters=40,
                          warmup=4),
           "device_ms": _device_ms(torch, grouped_ffn_sorted_cuda, sets,
                                   iters=40),
           "plain_ms": _time_ms(torch, ref.grouped_ffn_sorted_ref, sets[:1],
                                iters=2, warmup=1),
           "library_ms": None,
           "library": "none: no single PyTorch call computes this function",
           "bytes": cost["bytes"], "operations": cost["flops"],
           "bound_ms": bound_ms, "bound_by": bound_by}
    row["share_of_bound"] = bound_ms / row["device_ms"]
    row["tflops"] = cost["flops"] / row["device_ms"] / 1e9
    row["tflops_with_h_lo"] = row["tflops"] * 4 / 3   # the down pass twice
    del sets
    # the capacity kernel over the same tokens, chunk by chunk
    chunk_ms = []
    for i in range(0, T, moe.DROPLESS_TOKENS):
        c = min(moe.DROPLESS_TOKENS, T - i)
        chunk = []
        for j in range(min(4, n_layers)):
            sort_idx, sorted_ids, pos, keep, src, cnt = moe.dispatch(
                ids[i:i + c], E, c)
            buf = torch.zeros((E, c, D), dtype=xt.dtype, device=dev)
            buf[sorted_ids, pos] = xt[i:i + c][src]
            p = layer(j)
            chunk.append((buf, p["w_gate"], p["w_up"], p["w_down"],
                          cnt.to(torch.int32)))
        chunk_ms.append(_device_ms(torch, grouped_ffn_cuda, chunk, iters=16))
        del chunk
    row.update(capacity_chunks=len(chunk_ms), capacity_chunk_device_ms=chunk_ms,
               capacity_device_ms=sum(chunk_ms))
    emit({"phase": "timing", **row})
    torch.cuda.empty_cache()
    return err, row


def phase_mla(torch, dev):
    """moonlight-16b-a3b: with no model held, mla_decode_attention at the
    longdoc cell's decode and the prefill kernel's 192/128 instance at its
    prompt against their plain versions, and both timed; then the model at
    full width and depth through ContinuousServingEngine
    (``phase_side_continuous``), whose launches are held against its
    layers: mla_decode_attention and the 192/128 instance in all 27,
    grouped_ffn in the 26 MoE layers of each decode step and
    grouped_ffn_sorted in those of each prefill; then two prompts of the cell's
    7,168 tokens (``_sorted_prefill``: grouped_ffn_sorted in the 26 MoE
    layers of each prefill, grouped_ffn in those of each decode step) and
    grouped_ffn_sorted on the first MoE layer's routed rows
    (``_check_sorted_ffn``).  Returns ({kernel: the cell's error}, timing
    rows, {mode: launch counts})."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    errs = {"mla_decode_attention": _check_mla_decode(torch, dev, gen),
            MLA_PREFILL: _check_mla_prefill(torch, dev, gen)}
    rows = [_time_mla_decode(torch, dev, gen), _time_mla_prefill(torch, dev, gen)]
    for row in rows:
        emit({"phase": "timing", **row})
    torch.cuda.empty_cache()
    cfg = get_config(MLA_ARCH)
    params = M.init_params(cfg, 0, device=dev)
    counts, _, _ = phase_side_continuous(torch, dev, cfg, params,
                                         "mla_continuous")
    for mode, c in counts.items():
        n = cfg.num_layers * SIDE_REQUESTS
        require(c["prefill_attention"] == n, f"mla_continuous {mode}: "
                f"prefill_attention launched {c['prefill_attention']} times, "
                f"expected {n} ({cfg.num_layers} layers, {SIDE_REQUESTS} "
                "prefills)")
    counts["longdoc"], (xt, ids) = _sorted_prefill(torch, dev, cfg, params)
    errs[MLA_SORTED], row = _check_sorted_ffn(torch, dev, cfg, params, xt, ids)
    rows.append(row)
    del params, xt, ids
    return errs, rows, counts


# ---------------------------------------------------------------------------
# The SSM path: falcon-mamba-7b; then the hybrid zamba2-2.7b
# ---------------------------------------------------------------------------
def _scan_case(torch, gen, B, S, di, N, dev, pure_decay=False):
    """decay in [0.5, 0.999), bx ~ N(0, 0.1^2), h0 ~ N(0, 1) (the JAX
    suite's draws); ``pure_decay``: decay 0.99, bx 0, h0 1."""
    if pure_decay:
        decay = torch.full((B, S, di, N), 0.99, device=dev)
        return decay, torch.zeros_like(decay), torch.ones((B, di, N), device=dev)
    decay = torch.rand((B, S, di, N), generator=gen, device=dev) * 0.499 + 0.5
    bx = torch.randn((B, S, di, N), generator=gen, device=dev) * 0.1
    return decay, bx, torch.randn((B, di, N), generator=gen, device=dev)


def phase_ssm_kernel_checks(torch, dev, cfg, slice_summary):
    """ssm_scan against its plain version at every (B, S, di, N) the slice
    and the continuous path's B=1 admission prefills ran, at ragged shapes (S 1 and 300, di 100 and 101, N 3: the float4 and
    the scalar path) and the pure-decay case, h0 non-zero, f32 within 1e-5
    of the largest |h| (both sum in the same order, so they should agree
    bit for bit).  Returns the largest main-path abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    di, N = cfg.d_inner, cfg.ssm_state
    cases = [("main-path", B, PROMPT_LEN, di, N)      # slice; B=1: admission
             for B in _batch_sizes(slice_summary) + [1]]
    cases += [("ragged", 3, 1, 100, 3), ("ragged", 2, 300, 100, 3),
              ("ragged-scalar", 2, 300, 101, 3), ("pure-decay", 1, 128, 256, 8)]
    results, main_err = [], 0.0
    for name, B, S, d, n in cases:
        decay, bx, h0 = _scan_case(torch, gen, B, S, d, n, dev,
                                   pure_decay=name == "pure-decay")
        got = ssm_scan_cuda(decay, bx, h0)
        want = ref.ssm_scan_ref(decay, bx, h0)
        torch.cuda.synchronize()
        tag = f"ssm_scan {name} B={B} S={S} di={d} N={n}"
        require(all(g.shape == w.shape and g.dtype == torch.float32
                    and bool(torch.isfinite(g).all()) for g, w in zip(got, want)),
                f"{tag}: bad output")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = float(want[0].abs().max())
        require(err <= SCAN_TOL * max(scale, 1e-30),
                f"{tag}: max_abs_err {err} > {SCAN_TOL} x max|h| {scale}")
        row = {"case": name, "B": B, "S": S, "di": d, "N": n,
               "max_abs_err": err, "max_abs_h": scale,
               "exact": all(torch.equal(g, w) for g, w in zip(got, want))}
        if name == "pure-decay":
            decay_err = float((got[1] - 0.99 ** S).abs().max())
            require(decay_err <= 1e-3 * 0.99 ** S,
                    f"{tag}: h_last differs from 0.99^S by {decay_err}")
            row["pure_decay_err"] = decay_err
        if name == "main-path":
            main_err = max(main_err, err)
        results.append(row)
        del decay, bx, h0, got, want
    emit({"phase": "ssm_kernels", "kernel": "ssm_scan", "dtype": "float32",
          "tolerance": f"{SCAN_TOL} x max|h|", "cases": results})
    return {"ssm_scan": main_err}


def phase_ssm_parity(torch, dev, cfg, params, prompts):
    """A 2-layer float32 cut of the slice's weights at full width: the
    kernel path against the plain path, prefill logits and states and 8
    teacher-forced decode steps' logits within 1e-3 (the prefill states
    come from ssm_scan or its plain version; decode steps them with
    mamba1_step on both paths); then macro_steps 8 and 0 at full depth in
    bf16 give identical streams."""
    from repro_torch.core.offload import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                            seed_cache)

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:2].float(), params["blocks"])
    B = 4
    tokens = torch.as_tensor(prompts[:B], device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        lk, pre_k = make_prefill_step(cfg2, use_kernels=True)(p32, {"tokens": tokens})
        launched = ops.launch_counts()["ssm_scan"]
        lp, pre_p = make_prefill_step(cfg2, use_kernels=False)(p32, {"tokens": tokens})
        require(launched == 2 and ops.launch_counts()["ssm_scan"] == 2,
                f"the kernel prefill launched ssm_scan {launched} times, the "
                "plain one must launch none (2-layer cut: expected 2)")
        errs = [float((lk - lp).abs().max())]
        state_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(pre_k, pre_p))
        caches = [seed_cache(cfg2, M.init_cache(cfg2, B, S_MAIN, device=dev),
                             pre, PROMPT_LEN) for pre in (pre_p, pre_k)]
        del pre_k, pre_p
        plain = make_serve_step(cfg2, use_kernels=False)
        kern = make_serve_step(cfg2, use_kernels=True)
        tok = lp.argmax(dim=-1).to(torch.int32)
        for i in range(8):
            lengths = torch.full((B,), PROMPT_LEN + i, dtype=torch.int32, device=dev)
            lp, _ = plain(p32, caches[0], tok[:, None], lengths)
            lk, _ = kern(p32, caches[1], tok[:, None], lengths)
            errs.append(float((lk - lp).abs().max()))
            tok = lp.argmax(dim=-1).to(torch.int32)
        del caches, p32
    require(max(errs) <= 1e-3 and state_err <= 1e-3,
            f"{cfg.name}: kernel and plain paths differ: logits {errs}, "
            f"prefill states {state_err} (tolerance 1e-3)")
    same = _macro_streams_equal(torch, dev, cfg, params, prompts[:B], MAX_NEW)
    emit({"phase": "ssm_parity", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "requests": B,
          "prefill_and_teacher_forced_max_abs": errs,
          "prefill_state_max_abs": state_err, "tolerance": 1e-3,
          "macro_8_equals_0": same, "macro_check_dtype": "bfloat16",
          "macro_check_layers": cfg.num_layers})


def phase_ssm_timing(torch, dev, cfg):
    """ssm_scan and its plain version at the auxiliary group's prefill
    shape (B=11: [11,128,8192,16] f32, 1.48 GB of inputs a call), cycling
    through more input sets than L2 holds; ``device_ms`` from ``_device_ms``
    (the plain version's 384 launches a call allow one call a loop)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B = TIMED_GROUPS["auxiliary"]
    S, di, N = PROMPT_LEN, cfg.d_inner, cfg.ssm_state
    C = di * N
    sets = [_scan_case(torch, gen, B, S, di, N, dev)
            for _ in range(_sets_for(4 * B * C * (2 * S + 1)))]
    fns = {"": ssm_scan_cuda, "plain_": ref.ssm_scan_ref}
    times = {f"{p}ms": _time_ms(torch, fn, sets, iters=40, warmup=4)
             for p, fn in fns.items()}
    times["device_ms"] = _device_ms(torch, ssm_scan_cuda, sets, iters=10)
    times["plain_device_ms"] = _device_ms(torch, ref.ssm_scan_ref, sets, iters=1,
                                          need_ahead=False)
    cost = costs.ssm_scan(B, S, di, N)    # decay, bx, h_all; h0, h_last (f32)
    n_bytes, n_ops = cost["bytes"], cost["flops"]
    bound_ms, bound_by = _bound(n_bytes, n_ops, H100_PEAK_FLOPS_F32)
    row = {"kernel": "ssm_scan", "step": "prefill", "group": "auxiliary",
           "B": B, "S": S, "di": di, "N": N, "dtype": "float32", **times,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this recurrence",
           "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
           "bound_by": bound_by, "sets": len(sets)}
    emit({"phase": "ssm_timing", "arch": cfg.name, **row})
    return [row]


def phase_hybrid(torch, dev):
    """zamba2-2.7b at full width through the launcher (--split none), its
    decode_attention launches held to 9 shared-block calls a decode step;
    decode_attention against its plain version at zamba2's head shape
    (H=Hkv=32, dh=80); macro_steps 8 and 0 give identical bf16 streams.
    Returns (launch counts, {kernel: main-path error}, the slice's streams
    {uid: tokens})."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(HYBRID_ARCH)
    summary, counts = phase_slice(torch, HYBRID_ARCH, phase="hybrid_slice",
                                  split="none", requests=HYBRID_REQUESTS,
                                  max_new=HYBRID_MAX_NEW)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    err = _check_decode_attention(torch, dev, gen, [HYBRID_REQUESTS],
                                  cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                  "hybrid_kernels")
    params = M.init_params(cfg, 0, device=dev)          # the slice's weights
    prompts = _prompts(cfg)[:HYBRID_REQUESTS]
    same = _macro_streams_equal(torch, dev, cfg, params, prompts, HYBRID_MAX_NEW)
    emit({"phase": "hybrid_parity", "arch": cfg.name, "requests": HYBRID_REQUESTS,
          "macro_8_equals_0": same, "dtype": "bfloat16",
          "layers": cfg.num_layers})
    del params
    return counts, {"decode_attention": err}, \
        {u: t.tolist() for u, t in enumerate(summary["tokens"])}


# ---------------------------------------------------------------------------
# Continuous serving: llama3.2-1b with the prefix cache and disaggregated
# prefill; then short continuous runs on the MoE and SSM paths
# ---------------------------------------------------------------------------
def _continuous_requests(cfg, n_requests=CONT_REQUESTS, most_new=CONT_MAX_NEW):
    """llama's continuous traffic from request_stream(seed=0): 4 shared
    64-token prefixes (the first 4 prompts, tiled), each followed by
    distinct suffixes (the next ``n_requests`` prompts, cut to 8-192
    tokens), so the prompts run 72-256 tokens, right-padded with 0 to 256
    (the engine takes one prompt length); the last request repeats the one
    before it exactly (a full hit at 24 requests: the 256-block budget has
    evicted the earliest prompts' tails by then); max_new from
    default_rng(0) over 1-``most_new``, with both ends (24 requests over
    1-48 on the continuous path, 64 over 1-32 on the fleet paths)."""
    from repro_torch.data.pipeline import request_stream
    from repro_torch.serving.engine import ServeRequest
    stream = request_stream(cfg.vocab_size, n=4 + n_requests,
                            mean_prompt=PROMPT_LEN, seed=0)
    prompts = []
    for i in range(n_requests):
        body = stream[4 + i].prompt
        n = int(np.clip(len(body), CONT_MIN_PROMPT - CONT_PREFIX,
                        CONT_P - CONT_PREFIX))
        prompts.append(np.concatenate([np.resize(stream[i % 4].prompt, CONT_PREFIX),
                                       np.resize(body, n)]))
    prompts[-1] = prompts[-2].copy()
    max_news = np.random.default_rng(0).integers(1, most_new + 1, n_requests)
    max_news[1], max_news[2] = 1, most_new
    return [ServeRequest(uid=i, max_new=int(m), prompt=np.pad(
        p, (0, CONT_P - len(p))).astype(np.int32))
        for i, (p, m) in enumerate(zip(prompts, max_news))]


def _run_engine(torch, dev, cfg, params, reqs, **kw):
    """One ContinuousServingEngine run, its launch counts set to 0 just
    before and read just after.  Returns (outputs, stats, counts, wall,
    peak memory)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousServingEngine
    eng = ContinuousServingEngine(cfg, params, device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs, stats = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return outs, stats, counts, wall, torch.cuda.max_memory_allocated()


def _model_decode_steps(stats, K):
    """Model decode steps an engine ran: K per fused macro-step (frozen
    slots included), one per per-step iteration."""
    return stats.macro_dispatches * K if K else stats.decode_steps


def _first_diff(a, b):
    """The first position where two token streams differ (None: equal)."""
    n = min(len(a), len(b))
    diff = np.nonzero(a[:n] != b[:n])[0]
    if diff.size:
        return int(diff[0])
    return None if len(a) == len(b) else n


def _stats_row(stats, wall, peak, counts, K):
    keys = ("total_tokens", "decode_steps", "tokens_per_s", "prefill_s",
            "decode_s", "t_dispatch_s", "t_await_s", "t_prefill_overlap_s",
            "t_splice_s", "t_slot_write_s", "t_kv_transfer_s", "host_syncs",
            "macro_dispatches", "wave_launches", "admission_stalls",
            "shadow_prefills", "prefill_offloaded", "prefill_fallbacks",
            "prefix_hits", "prefix_blocks_reused", "prefill_flops_avoided",
            "prefill_flops_total", "kv_hop_bytes_raw", "kv_hop_bytes_wire",
            "occupancy")
    return {**{k: getattr(stats, k) for k in keys}, "wall_s": wall,
            "peak_memory_bytes": peak, "launches": counts,
            "model_decode_steps": _model_decode_steps(stats, K)}


CONT_MODES = [("per-step", dict(macro_steps=0), None),
              ("boundary", dict(overlap_admission=False), None),
              ("overlapped", {}, None),
              ("overlapped-wave2", dict(wave_steps=2), None),
              ("prefix-cache", {}, "cache"),
              ("disaggregated", {}, "worker"),
              ("disaggregated-lossy", {}, "lossy")]


def phase_continuous(torch, dev, cfg, params):
    """llama3.2-1b at full width and depth through ContinuousServingEngine
    (slots 8, max_len 512, K=8) in seven modes on the same 24 requests:
    per-step, boundary, overlapped, overlapped with wave_steps=2, overlapped
    with a PrefixCache(block_size=8, budget_blocks=256), the same with a
    PrefillWorker on the card (disaggregated, lossless hop) and with
    kv_keep_rate=0.72 (lossy).  Checks: the streams of modes 1-6 identical
    request by request; decode_attention launched layers x model decode
    steps in every mode; masked_compact 2 x the remote partial hits in the
    disaggregated modes (0 elsewhere), counted as the hops that shipped a
    KV tail.  Returns ({mode: launch counts}, the per-step mode's streams by
    uid, {mode: its row})."""
    import repro_torch.core as C
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache

    class HopCountingWorker(PrefillWorker):
        """Counts the fetches that ship a resumed prefill's KV tail (each
        compacts K and V with masked_compact)."""
        hops = 0

        def fetch(self, logits, cache=None, *, target=None, prefix=None):
            if prefix is not None and cache is not None:
                self.hops += 1
            return super().fetch(logits, cache, target=target, prefix=prefix)

    reqs = _continuous_requests(cfg)
    K, L = MACRO, cfg.num_layers
    base = dict(slots=CONT_SLOTS, max_len=CONT_MAX_LEN, macro_steps=K)
    ref, counts_by_mode, rows_by_mode = None, {}, {}
    for name, kw, extra in CONT_MODES:
        pc = worker = None
        if extra:
            pc = PrefixCache(cfg, block_size=8, budget_blocks=256, device=dev)
        if extra in ("worker", "lossy"):
            worker = HopCountingWorker(
                cfg, params, device=dev, link=C.ICI_LINK,
                kv_keep_rate=0.72 if extra == "lossy" else None)
            require(worker.params["embed"]["table"] is params["embed"]["table"],
                    "the prefill worker copied the params")
        outs, stats, counts, wall, peak = _run_engine(
            torch, dev, cfg, params, reqs, **{**base, **kw}, prefix_cache=pc,
            prefill_worker=worker)
        k = kw.get("macro_steps", K)
        steps = _model_decode_steps(stats, k)
        require(stats.requests == len(reqs) and stats.total_tokens
                == sum(r.max_new for r in reqs), f"continuous {name}: "
                f"{stats.requests} requests, {stats.total_tokens} tokens")
        require(all(0 <= int(t) < cfg.vocab_size for o in outs for t in o.tokens),
                f"continuous {name}: token ids out of range")
        require(counts["decode_attention"] == L * steps,
                f"continuous {name}: decode_attention launched "
                f"{counts['decode_attention']} times, expected {L} x {steps}")
        hops = worker.hops if worker is not None else 0
        require(counts["masked_compact"] == 2 * hops,
                f"continuous {name}: masked_compact launched "
                f"{counts['masked_compact']} times, expected 2 x {hops} remote "
                "partial hits that shipped a KV tail")
        require(counts["grouped_ffn"] == counts["ssm_scan"] == 0,
                f"continuous {name}: MoE/SSM kernels launched: {counts}")
        if pc is not None:
            # with local prefill every request but the 4 first of a prefix
            # hits, the duplicate in full; remote blocks are indexed only
            # when fetched, so the disaggregated modes hit less
            require(stats.prefix_hits > 0 and (worker is not None or (
                stats.prefix_hits == CONT_REQUESTS - 4 and pc.full_hits == 1)),
                f"continuous {name}: {stats.prefix_hits} prefix hits, "
                f"{pc.full_hits} full")
            pc.check_invariants()
        if worker is not None:
            require(hops > 0 and stats.prefill_fallbacks == 0
                    and stats.prefill_offloaded > 0
                    and 0 < stats.kv_hop_bytes_wire < stats.kv_hop_bytes_raw,
                    f"continuous {name}: offloaded {stats.prefill_offloaded}, "
                    f"fallbacks {stats.prefill_fallbacks}, hop bytes "
                    f"{stats.kv_hop_bytes_wire} of {stats.kv_hop_bytes_raw}")
        streams = {o.uid: o.tokens for o in outs}
        row = {"phase": "continuous", "mode": name, "arch": cfg.name,
               "slots": CONT_SLOTS, "max_len": CONT_MAX_LEN, "macro_steps": k,
               "requests": len(reqs), **_stats_row(stats, wall, peak, counts, k),
               "prefix_cache": pc.stats() if pc is not None else None,
               "remote_partial_hits_shipped": hops}
        if ref is None:
            ref = streams
        else:
            diffs = {uid: _first_diff(ref[uid], streams[uid]) for uid in ref}
            diffs = {uid: d for uid, d in diffs.items() if d is not None}
            row["requests_differing_from_per_step"] = len(diffs)
            row["first_differences"] = dict(list(diffs.items())[:8])
            if extra != "lossy":
                require(not diffs, f"continuous {name}: streams differ from "
                        f"the per-step mode at {diffs}")
        emit(row)
        counts_by_mode[name] = counts
        rows_by_mode[name] = row
        del outs, pc, worker
        torch.cuda.empty_cache()
    return counts_by_mode, ref, rows_by_mode


def phase_continuous_checks(torch, dev, cfg, params):
    """Around the continuous path: one lossless compact_kv_hop ->
    restore_kv_hop at llama's real tail gives the prefill cache back bit
    for bit; the resumed prefill against the cold one (bf16, reported);
    decode_attention at the slot width over the 512-row cache and
    masked_compact at the hop's [16, 192, 512] shape against their plain
    versions; the tail's .contiguous() copy timed; a float32 2-layer cut's
    continuous streams equal to the plain static path's up to the first
    top-2 gap < 1e-3.  Returns {kernel: max error}."""
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.serving.prefix_cache import compact_kv_hop, restore_kv_hop

    reqs = _continuous_requests(cfg)
    req = reqs[4]                         # a partial hit on prefix 0
    tokens = torch.as_tensor(req.prompt[None], device=dev)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
        prefix = {"self": {n: t[:, :, :CONT_PREFIX].clone()
                           for n, t in cache["self"].items()}}
        packed, wire = compact_kv_hop(cache, CONT_PREFIX)
        restored = restore_kv_hop(packed, prefix)
        torch.cuda.synchronize()
        exact = all(torch.equal(restored["self"][n], cache["self"][n])
                    for n in ("k", "v"))
        require(exact, "the lossless KV hop did not restore the prefill cache "
                "bit for bit")
        raw = sum(t.numel() * t.element_size() for t in cache["self"].values())
        del restored, packed, cache
    emit({"phase": "continuous_checks", "check": "kv_hop", "arch": cfg.name,
          "q_rows": CONT_PREFIX, "rows": CONT_P, "lossless_bit_exact": exact,
          "wire_bytes": wire, "raw_kv_bytes": raw, "resume_vs_cold_bf16":
          _resume_vs_cold(torch, dev, cfg, params, req, CONT_PREFIX)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    att_err = _check_decode_attention(torch, dev, gen, [CONT_SLOTS],
                                      cfg.num_heads, cfg.num_kv_heads,
                                      cfg.head_dim, "continuous_kernels",
                                      S_main=CONT_MAX_LEN, edge_cases=False)
    D = cfg.num_kv_heads * cfg.head_dim
    hop = (cfg.num_layers, CONT_P - CONT_PREFIX, D)
    mc = [_check_mc_at(torch, dev, gen, f"kv-hop-{kind}", *hop, kind)
          for kind in ("all", "make_mask")]
    emit({"phase": "continuous_kernels", "kernel": "masked_compact",
          "tolerance": "exact", "cases": mc})
    emit({"phase": "continuous_timing", **_time_tail_copy(torch, dev, gen, cfg)})
    parity = _continuous_parity(torch, dev, cfg, params, reqs)
    emit({"phase": "continuous_parity", **parity})
    return {"decode_attention": att_err, "masked_compact": 0.0}


def _check_mc_at(torch, dev, gen, name, B, S, D, kind):
    """masked_compact at [B,S,D] bf16 (mask ``kind`` of ``_mc_case``) against
    its plain version, bit for bit: the plan's branch twice and the other
    base-finding branch once."""
    from repro_torch.kernels import masked_compact as mc
    from repro_torch.kernels import ref
    toks, mask, K = _mc_case(torch, gen, dev, B, S, D, kind)
    plan = mc.masked_compact_plan(B, S, D * toks.element_size(), K)
    other = mc.masked_compact_plan(B, S, D * toks.element_size(), K,
                                   long_rows=not plan.long_rows)
    got = mc.masked_compact_cuda(toks, mask, K)
    again = mc.masked_compact_cuda(toks, mask, K)
    branch = mc.masked_compact_cuda(toks, mask, K, plan=other)
    want = ref.masked_compact_ref(toks, mask, K)
    torch.cuda.synchronize()
    for what, res in (("first call", got), ("second call", again),
                      ("other branch", branch)):
        require(all(torch.equal(a, b) for a, b in zip(res, want)),
                f"masked_compact {name} [{B},{S},{D}] K={K}: {what} differs "
                "from the plain version")
    return {"case": name, "B": B, "S": S, "D": D, "K": K, "dtype": "bfloat16",
            "kept": int(mask.sum()), "exact": True, "bit_equal_twice": True,
            "other_branch_exact": True}


def _time_tail_copy(torch, dev, gen, cfg):
    """The KV hop's tail of a [L,1,S,Hkv,dh] bf16 cache is a strided view;
    compact_kv_hop copies it contiguous for masked_compact.  That copy at
    llama's timed hop (q 64 rows, Rt 2048: ``KV_HOP``), beside the bytes
    bound."""
    from repro_torch.core.profiler import H100_HBM_BW
    L, Rt, D = cfg.num_layers, KV_HOP[1], cfg.num_kv_heads * cfg.head_dim
    S = CONT_PREFIX + Rt
    per_set = L * S * D * 2
    sets = [(torch.randn((L, 1, S, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                         device=dev).to(torch.bfloat16),)
            for _ in range(_sets_for(per_set))]

    def copy(leaf):
        return leaf[:, 0, CONT_PREFIX:].reshape(L, Rt, D).contiguous()

    n_bytes = 2 * L * Rt * D * 2                  # the tail read, the copy written
    times = {"ms": _time_ms(torch, copy, sets),
             "device_ms": _device_ms(torch, copy, sets, iters=50)}
    return {"kernel": "kv_hop_tail_copy", "group": "kv_hop_lossless",
            "shape": [L, Rt, D], "q_rows": CONT_PREFIX, "dtype": "bfloat16",
            **times, "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / H100_HBM_BW,
            "bound_by": "bytes", "sets": len(sets)}


def _continuous_parity(torch, dev, cfg, params, reqs):
    """A float32 2-layer cut of the weights: the plain static path (one
    batch, kernels off, per-token steps, each step's top-2 gap recorded)
    against the overlapped continuous engine (kernels on): each request's
    stream equal up to the first top-2 gap < 1e-3."""
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    from repro_torch.serving.engine import make_prefill_step, make_serve_step, seed_cache

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:2].float(), params["blocks"])
    B, max_new = len(reqs), max(r.max_new for r in reqs)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]), device=dev)
    with torch.no_grad():
        last, pre = make_prefill_step(cfg2, use_kernels=False)(p32, {"tokens": tokens})
        cache = seed_cache(cfg2, M.init_cache(cfg2, B, CONT_MAX_LEN, device=dev),
                           pre, CONT_P)
        del pre
        step = make_serve_step(cfg2, use_kernels=False)
        tok = last.argmax(dim=-1).to(torch.int32)
        stream, gaps = [tok], [_top2_gap(torch, last)]
        for i in range(max_new - 1):
            lengths = torch.full((B,), CONT_P + i, dtype=torch.int32, device=dev)
            lp, cache = step(p32, cache, tok[:, None], lengths)
            tok = lp.argmax(dim=-1).to(torch.int32)
            stream.append(tok)
            gaps.append(_top2_gap(torch, lp))
        plain = torch.stack(stream, dim=1).cpu().numpy()
        gaps = torch.stack(gaps, dim=1).cpu().numpy()
        del cache
    outs, stats, counts, _, _ = _run_engine(
        torch, dev, cfg2, p32, reqs, slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
        macro_steps=MACRO, use_kernels=True)
    require(counts["decode_attention"] == 2 * _model_decode_steps(stats, MACRO),
            f"continuous parity: decode_attention launched {counts}")
    first_mismatch, first_low_gap = {}, {}
    for o in outs:
        n = len(o.tokens)
        diff = np.nonzero(o.tokens != plain[o.uid, :n])[0]
        low = np.nonzero(gaps[o.uid, :n] < 1e-3)[0]
        m = int(diff[0]) if diff.size else None
        g = int(low[0]) if low.size else None
        first_mismatch[o.uid], first_low_gap[o.uid] = m, g
        require(m is None or (g is not None and m >= g),
                f"continuous parity, request {o.uid}: the continuous stream "
                f"leaves the static one at {m} before any top-2 gap < 1e-3 "
                f"(first at {g})")
    del p32
    return {"arch": cfg.name, "layers": 2, "dtype": "float32",
            "requests": B, "mismatching_requests":
            sum(m is not None for m in first_mismatch.values()),
            "first_mismatch": first_mismatch,
            "first_top2_gap_below_1e-3": first_low_gap,
            "min_top2_gap": float(gaps.min())}


def phase_side_continuous(torch, dev, cfg, params, phase):
    """A short continuous run on a path whose params are loaded (moonshot:
    MoE, falcon-mamba: SSM): slots 4, 6 requests of 128 prompt tokens,
    max_new <= 8, in per-step, boundary and overlapped modes.  Checks the
    streams identical across modes and the launches: grouped_ffn in every
    MoE layer of each B=1 admission prefill and each model decode step,
    ssm_scan in every Mamba-1 layer of each B=1 prefill.  Returns {mode:
    launch counts}, the streams (uid -> tokens) and {mode: stats row}."""
    from repro_torch.serving.engine import ServeRequest

    prompts = _prompts(cfg)[:SIDE_REQUESTS]
    max_news = SIDE_MAX_NEWS
    reqs = [ServeRequest(uid=i, prompt=prompts[i], max_new=m)
            for i, m in enumerate(max_news)]
    ref, counts_by_mode, rows = None, {}, {}
    for name, kw, _ in CONT_MODES[:3]:
        kw = {"macro_steps": MACRO, **kw}
        outs, stats, counts, wall, peak = _run_engine(
            torch, dev, cfg, params, reqs, slots=SIDE_SLOTS,
            max_len=PROMPT_LEN + SIDE_MAX_NEW + 8, **kw)
        steps = _model_decode_steps(stats, kw["macro_steps"])
        want = _expected_launches(cfg, {"decode_steps": steps,
                                        "prefills": len(reqs)}, PROMPT_LEN)
        for kname, n in want.items():
            require(counts[kname] == n, f"{phase} {name}: {kname} launched "
                    f"{counts[kname]} times, expected {n} ({cfg.num_layers} "
                    f"layers, {steps} decode steps, {len(reqs)} prefills)")
        require(stats.total_tokens == sum(max_news),
                f"{phase} {name}: {stats.total_tokens} tokens")
        streams = {o.uid: o.tokens for o in outs}
        if ref is None:
            ref = streams
        require(all(np.array_equal(ref[u], streams[u]) for u in ref),
                f"{phase} {name}: streams differ from the per-step mode")
        rows[name] = _stats_row(stats, wall, peak, counts, kw["macro_steps"])
        emit({"phase": phase, "mode": name, "arch": cfg.name,
              "slots": SIDE_SLOTS, "requests": len(reqs), "max_news": max_news,
              **rows[name], "expected_launches": want,
              "streams_equal_per_step": True})
        counts_by_mode[name] = counts
    return counts_by_mode, {u: t.tolist() for u, t in ref.items()}, rows


# ---------------------------------------------------------------------------
class _FleetRecorder:
    """While active: every ContinuousServingEngine.run's stats, K and
    decode shape (slots, cache rows; the runtime's warmup runs included),
    the shape of every resumed prefill's KV tail a prefill worker ships
    (compact_kv_hop compacts its K and V with masked_compact), and the host
    ms and result of every solve_star call the split controller makes.
    The wrapped functions are called as they are; the recorder only reads
    what goes in and out."""

    def __enter__(self):
        from repro_torch.core import scheduler
        from repro_torch.serving import engine, prefill
        self.runs, self.hops, self.solves = [], [], []
        rec = self
        self._saved = [(engine.ContinuousServingEngine, "run",
                        engine.ContinuousServingEngine.run),
                       (prefill, "compact_kv_hop", prefill.compact_kv_hop),
                       (scheduler, "solve_star", scheduler.solve_star)]
        run, hop, solve = (f for _, _, f in self._saved)

        def run_rec(eng, *a, **kw):
            outs, stats = run(eng, *a, **kw)
            rec.runs.append((stats, eng.macro_steps, (eng.slots, eng.max_len)))
            return outs, stats

        def hop_rec(cache, q_rows, *, keep_rate=None):
            k = cache["self"]["k"]                  # [L, 1, S, Hkv, dh]
            rec.hops.append((k.shape[0], k.shape[2] - q_rows,
                             k.shape[3] * k.shape[4]))
            return hop(cache, q_rows, keep_rate=keep_rate)

        def solve_rec(fn, n, **kw):
            t0 = time.perf_counter()
            f, t = solve(fn, n, **kw)
            rec.solves.append({"host_ms": 1e3 * (time.perf_counter() - t0),
                               "fractions": [float(x) for x in f]})
            return f, t

        engine.ContinuousServingEngine.run = run_rec
        prefill.compact_kv_hop = hop_rec
        scheduler.solve_star = solve_rec
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def model_decode_steps(self) -> int:
        return sum(_model_decode_steps(st, k) for st, k, _ in self.runs)


def _fleet_requests(cfg):
    """The fleet paths' 64 requests as the launcher takes them (a
    request_stream-shaped record each; prompts already 256 tokens)."""
    from repro_torch.data.pipeline import Request
    return [Request(uid=r.uid, arrival_s=0.0, prompt=r.prompt,
                    max_new_tokens=r.max_new)
            for r in _continuous_requests(cfg, FLEET_REQUESTS, FLEET_MAX_NEW)]


def phase_fleet_reference(torch, dev, cfg, params):
    """The fleet paths' reference streams: one ContinuousServingEngine
    (slots 4, per-step, the launcher's 296 cache rows) over the same 64
    requests."""
    from repro_torch.serving.engine import ServeRequest
    reqs = [ServeRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new_tokens)
            for r in _fleet_requests(cfg)]
    outs, stats, counts, wall, peak = _run_engine(
        torch, dev, cfg, params, reqs, slots=FLEET_SLOTS,
        max_len=FLEET_MAX_LEN, macro_steps=0)
    require(stats.total_tokens == sum(r.max_new for r in reqs),
            f"fleet reference: {stats.total_tokens} tokens")
    emit({"phase": "fleet_reference", "arch": cfg.name, "slots": FLEET_SLOTS,
          "macro_steps": 0, "requests": len(reqs),
          **_stats_row(stats, wall, peak, counts, 0)})
    return {o.uid: o.tokens for o in outs}


def _check_fleet_streams(name, streams, ref):
    require(sorted(streams) == sorted(ref),
            f"{name}: served uids {sorted(streams)} are not each request once")
    diffs = {uid: _first_diff(ref[uid], np.asarray(streams[uid]))
             for uid in ref}
    diffs = {uid: d for uid, d in diffs.items() if d is not None}
    require(not diffs, f"{name}: streams differ from the per-step engine's "
            f"(uid: first position) {diffs}")


def _check_fleet_launches(name, cfg, counts, rec):
    steps = rec.model_decode_steps()
    want = cfg.num_layers * steps
    require(counts["decode_attention"] == want,
            f"{name}: decode_attention launched {counts['decode_attention']} "
            f"times, expected {cfg.num_layers} x {steps} model decode steps "
            f"over {len(rec.runs)} engine runs")
    require(counts["masked_compact"] == 2 * len(rec.hops),
            f"{name}: masked_compact launched {counts['masked_compact']} times, "
            f"expected 2 x {len(rec.hops)} hops that shipped a KV tail")
    require(counts["grouped_ffn"] == counts["ssm_scan"]
            == counts["ssm_scan_bwd"] == 0,
            f"{name}: MoE/SSM kernels launched: {counts}")
    return steps


def _waves_row(tel):
    return [{"wave": w["wave"], "n": w["n"], "split": w["split"],
             "counts": w["counts"], "wall_s": w["wall_s"],
             "tokens": w["tokens"], "host_syncs": w["host_syncs"],
             "prefill_route": w["prefill_route"],
             "group_wall_s": {g: pg["wall_s"] for g, pg in w["per_group"].items()}}
            for w in tel["waves"]]


def phase_fleet_static(torch, dev, cfg):
    """The launcher's static star: --topology star --nodes 3 --split auto
    (probe -> fit -> solve_star -> SplitVector -> each spoke's §VI payload
    -> OffloadEngine) on llama3.2-1b, 16 x 128 tokens, 32 new.  Checks
    decode_attention == layers x decode steps and masked_compact == the
    spokes that got requests; then decode_attention against its plain
    version at the probe's and each group's batch over the engines' cache,
    and masked_compact bit for bit at each spoke's payload [n, 128, d].
    Returns (the launch counts, {kernel: max main-path error})."""
    s, counts = phase_slice(torch, ARCH, phase="fleet_static",
                            extra=("--topology", "star", "--nodes", "3"))
    spokes = [n for g, n in zip(s["group_names"][1:], s["n_group"][1:]) if n]
    require(len(s["f_star"]) == 3 and abs(sum(s["split"]) - 1.0) < 1e-6,
            f"fleet_static: split {s['split']}")
    require(counts["masked_compact"] == len(spokes) == len(s["compression_by_group"]),
            f"fleet_static: masked_compact launched {counts['masked_compact']} "
            f"times for {len(spokes)} spokes with requests")
    emit({"phase": "fleet_static_split", "f_star": s["f_star"],
          "solve_star_ms": s["solve_star_ms"], "t_parallel_s": s["t_parallel_s"],
          "t_serial_s": s["t_serial_s"], "n_group": s["n_group"],
          "compression_by_group": s["compression_by_group"]})
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    err = _check_decode_attention(torch, dev, gen, _batch_sizes(s),
                                  cfg.num_heads, cfg.num_kv_heads,
                                  cfg.head_dim, "fleet_static_kernels",
                                  edge_cases=False)
    mc = [_check_mc_at(torch, dev, gen, f"payload-spoke-{n}", n, PROMPT_LEN,
                       cfg.d_model, "keep72") for n in sorted(set(spokes))]
    emit({"phase": "fleet_static_kernels", "kernel": "masked_compact",
          "tolerance": "exact", "cases": mc})
    return counts, {"decode_attention": err, "masked_compact": 0.0}


def phase_fleet(torch, dev, cfg, params, ref, phase):
    """llama3.2-1b at full width through the launcher's serve_continuous
    over HeteroRuntime on the card, with split "auto" (the live
    controller), slots 4 per group, K=8, overlapped admission, 296 cache rows,
    on the 64 requests; the launch counts set to 0 just before and read
    just after.  ``phase``: fleet_star (a 3-group star: waves of 16, the
    controller re-solves with solve_star), fleet_disagg (a 4-group star
    whose spoke 3 prefills, a PrefixCache of 256 blocks of 8 and a 2-worker
    PrefillWorkerPool; KV hops on masked_compact) or fleet_frontend (the
    3-group star behind ServingFrontend, tenants interactive:0:2:0.5 and
    batch:1:1, queue depth 64).  Checks every uid served once with the
    per-step reference's stream, decode_attention == layers x the model
    decode steps of every engine run, masked_compact == 2 x the hops that
    shipped a tail; per phase, a star re-solve on the simplex, prefix hits,
    no refusal.  Returns (the launch counts, the shapes the kernels ran at:
    {"decode": {(slots, cache rows)}, "hops": {(layers, tail rows,
    width)}})."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    reqs = _fleet_requests(cfg)
    kw = dict(prompt_len=CONT_P, max_new=FLEET_MAX_NEW, slots=FLEET_SLOTS,
              split="auto", macro_steps=MACRO, device=dev)
    if phase == "fleet_disagg":
        kw.update(topology=serve.build_topology("star", 4, prefill_group=3,
                                                device=dev),
                  prefix_cache_blocks=256, prefix_block_size=8, prefill_pool=2)
    else:
        kw.update(topology=serve.build_topology("star", 3, device=dev))
    if phase == "fleet_frontend":
        kw.update(frontend=True, tenants=serve.parse_tenants(FLEET_TENANTS),
                  queue_depth=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _FleetRecorder() as rec:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = serve.serve_continuous(cfg, params, reqs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = _check_fleet_launches(phase, cfg, counts, rec)
    shapes = {"decode": {shape for _, _, shape in rec.runs},
              "hops": set(rec.hops)}
    row = {"phase": phase, "arch": cfg.name, "groups": len(kw["topology"]),
           "slots": FLEET_SLOTS, "macro_steps": MACRO, "requests": len(reqs),
           "wall_s": wall, "peak_memory_bytes": peak, "launches": counts,
           "model_decode_steps": steps, "engine_runs": len(rec.runs),
           "kv_tail_hops": len(rec.hops), "solve_star_calls": rec.solves}
    if phase == "fleet_frontend":
        tel = out["frontend"]
        require(out["refused"] == 0, f"{phase}: {out['refused']} refused")
        _check_fleet_streams(phase, out["streams"], ref)
        row.update(waves_served=tel["waves_served"], runtime=tel["runtime"],
                   tenants={n: {k: t[k] for k in (
                       "submitted", "completed", "ttft_p50_s", "ttft_p99_s",
                       "itl_p50_s", "itl_p99_s")} for n, t in tel["tenants"].items()})
        emit(row)
        return counts, shapes
    tel, tot = out.telemetry, out.telemetry["totals"]
    _check_fleet_streams(phase, {o.uid: o.tokens for o in out.outputs[cfg.name]},
                         ref)
    star_solves = [f for f in rec.solves
                   if min(f["fractions"]) >= 0.0
                   and abs(sum(f["fractions"]) - 1.0) < 1e-5]
    require(star_solves and len(star_solves) == len(rec.solves),
            f"{phase}: solve_star calls {rec.solves} (none, or off the simplex)")
    for w in tel["waves"]:
        require(sum(w["counts"]) == w["n"] and min(w["split"]) >= 0.0
                and abs(sum(w["split"]) - 1.0) < 1e-3,
                f"{phase}: wave {w['wave']} split {w['split']} counts {w['counts']}")
    if phase == "fleet_disagg":
        require(tot["prefix_hits"] > 0 and rec.hops
                and tot["prefill_offloaded"] > 0 and tot["prefill_fallbacks"] == 0,
                f"{phase}: hits {tot['prefix_hits']}, hops {len(rec.hops)}, "
                f"offloaded {tot['prefill_offloaded']}, fallbacks "
                f"{tot['prefill_fallbacks']}")
    row.update({k: tot[k] for k in (
        "tokens", "wall_s", "tok_per_s", "host_syncs", "host_syncs_per_token",
        "admission_stalls", "final_split", "prefill_offloaded",
        "t_kv_transfer_s", "prefix_hits", "prefix_blocks_reused",
        "prefill_flops_avoided_frac", "kv_hop_bytes_raw", "kv_hop_bytes_wire",
        "t_dispatch_s", "t_await_s")}, waves=_waves_row(tel))
    emit(row)
    return counts, shapes


def phase_fleet_kernels(torch, dev, cfg, shapes):
    """With no fleet run in flight: decode_attention against its plain
    version at every (slots, cache rows) the fleet engines decoded at, with
    llama's heads, and masked_compact bit for bit at every KV-tail shape
    [layers, tail rows, Hkv*dh] a fleet hop shipped (all kept, as the
    fleet phases' lossless hops keep them).  Returns {kernel: max
    main-path error}."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    err = 0.0
    for slots, rows in sorted(shapes["decode"]):
        err = max(err, _check_decode_attention(
            torch, dev, gen, [slots], cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, "fleet_kernels", S_main=rows, edge_cases=False))
    mc = [_check_mc_at(torch, dev, gen, "fleet-kv-hop", L, Rt, D, "all")
          for L, Rt, D in sorted(shapes["hops"])]
    emit({"phase": "fleet_kernels", "kernel": "masked_compact",
          "tolerance": "exact", "cases": mc})
    return {"decode_attention": err, "masked_compact": 0.0}


def phase_dense_slices(torch, dev):
    """olmo-1b and nemotron-4-15b at full width and depth through the
    launcher (the same 16 requests x 128 tokens, 32 new, --split auto), one
    after the other, each model's params freed before the next loads; then,
    with no model held, decode_attention against its plain version at each
    group's batch with the model's heads (olmo G=1, nemotron G=6; dh 128)
    and masked_compact bit for bit at the model's §VI payload.  Returns
    ({arch: launch counts}, {kernel: max main-path error})."""
    from repro_torch.configs.base import get_config

    counts_by_arch, errs = {}, {"decode_attention": 0.0, "masked_compact": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        summary, counts = phase_slice(torch, arch, phase="dense_slice")
        counts_by_arch[arch] = counts
        torch.cuda.empty_cache()
        err = _check_decode_attention(torch, dev, gen, _batch_sizes(summary),
                                      cfg.num_heads, cfg.num_kv_heads,
                                      cfg.head_dim, "dense_kernels")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        groups = dict(zip(summary["group_names"], summary["n_group"]))
        B = groups.get("auxiliary") or max(groups.values())
        mc = _check_mc_at(torch, dev, gen, f"payload-{arch}", B, PROMPT_LEN,
                          cfg.d_model, "keep72")
        emit({"phase": "dense_kernels", "arch": arch, "kernel": "masked_compact",
              "tolerance": "exact", "cases": [mc]})
        torch.cuda.empty_cache()
    return counts_by_arch, errs


# ---------------------------------------------------------------------------
# The vlm and audio families and the int8 KV cache
# ---------------------------------------------------------------------------
class _DecodeRecorder:
    """While active: the shape of every decode_attention launch, as
    (B, S, H, Hkv, dh, dtype, whether the length came as a Python int),
    with its count.  The wrapped
    ``ops.decode_attention_cuda`` is called as it is (its own count goes
    on); the recorder only reads what goes in."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.shapes = {}
        self._ops, self._fn = ops, ops.decode_attention_cuda
        rec, fn = self, self._fn

        def recording(q, k, v, cache_len, **kw):
            key = (q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                   str(q.dtype)[6:], isinstance(cache_len, int))
            rec.shapes[key] = rec.shapes.get(key, 0) + 1
            return fn(q, k, v, cache_len, **kw)

        ops.decode_attention_cuda = recording
        return self

    def __exit__(self, *exc):
        self._ops.decode_attention_cuda = self._fn

    def rows(self):
        return [{"B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh, "dtype": dt,
                 "int_len": il, "launches": n}
                for (B, S, H, Hkv, dh, dt, il), n in sorted(self.shapes.items())]


def phase_family_slice(torch, arch, phase, extra=()):
    """The launcher's static path on a family of this slice (internvl2-1b
    and seamless-m4t-medium with the request stream's patch or frame
    embeddings, llama3.2-1b with ``--kv-int8``) at full width and depth:
    the launches held as in the slice (the audio decoder's cross-attention
    counted), masked_compact once per spoke with requests; every decode
    attention launch recorded by shape.  The int8 path's launches are all
    f32 (the dequantized cache), the audio's cross launches take the
    encoder's 1024 rows as a Python-int length.  Returns (summary, counts,
    {decode shape: launches})."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    with _DecodeRecorder() as rec:
        s, counts = phase_slice(torch, arch, phase=phase, extra=extra)
    require(counts["masked_compact"] == len(s["compression_by_group"]) > 0,
            f"{phase}: masked_compact launched {counts['masked_compact']} times "
            f"for {len(s['compression_by_group'])} spokes with requests")
    require(sum(rec.shapes.values()) == counts["decode_attention"],
            f"{phase}: recorded {sum(rec.shapes.values())} decode_attention "
            f"calls, counted {counts['decode_attention']}")
    if "--kv-int8" in extra:
        require(all(k[5] == "float32" for k in rec.shapes),
                f"{phase}: decode_attention launched off the f32 route: "
                f"{rec.rows()}")
    cross = sum(n for k, n in rec.shapes.items() if k[6])
    if cfg.family == "audio":
        require(cross == cfg.num_layers * s["decode_steps"]
                and all(k[1] == cfg.frontend_tokens for k in rec.shapes if k[6]),
                f"{phase}: {cross} cross-attention launches, expected "
                f"{cfg.num_layers} x {s['decode_steps']} over "
                f"{cfg.frontend_tokens} rows: {rec.rows()}")
    else:
        require(cross == 0, f"{phase}: Python-int length launches {rec.rows()}")
    emit({"phase": f"{phase}_decode_shapes", "arch": arch,
          "kv_int8": "--kv-int8" in extra, "shapes": rec.rows(),
          "cross_launches": cross})
    return s, counts, dict(rec.shapes)


def _vlm_continuous_requests(cfg):
    """The vlm's continuous traffic from request_stream(seed=0): 4 request
    groups, each with its own image (the stream's first 4 frontends) and
    shared 64-token prefix (its first 4 prompts), then distinct suffixes
    (the next prompts, cut to 8-64 tokens), right-padded to 128 tokens;
    max_new from default_rng(0) over 1-16, with 16 and two single-token
    requests, but at least 2 for each group's first request: a
    single-token request takes no slot and a disaggregated one ships no
    block back, so its group's prefix would be indexed in one mode and not
    in the other."""
    from repro_torch.data.pipeline import request_stream
    from repro_torch.serving.engine import ServeRequest
    n = VLM_CONT_REQUESTS
    stream = request_stream(cfg.vocab_size, n=4 + n, mean_prompt=PROMPT_LEN,
                            seed=0, frontend_tokens=cfg.frontend_tokens,
                            frontend_dim=cfg.frontend_dim)
    max_news = np.random.default_rng(0).integers(1, VLM_CONT_MAX_NEW + 1, n)
    max_news[2] = VLM_CONT_MAX_NEW
    max_news[:4] = np.maximum(max_news[:4], 2)
    reqs = []
    for i in range(n):
        g, body = i % 4, stream[4 + i].prompt
        k = int(np.clip(len(body), 8, VLM_CONT_P - CONT_PREFIX))
        p = np.concatenate([np.resize(stream[g].prompt, CONT_PREFIX),
                            np.resize(body, k)])
        reqs.append(ServeRequest(uid=i, max_new=int(max_news[i]),
                                 prompt=np.pad(p, (0, VLM_CONT_P - len(p))).astype(np.int32),
                                 frontend=stream[g].frontend))
    return reqs


def phase_vlm_continuous(torch, dev):
    """internvl2-1b at full width and depth through ContinuousServingEngine
    on one card (slots 4, 256 patch rows + 128 prompt + 16 new + 8 = 408
    cache rows) over 12 requests in 4 image groups with shared 64-token
    prefixes, in two modes with a PrefixCache (block 8, budget 256: the
    prologue root and the token blocks, resumes at row F + q): per-step
    with local prefill, and overlapped (K=8) with a PrefillWorker on the
    card (lossless KV hop on masked_compact).  Checks both modes' streams
    identical (every request takes the same prefill route in both: cold for
    each group's first, resumed for the rest), decode_attention == layers
    x model decode steps, masked_compact == 2 x the hops that shipped a KV
    tail, 8 prefix hits in each mode.  Then, reported: a per-step run with
    no cache (every prefill cold) against those streams, and one resumed
    prefill against its cold one (bf16 logits and tail K/V).  Returns
    ({mode: launch counts}, {KV tail shape}, {decode shape: launches}, the
    per-step cached mode's streams {uid: tokens}, {cached mode: its
    row})."""
    import repro_torch.core as C
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache

    cfg = get_config(VLM_ARCH)
    params = M.init_params(cfg, 0, device=dev)            # the slice's weights
    reqs = _vlm_continuous_requests(cfg)
    max_len = cfg.frontend_tokens + VLM_CONT_P + VLM_CONT_MAX_NEW + 8
    L = cfg.num_layers
    modes = [("per-step-cached", 0, True, False),
             ("overlapped-disaggregated", MACRO, True, True),
             ("per-step-uncached", 0, False, False)]
    ref, counts_by_mode, rows, hops = None, {}, {}, set()
    with _DecodeRecorder() as drec:
        for name, k, cached, remote in modes:
            pc = PrefixCache(cfg, block_size=8, budget_blocks=256, device=dev) \
                if cached else None
            worker = PrefillWorker(cfg, params, device=dev, link=C.ICI_LINK) \
                if remote else None
            with _FleetRecorder() as rec:
                outs, stats, counts, wall, peak = _run_engine(
                    torch, dev, cfg, params, reqs, slots=SIDE_SLOTS,
                    max_len=max_len, macro_steps=k, prefix_cache=pc,
                    prefill_worker=worker)
            steps = _model_decode_steps(stats, k)
            require(stats.requests == len(reqs)
                    and stats.total_tokens == sum(r.max_new for r in reqs),
                    f"vlm_continuous {name}: {stats.requests} requests, "
                    f"{stats.total_tokens} tokens")
            require(counts["decode_attention"] == L * steps,
                    f"vlm_continuous {name}: decode_attention launched "
                    f"{counts['decode_attention']} times, expected {L} x {steps}")
            require(counts["masked_compact"] == 2 * len(rec.hops),
                    f"vlm_continuous {name}: masked_compact launched "
                    f"{counts['masked_compact']} times, expected 2 x "
                    f"{len(rec.hops)} hops that shipped a KV tail")
            if cached:
                require(stats.prefix_hits == len(reqs) - 4,
                        f"vlm_continuous {name}: {stats.prefix_hits} prefix "
                        f"hits, expected {len(reqs) - 4}")
                pc.check_invariants()
            if remote:
                require(rec.hops and stats.prefill_offloaded > 0
                        and stats.prefill_fallbacks == 0
                        and 0 < stats.kv_hop_bytes_wire < stats.kv_hop_bytes_raw,
                        f"vlm_continuous {name}: hops {len(rec.hops)}, "
                        f"offloaded {stats.prefill_offloaded}, fallbacks "
                        f"{stats.prefill_fallbacks}, hop bytes "
                        f"{stats.kv_hop_bytes_wire} of {stats.kv_hop_bytes_raw}")
            streams = {o.uid: o.tokens for o in outs}
            ref = ref or streams
            diffs = {u: _first_diff(ref[u], streams[u]) for u in ref}
            diffs = {u: d for u, d in diffs.items() if d is not None}
            row = {"phase": "vlm_continuous", "mode": name, "arch": cfg.name,
                   "slots": SIDE_SLOTS, "max_len": max_len, "macro_steps": k,
                   "requests": len(reqs), "frontend_tokens": cfg.frontend_tokens,
                   **_stats_row(stats, wall, peak, counts, k),
                   "prefix_cache": pc.stats() if pc is not None else None,
                   "kv_tail_hops": len(rec.hops),
                   "kv_tail_shapes": sorted(set(rec.hops)),
                   "requests_differing_from_cached": len(diffs),
                   "first_differences": diffs}
            if cached:
                require(not diffs, f"vlm_continuous {name}: streams differ "
                        f"from the per-step cached mode at {diffs}")
            emit(row)
            hops |= set(rec.hops)
            if name != "per-step-uncached":
                counts_by_mode[name], rows[name] = counts, row
            del outs, pc, worker
            torch.cuda.empty_cache()
    emit({"phase": "vlm_continuous_resume", **_resume_vs_cold(
        torch, dev, cfg, params, reqs[4], cfg.frontend_tokens + CONT_PREFIX)})
    del params
    torch.cuda.empty_cache()
    return counts_by_mode, hops, dict(drec.shapes), \
        {u: t.tolist() for u, t in ref.items()}, rows


def _resume_vs_cold(torch, dev, cfg, params, req, q_rows):
    """One request's prefill resumed from the first ``q_rows`` rows of its
    own cold prefill cache, against the cold one (bf16, kernels on)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import make_prefill_step
    batch = {"tokens": torch.as_tensor(req.prompt[None], device=dev)}
    if req.frontend is not None:
        batch["frontend"] = torch.as_tensor(req.frontend[None], device=dev)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, batch)
        prefix = {"self": {n: t[:, :, :q_rows].clone()
                           for n, t in cache["self"].items()}}
        out = M.forward(params, cfg, dict(batch, prefix=prefix), mode="prefill",
                        use_kernels=True)
        rl = out.logits[:, -1]
        tail = max(float((out.cache["self"][n][:, :, q_rows:].float()
                          - cache["self"][n][:, :, q_rows:].float()).abs().max())
                   for n in ("k", "v"))
        head = max(float((out.cache["self"][n][:, :, :q_rows].float()
                          - cache["self"][n][:, :, :q_rows].float()).abs().max())
                   for n in ("k", "v"))
    return {"arch": cfg.name, "uid": req.uid, "q_rows": q_rows,
            "rows": int(cache["self"]["k"].shape[2]),
            "logits_max_abs": float((rl.float() - logits.float()).abs().max()),
            "logits_equal": bool(torch.equal(rl, logits)),
            "argmax_equal": bool(rl.argmax() == logits.argmax()),
            "prefix_kv_max_abs": head, "tail_kv_max_abs": tail,
            "tail_kv_equal": tail == 0.0,
            "top2_gap": float(_top2_gap(torch, logits)[0])}


def phase_families_kernels(torch, dev, decode_shapes, payloads, hops):
    """With no model held: decode_attention against its plain version at
    every decode shape the new paths launched, at the batch of each group
    (the vlm's G=7 over 424 rows and its continuous slots over 408, the
    audio decoder's self-attention G=1 over 168 and its cross-attention
    over 1024 rows with a Python-int length, the int8 route's f32 at
    llama's heads), bf16 within 3e-2 and f32 within 1e-4; masked_compact
    bit for bit at each spoke's §VI payload ([n,128,896], [n,128,1024],
    [n,128,2048]) and each KV tail the vlm's hops shipped; then the f32
    route and the cross shape timed beside their bound and SDPA.  Returns
    ({kernel: max main-path error}, timing rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    errs = {"decode_attention": 0.0, "masked_compact": 0.0}
    by_shape = []
    for (B, S, H, Hkv, dh, dtype, int_len) in sorted(decode_shapes):
        err = _check_decode_attention(torch, dev, gen, [B], H, Hkv, dh,
                                      "families_kernels", S_main=S,
                                      edge_cases=False,
                                      main_dtype=getattr(torch, dtype),
                                      int_len=int_len)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        by_shape.append({"B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh,
                         "dtype": dtype, "int_len": int_len, "max_abs_err": err})
    emit({"phase": "families_kernels", "kernel": "decode_attention",
          "tolerance": {"bfloat16": 3e-2, "float32": 1e-4}, "shapes": by_shape})
    mc = [_check_mc_at(torch, dev, gen, name, B, PROMPT_LEN, D, "keep72")
          for name, B, D in sorted(payloads)]
    mc += [_check_mc_at(torch, dev, gen, "vlm-kv-hop", L, Rt, D, "all")
           for L, Rt, D in sorted(hops)]
    emit({"phase": "families_kernels", "kernel": "masked_compact",
          "tolerance": "exact", "cases": mc})
    # timed at the largest batch of each new route
    B, S, H, Hkv, dh = max(k for k in decode_shapes if k[5] == "float32")[:5]
    rows = [_time_decode_attention(torch, dev, gen, "int8-f32-route", B, H, Hkv,
                                   dh, S=S, dtype=torch.float32)]
    B, S, H, Hkv, dh = max(k for k in decode_shapes if k[6])[:5]
    rows.append(_time_decode_attention(torch, dev, gen, "audio-cross", B, H, Hkv,
                                       dh, S=S, cache_len=S, int_len=True))
    for row in rows:
        emit({"phase": "families_timing", **row,
              "share_of_bound": row["bound_ms"] / row["device_ms"]})
    return errs, rows


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
def _train_data(cfg, batch, seq):
    """The launcher's corpus: ``synthetic_lm_batches`` seed 0, after the
    batch the launcher draws before its first step."""
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    data = synthetic_lm_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, batch_size=batch))
    next(data)
    return data


def _on(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _grad_norms(torch, phase, grads):
    """Every leaf's gradient norm; fails unless each is finite and above 0."""
    from repro_torch.training.checkpoint import named_leaves
    norms = {name: float(torch.linalg.vector_norm(g.float()))
             for name, g in named_leaves(grads)}
    bad = {k: v for k, v in norms.items() if not (math.isfinite(v) and v > 0)}
    require(not bad, f"{phase}: leaves without a finite non-zero gradient: {bad}")
    return norms


def _run_steps(torch, step_fn, params, state, batches):
    """One train step a batch, each between CUDA events (forward, backward
    and AdamW as the device ran them; no host sync inside the loop).
    Returns (params, state, losses, ms a step)."""
    marks, metrics = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step_fn(params, state, batch)
        end.record()
        marks.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return params, state, losses, [s.elapsed_time(e) for s, e in marks]


def _step_row(cfg, batch, seq, losses, ms, peak, before):
    steady = ms[1:] or ms
    mean = sum(steady) / len(steady)
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
            "seq": seq, "steps": len(ms), "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses, "ms_per_step": mean,
            "ms_per_step_first": ms[0], "tokens_per_s": batch * seq / mean * 1e3,
            "peak_memory_bytes": peak, "allocated_before_bytes": before}


def _fwd_bwd_ms(torch, T, params, cfg, batch, reps=3):
    """ms of the loss's forward and backward alone (no AdamW), the mean of
    ``reps`` calls between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        T.value_and_grad(params, cfg, batch, remat=False)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bits(torch, t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype))


def phase_train_slice(torch, dev):
    """llama3.2-1b at full width and depth (bf16, random weights from seed
    0) through make_train_step at the train launcher's defaults: batch 8,
    seq 64, synthetic_lm_batches seed 0, lr 1e-3, warmup 2, 20 steps.
    Checks: every leaf's gradient finite and non-zero at the first batch;
    a microbatches=2 step and a remat step give the full-batch loss within
    1e-2 relative; the loss finite at every step and the last below the
    first; no kernel launched (the dense path has none); save_checkpoint
    then restore_checkpoint of the params and the AdamW state bit-equal.
    Then ``python -m repro_torch.launch.train --steps 3`` exits 0."""
    import itertools
    from repro_torch.configs.base import get_config
    from repro_torch.core.offload import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import train as T
    from repro_torch.training.checkpoint import (named_leaves, restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

    cfg = get_config(ARCH)
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
                              total_steps=TRAIN_STEPS)
    params = M.init_params(cfg, 0, device=dev)
    data = _train_data(cfg, TRAIN_BATCH, TRAIN_SEQ)
    first = next(data)
    loss0, _, grads = T.value_and_grad(params, cfg, _on(torch, first, dev),
                                       remat=False)
    norms = _grad_norms(torch, "train_slice", grads)
    del grads
    loss_remat = T.value_and_grad(params, cfg, _on(torch, first, dev),
                                  remat=True)[0]
    copy = tree_map(torch.clone, params)
    copy, copy_state, m_mb = T.make_train_step(
        cfg, opt_cfg, remat=False, microbatches=2)(copy, init_opt_state(copy),
                                                    first)
    loss_mb = float(m_mb["loss"])
    del copy, copy_state, m_mb
    _free(torch)

    state = init_opt_state(params)
    step_fn = T.make_train_step(cfg, opt_cfg, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    params, state, losses, ms = _run_steps(
        torch, step_fn, params, state,
        itertools.chain([first], itertools.islice(data, TRAIN_STEPS - 1)))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(losses[-1] < losses[0], f"train_slice: the loss did not fall: {losses}")
    require(abs(float(loss0) - losses[0]) <= 1e-6 * abs(losses[0]),
            f"train_slice: step 0's loss {losses[0]} is not the loss {float(loss0)}"
            " of the same params and batch")
    for name, other in (("microbatches=2", loss_mb), ("remat", float(loss_remat))):
        require(abs(other - losses[0]) <= TRAIN_TOL * abs(losses[0]),
                f"train_slice: the {name} loss {other} is not within "
                f"{TRAIN_TOL} of the full-batch loss {losses[0]}")
    require(not any(counts.values()), f"train_slice: kernels launched: {counts}")
    fwd_bwd_ms = _fwd_bwd_ms(torch, T, params, cfg, _on(torch, first, dev))

    path = ROOT / "build" / "chip_smoke_train.npz"
    t0 = time.perf_counter()
    save_checkpoint(str(path), params, state, metadata={"arch": cfg.name})
    save_s = time.perf_counter() - t0
    ckpt_bytes = path.stat().st_size
    t0 = time.perf_counter()
    p2, s2, meta = restore_checkpoint(str(path), tree_map(torch.empty_like, params),
                                      init_opt_state(params))
    restore_s = time.perf_counter() - t0
    path.unlink()
    pairs = list(zip(named_leaves((params, state)), named_leaves((p2, s2))))
    require(all(a[0] == b[0] and a[1].dtype == b[1].dtype
                and torch.equal(_bits(torch, a[1]), _bits(torch, b[1]))
                for a, b in pairs) and meta == {"arch": cfg.name},
            "train_slice: the restored checkpoint differs from the saved state")
    row = _step_row(cfg, TRAIN_BATCH, TRAIN_SEQ, losses, ms, peak, before)
    row.update(ms_forward_backward=fwd_bwd_ms,
               loss_full_batch=float(loss0), loss_microbatches_2=loss_mb,
               loss_remat=float(loss_remat), launches=counts,
               grad_norm_min=min(norms.values()), leaves=len(norms),
               params=sum(t.numel() for _, t in named_leaves(params)),
               checkpoint_bytes=ckpt_bytes, checkpoint_leaves=len(pairs),
               save_s=save_s, restore_s=restore_s, checkpoint_bit_equal=True)
    emit({"phase": "train_slice", **row})
    del params, state, p2, s2, pairs, step_fn
    _free(torch)

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "3"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"{' '.join(cmd[1:])} exited {proc.returncode}:"
            f" {proc.stderr[-2000:]}")
    emit({"phase": "train_launcher", "argv": cmd[1:], "returncode": 0,
          "seconds": time.perf_counter() - t0, "stdout": proc.stdout.splitlines()})
    return counts, row


def phase_train_moe(torch, dev):
    """moonshot-v1-16b-a3b at full width, depth cut to 2 layers (64 experts,
    d 2048, F 1408, vocab 163840, bf16, ~1.85 B params), 5 steps at batch 4,
    seq 64.  Checks grouped_ffn == layers x steps, then == 2 x layers x
    steps in two remat steps (the forward runs again in the backward), and
    every leaf's
    gradient non-zero, the experts' w_gate, w_up and w_down among them.
    Returns (counts, remat counts, the train buffer's (E, C, D, F), row)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import train as T
    from repro_torch.training.checkpoint import named_leaves
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    B, S, steps = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    params = M.init_params(cfg, 0, device=dev)
    state = init_opt_state(params)
    data = _train_data(cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    params, state, losses, ms = _run_steps(
        torch, T.make_train_step(cfg, opt_cfg, remat=False), params, state,
        [next(data) for _ in range(steps)])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["grouped_ffn"] = cfg.num_layers * steps
    require(counts == want, f"train_moe: launches {counts}, expected {want}")
    ops.reset_launch_counts()
    params, state, remat_losses, remat_ms = _run_steps(
        torch, T.make_train_step(cfg, opt_cfg, remat=True), params, state,
        [next(data) for _ in range(MOE_REMAT_STEPS)])
    remat_counts = ops.launch_counts()
    want = dict(want, grouped_ffn=2 * cfg.num_layers * MOE_REMAT_STEPS)
    require(remat_counts == want,
            f"train_moe remat: launches {remat_counts}, expected {want}")
    batch = _on(torch, next(data), dev)
    _, _, grads = T.value_and_grad(params, cfg, batch, remat=False)
    norms = _grad_norms(torch, "train_moe", grads)
    del grads
    fwd_bwd_ms = _fwd_bwd_ms(torch, T, params, cfg, batch)
    shape = (cfg.num_experts, moe_mod._capacity(B * S, cfg), cfg.d_model, cfg.d_ff)
    row = _step_row(cfg, B, S, losses, ms, peak, before)
    row.update(ms_forward_backward=fwd_bwd_ms, launches=counts,
               remat_launches=remat_counts, remat_ms_per_step=remat_ms,
               remat_losses=remat_losses,
               params=sum(t.numel() for _, t in named_leaves(params)),
               leaves=len(norms), grad_norm_min=min(norms.values()),
               expert_grad_norms={k: v for k, v in norms.items()
                                  if k.split("/")[-1] in ("w_gate", "w_up", "w_down")
                                  and "/moe/" in f"/{k}" and "shared" not in k},
               train_buffer_ECDF=shape)
    emit({"phase": "train_moe", **row})
    del params, state
    _free(torch)
    return counts, remat_counts, shape, row


def phase_train_ssm(torch, dev):
    """falcon-mamba-7b at full width, depth cut to 4 layers (d 4096, d_inner
    8192, N 16, bf16, ~0.69 B params), 5 steps at batch 2, seq 256 (one
    256-row scan chunk).  Checks ssm_scan == layers x chunks x steps and
    ssm_scan_bwd the same, and every leaf's gradient non-zero.  Returns
    (counts, the chunk's (B, S, di, N), row)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import train as T
    from repro_torch.training.checkpoint import named_leaves
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_TRAIN_LAYERS)
    B, S, steps = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    params = M.init_params(cfg, 0, device=dev)
    state = init_opt_state(params)
    data = _train_data(cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    params, state, losses, ms = _run_steps(
        torch, T.make_train_step(cfg, opt_cfg, remat=False), params, state,
        [next(data) for _ in range(steps)])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = cfg.num_layers * -(-S // 256) * steps
    want = dict({k: 0 for k in counts}, ssm_scan=n, ssm_scan_bwd=n)
    require(counts == want, f"train_ssm: launches {counts}, expected {want}")
    batch = _on(torch, next(data), dev)
    _, _, grads = T.value_and_grad(params, cfg, batch, remat=False)
    norms = _grad_norms(torch, "train_ssm", grads)
    del grads
    fwd_bwd_ms = _fwd_bwd_ms(torch, T, params, cfg, batch)
    row = _step_row(cfg, B, S, losses, ms, peak, before)
    row.update(ms_forward_backward=fwd_bwd_ms, launches=counts, leaves=len(norms),
               params=sum(t.numel() for _, t in named_leaves(params)),
               grad_norm_min=min(norms.values()),
               scan_chunk=(B, min(S, 256), cfg.d_inner, cfg.ssm_state))
    emit({"phase": "train_ssm", **row})
    del params, state
    _free(torch)
    return counts, (B, min(S, 256), cfg.d_inner, cfg.ssm_state), row


def _grads_of(torch, fn, inputs, cotangents):
    """(outputs..., input gradients...) of ``fn`` at fresh leaves of
    ``inputs``; the outputs paired with the non-None cotangents."""
    ins = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    used = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
    grads = torch.autograd.grad([o for o, _ in used], ins, [c for _, c in used])
    return tuple(o.detach() for o in outs) + grads


def _compare_grads(torch, tag, got, again, want, tol):
    """Every output and gradient within ``tol`` of the plain one's max|x|,
    and the kernel path's two runs bit-equal; returns the largest abs and
    relative errors."""
    require(all(torch.equal(_bits(torch, a), _bits(torch, b))
                for a, b in zip(got, again)), f"{tag}: two runs differ")
    worst_abs = worst_rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype
                and bool(torch.isfinite(g.float()).all()),
                f"{tag}: output {i} bad ({g.shape} {g.dtype})")
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        require(err <= tol * max(scale, 1e-30),
                f"{tag}: output {i} max_abs_err {err} > {tol} x max|g| {scale}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return worst_abs, worst_rel


def phase_train_kernels(torch, dev, ffn_shape, scan_shape):
    """The differentiable ops' outputs and gradients on the card against
    torch.autograd through their plain versions: grouped_ffn at moonshot's
    train buffer in bf16 with counts full, ragged and zero (within 3e-2 of
    max|g|; rows past a count exactly zero in dbuf); ssm_scan's forward and
    backward (the CUDA ssm_scan_bwd) at falcon-mamba's train chunk and at
    ragged shapes (S 1, odd di x N, S past the unroll, G or g absent),
    within 1e-5 of max|g| in f32, and the raw ssm_scan_bwd against
    ssm_scan_bwd_ref.  Every kernel-path call twice, bit-equal.  Then
    ssm_scan_bwd timed beside its bound and the plain reverse loop.
    Returns ({"ssm_scan_bwd": main-path max abs err}, [timing row])."""
    from repro_torch.kernels import costs, ops, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    E, C, D, F = ffn_shape
    ffn_rows = []
    for kind in ("full", "ragged", "zero"):
        buf, wg, wu, wd = _ffn_case(torch, gen, E, C, D, F, torch.bfloat16, dev)
        counts = _ffn_counts(torch, gen, kind, E, C, dev)
        cot = torch.randn((E, C, D), generator=gen, device=dev).to(torch.bfloat16)
        kern = functools.partial(ops.grouped_ffn, counts=counts, use_kernels=True)
        plain = functools.partial(ref.grouped_ffn_ref, counts=counts)
        got = _grads_of(torch, kern, (buf, wg, wu, wd), (cot,))
        again = _grads_of(torch, kern, (buf, wg, wu, wd), (cot,))
        want = _grads_of(torch, plain, (buf, wg, wu, wd), (cot,))
        tag = f"grouped_ffn backward {kind} E={E} C={C} D={D} F={F}"
        err, rel = _compare_grads(torch, tag, got, again, want,
                                  GRAD_TOL["bfloat16"])
        dead = torch.arange(C, device=dev)[None, :] >= counts[:, None]
        require(not bool(got[1][dead].any()), f"{tag}: dbuf non-zero past a count")
        ffn_rows.append({"counts": kind, "max_abs_err": err, "max_rel_err": rel,
                         "live_rows": int(counts.sum())})
        del buf, wg, wu, wd, got, again, want
    emit({"phase": "train_kernels", "kernel": "grouped_ffn (autograd)",
          "dtype": "bfloat16", "shape_ECDF": ffn_shape,
          "tolerance": f"{GRAD_TOL['bfloat16']} x max|g|", "cases": ffn_rows})

    Bm, Sm, dim, Nm = scan_shape
    cases = [("main-path", Bm, Sm, dim, Nm, True, False),
             ("main-path h_last too", Bm, Sm, dim, Nm, True, True),
             ("S=1", 3, 1, 100, 3, True, True),
             ("odd di*N", 2, 7, 101, 3, True, True),
             ("S past the unroll", 1, 300, 100, 4, True, True),
             ("h_last only", 2, 9, 64, 4, False, True)]
    scan_rows, main_err = [], 0.0
    for name, B, S, di, N, with_G, with_g in cases:
        decay, bx, h0 = _scan_case(torch, gen, B, S, di, N, dev)
        G = torch.randn((B, S, di, N), generator=gen, device=dev) if with_G else None
        g = torch.randn((B, di, N), generator=gen, device=dev) if with_g else None
        kern = functools.partial(ops.ssm_scan, use_kernels=True)
        got = _grads_of(torch, kern, (decay, bx, h0), (G, g))
        again = _grads_of(torch, kern, (decay, bx, h0), (G, g))
        want = _grads_of(torch, ref.ssm_scan_ref, (decay, bx, h0), (G, g))
        tag = f"ssm_scan backward {name} B={B} S={S} di={di} N={N}"
        err, rel = _compare_grads(torch, tag, got, again, want, GRAD_TOL["float32"])
        raw = ssm_scan_bwd_cuda(decay, got[0], h0, G, g)
        plain = ref.ssm_scan_bwd_ref(decay, got[0], h0, G, g)
        raw_err = max(float((a - b).abs().max()) for a, b in zip(raw, plain))
        exact = all(torch.equal(a, b) for a, b in zip(raw, plain))
        if name.startswith("main-path"):
            main_err = max(main_err, raw_err)
        scan_rows.append({"case": name, "B": B, "S": S, "di": di, "N": N,
                          "G": with_G, "g": with_g, "max_abs_err": err,
                          "max_rel_err": rel, "bwd_vs_bwd_ref_max_abs_err": raw_err,
                          "bwd_vs_bwd_ref_exact": exact})
        del decay, bx, h0, G, g, got, again, want, raw, plain
    emit({"phase": "train_kernels", "kernel": "ssm_scan / ssm_scan_bwd (autograd)",
          "dtype": "float32", "tolerance": f"{GRAD_TOL['float32']} x max|g|",
          "cases": scan_rows})
    torch.cuda.empty_cache()

    # ssm_scan_bwd at the train path's chunk
    B, S, di, N = scan_shape
    Cn = di * N
    per_set = 4 * B * Cn * (3 * S + 1)
    sets = []
    for _ in range(_sets_for(per_set)):
        decay, bx, h0 = _scan_case(torch, gen, B, S, di, N, dev)
        h_all = ref.ssm_scan_ref(decay, bx, h0)[0]
        sets.append((decay, h_all, h0, torch.randn_like(decay)))
        del bx
    # (decay, h_all, h0, G): the train path's call, g absent
    kern, plain = ssm_scan_bwd_cuda, ref.ssm_scan_bwd_ref
    times = {"ms": _time_ms(torch, kern, sets, iters=40, warmup=4),
             "device_ms": _device_ms(torch, kern, sets, iters=10),
             "plain_ms": _time_ms(torch, plain, sets, iters=3, warmup=1),
             "plain_device_ms": _device_ms(torch, plain, sets, iters=1,
                                           need_ahead=False)}
    # reads decay, h_all, G and h0; writes d_decay, d_bx and d_h0 (f32)
    cost = costs.ssm_scan_bwd(B, S, di, N)
    n_bytes, n_ops = cost["bytes"], cost["flops"]
    bound_ms, bound_by = _bound(n_bytes, n_ops, H100_PEAK_FLOPS_F32)
    row = {"kernel": "ssm_scan_bwd", "step": "train", "group": "train",
           "B": B, "S": S, "di": di, "N": N, "dtype": "float32", **times,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this backward",
           "bytes": n_bytes, "operations": n_ops, "bound_ms": bound_ms,
           "bound_by": bound_by, "sets": len(sets)}
    emit({"phase": "train_timing", **row,
          "share_of_bound": row["bound_ms"] / row["device_ms"]})
    del sets
    torch.cuda.empty_cache()
    return {"ssm_scan_bwd": main_err}, [row]


# ---------------------------------------------------------------------------
# The mesh paths: 2-4 ranks spawned on the one card, one process each, over
# gloo (NCCL refuses two ranks on one card); NCCL at world size 1
# ---------------------------------------------------------------------------
MESH_TIMEOUT_S = 480            # a mesh phase's whole spawn
MESH_SEQ_SLOTS, MESH_SEQ_REQUESTS = 3, 12
MESH_SEQ_LAYERS = 8             # llama's depth on mesh_seq (of 16): the
                                # script's time limit
MESH_F32_REQUESTS = 8           # the float32 2-layer copies' requests
MESH_MOE_LAYERS = 4             # moonshot's depth on its mesh (of 48)
MESH_LOGIT_TOL = 5e-2           # bf16 prefill logits, of max|logit|: each
                                # of 16 layers rounds its 3 partial sums
                                # apart on two ranks
LSE_TOL = 1e-4
MESH_MOE_F32_TOL = 1e-3         # float32 logits, absolute (moe_parity's)
MESH_MOE_F32_STEPS = 4          # its teacher-forced decode steps


def _rank_env(shape):
    """In a spawned rank: the card, TF32 off, the kernels the parent built
    loaded, and the (data, model) mesh of ``shape``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), ("data", "model"))
    return torch, dev, mesh


class _MeshRecorder:
    """While active: every decode_attention launch's (B, S, H, Hkv, dh,
    dtype, start given, lse asked), every grouped_ffn call's (E, C, D, F,
    dtype, counts given), every ssm_scan and ssm_scan_bwd launch's (B, S,
    di, N) and every
    KV tail this rank's prefill worker compacts (``compact_kv_hop``:
    [layers, tail rows, this rank's Hkv*dh]), with their counts;
    ``n_hops`` counts the tails.  The wrapped functions run as they are;
    the recorder only reads what goes in."""

    def __enter__(self):
        from repro_torch.kernels import autograd, ops
        from repro_torch.serving import prefill
        self.decode, self.ffn, self.hops, self.n_hops = {}, {}, {}, 0
        self.scan, self.scan_bwd = {}, {}
        self._ops, self._prefill, self._autograd = ops, prefill, autograd
        self._dec, self._ffn = ops.decode_attention_cuda, ops.grouped_ffn
        self._hop, self._scan = prefill.compact_kv_hop, autograd.ssm_scan_cuda
        self._scan_bwd = autograd.ssm_scan_bwd_cuda
        rec, dec, ffn, hop, scan, scan_bwd = (
            self, self._dec, self._ffn, self._hop, self._scan, self._scan_bwd)

        def recording_scan(decay, bx, h0):
            key = tuple(decay.shape)
            rec.scan[key] = rec.scan.get(key, 0) + 1
            return scan(decay, bx, h0)

        def recording_scan_bwd(decay, h_all, h0, G, g):
            key = tuple(decay.shape)
            rec.scan_bwd[key] = rec.scan_bwd.get(key, 0) + 1
            return scan_bwd(decay, h_all, h0, G, g)

        def recording_decode(q, k, v, cache_len, **kw):
            key = (q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                   str(q.dtype)[6:], kw.get("start") is not None,
                   bool(kw.get("lse")))
            rec.decode[key] = rec.decode.get(key, 0) + 1
            return dec(q, k, v, cache_len, **kw)

        def recording_ffn(buf, wg, wu, wd, **kw):
            key = (*buf.shape, wg.shape[2], str(buf.dtype)[6:],
                   kw.get("counts") is not None)
            rec.ffn[key] = rec.ffn.get(key, 0) + 1
            return ffn(buf, wg, wu, wd, **kw)

        def recording_hop(cache, q_rows, *, keep_rate=None):
            k = cache["self"]["k"]                  # [L, 1, S, Hkv_loc, dh]
            key = (k.shape[0], k.shape[2] - q_rows, k.shape[3] * k.shape[4])
            rec.hops[key] = rec.hops.get(key, 0) + 1
            rec.n_hops += 1
            return hop(cache, q_rows, keep_rate=keep_rate)

        ops.decode_attention_cuda = recording_decode
        ops.grouped_ffn = recording_ffn
        prefill.compact_kv_hop = recording_hop
        autograd.ssm_scan_cuda = recording_scan
        autograd.ssm_scan_bwd_cuda = recording_scan_bwd
        return self

    def __exit__(self, *exc):
        self._ops.decode_attention_cuda = self._dec
        self._ops.grouped_ffn = self._ffn
        self._prefill.compact_kv_hop = self._hop
        self._autograd.ssm_scan_cuda = self._scan
        self._autograd.ssm_scan_bwd_cuda = self._scan_bwd


def _rank_run(torch, dev, mesh, cfg, params, reqs, rec=None, **kw):
    """One ContinuousServingEngine run on this rank, its launch counts set
    to 0 just before and read just after, its collectives counted (and,
    under a _MeshRecorder ``rec``, the KV tails it compacted).  Returns
    (engine, summary)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousServingEngine
    eng = ContinuousServingEngine(cfg, params, device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hops0 = rec.n_hops if rec is not None else 0
    ops.reset_launch_counts()
    with coll.counting(mesh) as cc:
        t0 = time.perf_counter()
        outs, stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    K = kw.get("macro_steps", MACRO)
    row = _stats_row(stats, wall, torch.cuda.max_memory_allocated(), counts, K)
    row["collectives"] = {"calls": dict(cc.calls), "bytes": cc.totals(),
                          "host_seconds": cc.seconds}
    row["ms_per_model_decode_step"] = 1e3 * stats.decode_s / max(
        row["model_decode_steps"], 1)
    row["requests"] = stats.requests
    row["streams"] = {o.uid: o.tokens.tolist() for o in outs}
    row["kv_tail_hops"] = rec.n_hops - hops0 if rec is not None else 0
    return eng, row


def _f32_cut(torch, params, layers=2):
    """A float32 copy of the first ``layers`` layers of bf16 params."""
    from repro_torch.core.offload import tree_map
    p32 = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    p32["blocks"] = tree_map(lambda t: t[:layers].float(), params["blocks"])
    return p32


def _plain_streams(torch, dev, cfg, params, reqs, max_len):
    """The one-rank plain static path (one batch with the requests'
    frontends, kernels off, per-token steps): greedy streams and each
    step's top-2 gap, [B, max_new]."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                            seed_cache)
    B, max_new = len(reqs), max(r.max_new for r in reqs)
    P = len(reqs[0].prompt) + M.frontend_offset(cfg)
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                       device=dev)}
    if reqs[0].frontend is not None:
        batch["frontend"] = torch.as_tensor(
            np.stack([r.frontend for r in reqs]), device=dev)
    with torch.no_grad():
        last, pre = make_prefill_step(cfg, use_kernels=False)(params, batch)
        cache = seed_cache(cfg, M.init_cache(cfg, B, max_len, device=dev),
                           pre, P)
        del pre
        step = make_serve_step(cfg, use_kernels=False)
        tok = last.argmax(dim=-1).to(torch.int32)
        stream, gaps = [tok], [_top2_gap(torch, last)]
        for i in range(max_new - 1):
            lengths = torch.full((B,), P + i, dtype=torch.int32, device=dev)
            lp, cache = step(params, cache, tok[:, None], lengths)
            tok = lp.argmax(dim=-1).to(torch.int32)
            stream.append(tok)
            gaps.append(_top2_gap(torch, lp))
        return (torch.stack(stream, dim=1).cpu().numpy(),
                torch.stack(gaps, dim=1).cpu().numpy())


def _gap_rule(streams, plain, gaps):
    """Per request: the first position where a stream leaves the plain one
    and the plain one's first top-2 gap < 1e-3; a stream may leave only at
    or after such a gap (the parity phase's rule)."""
    out = {}
    for uid, toks in streams.items():
        toks = np.asarray(toks)
        n = len(toks)
        diff = np.nonzero(toks != plain[uid, :n])[0]
        low = np.nonzero(gaps[uid, :n] < 1e-3)[0]
        m = int(diff[0]) if diff.size else None
        g = int(low[0]) if low.size else None
        out[uid] = {"first_mismatch": m, "first_low_gap": g,
                    "ok": m is None or (g is not None and m >= g)}
    return out


def _rank_f32(torch, dev, mesh, cfg, p32, reqs, **kw):
    """The float32 2-layer copy: the one-rank plain streams (rank 0, off
    the mesh), then the mesh engine (kernels on) on this rank's shard."""
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models.sharding import activation_sharding
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    plain = _plain_streams(torch, dev, cfg2, p32, reqs, kw["max_len"]) \
        if mesh.rank == 0 else None
    shard = shard_params(p32, mesh)
    with activation_sharding(mesh):
        _, row = _rank_run(torch, dev, mesh, cfg2, shard, reqs, **kw)
    out = {"launches": row["launches"], "requests": row["requests"],
           "model_decode_steps": row["model_decode_steps"]}
    if plain is not None:
        out["rule"] = _gap_rule(row["streams"], *plain)
        out["min_top2_gap"] = float(plain[1].min())
    return out


def _rank_mesh_dense(rank, world, shape, reqs):
    """mesh_dense on one rank: llama3.2-1b (bf16, seed 0) on a (1, 2) mesh;
    prefill logits against the one-rank model (rank 0), the continuous
    traffic per-step and fused, the float32 2-layer copy."""
    torch, dev, mesh = _rank_env(shape)
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    cfg = get_config(ARCH)
    full = M.init_params(cfg, 0, device=dev)
    p32 = _f32_cut(torch, full)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs[:4]]), device=dev)
    out = {"rank": rank}
    with torch.no_grad():
        ref = M.forward(full, cfg, {"tokens": tokens}, mode="prefill",
                        use_kernels=True).logits[:, -1].float() \
            if rank == 0 else None
        params = shard_params(full, mesh)
        del full
        _free(torch)
        with activation_sharding(mesh):
            got = M.forward(params, cfg, {"tokens": tokens}, mode="prefill",
                            use_kernels=True).logits[:, -1].float()
    if ref is not None:
        err = (got - ref).abs()
        out["prefill_logits"] = {"max_abs_err": float(err.max()),
                                 "mean_abs_err": float(err.mean()),
                                 "max_abs_logit": float(ref.abs().max())}
    runs = {}
    with _MeshRecorder() as rec, activation_sharding(mesh):
        for name, kw in (("per-step", dict(macro_steps=0)),
                         ("fused", dict(macro_steps=MACRO))):
            _, runs[name] = _rank_run(torch, dev, mesh, cfg, params, reqs,
                                      rec, slots=CONT_SLOTS,
                                      max_len=CONT_MAX_LEN, **kw)
    del params
    _free(torch)
    out.update(runs=runs, decode_shapes=rec.decode, ffn_shapes=rec.ffn,
               hop_shapes=rec.hops)
    out["f32"] = _rank_f32(torch, dev, mesh, cfg, p32, reqs[:MESH_F32_REQUESTS],
                           slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                           macro_steps=MACRO)
    return out


def _rank_mesh_seq(rank, world, shape, reqs):
    """mesh_seq on one rank: llama3.2-1b (bf16, seed 0, MESH_SEQ_LAYERS
    deep) on a (2, 2) mesh
    with 3 slots (the batch spills onto the sequence over "data", the
    heads split over "model"); the local arm, the disaggregated arm (a
    mesh-wide PrefillWorker and a PrefixCache: the KV hops compact this
    rank's rows), the engine's program profile, the float32 copy."""
    torch, dev, mesh = _rank_env(shape)
    import repro_torch.core as C
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.profiling import profile_engine_programs
    cfg = dataclasses.replace(get_config(ARCH), num_layers=MESH_SEQ_LAYERS)
    full = M.init_params(cfg, 0, device=dev)
    p32 = _f32_cut(torch, full)
    params = shard_params(full, mesh)
    del full
    _free(torch)
    kw = dict(slots=MESH_SEQ_SLOTS, max_len=CONT_MAX_LEN, macro_steps=MACRO)
    runs = {}
    with _MeshRecorder() as rec, activation_sharding(mesh):
        _, runs["local"] = _rank_run(torch, dev, mesh, cfg, params, reqs, rec,
                                     **kw)
        pc = PrefixCache(cfg, block_size=8, budget_blocks=256, device=dev)
        worker = PrefillWorker(cfg, params, device=dev, link=C.ICI_LINK)
        eng, runs["disaggregated"] = _rank_run(
            torch, dev, mesh, cfg, params, reqs, rec, prefill_worker=worker,
            prefix_cache=pc, **kw)
        t0 = time.perf_counter()
        profile = profile_engine_programs(eng, prompt_len=CONT_P, n_blocks=2)
        profile["seconds"] = time.perf_counter() - t0
        layout = eng._shard._asdict()
        layout.pop("mesh")
        layout["seq"] = layout["seq"]._asdict() if layout["seq"] else None
    del params, eng, worker, pc
    _free(torch)
    out = {"rank": rank, "runs": runs, "profile": profile, "layout": layout,
           "decode_shapes": rec.decode, "ffn_shapes": rec.ffn,
           "hop_shapes": rec.hops}
    out["f32"] = _rank_f32(torch, dev, mesh, cfg, p32,
                           reqs[:MESH_F32_REQUESTS], **kw)
    return out


def _teacher_forced_logits(torch, dev, cfg, params, tokens, steps):
    """Prefill logits of ``tokens`` [B, P] and of ``steps`` decode steps fed
    the prompts' own first tokens (kernels on; under a mesh, this rank's
    block), stacked [1 + steps, B, V] f32."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import seed_cache
    B, P = tokens.shape
    with torch.no_grad():
        out = M.forward(params, cfg, {"tokens": tokens}, mode="prefill",
                        use_kernels=True)
        logits = [out.logits[:, -1].float()]
        cache = M.init_cache(cfg, B, P + steps, device=dev)
        shard = M.cache_shard(cfg, B, P + steps)
        seed_cache(cfg, cache, out.cache, P, shard)
        del out
        for i in range(steps):
            lengths = torch.full((B,), P + i, dtype=torch.int32, device=dev)
            o = M.forward(params, cfg, {"token": tokens[:, i:i + 1],
                                        "cache": cache, "cache_index": lengths},
                          mode="decode", use_kernels=True, shard=shard)
            logits.append(o.logits[:, 0].float())
    return torch.stack(logits)


def _min_router_margin(torch, fn):
    """``fn()`` with every routing call's smallest gap between the K-th and
    (K+1)-th router probability recorded: (its result, the least gap)."""
    from repro_torch.models import moe as moe_mod
    orig, gaps = moe_mod.route, []

    def spy(xt, router, cfg):
        res = orig(xt, router, cfg)
        top = torch.topk(res[3], cfg.experts_per_token + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return res

    moe_mod.route = spy
    try:
        return fn(), min(gaps)
    finally:
        moe_mod.route = orig


def _rank_mesh_moe(rank, world, shape, reqs):
    """mesh_moe on one rank: moonshot-v1-16b-a3b at full width, its first
    4 of 48 layers (bf16, seed 0), expert-parallel on a (1, 2) mesh (32
    experts a rank); the one-rank streams (rank 0) before the mesh run;
    the float32 2-layer copy's prefill and teacher-forced decode logits,
    one-rank (rank 0, with its least router margin) and on the mesh."""
    torch, dev, mesh = _rank_env(shape)
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_MOE_LAYERS)
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    full = M.init_params(cfg, 0, device=dev)
    p32 = _f32_cut(torch, full)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs[:4]]), device=dev)
    kw = dict(slots=SIDE_SLOTS, max_len=CONT_MAX_LEN, macro_steps=MACRO)
    one_rank = ref32 = margin = None
    if rank == 0:
        from repro_torch.launch.mesh import make_smoke_mesh
        _, row = _rank_run(torch, dev, make_smoke_mesh(), cfg, full, reqs, **kw)
        one_rank = row["streams"]
        ref32, margin = _min_router_margin(torch, lambda: _teacher_forced_logits(
            torch, dev, cfg32, p32, tokens, MESH_MOE_F32_STEPS))
    params = shard_params(full, mesh)
    del full
    _free(torch)
    with _MeshRecorder() as rec, activation_sharding(mesh):
        _, row = _rank_run(torch, dev, mesh, cfg, params, reqs, rec, **kw)
        calls = _decode_step_all_reduces(torch, dev, mesh, cfg, params,
                                         SIDE_SLOTS, CONT_MAX_LEN)
    out = {"rank": rank, "runs": {"fused": row}, "one_rank": one_rank,
           "decode_step_all_reduces": calls,
           "spec_mismatches": _spec_mismatches(cfg, params, mesh),
           "experts_held": int(params["blocks"]["moe"]["w_gate"].shape[1]),
           "decode_shapes": rec.decode, "ffn_shapes": rec.ffn,
           "hop_shapes": rec.hops}
    del params
    p32 = shard_params(p32, mesh)
    _free(torch)
    with activation_sharding(mesh):
        got = _teacher_forced_logits(torch, dev, cfg32, p32, tokens,
                                     MESH_MOE_F32_STEPS)
    if ref32 is not None:
        out["f32"] = {"max_abs_err": (got - ref32).abs().amax(dim=(1, 2)).tolist(),
                      "max_abs_logit": float(ref32.abs().max()),
                      "min_router_margin": margin}
    return out


def _rank_mesh_nccl(rank, world, reqs):
    """mesh_nccl: the mesh_dense path at world size 1 over NCCL (a (1, 1)
    mesh; its collectives are over one rank and not issued), and one
    all_reduce and broadcast on the NCCL group itself."""
    torch, dev, mesh = _rank_env((1, 1))
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    cfg = get_config(ARCH)
    params = shard_params(M.init_params(cfg, 0, device=dev), mesh)
    with activation_sharding(mesh):
        _, row = _rank_run(torch, dev, mesh, cfg, params, reqs,
                           slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                           macro_steps=MACRO)
    t = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(t)
    dist.broadcast(t, src=0)
    torch.cuda.synchronize()
    return {"rank": rank, "backend": dist.get_backend(), "runs": {"fused": row},
            "nccl_check": t.tolist()}


def _mesh_checks(name, cfg, res, prompt_len=CONT_P):
    """Launch checks of every run on every rank (``_expected_launches``):
    decode_attention == attention layers x model decode steps (the hybrid's
    shared block, the audio decoder's self- and cross-attention),
    grouped_ffn == layers x (model decode steps + prefills) on MoE,
    ssm_scan == Mamba-1 layers x prefills x chunks of ``prompt_len`` (none
    elsewhere), masked_compact == 2 x the KV tails the rank compacted (K
    and V), and every rank's streams identical."""
    for r in res:
        for mode, row in r["runs"].items():
            c, steps = row["launches"], row["model_decode_steps"]
            tag = f"{name} rank {r['rank']} {mode}"
            want = _expected_launches(cfg, {"decode_steps": steps,
                                            "prefills": row["requests"]},
                                      prompt_len)
            require(steps > 0, f"{tag}: no model decode step")
            for kname, n in want.items():
                require(c[kname] == n, f"{tag}: {kname} {c[kname]}, expected "
                        f"{n} ({cfg.num_layers} layers, {steps} decode steps, "
                        f"{row['requests']} prefills)")
            require(c["masked_compact"] == 2 * row["kv_tail_hops"],
                    f"{tag}: masked_compact {c['masked_compact']}, expected 2 x "
                    f"{row['kv_tail_hops']} KV tails")
            require(row["streams"] == res[0]["runs"][mode]["streams"],
                    f"{tag}: streams differ from rank 0's")


def _mesh_row(name, r, mode, row, one_rank_row=None):
    keys = ("requests", "total_tokens", "tokens_per_s", "wall_s", "decode_s",
            "prefill_s", "t_dispatch_s", "t_await_s", "t_splice_s",
            "t_slot_write_s", "model_decode_steps", "ms_per_model_decode_step",
            "macro_dispatches", "admission_stalls", "prefill_offloaded",
            "prefix_hits", "kv_hop_bytes_raw", "kv_hop_bytes_wire",
            "kv_tail_hops", "peak_memory_bytes", "launches", "collectives")
    out = {"phase": name, "mode": mode, "rank": r["rank"],
           **{k: row[k] for k in keys}}
    steps = max(row["model_decode_steps"], 1)
    out["all_reduce_calls_per_decode_step"] = \
        row["collectives"]["calls"]["all-reduce"] / steps
    if one_rank_row is not None:
        out["one_rank"] = {k: one_rank_row[k] for k in
                           ("tokens_per_s", "wall_s", "decode_s",
                            "model_decode_steps")}
        out["one_rank"]["ms_per_model_decode_step"] = 1e3 * \
            one_rank_row["decode_s"] / max(one_rank_row["model_decode_steps"], 1)
    return out


def _agreement(streams, ref):
    """(requests with identical streams, tokens agreeing before the first
    difference, tokens) of ``streams`` against ``ref`` (uid -> tokens)."""
    same = agree = total = 0
    for uid, toks in streams.items():
        toks, want = np.asarray(toks), np.asarray(ref[uid])
        d = _first_diff(toks, want)
        same += d is None
        agree += len(toks) if d is None else d
        total += len(want)
    return {"identical_requests": same, "requests": len(streams),
            "agreeing_tokens": agree, "tokens": total}


def _check_f32(name, res, cfg32=None, prompt_len=CONT_P,
               run="float32 2-layer copy"):
    """The float32 copy (``cfg32``; default: 2 layers of a dense model):
    rank 0's streams against the one-rank plain path by the parity rule,
    and every rank's launches as ``_expected_launches`` says."""
    f32 = res[0]["f32"]
    bad = {u: v for u, v in f32["rule"].items() if not v["ok"]}
    require(not bad, f"{name} {run}: streams leave the one-rank plain "
            f"path before a top-2 gap < 1e-3: {bad}")
    for r in res:
        got = r["f32"]
        if cfg32 is None:
            want = {"decode_attention": 2 * got["model_decode_steps"]}
        else:
            want = _expected_launches(cfg32, {
                "decode_steps": got["model_decode_steps"],
                "prefills": got["requests"]}, prompt_len)
        require(all(got["launches"][k] == n for k, n in want.items()),
                f"{name} {run} rank {r['rank']}: {got['launches']}, "
                f"expected {want}")
    emit({"phase": name, "run": run, "rule": f32["rule"],
          "min_top2_gap": f32["min_top2_gap"],
          "mismatching_requests": sum(v["first_mismatch"] is not None
                                      for v in f32["rule"].values())})


def phase_mesh_dense(torch, dev, ref_streams, ref_rows):
    """llama3.2-1b at full width and depth on a (data=1, model=2) mesh: two
    ranks on the one card over gloo (spawned); the continuous phase's 24
    requests per-step and with macro_steps=8 (slots 8, max_len 512).
    Checks the launches on each rank, both ranks' streams identical, the
    prefill logits within MESH_LOGIT_TOL of max|logit| of the one-rank
    model; reports how many greedy streams agree with the one-rank
    continuous run's, ms a decode step and tokens/s beside it; the float32
    2-layer copy within the parity rule."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.spawn import run_ranks
    cfg = get_config(ARCH)
    reqs = _continuous_requests(cfg)
    res = run_ranks(_rank_mesh_dense, 2, (1, 2), reqs, timeout_s=MESH_TIMEOUT_S)
    _mesh_checks("mesh_dense", cfg, res)
    lg = res[0]["prefill_logits"]
    require(lg["max_abs_err"] <= MESH_LOGIT_TOL * lg["max_abs_logit"],
            f"mesh_dense: prefill logits off the one-rank model by {lg}")
    emit({"phase": "mesh_dense", "mesh": {"data": 1, "model": 2},
          "backend": "gloo", "prefill_logits": lg,
          "tolerance_of_max_abs_logit": MESH_LOGIT_TOL})
    counts = {}
    for r in res:
        for mode, row in r["runs"].items():
            one = ref_rows["per-step" if mode == "per-step" else "overlapped"]
            out = _mesh_row("mesh_dense", r, mode, row, one)
            out["agreement_with_one_rank"] = _agreement(row["streams"],
                                                        ref_streams)
            emit(out)
            counts[f"{ARCH} mesh_dense 1x2 rank {r['rank']} {mode}"] = \
                row["launches"]
    _check_f32("mesh_dense", res)
    return counts, _merge_shapes(res)


def phase_mesh_seq(torch, dev):
    """llama3.2-1b at full width, MESH_SEQ_LAYERS = 8 of its 16 layers, on
    a (data=2, model=2) mesh:
    four ranks, 3 slots, so the batch spills onto the sequence (over
    "data") and the heads split (over "model"): the sequence-sharded
    cache_update and splice_blocks, decode_attention with lse merged
    across "data".  12 of the continuous requests, local and disaggregated
    (a mesh-wide PrefillWorker with a PrefixCache: the hops compact each
    rank's rows).  Checks the launches, the streams of both arms identical
    on every rank, masked_compact == 2 x the KV tails each rank compacted
    (none on the local arm, some on the disaggregated one), decode_s ==
    t_dispatch_s + t_await_s exactly, the boundary wall in t_splice_s
    (disaggregated) or t_slot_write_s (local); mesh_profile: the four
    programs, zero collective bytes on splice and slot_write."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.spawn import run_ranks
    cfg = dataclasses.replace(get_config(ARCH), num_layers=MESH_SEQ_LAYERS)
    reqs = _continuous_requests(cfg)[:MESH_SEQ_REQUESTS]
    res = run_ranks(_rank_mesh_seq, 4, (2, 2), reqs, timeout_s=MESH_TIMEOUT_S)
    _mesh_checks("mesh_seq", cfg, res)
    counts = {}
    for r in res:
        lay = r["layout"]
        require(lay["seq"] is not None and lay["seq"]["s_axes"] == ("data",)
                and not lay["b_sharded"],
                f"mesh_seq rank {r['rank']}: cache layout {lay}")
        loc, dis = r["runs"]["local"], r["runs"]["disaggregated"]
        require(loc["streams"] == dis["streams"],
                f"mesh_seq rank {r['rank']}: the arms' streams differ")
        for name, row in (("local", loc), ("disaggregated", dis)):
            require(row["decode_s"] == row["t_dispatch_s"] + row["t_await_s"],
                    f"mesh_seq {name}: decode_s != t_dispatch_s + t_await_s")
        require(dis["t_splice_s"] > 0 and dis["t_slot_write_s"] == 0
                and loc["t_slot_write_s"] > 0 and loc["t_splice_s"] == 0,
                f"mesh_seq: boundary walls in the wrong buckets: {dis} {loc}")
        require(dis["prefill_offloaded"] > 0 and dis["prefix_hits"] > 0
                and dis["kv_tail_hops"] > 0,
                f"mesh_seq disaggregated rank {r['rank']}: offloaded "
                f"{dis['prefill_offloaded']}, hits {dis['prefix_hits']}, "
                f"KV tails {dis['kv_tail_hops']}")
        for name, row in (("local", loc), ("disaggregated", dis)):
            out = _mesh_row("mesh_seq", r, name, row)
            out["layout"] = lay
            emit(out)
            counts[f"{ARCH} mesh_seq 2x2 rank {r['rank']} {name}"] = \
                row["launches"]
        progs = r["profile"]["programs"]
        require(set(progs) >= {"decode_loop", "splice", "slot_write",
                               "prefill"}, f"mesh_profile: {sorted(progs)}")
        require(progs["splice"]["collective_bytes"]["total"] == 0
                and progs["slot_write"]["collective_bytes"]["total"] == 0,
                f"mesh_profile rank {r['rank']}: the splice or slot write "
                "moved collective bytes")
        emit({"phase": "mesh_profile", "rank": r["rank"], **r["profile"]})
    _check_f32("mesh_seq", res)
    return counts, _merge_shapes(res)


def phase_mesh_moe(torch, dev):
    """moonshot-v1-16b-a3b at full width, 4 of its 48 layers, on a (data=1,
    model=2) mesh, expert-parallel (32 experts a rank): the continuous
    engine (slots 4, K=8) over 6 requests; grouped_ffn launched with counts
    on both ranks, layers x (model decode steps + prefills); agreement with
    the one-rank streams reported.  The float32 2-layer copy: prefill and 4
    teacher-forced decode steps' logits within MESH_MOE_F32_TOL of the
    one-rank model (moe_parity's rule: excused only by a router margin
    below 1e-6; the parity gap rule does not apply, since the static
    batch's and the engine's prefills route under different capacities).
    One decode step's all_reduces equal ``_all_reduces_per_decode_step``
    (the router's gather a layer among them) and every leaf's bytes
    ``param_spec``'s (``_spec_mismatches``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.spawn import run_ranks
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_MOE_LAYERS)
    reqs = _continuous_requests(cfg, n_requests=SIDE_REQUESTS,
                                most_new=SIDE_MAX_NEW)
    res = run_ranks(_rank_mesh_moe, 2, (1, 2), reqs, timeout_s=MESH_TIMEOUT_S)
    _mesh_checks("mesh_moe", cfg, res)
    f32 = res[0]["f32"]
    excused = f32["min_router_margin"] < 1e-6
    require(max(f32["max_abs_err"]) <= MESH_MOE_F32_TOL or excused,
            f"mesh_moe float32 copy: logits off the one-rank model by "
            f"{f32['max_abs_err']} > {MESH_MOE_F32_TOL} with no router margin "
            f"below 1e-6 ({f32['min_router_margin']})")
    emit({"phase": "mesh_moe", "run": "float32 2-layer copy",
          "steps": ["prefill"] + [f"decode {i}" for i in range(MESH_MOE_F32_STEPS)],
          **f32, "tolerance": MESH_MOE_F32_TOL,
          "excused_by_router_margin": excused})
    want_calls = _all_reduces_per_decode_step(cfg, (1, 2), SIDE_SLOTS,
                                              CONT_MAX_LEN)
    counts = {}
    for r in res:
        require(r["decode_step_all_reduces"] == want_calls,
                f"mesh_moe rank {r['rank']}: {r['decode_step_all_reduces']} "
                f"all_reduces a decode step, expected {want_calls}")
        require(not r["spec_mismatches"], f"mesh_moe rank {r['rank']}: "
                f"leaves off param_spec {r['spec_mismatches']}")
        require(r["experts_held"] == cfg.num_experts // 2,
                f"mesh_moe rank {r['rank']}: holds {r['experts_held']} experts")
        require(r["ffn_shapes"] and all(k[0] == cfg.num_experts // 2 and k[-1]
                                        for k in r["ffn_shapes"]),
                f"mesh_moe rank {r['rank']}: grouped_ffn calls {r['ffn_shapes']}")
        row = r["runs"]["fused"]
        out = _mesh_row("mesh_moe", r, "fused", row)
        out.update(layers=MESH_MOE_LAYERS, layers_of=get_config(MOE_ARCH).num_layers,
                   experts_held=r["experts_held"],
                   decode_step_all_reduces=r["decode_step_all_reduces"],
                   expected_decode_step_all_reduces=want_calls,
                   agreement_with_one_rank=_agreement(row["streams"],
                                                      res[0]["one_rank"]))
        emit(out)
        counts[f"{MOE_ARCH} mesh_moe 1x2 ({MESH_MOE_LAYERS} layers) rank "
               f"{r['rank']}"] = row["launches"]
    return counts, _merge_shapes(res)


def phase_mesh_nccl(torch, dev, ref_streams):
    """The mesh_dense path at world size 1 over NCCL: the fused continuous
    run's streams identical to the one-rank run's, and NCCL's own
    all_reduce and broadcast right."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.spawn import run_ranks
    cfg = get_config(ARCH)
    reqs = _continuous_requests(cfg)
    res = run_ranks(_rank_mesh_nccl, 1, reqs, backend="nccl",
                    timeout_s=MESH_TIMEOUT_S)
    _mesh_checks("mesh_nccl", cfg, res)
    r = res[0]
    row = r["runs"]["fused"]
    agree = _agreement(row["streams"], ref_streams)
    require(r["backend"] == "nccl" and r["nccl_check"] == [0.0, 1.0, 2.0, 3.0],
            f"mesh_nccl: backend {r['backend']}, all_reduce {r['nccl_check']}")
    require(agree["identical_requests"] == agree["requests"],
            f"mesh_nccl: streams differ from the one-rank run: {agree}")
    out = _mesh_row("mesh_nccl", r, "fused", row)
    out["agreement_with_one_rank"] = agree
    emit(out)
    return {f"{ARCH} mesh_nccl 1x1": row["launches"]}


# ---------------------------------------------------------------------------
# The SSM, hybrid, vlm and audio families on a mesh
# ---------------------------------------------------------------------------
# phase -> (arch, mesh, slots): falcon-mamba at full depth, the others at
# full width and depth too; the vlm's 3 slots on (2, 2) spill its batch onto
# the cache's sequence (the 256 prologue rows in the sequence shards).
# mesh_dcut and mesh_gqa16 run JAX's param_spec fallback cuts
# (launch.mesh.ATTN_CUTS): internvl2-1b's 14 / 2 heads on a "model" axis of
# 4 are Case D (every projection, the tied table and frontend_proj on D);
# llama3.2-1b's 32 / 8 heads on 16 are Case Q (2 query heads a rank, wk/wv
# on 128 of their 2048 D rows); both caches sequence-sharded over "model"
MESH_FAMILIES = {"mesh_ssm": (SSM_ARCH, (1, 2), SIDE_SLOTS),
                 "mesh_hybrid": (HYBRID_ARCH, (1, 2), HYBRID_REQUESTS),
                 "mesh_vlm": (VLM_ARCH, (2, 2), MESH_SEQ_SLOTS),
                 "mesh_audio": (AUDIO_ARCH, (1, 2), SIDE_SLOTS),
                 "mesh_dcut": (VLM_ARCH, (1, 4), SIDE_SLOTS),
                 "mesh_gqa16": (ARCH, (1, 16), SIDE_SLOTS)}
# each phase's cut of the attention and the tables
MESH_CUTS = {"mesh_ssm": (None, "vocab"), "mesh_hybrid": ("heads", "vocab"),
             "mesh_vlm": ("heads", "d"), "mesh_audio": ("heads", "vocab"),
             "mesh_dcut": ("d", "d"), "mesh_gqa16": ("q", "vocab")}
# the cache's sequence axes and whether the batch splits
MESH_LAYOUT = {"mesh_vlm": (("data",), False), "mesh_dcut": (("model",), True),
               "mesh_gqa16": (("model",), True)}
# the reduced() float32 copy's heads and vocabulary, chosen to hit the
# phase's cut: Case D (6 / 2 heads of 32 on 4, a 509-row vocab on D), Case Q
# (32 / 8 heads of 16 on 16)
MESH_F32_REPLACE = {"mesh_dcut": dict(num_heads=6, num_kv_heads=2,
                                      head_dim=32, vocab_size=509),
                    "mesh_gqa16": dict(num_heads=32, num_kv_heads=8,
                                       head_dim=16, num_layers=1)}
# params built on the host once, each rank loading its shard from the file
# (mmap): 16 whole copies would not fit on the card together
MESH_HOST_PARAMS = ("mesh_gqa16",)
# depth cuts of the family phases, for the script's time limit: mesh_gqa16
# (a gloo all_reduce over 16 ranks on the one card's host takes 60-90 ms,
# PERF.md §5, so llama's 16 layers, 82 a decode step, would hold the
# 168 decode steps of its traffic for ~15 minutes; one layer at full width
# runs every piece of Case Q), mesh_vlm and mesh_hybrid (mesh_dcut keeps
# internvl2-1b's full depth)
MESH_LAYERS = {"mesh_gqa16": 1, "mesh_vlm": 12, "mesh_hybrid": 18}
# mesh_gqa16's traffic: the first 8 of mesh_dense's requests, at most 16
# new tokens each (16 decode steps)
MESH_GQA16_REQUESTS, MESH_GQA16_MAX_NEW = 8, 16
VLM_MESH_ARMS = (("per-step-cached", 0, False),
                 ("overlapped-disaggregated", MACRO, True))
# the arms a vlm phase serves: mesh_dcut the disaggregated one only (its
# KV tails on masked_compact; over four ranks the arms' bf16 streams may
# round apart, so a second arm would only be reported)
MESH_VLM_ARMS = {"mesh_vlm": VLM_MESH_ARMS, "mesh_dcut": VLM_MESH_ARMS[1:]}


def _family_traffic(cfg, phase, short=False):
    """(requests, cache rows) of a family phase, made for
    ``cfg`` (the full config or its reduced() copy): ssm_continuous's 6
    requests of 128 tokens for falcon-mamba; the hybrid slice's 4 requests
    of 128 tokens and 16 new; vlm_continuous's 12 requests in 4 image
    groups for internvl2-1b; the first MESH_GQA16_REQUESTS of mesh_dense's
    continuous requests, at most MESH_GQA16_MAX_NEW new tokens each (512
    cache rows) for mesh_gqa16, or with ``short`` the 6 of the others; for
    seamless request_stream(seed=0)'s first 6 prompts of 128 tokens with
    their frame embeddings and ssm_continuous's max_new."""
    from repro_torch.data.pipeline import request_stream
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServeRequest
    if cfg.family == "vlm":
        rows = M.frontend_offset(cfg) + VLM_CONT_P + VLM_CONT_MAX_NEW + 8
        return _vlm_continuous_requests(cfg), rows
    if phase == "mesh_gqa16" and not short:
        return [dataclasses.replace(r, max_new=min(r.max_new,
                                                   MESH_GQA16_MAX_NEW))
                for r in _continuous_requests(cfg)[:MESH_GQA16_REQUESTS]], \
            CONT_MAX_LEN
    if phase == "mesh_hybrid":
        prompts = _prompts(cfg)
        return ([ServeRequest(uid=i, prompt=prompts[i], max_new=HYBRID_MAX_NEW)
                 for i in range(HYBRID_REQUESTS)],
                PROMPT_LEN + HYBRID_MAX_NEW + 8)
    if cfg.frontend:
        stream = request_stream(cfg.vocab_size, n=SIDE_REQUESTS,
                                mean_prompt=PROMPT_LEN, seed=0,
                                frontend_tokens=cfg.frontend_tokens,
                                frontend_dim=cfg.frontend_dim or cfg.d_model)
        prompts = [np.pad(r.prompt[:PROMPT_LEN],
                          (0, max(0, PROMPT_LEN - len(r.prompt)))).astype(np.int32)
                   for r in stream]
        frontends = [r.frontend for r in stream]
    else:
        prompts, frontends = _prompts(cfg), [None] * SIDE_REQUESTS
    return ([ServeRequest(uid=i, prompt=prompts[i], max_new=m,
                          frontend=frontends[i])
             for i, m in enumerate(SIDE_MAX_NEWS)],
            PROMPT_LEN + SIDE_MAX_NEW + 8)


# all_reduces of one decode step of an attention sublayer over "model" by
# its cut (``launch.mesh.ATTN_CUTS``), before the lse merge of a
# sequence-sharded cache: "heads" the output projection; "q" k and v with
# the query heads' gather, and the output projection; "d" q, k and v, and
# the output's D gather.  A cross-attention sublayer's: "q" the query
# heads' gather and the output projection, "d" q and the output's D gather
ATTN_DECODE_ALL_REDUCES = {None: 0, "heads": 1, "q": 2, "d": 2}
CROSS_DECODE_ALL_REDUCES = {None: 0, "heads": 1, "q": 2, "d": 2}


def _all_reduces_per_decode_step(cfg, shape, B, S=None):
    """The all_reduces one decode step runs on a rank of a (data, model)
    or (pod, data, model) mesh ``shape`` over a cache of ``S`` rows (None:
    a length every sequence split divides) (PERF.md §6;
    tests/test_torch_mesh_families.py, tests/test_torch_mesh_fallback.py
    and tests/test_torch_dryrun.py hold the ranks to the same count), the
    batch axes taken together, the cuts those of ``launch.mesh.model_cuts``:
    the embedding and the LM head where "model" cuts their table (on its
    vocab rows or its D columns), a gather of the batch rows when the batch
    splits over batch axes > 1; two a Mamba layer (the mixer's channels
    split), and a Mamba-2 layer one more (``dt_proj``'s gather: it is held
    on its heads); a self-attention sublayer ``ATTN_DECODE_ALL_REDUCES`` of its
    cut, two more when its cache's sequence is sharded (the lse merge: the
    batch spills onto the sequence, or "model" does not divide the kv
    heads); a cross-attention sublayer ``CROSS_DECODE_ALL_REDUCES``; an MLP
    one; an MoE layer one, one more (its aux loss's mean) when the batch
    splits over batch axes > 1, and one more (its router's gather) where
    "model" cuts the router."""
    from repro_torch.launch.mesh import model_cuts, serving_model_dim
    *batch, model = shape
    data = math.prod(batch)
    b_split = B % data == 0 and B >= data
    if model == 1 and data == 1:
        return 0
    cuts = model_cuts(cfg, model)
    n = (cuts.embed is not None) + (cuts.head is not None) \
        + (1 if b_split and data > 1 else 0)
    attn = 0
    if cfg.num_heads:
        hkv = cfg.num_kv_heads
        sdiv = (1 if b_split else data) \
            * (model if hkv % model or hkv < model else 1)
        seq = sdiv > 1 and (S is None or (S % sdiv == 0 and S >= sdiv))
        attn = ATTN_DECODE_ALL_REDUCES[cuts.attn] + (2 if seq else 0)
    mlp = 1 if model > 1 else 0
    mamba = (2 + (cfg.mamba_version == 2)) if model > 1 else 0
    if cfg.family == "ssm":
        return n + mamba * cfg.num_layers
    if cfg.family == "hybrid":
        return n + mamba * cfg.num_layers \
            + (cfg.num_layers // cfg.hybrid_attn_every) * (attn + mlp)
    per_layer = attn + mlp
    if cfg.family == "audio":
        per_layer += CROSS_DECODE_ALL_REDUCES[cuts.attn]
    if cfg.num_experts and b_split and data > 1:
        per_layer += 1
    if cfg.num_experts and serving_model_dim(
            ("blocks", "moe", "router"),
            (cfg.num_layers, cfg.d_model, cfg.num_experts), model) is not None:
        per_layer += 1
    return n + per_layer * cfg.num_layers


def _decode_step_all_reduces(torch, dev, mesh, cfg, params, slots, max_len):
    """The all_reduces of one decode step of the engine's shape on this
    rank (kernels on; outside the counted runs)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, slots, max_len, device=dev)
    shard = M.cache_shard(cfg, slots, max_len)
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    idx = torch.full((slots,), 8, dtype=torch.int32, device=dev)
    with torch.no_grad(), coll.counting(mesh) as cc:
        M.forward(params, cfg, {"token": tok, "cache": cache,
                                "cache_index": idx},
                  mode="decode", use_kernels=True, shard=shard)
    torch.cuda.synchronize()
    return cc.calls["all-reduce"]


def _phase_config(phase):
    """The phase's config at full width, its depth cut as ``MESH_LAYERS``
    says (full depth elsewhere)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(MESH_FAMILIES[phase][0])
    layers = MESH_LAYERS.get(phase)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _f32_config(phase):
    """The phase's reduced() float32 config (``MESH_F32_REPLACE``)."""
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(MESH_FAMILIES[phase][0])),
                               **MESH_F32_REPLACE.get(phase, {}))


def _spec_mismatches(cfg, shard, mesh):
    """{leaf: (bytes held, bytes by param_spec)} of every leaf of this
    rank's serving shard whose bytes differ from the port's ``param_spec``
    (JAX's rule, ``fsdp=False``) on ``mesh``: every leaf, the MoE layer's
    shared experts too (cut on another dim than JAX's, with its bytes)."""
    from repro_torch.launch.mesh import _stacked, param_spec
    from repro_torch.models import model as M
    sizes = dict(mesh.shape)
    out = {}

    def walk(full, part, names):
        if isinstance(full, dict):
            for k in full:
                walk(full[k], part[k], names + (k,))
            return
        spec = param_spec(names, tuple(full.shape), model_size=sizes["model"],
                          data_size=sizes.get("data", 1),
                          stacked=_stacked(names), fsdp=False)
        want = full.numel() * part.element_size()
        for e in spec:
            want //= sizes[e] if e else 1
        got = part.numel() * part.element_size()
        if got != want:
            out["/".join(names)] = (got, want)

    walk(M.init_params(cfg, 0, device="meta"), shard, ())
    return out


def _rank_family_f32(torch, dev, mesh, phase, slots):
    """The phase's reduced() float32 copy (seed 0): the one-rank plain
    streams (rank 0, off the mesh), then the mesh engine (kernels on,
    K=8) on this rank's shard over the phase's traffic made for it."""
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    cfg = _f32_config(phase)
    params = M.init_params(cfg, 0, device=dev)
    # 16 ranks' gloo calls cost ~60-90 ms each: mesh_gqa16's copy serves
    # the short traffic
    reqs, max_len = _family_traffic(cfg, phase, short=phase == "mesh_gqa16")
    reqs = reqs[:MESH_F32_REQUESTS]
    plain = _plain_streams(torch, dev, cfg, params, reqs, max_len) \
        if mesh.rank == 0 else None
    with activation_sharding(mesh):
        _, row = _rank_run(torch, dev, mesh, cfg, shard_params(params, mesh),
                           reqs, slots=slots, max_len=max_len,
                           macro_steps=MACRO)
    out = {"launches": row["launches"], "requests": row["requests"],
           "model_decode_steps": row["model_decode_steps"]}
    if plain is not None:
        out["rule"] = _gap_rule(row["streams"], *plain)
        out["min_top2_gap"] = float(plain[1].min())
    return out


def _host_params_path(arch):
    """Where a phase of ``MESH_HOST_PARAMS`` keeps the config's seed-0
    params built on the host (under the git-ignored build/)."""
    return ROOT / "build" / "mesh_params" / f"{arch}-seed0.pt"


def _rank_mesh_family(rank, world, shape, phase):
    """One family phase on one rank: the config at full width and depth
    (bf16, seed 0; on the card, or for ``MESH_HOST_PARAMS`` from the
    host-built file) sharded over the mesh, its continuous traffic (the
    vlm: per-step with a PrefixCache, then overlapped with a PrefillWorker
    and a PrefixCache), each decode step's all_reduces, the leaves against
    ``param_spec``, then the reduced() float32 copy."""
    t0 = time.perf_counter()
    torch, dev, mesh = _rank_env(shape)
    import repro_torch.core as C
    from repro_torch.core.offload import tree_map
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.serving.prefill import PrefillWorker
    from repro_torch.serving.prefix_cache import PrefixCache
    arch, _, slots = MESH_FAMILIES[phase]
    cfg = _phase_config(phase)
    if phase in MESH_HOST_PARAMS:
        full = torch.load(_host_params_path(arch), mmap=True,
                          weights_only=True)
        params = tree_map(lambda t: t.to(dev), shard_params(full, mesh))
        del full
    else:
        params = shard_params(M.init_params(cfg, 0, device=dev), mesh)
    _free(torch)
    spec_mismatches = _spec_mismatches(cfg, params, mesh)
    held = {}
    if "attn" in params["blocks"]:
        attn, mlp = params["blocks"]["attn"], params["blocks"].get("mlp", {})
        held = {"wq": list(attn["wq"].shape), "wk": list(attn["wk"].shape),
                "wo": list(attn["wo"].shape),
                "table": list(params["embed"]["table"].shape)}
        if "w_down" in mlp:
            held["w_down"] = list(mlp["w_down"].shape)
        if "frontend_proj" in params:
            held["frontend_proj"] = list(params["frontend_proj"].shape)
    reqs, max_len = _family_traffic(cfg, phase)
    kw = dict(slots=slots, max_len=max_len)
    runs = {}
    walls = {"setup_s": time.perf_counter() - t0}
    with _MeshRecorder() as rec, activation_sharding(mesh):
        if cfg.family == "vlm":
            for name, k, remote in MESH_VLM_ARMS[phase]:
                pc = PrefixCache(cfg, block_size=8, budget_blocks=256,
                                 device=dev)
                worker = PrefillWorker(cfg, params, device=dev,
                                       link=C.ICI_LINK) if remote else None
                _, runs[name] = _rank_run(torch, dev, mesh, cfg, params, reqs,
                                          rec, macro_steps=k, prefix_cache=pc,
                                          prefill_worker=worker, **kw)
                pc.check_invariants()
            del pc, worker
        else:
            _, runs["fused"] = _rank_run(torch, dev, mesh, cfg, params, reqs,
                                         rec, macro_steps=MACRO, **kw)
        eng_shard = M.cache_shard(cfg, slots, max_len)
    walls["runs_s"] = time.perf_counter() - t0 - walls["setup_s"]
    layout = eng_shard._asdict()
    layout.pop("mesh")
    layout["seq"] = layout["seq"]._asdict() if layout["seq"] else None
    with activation_sharding(mesh):
        calls = _decode_step_all_reduces(torch, dev, mesh, cfg, params, slots,
                                         max_len)
    if cfg.family == "ssm":
        held["mixer_channels"] = int(
            params["blocks"]["mamba"]["conv_w"].shape[-1])
    del params
    _free(torch)
    out = {"rank": rank, "runs": runs, "layout": layout, "max_len": max_len,
           "decode_step_all_reduces": calls, "held": held,
           "spec_mismatches": spec_mismatches,
           "decode_shapes": rec.decode, "ffn_shapes": rec.ffn,
           "hop_shapes": rec.hops, "scan_shapes": rec.scan}
    t1 = time.perf_counter()
    out["f32"] = _rank_family_f32(torch, dev, mesh, phase, slots)
    out["walls"] = dict(walls, f32_s=time.perf_counter() - t1,
                        total_s=time.perf_counter() - t0)
    return out


def _one_rank_gqa16(torch, dev):
    """mesh_gqa16's weights built on the host (seed 0) and saved for the
    ranks (``_host_params_path``), and its one-rank run:
    those weights on the card, the phase's traffic and slots, fused (K=8).
    Returns (streams {uid: tokens}, {"fused": row})."""
    from repro_torch.core.offload import tree_map
    from repro_torch.models import model as M
    cfg = _phase_config("mesh_gqa16")
    path = _host_params_path(cfg.name)
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    host = M.init_params(cfg, 0, device="cpu")
    torch.save(host, path)
    built_s = time.perf_counter() - t0
    params = tree_map(lambda t: t.to(dev), host)
    del host
    reqs, max_len = _family_traffic(cfg, "mesh_gqa16")
    outs, stats, counts, wall, peak = _run_engine(
        torch, dev, cfg, params, reqs, slots=MESH_FAMILIES["mesh_gqa16"][2],
        max_len=max_len, macro_steps=MACRO)
    row = _stats_row(stats, wall, peak, counts, MACRO)
    require(counts["decode_attention"] == cfg.num_layers
            * row["model_decode_steps"],
            f"mesh_gqa16 one rank: decode_attention {counts}")
    emit({"phase": "mesh_gqa16_one_rank", "arch": cfg.name,
          "host_params_s": built_s, **row})
    streams = {o.uid: o.tokens.tolist() for o in outs}
    del params, outs
    _free(torch)
    return streams, {"fused": row}


def phase_mesh_family(torch, dev, phase, one_rank=None, one_rank_rows=None):
    """One family phase (``MESH_FAMILIES``) over ranks spawned on the card:
    mesh_ssm (falcon-mamba-7b at full width and depth on (1, 2): ssm_scan
    on each rank's 4096 channels), mesh_hybrid (zamba2-2.7b on (1, 2):
    Mamba-2 on 40 heads a rank, the shared block's 16 heads and their KV
    cache), mesh_vlm (internvl2-1b on (2, 2), 3 slots: the prologue rows in
    the sequence-sharded cache, the local and the disaggregated arm with
    the prologue root, the vocab on D), mesh_audio (seamless-m4t-medium on
    (1, 2): the encoder and the cross cache split by heads), mesh_dcut
    (internvl2-1b on (1, 4): Case D, every projection, the tied table and
    frontend_proj on 224 of the 896 D columns, the disaggregated arm) and
    mesh_gqa16 (llama3.2-1b on (1, 16): Case Q, 2 query heads a rank,
    wk/wv on 128 of their 2048 rows, the MLP on 512 of 8192, 8016 vocab
    rows; mesh_dense's first 8 requests, 4 slots, fused); ``MESH_LAYERS``
    cuts some depths.  Checks every run's
    launches on every rank (``_mesh_checks``), every rank's streams
    identical, every leaf's bytes against ``param_spec`` (``MESH_CUTS``
    names the cuts), one decode step's all_reduces equal to
    ``_all_reduces_per_decode_step``; the cache layout (``MESH_LAYOUT``);
    the vlm's arms identical, with 8 prefix hits each and KV tails on the
    disaggregated one; falcon's ssm_scan shapes on di / 2 channels; the
    reduced() float32 copy within the parity rule.  Reports each run
    beside ``one_rank_rows`` (the same traffic on one rank, where a phase
    ran it) and the streams that agree with ``one_rank``.  Returns
    ({path: launch counts}, recorded shapes)."""
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.launch.mesh import model_cuts
    arch, shape, slots = MESH_FAMILIES[phase]
    cfg = _phase_config(phase)
    m = shape[-1]
    cuts = model_cuts(cfg, m)
    require((cuts.attn, cuts.embed) == MESH_CUTS[phase],
            f"{phase}: cuts {cuts}, expected {MESH_CUTS[phase]}")
    prompt_len = VLM_CONT_P if cfg.family == "vlm" else \
        CONT_P if phase == "mesh_gqa16" else PROMPT_LEN
    res = run_ranks(_rank_mesh_family, int(np.prod(shape)), shape, phase,
                    timeout_s=MESH_TIMEOUT_S)
    _mesh_checks(phase, cfg, res, prompt_len)
    want_calls = _all_reduces_per_decode_step(cfg, shape, slots,
                                              res[0]["max_len"])
    counts = {}
    for r in res:
        require(r["decode_step_all_reduces"] == want_calls,
                f"{phase} rank {r['rank']}: {r['decode_step_all_reduces']} "
                f"all_reduces a decode step, expected {want_calls}")
        require(not r["spec_mismatches"],
                f"{phase} rank {r['rank']}: leaves off param_spec "
                f"{r['spec_mismatches']}")
        if cfg.family == "ssm":
            held = r["held"]["mixer_channels"]
            require(held == cfg.d_inner // shape[1]
                    and r["scan_shapes"]
                    and all(k[2] == cfg.d_inner // shape[1]
                            for k in r["scan_shapes"]),
                    f"{phase} rank {r['rank']}: ssm_scan shapes "
                    f"{r['scan_shapes']} on {held} channels")
        if phase == "mesh_gqa16":      # 2 query heads, 128 D rows, 512, 8016
            want = {"wq": [cfg.num_layers, cfg.d_model, cfg.num_heads // m,
                           cfg.head_dim],
                    "wk": [cfg.num_layers, cfg.d_model // m, cfg.num_kv_heads,
                           cfg.head_dim],
                    "wo": [cfg.num_layers, cfg.num_heads // m, cfg.head_dim,
                           cfg.d_model],
                    "table": [cfg.vocab_size // m, cfg.d_model],
                    "w_down": [cfg.num_layers, cfg.d_ff // m, cfg.d_model]}
            require(r["held"] == want, f"{phase} rank {r['rank']}: held "
                    f"{r['held']}, expected {want}")
        if phase in MESH_LAYOUT:
            lay = r["layout"]
            s_axes, b_sharded = MESH_LAYOUT[phase]
            require(lay["seq"] is not None and lay["seq"]["s_axes"] == s_axes
                    and lay["b_sharded"] == b_sharded,
                    f"{phase} rank {r['rank']}: cache layout {lay}")
        if cfg.family == "vlm":
            runs = [r["runs"][a[0]] for a in MESH_VLM_ARMS[phase]]
            if len(runs) == 2:
                loc = runs[0]
                require(loc["streams"] == runs[1]["streams"],
                        f"{phase} rank {r['rank']}: the arms' streams differ")
                require(loc["kv_tail_hops"] == 0,
                        f"{phase} rank {r['rank']}: KV tails on the local arm")
            dis = runs[-1]
            n_req = len(dis["streams"])
            require(all(run["prefix_hits"] == n_req - 4 for run in runs),
                    f"{phase} rank {r['rank']}: prefix hits "
                    f"{[run['prefix_hits'] for run in runs]}, expected "
                    f"{n_req - 4}")
            require(dis["kv_tail_hops"] > 0 and dis["prefill_offloaded"] > 0,
                    f"{phase} rank {r['rank']}: KV tails {dis['kv_tail_hops']}"
                    f", offloaded {dis['prefill_offloaded']}")
        for mode, row in r["runs"].items():
            one = one_rank_rows.get(mode) if one_rank_rows else None
            out = _mesh_row(phase, r, mode, row, one)
            out.update(arch=arch, mesh={"data": shape[0], "model": shape[1]},
                       slots=slots, layout=r["layout"], held=r["held"],
                       rank_walls=r["walls"],
                       cuts=cuts._asdict(),
                       decode_step_all_reduces=r["decode_step_all_reduces"],
                       expected_decode_step_all_reduces=want_calls,
                       scan_shapes=[list(k) + [n] for k, n in
                                    sorted(r["scan_shapes"].items())])
            if one_rank is not None:
                out["agreement_with_one_rank"] = _agreement(row["streams"],
                                                            one_rank)
            emit(out)
            counts[f"{arch} {phase} {shape[0]}x{shape[1]} rank {r['rank']} "
                   f"{mode}"] = row["launches"]
    _check_f32(phase, res, _f32_config(phase), prompt_len,
               run="reduced() float32 copy")
    return counts, _merge_shapes(res)


def phase_mesh_gqa16(torch, dev):
    """JAX's fallback cut Case Q on 16 ranks: the one-rank run on the
    host-built weights (``_one_rank_gqa16``), then ``phase_mesh_family``'s
    mesh_gqa16 on them; the weights' file removed after."""
    ref = timed("mesh_gqa16_one_rank", _one_rank_gqa16, torch, dev)
    try:
        return phase_mesh_family(torch, dev, "mesh_gqa16", *ref)
    finally:
        _host_params_path(ARCH).unlink(missing_ok=True)


MESH_SHAPE_KINDS = ("decode", "ffn", "hops", "scan", "scan_bwd")


def _merge_shapes(res):
    """The ranks' recorded launch shapes summed: {"decode", "ffn", "hops",
    "scan", "scan_bwd"}, each shape -> calls."""
    into = {key: {} for key in MESH_SHAPE_KINDS}
    for r in res:
        for key in MESH_SHAPE_KINDS:
            for k, n in r.get("hop_shapes" if key == "hops"
                              else f"{key}_shapes", {}).items():
                into[key][k] = into[key].get(k, 0) + n
    return into


def _shard_rows(B, S):
    """(local length, start) per slot at a shard of S rows: every shape a
    shard of a split cache meets -- the whole shard, a shard wholly past
    cache_len (length at s0: 0), wholly before the window (start = S), a
    window that starts inside it, a window inside it, a length inside it,
    a length at s0 + S_loc with the window below s0 -- cycled over B."""
    cases = [(S, 0), (0, 0), (S, S), (S, S // 2 + 3), (S - 2, S // 3),
             (S // 2 + 1, 0), (S, 0)]
    return [cases[b % len(cases)] for b in range(B)]


def phase_mesh_kernels(torch, dev, shapes):
    """With no model held: decode_attention with lse (and start) against
    its plain version at every shard shape the mesh phases launched, with
    the edge cases of _shard_rows; bf16 within 3e-2, f32 within 1e-4, the
    lse within 1e-4 and -inf exactly where the window is empty, 0 output
    there; every call twice, bit-equal, and its output bit-equal to the
    same call without lse.  grouped_ffn at every local-expert shape with
    counts; masked_compact bit for bit (both base-finding branches) at
    every KV tail a rank compacted ([layers, tail rows, the rank's
    Hkv*dh], all rows kept as the lossless hop keeps them); ssm_scan bit
    for bit against its plain version at every [B, S, di/m, N] a rank
    launched, twice, and ssm_scan_bwd bit for bit against ssm_scan_bwd_ref
    at every shape a rank's train step launched.  Times the lse call at
    mesh_seq's shard shape beside its bytes bound, the plain version and
    the call without lse, and ssm_scan, ssm_scan_bwd and grouped_ffn at
    every rank shape beside their bounds."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    cases = []
    errs = {"decode_attention": 0.0, "grouped_ffn": 0.0, "masked_compact": 0.0,
            "ssm_scan": 0.0}
    keys = sorted({k[:5] for k in shapes["decode"]})
    for (B, S, H, Hkv, dh) in keys:
        for dtype in (torch.bfloat16, torch.float32):
            rows = _shard_rows(B, S)
            q, k, v, cl = _decode_case(torch, gen, B, S, H, Hkv, dh, dtype,
                                       [r[0] for r in rows], dev)
            for with_start in (True, False):
                st = torch.as_tensor([r[1] for r in rows], dtype=torch.int32,
                                     device=dev) if with_start else None
                got, lse = decode_attention_cuda(q, k, v, cl, start=st, lse=True)
                again, lse2 = decode_attention_cuda(q, k, v, cl, start=st,
                                                    lse=True)
                want, wlse = ref.decode_attention_ref(q, k, v, cl, start=st,
                                                      lse=True)
                torch.cuda.synchronize()
                tag = (f"decode_attention lse B={B} S={S} H={H} Hkv={Hkv} "
                       f"dh={dh} {dtype} start={with_start}")
                empty = torch.isinf(wlse)
                err = float((got.float() - want.float()).abs().max())
                finite = ~empty
                lerr = float((lse[finite] - wlse[finite]).abs().max()) \
                    if bool(finite.any()) else 0.0
                require(err <= tol[dtype], f"{tag}: max_abs_err {err}")
                require(lerr <= LSE_TOL, f"{tag}: lse off by {lerr}")
                require(torch.equal(torch.isinf(lse), empty)
                        and bool((lse[empty] < 0).all()),
                        f"{tag}: lse not -inf exactly at the empty windows")
                require(not bool(got[:, 0][empty].any()),
                        f"{tag}: an empty window gave non-zero")
                require(torch.equal(got, again) and torch.equal(lse, lse2),
                        f"{tag}: two calls differ")
                if st is None:
                    plain = decode_attention_cuda(q, k, v, cl)
                    require(torch.equal(plain, got),
                            f"{tag}: lse changed the output")
                if dtype == torch.bfloat16:
                    errs["decode_attention"] = max(errs["decode_attention"], err)
                cases.append({"B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh,
                              "dtype": str(dtype)[6:], "start": with_start,
                              "max_abs_err": err, "lse_max_abs_err": lerr,
                              "empty_rows": int(empty.any(dim=1).sum())})
    emit({"phase": "mesh_kernels", "kernel": "decode_attention",
          "tolerance": {"bfloat16": 3e-2, "float32": 1e-4, "lse": LSE_TOL},
          "recorded": [list(k) + [n] for k, n in sorted(shapes["decode"].items())],
          "cases": cases})
    ffn_cases = []
    for (E, C, D, F, dt, _) in sorted(shapes["ffn"]):
        dtype = getattr(torch, dt)
        buf, wg, wu, wd = _ffn_case(torch, gen, E, C, D, F, dtype, dev)
        counts = torch.randint(0, C + 1, (E,), generator=gen, device=dev,
                               dtype=torch.int32)
        got = grouped_ffn_cuda(buf, wg, wu, wd, counts=counts)
        want = ref.grouped_ffn_ref(buf, wg, wu, wd, counts)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        require(err <= FFN_TOL[dt], f"mesh_kernels grouped_ffn {E}x{C}x{D}x{F}: "
                f"{err}")
        errs["grouped_ffn"] = max(errs["grouped_ffn"], err)
        ffn_cases.append({"E": E, "C": C, "D": D, "F": F, "dtype": dt,
                          "max_abs_err": err})
    emit({"phase": "mesh_kernels", "kernel": "grouped_ffn",
          "tolerance": FFN_TOL, "cases": ffn_cases})
    mc = [dict(_check_mc_at(torch, dev, gen, "mesh-kv-hop", L, Rt, D, "all"),
               recorded=n) for (L, Rt, D), n in sorted(shapes["hops"].items())]
    require(mc, "mesh_kernels: no KV tail recorded on the mesh paths")
    emit({"phase": "mesh_kernels", "kernel": "masked_compact",
          "tolerance": "exact", "cases": mc})
    scan = []
    for (B, S, di, N), n in sorted(shapes["scan"].items()):
        decay, bx, h0 = _scan_case(torch, gen, B, S, di, N, dev)
        got = ssm_scan_cuda(decay, bx, h0)
        again = ssm_scan_cuda(decay, bx, h0)
        want = ref.ssm_scan_ref(decay, bx, h0)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        require(all(torch.equal(g, w) and torch.equal(g, a)
                    for g, w, a in zip(got, want, again)),
                f"mesh_kernels ssm_scan [{B},{S},{di},{N}]: not bit-equal to "
                f"its plain version (max_abs_err {err}) or to itself")
        errs["ssm_scan"] = max(errs["ssm_scan"], err)
        scan.append({"B": B, "S": S, "di": di, "N": N, "recorded": n,
                     "max_abs_err": err, "exact": True})
        del decay, bx, h0, got, again, want
    require(scan, "mesh_kernels: no ssm_scan launch recorded on the mesh paths")
    emit({"phase": "mesh_kernels", "kernel": "ssm_scan", "tolerance": "exact",
          "cases": scan})
    bwd = []
    for (B, S, di, N), n in sorted(shapes["scan_bwd"].items()):
        decay, bx, h0 = _scan_case(torch, gen, B, S, di, N, dev)
        h_all = ssm_scan_cuda(decay, bx, h0)[0]
        G = torch.randn_like(decay)        # the train path: h_all's gradient
        got = ssm_scan_bwd_cuda(decay, h_all, h0, G, None)
        again = ssm_scan_bwd_cuda(decay, h_all, h0, G, None)
        want = ref.ssm_scan_bwd_ref(decay, h_all, h0, G, None)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        require(all(torch.equal(g, w) and torch.equal(g, a)
                    for g, w, a in zip(got, want, again)),
                f"mesh_kernels ssm_scan_bwd [{B},{S},{di},{N}]: not bit-equal "
                f"to ssm_scan_bwd_ref (max_abs_err {err}) or to itself")
        errs["ssm_scan_bwd"] = max(errs.get("ssm_scan_bwd", 0.0), err)
        bwd.append({"B": B, "S": S, "di": di, "N": N, "recorded": n,
                    "max_abs_err": err, "exact": True})
        del decay, bx, h0, h_all, G, got, again, want
    require(bwd, "mesh_kernels: no ssm_scan_bwd launch recorded on the mesh "
            "train path")
    emit({"phase": "mesh_kernels", "kernel": "ssm_scan_bwd",
          "tolerance": "exact", "cases": bwd})
    timing = [_time_lse(torch, dev, gen, shapes)]
    # mesh_gqa16's: every one of llama's 32 query heads over a rank's
    # 512 / 16 cache rows
    gqa = [k for k in shapes["decode"] if k[7] and k[2:6] == (32, 8, 64,
                                                              "bfloat16")
           and k[1] == CONT_MAX_LEN // 16]
    if gqa:
        timing.append(_time_lse(torch, dev, gen, shapes, key=max(gqa),
                                group="mesh_gqa16 shard"))
    timing += [_time_scan_rank(torch, dev, gen, k) for k in sorted(shapes["scan"])]
    timing += [_time_scan_bwd_rank(torch, dev, gen, k)
               for k in sorted(shapes["scan_bwd"])]
    timing += [_time_ffn_rank(torch, dev, gen, k) for k in sorted(shapes["ffn"])]
    return errs, timing


def _time_scan_rank(torch, dev, gen, key):
    """ssm_scan at a rank's shape ``key`` (falcon-mamba's B=1 admission
    prefill, or its train chunk, on di / 2 channels): ms a call, device ms
    and the plain version's ms, beside the bytes bound (decay, bx and
    h_all of every element, h0 and h_last, f32, each once)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    B, S, di, N = key
    C = di * N
    sets = [_scan_case(torch, gen, B, S, di, N, dev)
            for _ in range(_sets_for(4 * B * C * (2 * S + 1)))]
    cost = costs.ssm_scan(B, S, di, N)
    n_bytes = cost["bytes"]
    bound_ms, bound_by = _bound(n_bytes, cost["flops"], H100_PEAK_FLOPS_F32)
    row = {"phase": "mesh_kernels_timing", "kernel": "ssm_scan",
           "group": "mesh rank", "B": B, "S": S, "di": di, "N": N,
           "dtype": "float32",
           "ms": _time_ms(torch, ssm_scan_cuda, sets, iters=40, warmup=4),
           "device_ms": _device_ms(torch, ssm_scan_cuda, sets, iters=10),
           "plain_ms": _time_ms(torch, ref.ssm_scan_ref, sets, iters=4,
                                warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this recurrence",
           "sets": len(sets)}
    emit(row)
    del sets
    return row


def _time_scan_bwd_rank(torch, dev, gen, key):
    """ssm_scan_bwd at a rank's train chunk ``key``, as the train path
    calls it (the gradient of h_all only): ms, device ms and the plain
    reverse loop's ms, beside the bytes bound (decay, h_all, G and h0 read,
    d_decay, d_bx and d_h0 written, f32, each once)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda
    B, S, di, N = key
    Cn = di * N
    sets = []
    for _ in range(_sets_for(4 * B * Cn * (3 * S + 1))):
        decay, bx, h0 = _scan_case(torch, gen, B, S, di, N, dev)
        sets.append((decay, ref.ssm_scan_ref(decay, bx, h0)[0], h0,
                     torch.randn_like(decay), None))
        del bx
    cost = costs.ssm_scan_bwd(B, S, di, N)
    n_bytes = cost["bytes"]
    bound_ms, bound_by = _bound(n_bytes, cost["flops"], H100_PEAK_FLOPS_F32)
    row = {"phase": "mesh_kernels_timing", "kernel": "ssm_scan_bwd",
           "group": "mesh_train_ssm rank", "B": B, "S": S, "di": di, "N": N,
           "dtype": "float32",
           "ms": _time_ms(torch, ssm_scan_bwd_cuda, sets, iters=40, warmup=4),
           "device_ms": _device_ms(torch, ssm_scan_bwd_cuda, sets, iters=10),
           "plain_ms": _time_ms(torch, ref.ssm_scan_bwd_ref, sets, iters=2,
                                warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this backward",
           "sets": len(sets)}
    emit(row)
    del sets
    return row


def _time_ffn_rank(torch, dev, gen, key):
    """grouped_ffn at a rank's expert shape ``key`` (E, C, D, F, dtype,
    counts) with random counts: ms, device ms and the plain version's ms,
    beside the bound over these counts' experts and rows (rows read, the
    output written, the used experts' weights, the counts)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.grouped_ffn import grouped_ffn_cuda
    E, C, D, F, dt, _ = key
    dtype = getattr(torch, dt)
    es = torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(_sets_for(3 * E * D * F * es)):
        buf, wg, wu, wd = _ffn_case(torch, gen, E, C, D, F, dtype, dev)
        counts = torch.randint(0, C + 1, (E,), generator=gen, device=dev,
                               dtype=torch.int32)
        sets.append((buf, wg, wu, wd, counts))
    rows = sum(int(c.sum()) for *_, c in sets) / len(sets)
    used = sum(int((c > 0).sum()) for *_, c in sets) / len(sets)
    cost = costs.grouped_ffn(E, C, D, F, es, routed_rows=rows,
                             experts_used=used, counts=True)
    n_bytes = cost["bytes"]
    bound_ms, bound_by = _bound(n_bytes, cost["flops"])
    row = {"phase": "mesh_kernels_timing", "kernel": "grouped_ffn",
           "group": "mesh rank", "E": E, "C": C, "D": D, "F": F, "dtype": dt,
           "routed_rows_mean": rows, "experts_used_mean": used,
           "ms": _time_ms(torch, grouped_ffn_cuda, sets, iters=40, warmup=4),
           "device_ms": _device_ms(torch, grouped_ffn_cuda, sets, iters=20),
           "plain_ms": _time_ms(torch, ref.grouped_ffn_ref, sets, iters=4,
                                warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
           "library_ms": None,
           "library": "none: no single PyTorch call computes this function",
           "sets": len(sets)}
    emit(row)
    del sets
    return row


def _time_lse(torch, dev, gen, shapes, key=None, group="mesh_seq shard"):
    """decode_attention with lse and start at the largest shard shape the
    mesh phases launched with lse (mesh_seq's, bf16), or at ``key``:
    device ms and ms beside the bytes bound (q, the K/V rows of the windows
    -- here every row --, lengths, starts, output and lse, each once), the
    plain version's ms and the same call without lse."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    key = key or max((k for k in shapes["decode"] if k[7]),
                     key=lambda k: (k[5] == "bfloat16", k[0] * k[1] * k[3]))
    B, S, H, Hkv, dh = key[:5]
    dtype = getattr(torch, key[5])
    es = torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(_sets_for(2 * B * S * Hkv * dh * es)):
        q, k, v, cl = _decode_case(torch, gen, B, S, H, Hkv, dh, dtype, [S] * B,
                                   dev)
        sets.append((q, k, v, cl, torch.zeros((B,), dtype=torch.int32,
                                              device=dev)))
    lse_call = lambda q, k, v, cl, st: decode_attention_cuda(  # noqa: E731
        q, k, v, cl, start=st, lse=True)
    plain_call = lambda q, k, v, cl, st: decode_attention_cuda(q, k, v, cl)  # noqa: E731
    ref_call = lambda q, k, v, cl, st: ref.decode_attention_ref(  # noqa: E731
        q, k, v, cl, start=st, lse=True)
    cost = costs.decode_attention(B, H, Hkv, dh, B * S, es, start=True,
                                  lse=True)
    bound_ms, bound_by = _bound(cost["bytes"], cost["flops"])
    row = {"phase": "mesh_kernels_timing", "kernel": "decode_attention",
           "variant": "lse+start", "group": group,
           "B": B, "S": S, "H": H, "Hkv": Hkv, "dh": dh, "dtype": key[5],
           "ms": _time_ms(torch, lse_call, sets),
           "device_ms": _device_ms(torch, lse_call, sets),
           "ms_without_lse": _time_ms(torch, plain_call, sets),
           "device_ms_without_lse": _device_ms(torch, plain_call, sets),
           "plain_ms": _time_ms(torch, ref_call, sets, iters=20, warmup=2),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library_note": "not timed: the aten call that returns the "
                           "log-sum-exp beside the output, "
                           "_scaled_dot_product_efficient_attention("
                           "compute_log_sumexp=True), takes no GQA and no "
                           "lengths, so K/V would first be expanded H/Hkv-"
                           "fold and the lengths and start built into a "
                           "dense bias: not one call on these inputs"}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Training across ranks: ranks spawned on the card over gloo, FSDP over
# "data" and the serving cuts over "model"
# ---------------------------------------------------------------------------
MESH_TRAIN_SHAPE = (2, 2)
MESH_TRAIN_STEPS = 3            # each mesh-train phase's steps (and remat's 2)
MESH_TRAIN_F32_TOL = 1e-4       # the float32 2-layer witness's losses, relative


def _train_opt(steps):
    from repro_torch.training.optimizer import OptimizerConfig
    return OptimizerConfig(lr=TRAIN_LR, warmup_steps=max(steps // 10, 1),
                           total_steps=steps)


def _leaf_grad_norms(torch, grads, layout):
    """Every leaf's whole-gradient norm from this rank's shards: each sum
    of squares over the leaf's replicas, one all_reduce over the mesh."""
    from repro_torch.distributed import collectives as coll

    def walk(g, pl, path):
        if isinstance(g, dict):
            for k in g:
                yield from walk(g[k], pl[k], path + (k,))
        else:
            yield "/".join(path), g, pl.replicas

    leaves = list(walk(grads, layout.placements, ()))
    sq = torch.stack([g.float().square().sum() / r for _, g, r in leaves])
    coll.all_reduce(sq, layout.mesh, layout.mesh.axes)
    return dict(zip([k for k, _, _ in leaves], sq.sqrt().tolist()))


def _rank_train_steps(torch, mesh, cfg, layout, params, batches, *,
                      remat=False, steps_opt=None):
    """``make_train_step(layout=)`` over ``batches`` on this rank, kernel
    launch counts set to 0 just before and read just after, each step
    between CUDA events and under its own collective counter.  Returns
    (params, state, row)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.training import train as T
    from repro_torch.training.optimizer import init_opt_state
    state = init_opt_state(params)
    step_fn = T.make_train_step(cfg, steps_opt or _train_opt(len(batches)),
                                remat=remat, layout=layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    marks, metrics, counted = [], [], []
    t0 = time.perf_counter()
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with coll.counting(mesh) as cc:
            start.record()
            params, state, m = step_fn(params, state, batch)
            end.record()
        marks.append((start, end))
        metrics.append(m)
        counted.append(cc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(x) for x in losses),
            f"rank {mesh.rank}: non-finite loss {losses}")
    ms = [s.elapsed_time(e) for s, e in marks]
    B = batches[0]["tokens"].shape[0]
    S = batches[0]["tokens"].shape[1]
    steady = ms[1:] or ms
    row = {"steps": len(ms), "losses": losses, "loss_first": losses[0],
           "loss_last": losses[-1], "ms_per_step": sum(steady) / len(steady),
           "ms_per_step_all": ms, "wall_s": wall,
           "tokens_per_s": B * S * len(ms) / wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "allocated_before_bytes": before, "launches": counts,
           "collectives": [{"calls": dict(c.calls), "bytes": dict(c.bytes),
                            "host_seconds": c.seconds} for c in counted],
           "collective_host_seconds": sum(c.seconds for c in counted),
           "grad_norms": [float(m["grad_norm"]) for m in metrics]}
    return params, state, row


def _rank_fwd_bwd(torch, cfg, params, batch, layout):
    """(ms, gradients) of this rank's forward + backward and the
    gradients' mean over "data" (``step_grads``, no AdamW) between CUDA
    events."""
    from repro_torch.training import train as T
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, grads = T.step_grads(params, cfg, batch, remat=False, layout=layout)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), grads


def _rank_mesh_train(rank, world, shape, phase, batches_np):
    """One mesh-train phase on one rank (``phase_mesh_train``): the
    config's params from seed 0 cut by ``shard_params(fsdp=True)``, then
    MESH_TRAIN_STEPS steps (and for moonshot 2 remat steps) of
    ``make_train_step(layout=)`` on the rank's rows of ``batches_np``; the
    step's collectives against ``_train_collectives``; every leaf's
    gradient norm; the launch shapes.  mesh_train adds the float32 2-layer
    witness: the one-rank plain step on rank 0, then the mesh step."""
    torch, dev, mesh = _rank_env(shape)
    from repro_torch.core.offload import tree_leaves, tree_map
    from repro_torch.launch.mesh import shard_params, train_layout
    from repro_torch.models import model as M
    from repro_torch.training import train as T
    cfg = _mesh_train_cfg(phase)
    batches = [_on(torch, b, dev) for b in batches_np]
    full = M.init_params(cfg, 0, device=dev)
    out = {"rank": rank}
    if phase == "mesh_train":
        cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
        # a copy: an uncut leaf of a float32 cut would share its storage
        p32 = tree_map(torch.clone, _f32_cut(torch, full))
        layout32 = train_layout(p32, mesh)
        if rank == 0:         # the one-rank plain step on a copy
            from repro_torch.training.optimizer import init_opt_state
            one = tree_map(torch.clone, p32)
            state = init_opt_state(one)
            step = T.make_train_step(cfg32, _train_opt(len(batches)),
                                     remat=False)
            ref = []
            for b in batches:
                one, state, m = step(one, state, b)
                ref.append(float(m["loss"]))
            out["f32_one_rank"] = ref
            del one, state
        p32 = shard_params(p32, mesh, fsdp=True)
    layout = train_layout(full, mesh)
    params = shard_params(full, mesh, fsdp=True)
    del full
    _free(torch)
    B_loc = batches[0]["tokens"].shape[0] // shape[0]
    S = batches[0]["tokens"].shape[1]
    # llama steps on train_slice's schedule, to meet its losses
    opt = _train_opt(TRAIN_STEPS) if phase == "mesh_train" else None
    with _MeshRecorder() as rec:
        params, _, row = _rank_train_steps(torch, mesh, cfg, layout, params,
                                           batches, steps_opt=opt)
        row["expected_collectives"] = _train_collectives(cfg, layout, B_loc, S)
        out["runs"] = {"steps": row}
        if phase == "mesh_train_moe":
            params, _, rrow = _rank_train_steps(
                torch, mesh, cfg, layout, params, batches[:2], remat=True,
                steps_opt=_train_opt(2))
            rrow["expected_collectives"] = _train_collectives(
                cfg, layout, B_loc, S, remat=True)
            out["runs"]["remat"] = rrow
    ms_fb, grads = _rank_fwd_bwd(torch, cfg, params, batches[0], layout)
    out["grad_norms"] = _leaf_grad_norms(torch, grads, layout)
    del grads
    out["runs"]["steps"]["ms_forward_backward"] = ms_fb
    out["params_held"] = sum(t.numel() for t in tree_leaves(params))
    out.update(ffn_shapes=rec.ffn, scan_shapes=rec.scan,
               scan_bwd_shapes=rec.scan_bwd, decode_shapes=rec.decode,
               hop_shapes=rec.hops)
    del params
    _free(torch)
    if phase == "mesh_train":
        _, _, row32 = _rank_train_steps(torch, mesh, cfg32, layout32, p32,
                                        batches)
        out["f32_mesh"] = row32["losses"]
    return out


def _mesh_train_cfg(phase):
    """mesh_train: llama3.2-1b at full width and depth; mesh_train_moe:
    moonshot at full width, 2 layers; mesh_train_ssm: falcon-mamba at full
    width, 4 layers."""
    from repro_torch.configs.base import get_config
    if phase == "mesh_train":
        return get_config(ARCH)
    if phase == "mesh_train_moe":
        return dataclasses.replace(get_config(MOE_ARCH),
                                   num_layers=MOE_TRAIN_LAYERS)
    return dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_TRAIN_LAYERS)


MESH_TRAIN_BATCH = {"mesh_train": (TRAIN_BATCH, TRAIN_SEQ),
                    "mesh_train_moe": (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ),
                    "mesh_train_ssm": (SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)}


def phase_mesh_train(torch, dev, phase, one_rank_losses=None):
    """A mesh-train phase on (2, 2), ranks spawned on the card over gloo:
    mesh_train (llama3.2-1b at full width and depth, batch 8 x 64, the
    train launcher's defaults and train_slice's first batches), mesh_train_moe
    (moonshot, 2 layers, batch 4 x 64: each rank's 32 experts on
    grouped_ffn with counts, then 2 remat steps), mesh_train_ssm
    (falcon-mamba, 4 layers, batch 2 x 256: ssm_scan and ssm_scan_bwd on
    each rank's [1, 256, 4096, 16] chunk).  Checks on every rank: each
    step's collective calls and bytes by kind equal to _train_collectives;
    grouped_ffn == layers x steps (2 x under remat), ssm_scan ==
    ssm_scan_bwd == layers x chunks x steps, none on llama; every leaf's
    whole gradient finite and non-zero; the ranks' losses identical; llama's
    losses within TRAIN_TOL of the one-rank train_slice's on the same
    batches and its float32 2-layer witness within MESH_TRAIN_F32_TOL of
    the one-rank step's.  Reports ms a step, forward + backward ms,
    tokens/s, peak memory a rank, losses, the collectives a step (the
    all-reduce bytes beside the formula's) and their host seconds against
    the wall.  Returns ({path: launches}, shapes)."""
    from repro_torch.distributed.spawn import run_ranks
    cfg = _mesh_train_cfg(phase)
    B, S = MESH_TRAIN_BATCH[phase]
    data = _train_data(cfg, B, S)
    batches = [next(data) for _ in range(MESH_TRAIN_STEPS)]
    shape = MESH_TRAIN_SHAPE
    res = run_ranks(_rank_mesh_train, int(np.prod(shape)), shape, phase,
                    batches, timeout_s=MESH_TIMEOUT_S)
    counts = {}
    chunks = -(-S // 256)
    for r in res:
        tag = f"{phase} rank {r['rank']}"
        for mode, row in r["runs"].items():
            steps = row["steps"]
            want = {k: 0 for k in row["launches"]}
            if cfg.family == "moe":
                want["grouped_ffn"] = cfg.num_layers * steps * (
                    2 if mode == "remat" else 1)
            if cfg.family == "ssm":
                want["ssm_scan"] = want["ssm_scan_bwd"] = \
                    cfg.num_layers * chunks * steps
            require(row["launches"] == want, f"{tag} {mode}: launches "
                    f"{row['launches']}, expected {want}")
            exp = row["expected_collectives"]
            for i, got in enumerate(row["collectives"]):
                for key in ("calls", "bytes"):
                    have = {k: got[key][k] for k in exp[key]}
                    require(have == exp[key], f"{tag} {mode} step {i}: "
                            f"collective {key} {have}, expected {exp[key]}")
            require(row["losses"] == res[0]["runs"][mode]["losses"],
                    f"{tag} {mode}: losses differ from rank 0's")
            counts[f"{cfg.name} {phase} {shape[0]}x{shape[1]} rank "
                   f"{r['rank']} {mode}"] = row["launches"]
            emit({"phase": phase, "mode": mode, "rank": r["rank"],
                  "arch": cfg.name, "layers": cfg.num_layers,
                  "mesh": {"data": shape[0], "model": shape[1]},
                  "batch": B, "seq": S, "rows_a_rank": B // shape[0],
                  "params_held": r["params_held"],
                  **{k: v for k, v in row.items()
                     if k not in ("expected_collectives",)},
                  "expected_collectives_a_step": exp,
                  "all_reduce_bytes_a_step":
                      [c["bytes"]["all-reduce"] for c in row["collectives"]],
                  "all_reduce_bytes_formula": exp["bytes"]["all-reduce"],
                  "collective_share_of_wall":
                      row["collective_host_seconds"] / row["wall_s"]})
        bad = {k: v for k, v in r["grad_norms"].items()
               if not (math.isfinite(v) and v > 0)}
        require(not bad, f"{tag}: leaves without a finite non-zero gradient: "
                f"{bad}")
        if cfg.family == "ssm":
            want = {(1, 256, cfg.d_inner // shape[1], cfg.ssm_state)}
            require(set(r["scan_shapes"]) == want == set(r["scan_bwd_shapes"]),
                    f"{tag}: ssm_scan shapes {r['scan_shapes']} / backward "
                    f"{r['scan_bwd_shapes']}, expected {want}")
        if cfg.family == "moe":
            E_loc = cfg.num_experts // shape[1]
            require(r["ffn_shapes"] and all(k[0] == E_loc and k[5]
                                            for k in r["ffn_shapes"]),
                    f"{tag}: grouped_ffn shapes {r['ffn_shapes']}")
    losses = res[0]["runs"]["steps"]["losses"]
    extra = {}
    if one_rank_losses is not None:
        ref = one_rank_losses[:len(losses)]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        require(max(rel) <= TRAIN_TOL, f"{phase}: losses {losses} not within "
                f"{TRAIN_TOL} of the one-rank {ref}")
        extra.update(one_rank_losses=ref, loss_rel_err=rel)
    if phase == "mesh_train":
        ref32 = res[0]["f32_one_rank"]
        for r in res:
            rel = [abs(a - b) / abs(b) for a, b in zip(r["f32_mesh"], ref32)]
            require(max(rel) <= MESH_TRAIN_F32_TOL,
                    f"{phase} float32 witness rank {r['rank']}: {r['f32_mesh']}"
                    f" not within {MESH_TRAIN_F32_TOL} of one rank's {ref32}")
        extra.update(f32_one_rank=ref32, f32_mesh=res[0]["f32_mesh"],
                     f32_rel_err=[abs(a - b) / abs(b) for a, b in
                                  zip(res[0]["f32_mesh"], ref32)])
    emit({"phase": phase, "check": "losses", "losses": losses,
          "leaves": len(res[0]["grad_norms"]),
          "grad_norm_min": min(res[0]["grad_norms"].values()),
          "expert_grad_norms": {k: v for k, v in res[0]["grad_norms"].items()
                                if "/moe/" in f"/{k}/" and "shared" not in k
                                and k.split("/")[-1] in ("w_gate", "w_up",
                                                         "w_down")},
          **extra})
    return counts, _merge_shapes(res)


def phase_mesh_train_launcher(torch, dev):
    """``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --mesh 2x2 --dist-backend gloo --steps 1``
    (llama3.2-1b at full width, four ranks on the card): exits 0 and rank 0
    prints ``mesh=``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--mesh", "2x2", "--dist-backend", "gloo", "--steps", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    require(proc.returncode == 0, f"{' '.join(cmd[1:])} exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    require(any(line.startswith("mesh={'data': 2, 'model': 2}") for line in lines),
            f"the mesh train launcher printed no mesh= line: {lines[:5]}")
    emit({"phase": "mesh_train_launcher", "argv": cmd[1:], "returncode": 0,
          "seconds": time.perf_counter() - t0, "stdout": lines})


# ---------------------------------------------------------------------------
# Training across ranks: the collectives of one train step, by formula
# ---------------------------------------------------------------------------
def _pl_leaves(tree, names=()):
    """(names, Placement) of every leaf of a placements tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pl_leaves(v, names + (k,))
    else:
        yield names, tree


def _train_collectives(cfg, layout, B, S, *, remat=False):
    """The collectives one train step issues on each rank, by kind:
    {"calls": {kind: n}, "bytes": {kind: b}} for the rank's ``B`` rows of
    ``S`` tokens (``microbatches`` 1), from the params' placements
    (``layout``, a ``launch.mesh.TrainLayout``) and the config alone:

    * "all-gather" / "reduce-scatter": one FSDP gather per cut leaf per
      layer (a top-level leaf and the hybrid's shared block once), its
      gradient's reduce-scatter; bytes the gathered leaf (the rank's model
      slice of it) and the shard.  Under ``remat`` a stacked leaf's gather
      runs again in the backward.
    * "all-reduce", forward (*g*): the embedding [B, S, D] where "model"
      cuts the table (its vocab rows or its D columns); where it cuts the
      LM head's, the vocab-parallel loss: the blocks' logsumexps gathered
      [m, B, S''] f32 and the gold logit summed [B, S''] f32 (S'' the
      loss's positions: S - 1, the vlm's S), and on D columns the table
      gathered [m, V, D/m] (and its gradient summed in the backward);
      ``frontend_proj``'s D gather [m, B, F, D/m]; a self- or
      cross-attention sublayer's output [B, S', D] (its heads' partial
      projection, or its D columns gathered) and, under the "q" and "d"
      cuts (``launch.mesh.ATTN_CUTS``), its summed partial projections (k
      and v [B, S'k, Hkv, dh] each, and q [B, S', H, dh] under "d"); an
      MLP [B, S', D] where its width splits; an MoE layer [B S', D] and
      its router's gather [m, D, E/m] f32 where the router is cut; a
      Mamba layer its x_proj [B, S, r + 2N] (Mamba-2 dt and B/C, [B, S, H
      + 2N]) and out_proj [B, S, D] products, and Mamba-2's dt_proj
      gathered [m, di, H/m] (its gradient summed in the backward).
    * "all-reduce", backward (*f*): the gradient of each split's input --
      the normed x [B, S', D] of attention (and cross-attention's kv_x
      [B, F, D], the q/k-norm scales [dh] f32, the summed projections
      again), of the MLP, of the Mamba mixer, the vocab logits' x; the
      MoE's xt [B S', D] and gate values [B S', K] f32 -- and again each
      Mamba layer's first sum.  Under
      ``remat`` a layer's forward sums run again in the backward, all but
      its last (the MLP's, the MoE's, out_proj's): nothing after that one
      is saved for the backward, so the recomputation stops before it
      (``torch.utils.checkpoint``'s early stop).
    * "all-reduce", the step: each leaf that is not FSDP-cut, averaged
      over "data"; the loss, CE and aux [3] f32; the clipping norm [1] f32
      over the whole mesh.

    S' = S plus the vlm's F patch rows; the encoder's rows are its F
    frames.  Every count is 0 over an axis of size 1."""
    import math as _m
    import torch
    mesh = layout.mesh
    m = mesh.shape.get("model", 1)
    n = mesh.axes_size(tuple(a for a in ("pod", "data") if a in mesh.shape))
    es = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    D = cfg.d_model
    calls = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    nbytes = dict.fromkeys(calls, 0)
    pl = layout.placements

    def add(kind, count, size):
        calls[kind] += count
        nbytes[kind] += count * size

    # FSDP gathers and scatters; the data mean of every other leaf
    stacks = {"blocks": cfg.num_layers, "encoder": cfg.encoder_layers}
    for names, p in _pl_leaves(pl):
        local = _m.prod(p.shape) // (m if p.model_dim is not None else 1)
        size = local * torch.tensor([], dtype=_leaf_dtype(cfg, names))\
            .element_size()
        if p.fsdp_dim is None:
            if n > 1:
                add("all-reduce", 1, size)
            continue
        stacked = names[0] in stacks and names[1] != "shared"   # not zamba2's
        layers = stacks[names[0]] if stacked else 1
        add("all-gather", layers * (2 if remat and stacked else 1),
            size // layers)
        add("reduce-scatter", layers, size // layers // n)
    if m > 1:
        _model_all_reduces(cfg, pl, m, B, S, es, remat, add)
    if n > 1:
        add("all-reduce", 1, 3 * 4)             # loss, ce, aux
    if m * n > 1:
        add("all-reduce", 1, 4)                 # the clipping norm
    return {"calls": calls, "bytes": nbytes}


def _leaf_dtype(cfg, names):
    """A param leaf's dtype: the norms, the router and the SSM's D /
    dt_bias / A_log are f32, the rest the config's."""
    import torch
    leaf = names[-1]
    if leaf in ("scale", "bias", "router", "D", "dt_bias", "A_log"):
        return torch.float32
    return cfg.torch_dtype


def _model_all_reduces(cfg, pl, m, B, S, es, remat, add):
    """The forward and backward all_reduces over "model" of one step (see
    :func:`_train_collectives`)."""
    from repro_torch.launch.mesh import model_cuts
    blocks = pl["blocks"]
    D, F = cfg.d_model, cfg.frontend_tokens
    Sx = S + (F if cfg.family == "vlm" else 0)
    again = 2 if remat else 1       # a layer's sums but its last, under remat
    row = B * Sx * D * es

    cut = model_cuts(cfg, m).attn
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attention(att, T, n_layers, Tk=None):
        """T query rows (Tk key rows: a cross-attention's)."""
        if cut is None:
            return
        cross = Tk is not None
        Tk = T if Tk is None else Tk
        # the partial projections summed (forward g, backward f)
        summed = {"heads": 0, "q": 2 * Tk * Hkv * dh,
                  "d": T * H * dh + 2 * Tk * Hkv * dh}[cut] * es
        if summed:
            add("all-reduce", n_layers * again, summed)
            add("all-reduce", n_layers, summed)
        add("all-reduce", n_layers * again, T * D * es)  # wo (g) / D gather
        add("all-reduce", n_layers, T * D * es)          # the normed x (f)
        if cross:
            add("all-reduce", n_layers, Tk * D * es)     # kv_x (f)
        for k in ("q_norm", "k_norm"):
            if k in att:
                add("all-reduce", n_layers, cfg.head_dim * 4)

    def mlp(w, rows, n_layers):
        if w["w_down"].model_dim is None:
            return
        add("all-reduce", n_layers, rows)                # w_down (g)
        add("all-reduce", n_layers, rows)                # its x (f)

    def mamba(mx, n_layers):
        if mx["conv_w"].model_dim is None:
            return
        n = cfg.ssm_state
        mid = cfg.ssm_dt_rank + 2 * n if cfg.mamba_version == 1 else \
            cfg.d_inner // cfg.ssm_head_dim + 2 * n
        if cfg.mamba_version == 2:                   # dt_proj's gather
            w = cfg.d_inner * (cfg.d_inner // cfg.ssm_head_dim) * es
            add("all-reduce", n_layers * again, w)
            add("all-reduce", n_layers, w)           # its gradient's sum
        add("all-reduce", n_layers * again, B * S * mid * es)  # first sum
        add("all-reduce", n_layers, B * S * mid * es)         # its gradient
        add("all-reduce", n_layers, B * S * D * es)           # out_proj (g)
        add("all-reduce", n_layers, B * S * D * es)           # in_proj's x (f)

    L = cfg.num_layers
    if cfg.family == "hybrid":
        mamba(blocks["backbone"]["mamba"], L)
        nb = L // cfg.hybrid_attn_every
        attention(blocks["shared"]["attn"], B * Sx, nb)
        mlp(blocks["shared"]["mlp"], row, nb)
    elif cfg.family == "ssm":
        mamba(blocks["mamba"], L)
    else:
        attention(blocks["attn"], B * Sx, L)
        if "xattn" in blocks:
            attention(blocks["xattn"], B * Sx, L, Tk=B * F)
        if "moe" in blocks:
            T = B * Sx
            if blocks["moe"]["router"].model_dim is not None:
                add("all-reduce", L * again, D * cfg.num_experts * 4)  # router
            add("all-reduce", L, T * D * es)                      # y (g)
            add("all-reduce", L, T * D * es)                      # xt (f)
            add("all-reduce", L, T * cfg.experts_per_token * 4)   # gates (f)
        else:
            mlp(blocks["mlp"], row, L)
    if "encoder" in pl:
        rows = B * F * D * es
        attention(pl["encoder"]["attn"], B * F, cfg.encoder_layers)
        mlp(pl["encoder"]["mlp"], rows, cfg.encoder_layers)
    front = pl.get("frontend_proj")
    if front is not None and front.model_dim is not None:
        add("all-reduce", 1, B * F * D * es)                      # its D gather
    table = pl["embed"]["table"]
    if table.model_dim is not None:
        add("all-reduce", 1, B * S * D * es)                      # the embedding
    head = table if cfg.tie_embeddings else pl["lm_head"]["table"]
    if head.model_dim is not None:
        T = B * (S if cfg.family == "vlm" else S - 1)             # the loss's
        add("all-reduce", 1, m * T * 4)                           # lse gather
        add("all-reduce", 1, T * 4)                               # gold sum
        if head.model_dim == len(head.shape) - 1:                 # on D
            add("all-reduce", 2, cfg.vocab_size * D * es)         # table, grad
        add("all-reduce", 1, row)                                 # its x (f)


# ---------------------------------------------------------------------------
# The dry run, the roofline and the example twins
# ---------------------------------------------------------------------------
DRYRUN_CHILD = """
import sys
from repro_torch.configs.base import get_config, mesh_configs
from repro_torch.launch import dryrun
out, jobs = sys.argv[1], int(sys.argv[2])
todo = dryrun.combos(True) + [(a, "train_4k", True) for a in mesh_configs()]
order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
todo.sort(key=lambda c: (order[c[1]], -get_config(c[0]).num_layers))
dryrun.sweep(todo, jobs=jobs, out=out)
"""


def phase_dryrun_start():
    """Start the dry run in a child process on the meta device (it needs no
    card; ``CUDA_VISIBLE_DEVICES`` empty): every (arch x shape) on (16, 16)
    and train_4k on (2, 16, 16), ``DRYRUN_JOBS`` processes, one JSON file a
    combo under build/dryrun.  It runs at the lowest CPU priority (nice
    19), on the cycles the card's phases leave idle, so it does not slow
    them.  Its process group is killed at exit."""
    import atexit
    import shutil
    import signal
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    log = open(out / "sweep.log", "w")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, str(out),
                             str(DRYRUN_JOBS)], env=env, cwd=str(ROOT),
                            stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True,
                            preexec_fn=lambda: os.nice(19))

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()

    atexit.register(stop)
    return {"proc": proc, "out": out, "t0": time.perf_counter(), "stop": stop}


def phase_dryrun_finish(run):
    """Wait for the dry run; every combo OK, or skipped where
    ``applicable`` skips it (long_500k without sub-quadratic attention),
    0 failures; one line a combo (flops, collective bytes, temp and
    argument GB, whether they fit the card's 80 GB, the roofline terms) and
    the phase's seconds (its own wall, beside the card's phases)."""
    from repro_torch.configs.base import get_config, mesh_configs
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import fits
    proc = run["proc"]
    left = DRYRUN_TIMEOUT_S - (time.perf_counter() - run["t0"])
    try:
        rc = proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        run["stop"]()
        fail(f"dryrun: the sweep did not finish within {DRYRUN_TIMEOUT_S} s")
    wall = time.perf_counter() - run["t0"]
    run["stop"]()
    tail = (run["out"] / "sweep.log").read_text()[-3000:]
    require(rc == 0, f"dryrun: the sweep exited {rc}: {tail}")
    results = [json.loads(p.read_text()) for p in sorted(run["out"].glob("*.json"))]
    want = len(mesh_configs()) * (len(INPUT_SHAPES) + 1)
    require(len(results) == want, f"dryrun: {len(results)} results of {want}")
    bad = [(r["arch"], r["shape"], r["error"]) for r in results if r.get("error")]
    require(not bad, f"dryrun: failures {bad}")
    n_skip = 0
    for r in results:
        mesh = "2x16x16" if r["multi_pod"] else "16x16"
        if r["skipped"]:
            n_skip += 1
            require(r["shape"] == "long_500k"
                    and not get_config(r["arch"]).supports_long_context,
                    f"dryrun: {r['arch']} x {r['shape']} skipped")
            emit({"phase": "dryrun", "arch": r["arch"], "shape": r["shape"],
                  "mesh": mesh, "skipped": True})
            continue
        t = roofline.terms(r)
        emit({"phase": "dryrun", "arch": r["arch"], "shape": r["shape"],
              "mesh": mesh, "flops": r["flops"],
              "coll_bytes": r["collective_bytes"]["total"],
              "temp_gb": r["temp_size_in_bytes"] / 1e9,
              "args_gb": r["argument_size_in_bytes"] / 1e9,
              "fits_80gb": fits(r), "t_compute_ms": 1e3 * t.t_compute,
              "t_memory_ms": 1e3 * t.t_memory,
              "t_collective_ms": 1e3 * t.t_collective,
              "model_flops_per_chip": t.model_flops / t.chips,
              "trace_s": r["trace_s"]})
    emit({"phase": "dryrun", "combos": len(results), "skipped": n_skip,
          "failures": 0, "jobs": DRYRUN_JOBS, "seconds": wall,
          "trace_s_sum": sum(r.get("trace_s", 0.0) for r in results)})


def _roofline_programs(torch, cfg, B, dev):
    """llama3.2-1b's static-slice decode step (B rows over a full S_MAIN
    cache: cache_index S_MAIN - 1) and train_slice's first step, on ``dev``
    (the card or the meta device): {name: (fn, args)}."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import make_serve_step
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train import make_train_step
    params = M.init_params(cfg, 0, device=dev)
    cache = M.init_cache(cfg, B, S_MAIN, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    idx = torch.full((), S_MAIN - 1, dtype=torch.int32, device=dev)
    serve = make_serve_step(cfg)
    state = init_opt_state(params)
    batch = _on(torch, next(_train_data(cfg, TRAIN_BATCH, TRAIN_SEQ)), dev)
    train = make_train_step(cfg, OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
        total_steps=TRAIN_STEPS), remat=False)
    return {"decode": (lambda: serve(params, cache, tok, idx),
                       (params, cache, tok, idx)),
            "train": (lambda: train(params, state, batch),
                      (params, state, batch))}


def phase_roofline(torch, dev, B, timing_rows):
    """The roofline on the card: llama3.2-1b's decode step at the slice's
    auxiliary batch and train_slice's 8 x 64 step, each counted on the meta
    device and on the card under ``profiling.measure``: flops, bytes
    accessed, kernel calls, flops and bytes equal.  Beside each, the
    program's ms (CUDA events), its compute and memory terms on the H100's
    rates and the share of the step they make.  Then every kernel's bound
    at the timing phases' shapes (``kernels/costs.py``) against PERF.md
    §6's column."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.profiler import H100_PEAK_FLOPS_BF16
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import RooflineTerms
    from repro_torch.models import model as M
    from repro_torch.serving.profiling import measure
    cfg = get_config(ARCH)
    n = M.count_params_analytic(cfg)
    model_flops = {"decode": 2.0 * n * B,
                   "train": 6.0 * n * TRAIN_BATCH * TRAIN_SEQ}
    on_meta, launched = {}, {}
    for where in (torch.device("meta"), dev):
        progs = _roofline_programs(torch, cfg, B, where)
        for name, (fn, args) in progs.items():
            ops.reset_launch_counts()
            with torch.set_grad_enabled(name == "train"):
                rec = measure(fn, None, args)
            if where.type == "meta":
                on_meta[name] = rec
                continue
            torch.cuda.synchronize()
            launches = launched[name] = ops.launch_counts()
            meta = on_meta[name]
            for key in ("flops", "bytes_accessed", "kernels"):
                require(rec[key] == meta[key], f"roofline {name}: {key} on the "
                        f"card {rec[key]} != on the meta device {meta[key]}")
            for k, v in rec["kernels"].items():
                require(launches[k] == v["calls"], f"roofline {name}: {k} "
                        f"launched {launches[k]}, recorded {v['calls']}")
            with torch.set_grad_enabled(name == "train"):
                ms = _time_ms(torch, fn, [()], iters=ROOFLINE_REPS[name],
                              warmup=2)
            t = RooflineTerms(ARCH, name, name, 1, rec["flops"],
                              rec["bytes_accessed"], 0.0, model_flops[name])
            emit({"phase": "roofline", "program": name, "arch": ARCH,
                  "B": B if name == "decode" else TRAIN_BATCH,
                  "S": S_MAIN if name == "decode" else TRAIN_SEQ,
                  "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
                  "kernels": rec["kernels"], "meta_equal": True,
                  "temp_gb": rec["temp_size_in_bytes"] / 1e9,
                  "args_gb": rec["argument_size_in_bytes"] / 1e9,
                  "model_flops": model_flops[name],
                  "t_compute_ms": 1e3 * t.t_compute,
                  "t_memory_ms": 1e3 * t.t_memory, "ms": ms,
                  "share_compute": 1e3 * t.t_compute / ms,
                  "share_memory": 1e3 * t.t_memory / ms,
                  "t_model_flops_ms": 1e3 * model_flops[name]
                  / H100_PEAK_FLOPS_BF16})
        del progs
        _free(torch)
    picked = _picked_rows(timing_rows)
    for kname, want in SECTION6_BOUNDS.items():
        got = picked[kname]["bound_ms"]
        require(abs(got - want) <= BOUND_RTOL * want, f"roofline: {kname}'s "
                f"bound {got} ms is not PERF.md §6's {want}")
        emit({"phase": "roofline", "kernel": kname, "bound_ms": got,
              "section6_bound_ms": want})
    return launched["decode"], launched["train"]


def phase_examples(torch, dev):
    """``examples/serve_offload_torch.py`` on the card, in this process:
    its six steps at the JAX example's reduced() config; the §VI payload on
    masked_compact and every decode on decode_attention, and no plain
    version of any kernel called (each raises while it runs)."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import ops, ref
    spec = importlib.util.spec_from_file_location(
        "serve_offload_torch", ROOT / "examples" / "serve_offload_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = ("decode_attention_ref", "masked_compact_ref", "grouped_ffn_ref",
             "ssm_scan_ref", "ssm_scan_bwd_ref")
    saved = {n: getattr(ref, n) for n in names}

    def refuse(name):
        def plain(*a, **k):
            raise RuntimeError(f"examples: {name} ran on the card's path")
        return plain

    printed = io.StringIO()
    ops.reset_launch_counts()
    try:
        for n in names:
            setattr(ref, n, refuse(n))
        with contextlib.redirect_stdout(printed):
            out = mod.run("llama3.2-1b", 24, dev)
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts["masked_compact"] >= 1, "examples: no masked_compact launch")
    require(counts["decode_attention"] > 0, "examples: no decode_attention launch")
    packed, _, count, mask = out["payload"]
    require(packed.device.type == dev.type and int(count.sum()) == int(mask.sum()),
            "examples: the §VI payload was not compacted on the card")
    shapes = {r: tuple(rep.outputs.shape) for r, rep in out["reports"].items()}
    require(all(s == (24, 8) for s in shapes.values()),
            f"examples: split outputs {shapes}")
    emit({"phase": "examples", "script": "examples/serve_offload_torch.py",
          "launches": counts, "splits": sorted(shapes),
          "payload_rows": int(count.sum()),
          "printed_tail": printed.getvalue().strip().splitlines()[-3:]})
    return counts


# ---------------------------------------------------------------------------
KERNEL_META = {
    "decode_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:75"},
    "masked_compact": {
        "route": "cuda", "source": "src/repro_torch/csrc/masked_compact.cu",
        "replaces": "src/repro/kernels/masked_compact.py:70"},
    "grouped_ffn": {
        "route": "cuda", "source": "src/repro_torch/csrc/grouped_ffn.cu",
        "replaces": "src/repro/kernels/grouped_ffn.py:47"},
    "ssm_scan": {
        "route": "cuda", "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:51"},
    "ssm_scan_bwd": {
        "route": "cuda", "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/models/ssm.py:145",
        "replaces_note": "no Pallas kernel: JAX differentiates this "
                         "associative scan in XLA (a reverse scan)"},
    "prefill_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/models/attention.py:55",
        "replaces_note": "no Pallas kernel: JAX computes chunked_attention "
                         "in XLA"},
    "mla_decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/mla_decode_attention.cu",
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package has no latent "
                         "attention"},
    MLA_PREFILL: {
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": None,
        "replaces_note": "prefill_attention's q/k 192, v 128 instance; the "
                         "JAX package has no latent attention",
        "launches_of": "prefill_attention", "paths_of": MLA_ARCH},
    MLA_SORTED: {
        "route": "cuda", "source": "src/repro_torch/csrc/grouped_ffn_sorted.cu",
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package runs every MoE "
                         "layer over [E, C, D] buffers (grouped_ffn_pallas); "
                         "this serves the dropless layer's prefill"},
}


def _picked_rows(rows):
    """Each kernel's first row timed at an auxiliary group, else its first:
    the row the kernels line reports."""
    pick = {}
    for row in rows:
        if row["group"] == "auxiliary":
            pick.setdefault(row["kernel"], row)
    for row in rows:
        pick.setdefault(row["kernel"], row)
    return pick


def kernels_line(rows, counts_by_path, errs):
    """One entry per kernel: decode_attention and masked_compact timed at
    llama's auxiliary group, grouped_ffn at moonshot's auxiliary group's
    decode, ssm_scan at falcon-mamba's auxiliary group's prefill,
    ssm_scan_bwd at falcon-mamba's train chunk; launches summed over every
    main path (and listed per path: each static slice, each continuous mode,
    each train path); max_abs_err the largest main-path error of any
    path.  mla_decode_attention, prefill_attention's 192/128 instance and
    grouped_ffn_sorted are timed at moonlight's longdoc cell (the last
    also beside the capacity kernel's time over the same tokens,
    ``capacity_device_ms``); an instance's row counts its
    kernel's launches (``launches_of``) on the paths whose name starts
    with ``paths_of``."""
    pick = _picked_rows(rows)
    kernels = []
    for kname, meta in KERNEL_META.items():
        row = pick[kname]
        key = meta.get("launches_of", kname)
        by_path = {arch: c[key] for arch, c in counts_by_path.items()
                   if arch.startswith(meta.get("paths_of", ""))}
        entry = {"name": kname, **meta, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(e.get(kname, 0.0) for e in errs),
                 "ms": row["ms"], "device_ms": row["device_ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for key in ("composition_ms", "bound_counts", "bound_all_experts_ms",
                    "capacity_device_ms"):
            if key in row:
                entry[key] = row[key]
        kernels.append(entry)
    return kernels


def _free(torch):
    """After a model's params are dropped: collect the reference cycles that
    still hold its engines (the ingress's among them) and return the memory
    to the card, so the next model's peak stands on what is live."""
    gc.collect()
    torch.cuda.empty_cache()


def timed(label, fn, *args, **kw):
    """Run one phase and print its seconds and the device memory still
    allocated after it (what the next phase's peak stands on)."""
    import torch
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "seconds", "of": label, "seconds": time.perf_counter() - t0,
          "allocated_after_bytes": torch.cuda.memory_allocated()})
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is not next to this script ({SRC / 'repro_torch'})")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    name, card = phase_env(torch)
    dry = phase_dryrun_start()        # the dry run on the CPU, beside the card
    timed("build", phase_build)
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    # the dense path: llama3.2-1b, static then continuous
    slice_summary, counts = timed("slice", phase_slice, torch)
    errs = timed("kernels", phase_kernel_checks, torch, dev, slice_summary)
    prefill_errs, prefill_rows = timed("prefill_attention",
                                       phase_prefill_attention, torch, dev)
    cfg, params, prompts = timed("parity", phase_parity, torch, dev)
    groups = dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
    timed("trace", phase_trace, torch, dev, cfg, params, prompts,
          groups["auxiliary"] or REQUESTS)
    rows = timed("timing", phase_timing, torch, dev)
    cont_counts, cont_streams, cont_rows = timed("continuous", phase_continuous,
                                                 torch, dev, cfg, params)
    cont_errs = timed("continuous_checks", phase_continuous_checks, torch, dev,
                      cfg, params)
    # the fleet runtime: a static star, then HeteroRuntime three ways
    fleet_counts, fleet_static_errs = timed("fleet_static", phase_fleet_static,
                                            torch, dev, cfg)
    fleet_counts = {"fleet_static": fleet_counts}
    fleet_ref = timed("fleet_reference", phase_fleet_reference, torch, dev, cfg,
                      params)
    fleet_shapes = {"decode": set(), "hops": set()}
    for fleet in ("fleet_star", "fleet_disagg", "fleet_frontend"):
        fleet_counts[fleet], shapes = timed(fleet, phase_fleet, torch, dev, cfg,
                                            params, fleet_ref, fleet)
        for key in fleet_shapes:
            fleet_shapes[key] |= shapes[key]
    fleet_errs = timed("fleet_kernels", phase_fleet_kernels, torch, dev, cfg,
                       fleet_shapes)
    del params
    _free(torch)
    # the main path's other dense configs: olmo-1b, nemotron-4-15b
    dense_counts, dense_errs = timed("dense_slices", phase_dense_slices, torch, dev)

    # the MoE path: moonshot-v1-16b-a3b at full width
    moe_cfg = get_config(MOE_ARCH)
    moe_summary, moe_counts = timed("moe_slice", phase_slice, torch, MOE_ARCH)
    moe_errs = timed("moe_kernels", phase_moe_kernel_checks, torch, dev,
                     moe_cfg, moe_summary)
    torch.cuda.empty_cache()
    params = M.init_params(moe_cfg, 0, device=dev)      # the slice's weights
    prompts = _prompts(moe_cfg)
    timed("moe_parity", phase_moe_parity, torch, dev, moe_cfg, params, prompts)
    groups = dict(zip(moe_summary["group_names"], moe_summary["n_group"]))
    timed("moe_trace", phase_trace, torch, dev, moe_cfg, params, prompts,
          groups["auxiliary"] or REQUESTS, max_new=MOE_TRACE_NEW)
    moe_rows = timed("moe_timing", phase_moe_timing, torch, dev, moe_cfg,
                     params)
    moe_cont_counts, _, _ = timed("moe_continuous", phase_side_continuous,
                                  torch, dev, moe_cfg, params, "moe_continuous")
    del params
    _free(torch)
    # the latent-attention path: moonlight-16b-a3b at full width and depth
    mla_errs, mla_rows, mla_cont_counts = timed("mla", phase_mla, torch, dev)
    _free(torch)
    # decode_attention at long caches, no weights held: llama's and moonshot's heads
    long_rows = timed("long_cache_timing", phase_long_cache_timing, torch, dev,
                      groups["auxiliary"] or REQUESTS,
                      {ARCH: (32, 8, 64, 32768),
                       MOE_ARCH: (moe_cfg.num_heads, moe_cfg.num_kv_heads,
                                  moe_cfg.head_dim, 8192)})
    torch.cuda.empty_cache()

    # the SSM path: falcon-mamba-7b at full width
    ssm_cfg = get_config(SSM_ARCH)
    ssm_summary, ssm_counts = timed("ssm_slice", phase_slice, torch, SSM_ARCH,
                                    phase="ssm_slice")
    ssm_errs = timed("ssm_kernels", phase_ssm_kernel_checks, torch, dev,
                     ssm_cfg, ssm_summary)
    torch.cuda.empty_cache()
    params = M.init_params(ssm_cfg, 0, device=dev)      # the slice's weights
    prompts = _prompts(ssm_cfg)
    timed("ssm_parity", phase_ssm_parity, torch, dev, ssm_cfg, params, prompts)
    groups = dict(zip(ssm_summary["group_names"], ssm_summary["n_group"]))
    timed("ssm_trace", phase_trace, torch, dev, ssm_cfg, params, prompts,
          groups["auxiliary"] or REQUESTS)
    ssm_cont_counts, ssm_streams, ssm_cont_rows = timed(
        "ssm_continuous", phase_side_continuous, torch, dev, ssm_cfg, params,
        "ssm_continuous")
    del params
    _free(torch)
    ssm_rows = timed("ssm_timing", phase_ssm_timing, torch, dev, ssm_cfg)
    torch.cuda.empty_cache()

    # the hybrid path: zamba2-2.7b at full width, decode_attention at dh=80
    hyb_counts, hyb_errs, _ = timed("hybrid", phase_hybrid, torch, dev)

    # the vlm and audio families and the int8 KV cache at full width
    fam_counts, fam_shapes, payloads = {}, {}, set()
    for arch, phase, extra in ((VLM_ARCH, "vlm_slice", ()),
                               (AUDIO_ARCH, "audio_slice", ()),
                               (ARCH, "int8_slice", ("--kv-int8",))):
        s, c, shapes = timed(phase, phase_family_slice, torch, arch, phase, extra)
        fam_counts[" ".join((arch,) + extra)] = c
        fam_shapes.update(shapes)
        payloads |= {(f"payload-{phase}-{g}", n, get_config(arch).d_model)
                     for g, n in zip(s["group_names"][1:], s["n_group"][1:]) if n}
        torch.cuda.empty_cache()
    vlm_cont_counts, vlm_hops, shapes, vlm_streams, vlm_rows = timed(
        "vlm_continuous", phase_vlm_continuous, torch, dev)
    fam_shapes.update(shapes)
    fam_errs, fam_rows = timed("families_kernels", phase_families_kernels, torch,
                               dev, fam_shapes, payloads, vlm_hops)

    # the training path: llama3.2-1b at full width and depth, then the MoE
    # and SSM kernels forward and backward inside train steps
    train_counts, train_row = timed("train_slice", phase_train_slice, torch,
                                    dev)
    moe_train_counts, moe_remat_counts, ffn_shape, _ = timed(
        "train_moe", phase_train_moe, torch, dev)
    ssm_train_counts, scan_shape, _ = timed("train_ssm", phase_train_ssm, torch,
                                            dev)
    train_errs, train_rows = timed("train_kernels", phase_train_kernels, torch,
                                   dev, ffn_shape, scan_shape)

    # the mesh paths: ranks spawned on the card (the kernels built above;
    # the ranks only load them), no model held by this process
    _free(torch)
    mesh_counts, mesh_shapes = timed("mesh_dense", phase_mesh_dense, torch, dev,
                                     cont_streams, cont_rows)
    # the SSM, hybrid, vlm and audio families, each beside its one-rank run
    # where an earlier phase served the same traffic
    family_refs = {"mesh_ssm": (ssm_streams, {"fused": ssm_cont_rows["overlapped"]}),
                   "mesh_hybrid": (None, None), "mesh_vlm": (None, None),
                   "mesh_audio": (None, None),
                   "mesh_dcut": (vlm_streams, vlm_rows)}
    mesh_runs = [("mesh_seq", phase_mesh_seq, ()), ("mesh_moe", phase_mesh_moe, ())]
    mesh_runs += [(phase, phase_mesh_family, (phase, *refs))
                  for phase, refs in family_refs.items()]
    mesh_runs += [("mesh_gqa16", phase_mesh_gqa16, ())]
    for phase, fn, args in mesh_runs:
        c, shapes = timed(phase, fn, torch, dev, *args)
        mesh_counts.update(c)
        for key in MESH_SHAPE_KINDS:
            for k, n in shapes[key].items():
                mesh_shapes[key][k] = mesh_shapes[key].get(k, 0) + n
    mesh_counts.update(timed("mesh_nccl", phase_mesh_nccl, torch, dev,
                             cont_streams))
    # training across ranks on (2, 2): llama (beside train_slice's losses on
    # the same batches), moonshot's experts, falcon-mamba's scan
    for phase, ref in (("mesh_train", train_row["losses"]),
                       ("mesh_train_moe", None), ("mesh_train_ssm", None)):
        c, shapes = timed(phase, phase_mesh_train, torch, dev, phase, ref)
        mesh_counts.update(c)
        for key in MESH_SHAPE_KINDS:
            for k, n in shapes[key].items():
                mesh_shapes[key][k] = mesh_shapes[key].get(k, 0) + n
    timed("mesh_train_launcher", phase_mesh_train_launcher, torch, dev)
    mesh_errs, _ = timed("mesh_kernels", phase_mesh_kernels, torch, dev,
                         mesh_shapes)

    # the roofline on the card, the example twins, then the dry run's sweep
    timing_rows = rows + moe_rows + ssm_rows + long_rows + fam_rows + train_rows \
        + prefill_rows + mla_rows
    roof_decode, roof_train = timed(
        "roofline", phase_roofline, torch, dev,
        dict(zip(slice_summary["group_names"], slice_summary["n_group"]))
        ["auxiliary"] or REQUESTS, timing_rows)
    example_counts = timed("examples", phase_examples, torch, dev)
    timed("dryrun", phase_dryrun_finish, dry)

    by_path = {ARCH: counts}
    by_path.update({f"{ARCH} continuous {m}": c for m, c in cont_counts.items()})
    by_path.update({f"{ARCH} {f}": c for f, c in fleet_counts.items()})
    by_path.update(dense_counts)
    by_path[MOE_ARCH] = moe_counts
    by_path.update({f"{MOE_ARCH} continuous {m}": c
                    for m, c in moe_cont_counts.items()})
    by_path.update({f"{MLA_ARCH} continuous {m}": c
                    for m, c in mla_cont_counts.items()})
    by_path[SSM_ARCH] = ssm_counts
    by_path.update({f"{SSM_ARCH} continuous {m}": c
                    for m, c in ssm_cont_counts.items()})
    by_path[HYBRID_ARCH] = hyb_counts
    by_path.update(fam_counts)
    by_path.update({f"{VLM_ARCH} continuous {m}": c
                    for m, c in vlm_cont_counts.items()})
    by_path[f"{ARCH} train"] = train_counts
    by_path[f"{MOE_ARCH} train ({MOE_TRAIN_LAYERS} layers)"] = moe_train_counts
    by_path[f"{MOE_ARCH} train remat"] = moe_remat_counts
    by_path[f"{SSM_ARCH} train ({SSM_TRAIN_LAYERS} layers)"] = ssm_train_counts
    by_path.update(mesh_counts)
    by_path[f"{ARCH} roofline decode"] = roof_decode
    by_path[f"{ARCH} roofline train"] = roof_train
    by_path["examples/serve_offload_torch.py"] = example_counts
    kernels = kernels_line(timing_rows, by_path,
                           [errs, prefill_errs, cont_errs, fleet_static_errs,
                            fleet_errs,
                            dense_errs, moe_errs, mla_errs, ssm_errs, hyb_errs,
                            fam_errs,
                            train_errs, mesh_errs])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
