#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mnn_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the build of the
   hand-written kernels from `mnn_tpu_torch/csrc/` with nvcc for sm_90a;
2. every kernel of the serving paths at the shapes those paths give it,
   held against its plain PyTorch version on the same inputs on the card,
   with its time, the plain version's time, one PyTorch library call's time
   as a yardstick where one call computes the same function, and the least
   time the card could take (bound). The int8-row matmul is also timed
   alone on rows quantized beforehand and beside `torch._int_mm` on its
   re-centred int8 pattern, at M = 512 and at the 32- and 128-row
   buckets. The bf16-row matmul runs the split GEMV kernel at M = 1 (each
   row with its tiles and K ranges; two calls must give the same bits) and
   the tensor-core tile kernel above (the shared expert at the 32-, 128- and
   512-row buckets, qwen2-0.5b's projections at M = 512), each row with the
   kernel it launched and its tile. Flash prefill runs the prefill chunks
   of the three requests (also the short chunk over the long cache at batch
   2, and the chunk serving sends for the 300-token prompt), each row with
   the tiling the kernel took and SDPA's time. The decode step runs the
   last decode step of the three requests on qwen2-0.5b's and
   qwen1.5-moe-a2.7b's heads and at batch 2, each row with its split
   (blocks a cluster, positions a tile) and SDPA's time; two calls must
   give the same bits; then gemma's head_dim 256 (`GEMMA_DECODE_ROWS`):
   gemma2-2b's heads with softcap 50 on a sliding (4,096) and a global
   layer at 331 of 1,024 and 4,500 of 8,192, batch 4, a bf16 cache, and
   gemma3-4b's with QK-norm at 1,300 of 2,048 (SDPA's time beside these,
   none for the softcapped rows). Flash decode runs the last decode step of the three
   requests at int8 and int4 with qwen2-0.5b's and qwen1.5-moe-a2.7b's
   heads, at batch 2, and at kv_len 4000 of 4096, each row with its split
   (blocks a KV head) and SDPA's time; two calls must give the same bits
   (the first six rows are also summed alone, `six_shapes`); then as phase
   9 calls it (`FLASH_DECODE_KV_ROWS`): qwen2-0.5b's heads at 331 and 631
   of 1,024 over one bf16 layer without `layer_index` (a TQ3 / TQ4 step
   unpacks its layer first) and over the stacked int8 cache. The
   whole-model decode kernel runs
   full-size `qwen2-0.5b` (int8, int4 and bf16 caches, batch 1 and 4), two
   layers at `qwen2-7b` widths and all 28 of qwen2-7b (each row with the
   schedule the kernel walked; two calls must give the same bits); the two mixture-of-experts kernels and
   the dequantize-tile matmul at `qwen1.5-moe-a2.7b`'s and
   `qwen3-moe-30b-a3b`'s widths, each row with the tile the kernel took
   (the fused expert kernel's with the share of its bound it reaches);
   both expert kernels must give the same bits twice;
3. the serving paths themselves on `Llm.synthetic("qwen2-0.5b")` at full
   width and depth (W4 block-128 weights, int4 lm head, int8 prefill
   activations), each with the launch counts set to 0 before and read after:
   (a) three greedy requests of 17, 300 and 600 prompt tokens and 32 new
   tokens each over an int8 KV cache, decoded by the whole-model kernel, one
   launch per generated token; (b) one request over an int4 KV cache, the
   same way; (c) the per-layer fallback (`forward(megakernel=False)`), a
   prompt and 8 decode steps over an int8 and over an int4 cache, which
   runs the decode-step and flash-decode kernels; (f) the 300-token request
   with `prefill_act_bits=16`, the library's default: every prefill
   projection on bf16 rows through the tensor-core tile kernel, 96 launches
   a chunk; (d) `Llm.synthetic(
   "qwen1.5-moe-a2.7b")` at its 24 layers, the same three requests: the
   grouped expert kernel 24 times per prefill chunk, the shared expert on the
   tile kernel 48 times per chunk, the fused expert kernel
   and the decode-step kernel 24 times per token, the whole-model kernel
   never; (e) the 300-token request again with the dequantize-tile switch on
   (`dequant_matmul.DEQ_MIN_M = 512`), held against (d)'s logits. A kernel
   of a path that was launched no time in that path's run fails the script;
4. the first request again, prefill and 8 decode steps, on the card and
   through the plain versions on the CPU with the same weights: logits
   within rel-L2 5e-2 and equal tokens wherever the CPU's top-2 margin
   exceeds the largest logit difference seen; then the whole-model kernel
   against the per-layer path on the card from the same state, and the
   first request's prefill with `prefill_act_bits=16` on both. The same
   for the mixture-of-experts model at full width and 4 layers (the CPU side
   of 24 would take minutes);
5. serving batched requests through the continuous-batching engine
   (`runtime/batch_engine.py`) at 4 slots, each sub-phase with the launch
   counts set to 0 before and read after: (g) full-size qwen2-0.5b (phase
   3's configuration), 8 requests of 17, 300, 600, 17, 300, 600, 64 and 900
   prompt tokens and 32 new tokens each, submitted at once, so that
   admissions come between decode blocks: one launch of the whole-model
   kernel's batch-4 build a decode step (its name checked in a traced
   block), and per prefill chunk 96 int8-row matmuls, 24 flash prefills and
   one M = 1 GEMV (the head); (h) the qwen1.5-moe-a2.7b model of (d), 4
   requests of 17, 300, 600 and 64 tokens and 16 new tokens: per decode
   step the fused expert and decode-step kernels 24 times at 4 tokens and
   the tile kernel 49 times (qkv and wo at M = 4, the head), per chunk the
   grouped expert kernel 24 times. Each request's first 8 tokens are held
   to the same prompt alone at batch 1 on the card by phase 4's rule (the
   batched logit rows, teacher-forced with the batch-1 tokens, within
   rel-L2 5e-2; the served tokens equal up to the first step whose batch-1
   top-2 margin is not above the largest difference). Per request the time
   to the first token and in all; the engine's generated tok/s beside the
   same requests one after another through `Llm`; a decode block's wall
   and device-busy time, idle share and launches a step; the allocator's
   peak. (i) The server's handler (`serve/server.py`) over (g)'s engine on
   127.0.0.1: two streamed chat requests and a /v1/completions request
   with logprobs 2 at once, each answered with the engine's own answer to
   the same ids (the logprobs within 1e-4).

6. models from files, each in a temporary directory outside the checkout,
   deleted after: (j) full-size qwen2-0.5b written in the HF layout (HF
   tensor names, tied embedding, qkv bias) from seeded random bf16 weights
   with the port's own safetensors writer, converted by `convert_hf` on the
   card and on the CPU (W4, block 128, int4 head: every tensor byte-equal),
   loaded by `Llm.from_pretrained` (byte-equal to the converter's params),
   with the seconds and GB/s of each; (k) phase 3 (a)'s three requests
   through the loaded model: (a)'s launch counts, and the tokens of the same
   params in memory; (l) the directory converted at W8 with the tied bf16
   embedding as the head (the whole-model kernel runs without its head),
   the 17-token prompt's logits at every position, by one prefill and by
   prefill + decode steps, within rel-L2 6e-2 of a plain f32 forward of the
   HF tensors written here; (m) `evaluate.sequence_nll` over 256 seeded
   tokens in chunks of 128 on the card within 1e-2 of the CPU's plain
   versions, the head of that path (row 1b at M = 128 and 512, N =
   151,936) timed beside `torch.matmul` on bf16 weights; then a
   Qwen2-MoE-layout directory at qwen1.5-moe-a2.7b's width and 2 layers,
   converted and loaded on the card, one 300-token request of 16 new tokens
   (the grouped expert kernel twice a chunk, the fused expert kernel twice
   a token) with the in-memory model's tokens.
7. the gemma family (`Llm.synthetic("gemma2-2b")` at its 26 layers, cache
   1,024, and `"gemma3-4b"` at 34, cache 2,048; phase 3's weights and
   runtime), each sub-phase with the launch counts set to 0 before and read
   after. First phase 2's gemma rows of the whole-model kernel: gemma2-2b
   at batch 1 and 4 (331 of 1,024, its head fused), gemma3-4b (1,300 of
   2,048, its head on the GEMV kernel) and gemma2-2b's first 2 layers at
   4,500 of 8,192, each with its schedule, blocks an SM and ring slots.
   (n) gemma2-2b: three greedy requests of 17, 300 and 600 prompt tokens,
   32 new each: one whole-model launch a token, 104 int8-row launches a
   prefill chunk, no flash prefill or flash decode launch (gemma's prefill
   is the eager attention, as in the JAX package); (o) gemma3-4b: 17 and
   1,300 tokens (the second crosses the 1,024 window of its 29 sliding
   layers): one whole-model and one head GEMV launch a token; (p)
   `forward(megakernel=False)` for both over an int8 cache (the decode-step
   kernel once a layer a token) and over an int4 cache (the eager path, no
   decode kernel); each of (n) to (p) with the wall, device busy time, idle
   share and launches of a traced decode; (q) both at full width and cut
   depth (gemma2-2b 4 layers, 300 prompt tokens; gemma3-4b 6, so layer 5
   is global, 1,100 tokens) against the CPU's plain versions, 8 decode
   steps, on the whole-model and the per-layer path: phase 4's bounds and
   token rule; (r) (n)'s model through a 4-slot engine, 4 requests of 17,
   300, 600 and 64 tokens, 16 new each, held to batch-1 runs by phase 5's
   rule.
8. W3 and W2 weights (bench.py's --w-bits 3 and 2 rows: qwen2-0.5b at
   full width and depth, block 128, a head of the same bits, int8 KV,
   `prefill_act_bits=8`, greedy, batch 1), each sub-phase with the launch
   counts set to 0 before and read after. Phase 2's rows at each width:
   the GEMV (row 1a) on the four decode projections and the head, the tile
   kernel (1b), the a8 kernel (2) and the dequantize-tile kernel (3) at
   M = 512 on the four projections, and the whole-model kernel (7) on the
   served weights at batch 1 and 4, the head after it; then (s) the three
   requests of 17, 300 and 600 tokens, 32 new each: one whole-model launch
   and one head GEMV a token, 96 a8 launches a chunk; (t) the 300-token
   request with `megakernel=False`: every projection on the GEMV; (u) the
   same at `prefill_act_bits=16`: 96 tile-kernel launches; (w) its prefill
   with the dequantize-tile switch on: 96 launches of row 3, within 5e-2
   of the default path; (v) card against CPU at full width and 4 layers,
   prefill and 8 steps, phase 4's bounds and token rule.
9. KV variants and cache tiers on full-size qwen2-0.5b (phase 3's weights
   and runtime), each sub-phase with the launch counts set to 0 before and
   read after: (x) a TQ3 cache (`kv_bits=3`) and (y) a TQ4 cache
   (`kv_bits=4, kv_codebook=True`), the three requests of 17, 300 and 600
   tokens, 32 new each: no whole-model or decode-step launch (both refuse
   these caches, as in the JAX package), flash decode 24 times a token over
   each unpacked layer, flash prefill 24 times a chunk; (z) `kv_rotate=True`
   over an int8 and an int4 cache, the 300-token request, the same counts;
   (x) and (y) each with a traced decode step (wall, busy, idle, launches a
   token); (bb) on (x)'s model the 600-token context shelved into a
   `KVOffloadPool` while the 17-token request is served, then restored; the
   same through a pool of `max_bytes=1` (the entry spills to disk and
   reloads); and through `save_prefix` / `load_prefix` into a fresh `Llm`:
   each continued request's tokens equal those of a run that never left
   the card, with the seconds and bytes of each move; (aa) card against CPU
   at full width and 2 layers under (x), (y) and (z) over int4, prefill and
   8 steps, phase 4's bounds and token rule.
10. speculative decoding on full-size qwen2-0.5b (phase 3's weights and
   runtime, greedy, nothing cut; random draft nets), each sub-phase with
   the launch counts set to 0 before and read after. Phase 2's rows at its
   shapes come first: the tile kernel at M = 5, 8 and 13 (verify rows) on
   the four projections and the int4 head, flash prefill at Tq = 5 and 8
   over q_offset 331 and 631, flash decode over the EAGLE draft's one bf16
   layer at 300 and 600. Then the plain stream of each prompt (32 new
   tokens) and its logit rows three ways (the decode steps, a chain verify,
   a single-chain tree verify after the feature prefill): (cc)
   `lookahead`, draft 7, over the 300-token request and 64 tokens of the
   repeating [5, 6, 7] pattern; (dd) `eagle`, (ee) `eagle-tree` (fanout 3:
   13 nodes), (ff) `mtp`, each at draft 4, and (gg) `dflash`, block 4, over
   the 300-token request: each stream held to the plain one (equal up to
   the first step whose margin is not above that step's largest difference
   between the paths), with its `spec_stats`, rounds, prefill seconds,
   decode tok/s, launches by kernel a round (the prefill's taken off), and
   a traced run's device busy time and idle share a round; no decode step
   of T = 1 runs. (hh) an oracle tree (the target's own chain, run ahead)
   with the good chain first and last: every round accepted whole, the
   accepted rows where `compact_tail` put them, byte for byte. (ii) card
   against CPU at full width and 4 layers: the feature prefill of the
   300-token request, one chain verify of 8 tokens and one tree verify of
   13 nodes, features and logits within 5e-2, targets by phase 4's rule.
11. multimodal input, run right after phase 2's whole-model rows on the
   28-layer qwen2-7b weights they built (W4 block 128, int4 head), served
   with Qwen2.5-VL / Omni's `mrope_section` (16, 24, 24) over an int8 cache
   of 2,048 at `prefill_act_bits=8`, greedy; a Qwen2.5-VL tower at its
   published widths (32 blocks of 1,280, 16 heads, out 3,584) and a whisper
   encoder at whisper-large-v3's (128 mels, 32 layers of 1,280, 20 heads),
   both from seeded HF-layout weights made on the card and mapped by the
   port's `from_hf_*`; each sub-phase with the launch counts set to 0
   before and read after. Phase 2 times row 2 at qwen2-7b's four
   projections (M = 512), row 1a at the same four and its int4 head
   (M = 1), row 4 at its heads over the 2,048 cache (the 601-token
   prompt's two chunks) and row 6 at (ll)'s last decode step first. (jj) `Omni.stream_mm` of 17 text
   tokens, a seeded 480 x 640 image (64 tokens), 10 s of seeded audio (500
   tokens) and 20 text tokens, 32 new tokens: rows 2, 4 and 7 launched,
   row 6 not; the tower, fbank and encoder times, prefill seconds and
   decode tok/s. (kk) the exact Qwen2.5-VL route: `qwen2_preprocess` of a
   seeded 700 x 1,036 image (3,700 patches, 925 tokens, windows padded),
   the tower, `splice_embeds`, one prefill at `build_mrope_positions`, 16
   decode steps at max(position) + 1 + s on the whole-model kernel, the
   next step against the per-layer path (5e-2). (ll) deepstack (3 levels on
   100 image rows of a 300-token prefill) and a PLE table of dim 256 at
   qwen2-7b widths and 2 layers, card against CPU, 8 steps, phase 4's
   bounds and token rule; the decode-step kernel runs, the whole-model
   kernel does not. (mm) card against CPU: the 32-block tower on (jj)'s
   256 patches, the encoder at 8 layers on (jj)'s mel, a CLIP ViT-L/14 at
   2 layers (each f32, rel-L2 1e-3), and the LM at 2 layers under (jj)'s
   spliced embeddings, prefill and 8 steps by phase 4's rule. (nn)
   `Llm.embed` (last, mean) and `Llm.rerank` (yes-token, cosine) on
   full-size qwen2-0.5b, card against CPU: vectors within rel-L2 5e-2,
   each ranking's order equal wherever the CPU's score gaps exceed the
   largest score difference.
12. training and quantization tools on full-size qwen2-0.5b (phase 3's
   W4 block-128 weights and int4 head), each sub-phase with the launch
   counts set to 0 before and read after. Phase 2's rows of the tile kernel
   (1b) at the training forward's shapes come first: the four projections
   and the head (f32 out) at M = 4 x 256. (oo) LoRA fine-tuning: rank-8
   adapters on qkv, o, gate/up and down, adamw at lr 5e-3, 12 steps over 4
   sequences of 256 tokens (a seeded 16-token pattern, repeated): each
   step's loss, milliseconds and launches (97 of the tile kernel, every
   projection and the head inside `DequantMatmulFn`, no other kernel), the
   allocator's peak; the last loss below 0.9 x the first. (pp) card against
   CPU at full width and 2 layers, the same weights and numpy-made
   adapters: the loss within rel 1e-2, every adapter gradient within
   rel-L2 5e-2, the autograd node's dx at the five training shapes within
   rel-L2 1e-2. (qq) `merge_lora` of (oo)'s adapters at the weights' 4
   bits and at 8: the merged model's prefill logits of the 300-token
   request against the adapter forward's (the W8 merge within rel-L2 5e-2,
   the bound of the JAX test, whose weights are 8-bit), then that request
   served by each, one whole-model launch a token. (rr) qwen2-0.5b in the HF layout converted on the card by
   round to nearest and by `convert_hf(awq=True)` over seeded calibration
   ids [4, 128]: the seconds, the mean NLL of 256 seeded tokens side by
   side, the AWQ model serving the 300-token request; at 2 layers the
   card's AWQ conversion against the CPU's (each layer's scale ratios side
   by side, the loaded models' logits within rel-L2 5e-2). (ss) HQQ, ADMM
   and OmniQuant on one qwen2-7b-width projection (3,584 x 18,944) against
   round to nearest: seconds, weight and output MSE; `fake_quant_weight`
   bit for bit `dequantize(quantize(w))` on the card.
13. generative output, run right after phase 11 on its qwen2-7b thinker,
   each sub-phase with the launch counts set to 0 before and read after.
   (tt) `Omni.respond_mm(speak=True)` of phase 11's 37 text tokens, 32 new:
   a talker on qwen2-0.5b's stack at full width (24 layers) over a codec
   vocabulary of 8,448 (the JAX stop ids 8,292 and 8,294 inside; W4 block
   128, an int4 head, `act_bits` 16, a bf16 cache of 2,048), up to 128
   codec tokens, the conv mel denoiser over 10 flow-matching steps and
   BigVGAN at `VocoderConfig()` (80 mels, 1,536 channels, hop 256): the
   thinker's rows 2, 4, 1a and 7, the talker's 1b (4 a layer), 4, 1a (its
   head after the prefill) and one row 7 launch a codec token with the
   head fused; thinker prefill seconds and tok/s, talker prefill seconds
   and codec tok/s, mel and vocoder ms, samples/s, the allocator's peak.
   (uu) card against CPU: the talker at 2 layers (phase 4's bounds and
   token rule over 8 codec steps), the mel ODE from the same noise (1e-4)
   and the vocoder on 16 mel frames (1e-3). (vv) SD 1.5 at its published
   widths (`UNetConfig()`, `VAEConfig()`, `ClipTextConfig()`, seeded random
   weights) in bf16: `txt2img` 512 x 512, 20 DDIM steps, CFG 7.5: seconds,
   it/s, ms a CFG step (the UNet at batch 2), text-encoder and VAE-decode
   ms, the allocator's peak, a uint8 512 x 512 x 3 image. (ww) in f32 on
   both sides, card against CPU within rel-L2 1e-3: one CFG step on a 32 x
   32 latent, its VAE decode, CLIP on 77 tokens. (xx) `cli txt2img` on the
   card from a tiny diffusers-layout directory written here, 3 steps at
   64 px. It prints its seconds.
14. the rest of diffusion, the CV library and the native library, run last,
   each sub-phase with the launch counts set to 0 before and read after: no
   hand-written kernel runs (none of these modules reaches a TPU kernel in
   the JAX package), and the kernels line stays as it is. Weights are
   seeded random at each config's defaults, bf16 with the JAX package's f32
   products (TF32 off). (yy) SD3-medium's MMDiT (`MMDiTConfig()`: 24
   blocks of 1,536, 24 heads, QK norm, 2.04 B parameters) on a 16 x 128 x
   128 latent (a 1,024 x 1,024 image) and 333 context tokens, CFG at batch
   2, 4 `FlowMatchEulerScheduler(shift=3.0)` steps: ms a step, TFLOP/s from
   an operation count (17.8 TFLOP a step), the allocator's peak. (zz) Sana
   (`SanaConfig()`: 12 blocks of 1,152) on a 64 x 64 x 32 latent and 300
   text tokens, `SanaPipeline` for 4 steps and the DC-AE decode at 32x (the
   init's width 32, 5 stages) to 2,048 x 2,048: ms a step, decode ms,
   peak. (aaa) Wan 2.1 (`WanConfig()`: 30 blocks of 1,536) on a (5, 60,
   104) latent, 7,800 tokens, 512 text tokens of which 40 live under the
   mask, `WanPipeline` for 2 steps and the causal 3-D VAE (width 16, 3
   spatial stages: 10 frames of 480 x 832): ms a step, decode ms, peak.
   (bbb) f32 card against CPU within rel-L2 1e-3: each DiT at its full
   widths and 2 blocks, one CFG call on a small latent, and both decoders.
   (ccc) every exported `cv` function on a seeded 1,080 x 1,920 x 3 image,
   card against CPU: integer outputs equal, uint8 resamples within one
   level, floats within rel-L2 1e-5; `ImageProcess` to a 224 x 224 NCHW
   input, ms a call; `solve_pnp`'s pose within 1e-3. (ddd) the native
   library built from `native/` with g++ (a failed build fails), phase 6's
   checkpoints read by its `StFile` to the same bytes as `convert/stfile`,
   and phase 10 (cc)'s lookahead through its n-gram index.
15. the graph frontends and CNN inference, each sub-phase with
   the launch counts set to 0 before and read after: only the plugin path
   launches a hand-written kernel (row 10). The models are `models/vision.py`
   at their published widths (224 x 224, 1,000 classes) from torch's init
   under seed 0. (eee) `cli bench-cnn` for MobileNetV2, SqueezeNet 1.0 and
   ResNet-50 at batch 1 and 32 (the torch.fx frontend, bf16 params and
   input, `utils/benchit.chain`): latency, images/s, TFLOP/s from each
   model's MAC count (`cnn_macs`, its Conv2d and Linear shapes), the
   allocator's peak. (fff) each model at batch 2, card against the CPU run
   of the same converted function: f32 (TF32 off) within rel-L2 1e-4; bf16
   within 5e-2 of the f32 CPU logits, top-1 equal wherever the CPU's top-2
   margin exceeds the largest logit difference. (ggg) ResNet-50 written node
   by node with the port's `onnx_pb2` (`onnx_of_module`: Conv,
   BatchNormalization, Relu, MaxPool, Add, GlobalAveragePool, Flatten,
   Gemm), serialized, parsed and converted on the card: logits within 1e-4
   of the fx path's; then `onnx_cases()`, twelve graphs that reach every op
   of the frontend's table (If / Loop / Scan bodies, GridSample, RoiAlign,
   NonMaxSuppression and the quantize ops included), card against CPU:
   ints and bools equal, floats within 1e-5. The plugin path: the example
   op `MnnTpuSoftShrink` registered through `plugin.register_op`, backed by
   row 10, converted and run at the plugin test's (2, 8, 128) in f32 and
   bf16 and on a ResNet-50 activation [32, 256, 56, 56] bf16, each output
   the plain version's bits. (hhh) `ops/nms.nms` over 5,000 seeded boxes,
   card against CPU (kept indices equal), its ms; 64 seeded 240 x 320
   images through `preprocess_classification` and `topk_eval` with
   MobileNetV2 in f32, top-1 by (fff)'s rule. Then row 10 against its plain
   version at those three shapes, at [32, 256, 56, 56] f32, on a bf16 view
   off 16 bytes (x[1:] of a flat tensor) and at a ragged 2^20 + 7 (equal
   bits, signed zeros, +-lam and a NaN planted): its time, the plain
   version's, `F.softshrink`'s and its byte bound;
16. quant blocks of 256, each sub-phase with the launch counts
   set to 0 before and read after: qwen2-7b as bench.py:78-99 runs its
   --q-block 256 row (28 layers at published widths, random weights from
   seed 0, W4 at quant_block 256 for every projection and the int4 head,
   an int8 cache of 1,024, int8 prefill rows in chunks of 512, greedy).
   (iii) one 512-token prompt and 128 new tokens through `Llm.stream`
   (rows 2 and 4 in the prefill, row 1a for the head, row 7 a token),
   beside the same model at block 128 (phase 2's 28-layer weights, kept
   for this), in the order 128, 256, 256, 128: prefill s and decode tok/s
   of each; then on the block-256 weights 8 decode steps with
   megakernel=False (rows 1a and 6, one decode-step launch a layer a
   step), a prefill at prefill_act_bits=16 (row 1b, 4 launches a layer)
   and one with `dequant_matmul.DEQ_MIN_M = 512` (row 3, 4 a layer).
   (jjj) its first two layers on the card and through the plain versions
   on the CPU (in a thread, while phase 2's block-256 rows take the card),
   a 512-token prefill on bf16 rows and 8 decode steps fed the card's
   tokens, both decode paths, by phase 4's bounds and token rule; beside
   it, not held, the int8-row prefill's logits at block 256 and at block
   128, card against CPU. Phase 2's block-256
   rows: rows 1a, 1b and 2 at qwen2-7b's shapes (row 2 also at block 176
   on qwen1.5-moe-a2.7b's down projection, K = 1,408; its rows must give
   the plain version's bits, as every row-2 row must), row 3 on one
   projection, row 9 at qwen1.5-moe-a2.7b's (blocks 256 / 176) and
   qwen3-moe-30b-a3b's widths, row 8 at qwen3-moe-30b-a3b's, row 7 on two
   and on all 28 layers.
17. the TF, TFLite and Caffe frontends, run last, each sub-phase with the
   launch counts set to 0 before and read after: only the plugin paths
   launch a hand-written kernel (row 10). Every graph is written here by
   the port's own codecs (no TensorFlow, protobuf or flatbuffers package),
   with `models/vision.py`'s seeded weights. (kkk) SqueezeNet 1.0's
   published deploy prototxt (`squeezenet_prototxt`: 227 x 227, CEIL max
   pools, the eight Fire modules, dropout, conv10, global average pool,
   softmax; fillers and a comment left in for the text parser) and a
   caffemodel of the module's weights: logits (the net without `prob`)
   card against CPU at batch 1 and 32 and against the fx path of the same
   module, f32 with TF32 off, within rel-L2 1e-4; the caffemodel's read
   seconds; card ms at batch 1 and 32. (lll) ResNet-50 as a frozen NHWC
   GraphDef (`resnet50_graphdef`: Pad, Conv2D, FusedBatchNormV3, Relu,
   MaxPool, AddV2, Mean, MatMul, BiasAdd, Softmax), the same bounds at batch
   2; card ms; at batch 32 the layout kernels' share of the device time by
   torch.profiler, beside the fx path (NCHW). (mmm) MobileNetV2 1.0 at 224
   as a .tflite (`mobilenet_v2_tflite`, a FlatBuffers writer of its own:
   batch norm folded into CONV_2D / DEPTHWISE_CONV_2D with fused RELU6,
   PAD, ADD, MEAN, FULLY_CONNECTED, SOFTMAX), its batch norms calibrated on a
   seeded batch (`calibrated_mobilenet_v2`), the same bounds; then the same
   net with int8 per-channel weights, card against CPU within 1e-4. (nnn)
   `tf_cases()`, `tfl_cases()` and `caffe_cases()`: small graphs that reach
   every entry of the three tables (101 TF ops, 88 TFLite builtin codes,
   27 Caffe layer types), card against CPU: ints and bools equal, floats
   within 1e-5. (ooo) softshrink registered in the `tf` table (a NodeDef op
   `MnnTpuSoftShrink`), the `caffe` table (a layer type) and the `tflite`
   table (builtin code 20, RELU_N1_TO_1, a unary op the table lacks),
   backed by row 10: each graph refused
   before registration, then run on a [32, 256, 56, 56] bf16 activation
   with the plain version's bits.

It then prints one JSON line with every kernel's numbers (the bf16-row
matmul also split into `m1`, the GEMV kernel, and `m_gt1`, the tile kernel;
flash decode's phase 9 rows and launches under `kv_variants`)
and, last, the device line. Details go to `chiprun_out/chip_smoke.json`
(phase 5's under `serve_batched`, phase 6's under `checkpoints`, phase
7's under `gemma`, phase 8's under `sub4`, phase 9's under `kv`, phase
10's under `speculative`; phase 10's rows of rows 1b, 4 and 5 under
`verify` / `draft_cache` of their kernel, with the launches of (cc) to
(gg); phase 11's details under `multimodal`, its launches added to each
kernel's count (also alone, `multimodal_launches`), phase 2's qwen2-7b rows
of rows 1a, 2, 4 and 6 under `qwen2_7b` of their kernel; the gemma rows of rows 6 and 7
under `gemma` of their kernel in the kernels line, beside the sums of the
earlier rows; under `weight_bits` the weight bits of the rows that ran each
kernel in this run, and phase 8's rows and launches under `w3` and `w2`;
phase 12's under `training`, its launches added to each kernel's count (also
alone, `training_launches`), and row 1b's rows at the training shapes under
`train` of the bf16-row matmul, with (oo)'s launches; phase 13's under
`generative`, (tt)'s launches added to each kernel's count, also alone,
`generative_launches`; phase 14's under `dit_cv`; phase 15's under `cnn`,
row 10's rows under `kernels` / `softshrink`, and the kernels line's
`softshrink` entry with its launches on the plugin paths of phases 15 and
17; phase 17's under `frontends`; phase 16's under
`block256`, its launches added to each kernel's count, also alone,
`block256_launches`, and each kernel's block-256 rows summed under
`block256` of its entry).
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))      # the checkout's package, not an installed one

import numpy as np
import torch

import mnn_tpu_torch
from mnn_tpu_torch import cli, plugin, profile_decode
from mnn_tpu_torch import cv as cvlib
from mnn_tpu_torch.audio import audio as audio_mod
from mnn_tpu_torch.audio import vocoder
from mnn_tpu_torch.convert import (caffe_frontend, caffe_pb2, checkpoint, graphdef_pb2,
                                   onnx_frontend, onnx_pb2, stfile, tf_frontend,
                                   tflite_frontend)
from mnn_tpu_torch.convert.hf import convert_hf
from mnn_tpu_torch.convert.onnx_frontend import convert_onnx
from mnn_tpu_torch.convert.torch_fx import convert_torch_module
from mnn_tpu_torch.cv import calib3d
from mnn_tpu_torch.diffusion import StableDiffusion, clip_text
from mnn_tpu_torch.diffusion import mmdit, sana, wan
from mnn_tpu_torch.diffusion import unet as unet_mod
from mnn_tpu_torch.diffusion import vae as vae_mod
from mnn_tpu_torch.diffusion.nn import no_tf32
from mnn_tpu_torch.diffusion.scheduler import FlowMatchEulerScheduler
from mnn_tpu_torch.diffusion.scheduler import noise as sched_noise
from mnn_tpu_torch.kernels import (build, decode_model, decode_step, dequant_matmul,
                                   flash_attention, moe_decode, moe_prefill, softshrink)
from mnn_tpu_torch.models import audio_encoder, decoder, qwen_vl_vision, vision_encoder
from mnn_tpu_torch.models import talker as talker_mod
from mnn_tpu_torch.models.audio_encoder import AudioEncoderConfig
from mnn_tpu_torch.models.config import PRESETS, ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.layers import rms_norm, rope_cos_sin
from mnn_tpu_torch.models.vision import VISION_MODELS
from mnn_tpu_torch.ops import nms as nms_mod
from mnn_tpu_torch.quant import calibrate, hqq, omni_quant
from mnn_tpu_torch.quant.quantize import (QuantizedLinear, choose_block_size, dequantize,
                                          quantize, quantize_activations_int8, unpack_bits)
from mnn_tpu_torch.runtime import (batch_engine, classify, evaluate, generate, kvcache, omni,
                                   vision_preprocess)
from mnn_tpu_torch.runtime import speculative as spec
from mnn_tpu_torch.runtime.kv_offload import KVOffloadPool
from mnn_tpu_torch.runtime.llm import Llm
from mnn_tpu_torch.runtime.prefix_cache import load_prefix, save_prefix
from mnn_tpu_torch.serve.server import make_handler
from mnn_tpu_torch.train import compress, lora, trainer
from mnn_tpu_torch.utils import native

HBM_BYTES_S = 3.35e12       # H100 SXM device memory (data sheet)
BF16_OPS_S = 989e12         # dense bf16 tensor-core peak
F32_OPS_S = 67e12           # f32 outside the tensor cores
INT8_OPS_S = 1979e12        # dense int8 tensor-core peak
L2_ROTATE_BYTES = 128 << 20  # rotate over this many weight bytes: > 50 MB L2

PREFILL_LENS = (17, 300, 600)
NEW_TOKENS = 32
PARITY_STEPS = 8
FALLBACK_PROMPT = 300       # phase 3c: the per-layer path's prompt
PARITY_REL = 5e-2           # JAX megakernel logits bound, tests/test_decode_model.py:97
SEED = 0                    # weights and inputs
MOE_PRESET = "qwen1.5-moe-a2.7b"
# phase 4, mixture of experts: depth of both sides (at 4 layers the CPU side
# takes about 35 s)
MOE_PARITY_LAYERS = 4
MOE_TOL = 2e-2              # both expert kernels, tests/test_moe_decode.py:61
SERVE_SLOTS = 4             # phase 5: the engines' width
SERVE_DENSE_LENS = (17, 300, 600, 17, 300, 600, 64, 900)   # (g), NEW_TOKENS each
SERVE_MOE_LENS = (17, 300, 600, 64)                         # (h)
SERVE_MOE_NEW = 16          # (h): new tokens a request, one decode block
SERVE_HTTP_TOKENS = 16      # (i): new tokens a request
# (g), (h): the fewest steps whose tokens the batch-1 runs must check, summed
# over the requests (logit rows' tokens, served tokens): about half of what
# an H100 run compared (58 of 72 and 28 of 64 at (g), 22 of 36 and 12 of 32
# at (h), when served tokens stopped at the first unclear margin)
SERVE_DENSE_FLOORS = (32, 16)
SERVE_MOE_FLOORS = (12, 8)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, calls: int, replays: int = 3) -> float:
    """Device time of one `fn(i)` call. The calls are captured into a CUDA
    graph and replayed, so the time is the card's and not Python's launch
    overhead."""
    for i in range(2):                          # warm-up (allocator, handles)
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def event_ms(fn, calls: int) -> float:
    """Device time of one `fn(i)` call from CUDA events around a plain loop
    of launches, for a kernel that takes far longer than its enqueue: the
    whole-model decode kernel is a cooperative launch, which is kept out of
    graph capture here."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profiled_device_ms(fn, calls: int):
    """(device ms, kernel launches) of one `fn()` call: the sum of the
    kernels' device times that torch.profiler records over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    check(bool(evs), "the profiler recorded no device time")
    return (sum(e.self_device_time_total for e in evs) / 1e3 / calls,
            sum(e.count for e in evs) / calls)


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main-path shapes
# --------------------------------------------------------------------------

def rand_quantized(g, dev, k, n, *, layers, bits=4,
                   bs=128, with_bias=False, act_bits=16):
    packed = torch.randint(-128, 128, (layers, k * bits // 8, n),
                           dtype=torch.int8, device=dev, generator=g)
    scale = (torch.rand((layers, k // bs, n), device=dev, generator=g)
             * 2e-3 + 1e-3).to(torch.bfloat16)
    bias = (-((1 << bits) - 1) / 2 * scale.float()
            + torch.randn((layers, k // bs, n), device=dev, generator=g)
            * 1e-3).to(torch.bfloat16)
    ob = (torch.randn((layers, n), device=dev, generator=g) * 0.1
          if with_bias else None)
    return QuantizedLinear(packed=packed, scale=scale, bias=bias, out_bias=ob,
                           bits=bits, block_size=bs, act_bits=act_bits)


def copies_for(nbytes: int, cap: int = 512) -> int:
    return max(1, min(cap, math.ceil(L2_ROTATE_BYTES / max(nbytes, 1))))


def bound_of(ops: float, nbytes: float, ops_s: float = BF16_OPS_S):
    """(least ms the card could take, which of the two limits it)."""
    t_ops, t_bytes = ops / ops_s, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


PROJ = {  # qwen2-0.5b: (K, N, has out_bias) per projection
    "qkv": (896, 1152, True),
    "wo": (896, 896, False),
    "wgu": (896, 9728, False),
    "wdown": (4864, 896, False),
}
MOE_PROJ = {  # qwen1.5-moe-a2.7b's attention projections
    "moe_qkv": (2048, 6144, True),
    "moe_wo": (2048, 2048, False),
}


def a8_kernel_alone(ql, x, out_dtype, nl):
    """Device ms of `KERNEL_A8` alone, on rows quantized beforehand: the
    whole call also runs `quantize_activations_int8`'s torch ops."""
    m, k = x.shape
    xq, xs = quantize_activations_int8(x)
    xs = xs.reshape(m).contiguous()
    out = torch.empty((m, ql.out_features), dtype=out_dtype, device=x.device)

    def launch(i):
        q = ql.layer(i % nl)
        dequant_matmul.KERNEL_A8(
            xq.data_ptr(), xs.data_ptr(), q.packed.data_ptr(), q.scale.data_ptr(),
            q.bias.data_ptr(), None if q.out_bias is None else q.out_bias.data_ptr(),
            out.data_ptr(), m, k, ql.out_features, ql.bits, ql.block_size,
            int(out_dtype == torch.float32))
    return time_ms(launch, calls=max(nl, 8)), xq


def int_mm_ms(ql, xq, nl):
    """Yardstick: `torch._int_mm` of the int8 rows with the re-centred int8
    pattern [K, N] (column-major, as cuBLASLt takes it), with no per-block
    scales: the rate cuBLAS reaches on the int8 tensor cores."""
    k, n = xq.shape[1], ql.out_features
    center = 1 << (ql.bits - 1)
    nint = copies_for(k * n, cap=nl)
    wq = [(unpack_bits(ql.packed[i], ql.bits, ql.block_size) - center)
          .to(torch.int8).t().contiguous().t() for i in range(nint)]
    return time_ms(lambda i: torch._int_mm(xq, wq[i % nint]), calls=max(nint, 8))


def gemm_rows(a8: bool) -> list:
    """Phase 2's own rows of K1 (bf16 rows: at M = 1 the decode GEMVs and
    the lm head on the GEMV kernel; at M > 1 the tensor-core tile kernel,
    for qwen1.5-moe-a2.7b's shared expert at the 32-, 128- and 512-row
    buckets and qwen2-0.5b's projections at M = 512 under
    prefill_act_bits=16) or of K2 (int8 rows, M = 512: prefill GEMMs; and
    qwen2-0.5b's gate/up at the 32- and 128-row buckets), as (proj, K, N,
    out_bias, M)."""
    shapes = [(p, k, n, b, 512 if a8 else 1)
              for p, (k, n, b) in list(PROJ.items()) + list(MOE_PROJ.items())]
    if a8:
        return shapes + [("wgu", *PROJ["wgu"], 32), ("wgu", *PROJ["wgu"], 128)]
    shapes += [("lm_head", 896, 151936, False, 1), ("moe_lm_head", 2048, 151936, False, 1)]
    # qwen1.5-moe-a2.7b's shared expert in a prefill chunk: bf16 rows
    shapes += [(p, k, n, False, m) for m in (32, 128, 512)
               for p, k, n in (("moe_shared_gu", 2048, 11264), ("moe_shared_dn", 5632, 2048))]
    return shapes + [(p, k, n, b, 512) for p, (k, n, b) in PROJ.items()]


# phase 10's verify rows of K1: a chain verify of 4 + 1 and 7 + 1 rows and a
# 13-node tree, on qwen2-0.5b's four projections and its int4 head (f32 out)
VERIFY_MS = (5, 8, 13)
VERIFY_GEMM = [(p, k, n, b, m) for m in VERIFY_MS
               for p, (k, n, b) in list(PROJ.items()) + [("lm_head", (896, 151936, False))]]

# qwen2-7b's projections and int4 head (f32 out), served by phase 11: row 2
# at the 512-row prefill chunk; row 1a at M = 1, the projections in (ll)'s
# per-layer PLE decode and the head after every prefill of (jj) and (mm)
QWEN7B_PROJ = {
    "qwen7b_qkv": (3584, 4608, True),
    "qwen7b_wo": (3584, 3584, False),
    "qwen7b_wgu": (3584, 37888, False),
    "qwen7b_wdown": (18944, 3584, False),
}
QWEN7B_PREFILL = [(p, k, n, b, 512) for p, (k, n, b) in QWEN7B_PROJ.items()]
QWEN7B_GEMV = ([(p, k, n, b, 1) for p, (k, n, b) in QWEN7B_PROJ.items()]
               + [("qwen7b_lm_head", 3584, 152064, False, 1)])


def phase_gemm(dev, g, results, *, a8: bool, shapes=None, key=None, bs=128):
    """K1 (bf16 rows) or K2 (int8 rows, `a8`) at `shapes`, (proj, K, N,
    out_bias, M) rows (None: `gemm_rows(a8)`), W4 in quant blocks of `bs`
    (a row may end in its own block), each held against its plain version
    and timed beside a bf16 `torch.matmul`; the rows go to results[key]
    (None: the kernel's name). K2 rows must give the plain version's bits."""
    name = "dequant_matmul_a8" if a8 else "dequant_matmul"
    shapes = gemm_rows(a8) if shapes is None else shapes
    tol = 1e-2
    rows = []
    for proj, k, n, with_bias, m, *row_bs in shapes:
        bs_row = row_bs[0] if row_bs else bs
        # the shared expert's down projection gives f32 rows, as in the model
        out_dtype = (torch.float32 if proj.endswith("lm_head") or proj == "moe_shared_dn"
                     else torch.bfloat16)
        wbytes = k * n // 2 + 2 * (k // bs_row) * n * 2 + (n * 4 if with_bias else 0)
        nl = copies_for(wbytes)
        ql = rand_quantized(g, dev, k, n, layers=nl, bs=bs_row,
                            with_bias=with_bias, act_bits=8 if a8 else 16)
        x = (torch.randn((m, k), device=dev, generator=g)).to(torch.bfloat16)
        tile = None if a8 else dequant_matmul.bf16_tile(m, n, ql.bits, bs_row)
        kern = (dequant_matmul.KERNEL_A8 if a8 else
                dequant_matmul.KERNEL_BF16_TILE if tile else dequant_matmul.KERNEL_BF16)
        before = kern.launches
        got = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
        check(kern.launches == before + 1, f"{name} {proj} M={m}: {kern.name} not launched")
        if m == 1:   # the GEMV's K ranges meet in a fixed order
            again = dequant_matmul.dequant_matmul(x, ql, layer_index=0, out_dtype=out_dtype)
            check(torch.equal(got, again), f"{name} {proj} M=1: two calls gave different bits")
        check(a8 or (tile is None) == (m == 1),
              f"{name} {proj} M={m}: bf16 rows took {kern.name}")
        want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), out_dtype)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{name} {proj}: non-finite output")
        check(rel <= tol, f"{name} {proj} M={m}: rel-L2 {rel:.3g} > {tol}")
        check(not a8 or err == 0.0,
              f"{name} {proj} M={m} block {bs_row}: max |diff| {err:.3g} from the plain version")
        ms = time_ms(lambda i: dequant_matmul.dequant_matmul(
            x, ql, layer_index=i % nl, out_dtype=out_dtype), calls=max(nl, 8))
        plain_ms = time_ms(lambda i: dequant_matmul.dequant_matmul_plain(
            x, ql.layer(i % nl), out_dtype), calls=2, replays=2)
        # yardstick: one bf16 torch.matmul on weights dequantized beforehand
        nlib = copies_for(k * n * 2, cap=nl)
        wlib = [dequantize(ql.layer(i), dtype=torch.bfloat16)
                for i in range(nlib)]
        ob = ql.out_bias
        lib_ms = time_ms(lambda i: (
            torch.matmul(x, wlib[i % nlib]) if ob is None
            else torch.addmm(ob[i % nlib].to(torch.bfloat16), x, wlib[i % nlib])),
            calls=max(nlib, 8))
        del wlib
        out_b = m * n * (4 if out_dtype == torch.float32 else 2)
        nbytes = (m * k + m * 4 if a8 else m * k * 2) + wbytes + out_b
        bound, bound_by = bound_of(2 * m * k * n, nbytes,
                                   INT8_OPS_S if a8 else BF16_OPS_S)
        row = dict(shape=f"{proj} M={m} K={k} N={n}" + (f" block {bs_row}" if bs_row != 128 else ""),
                   m=m, bits=ql.bits, block=bs_row, max_abs_err=err,
                   rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   l2_rotation=nl, kernel=kern.name)
        extra = ""
        if tile:
            row["tile"] = tile
            extra = f" | tile {tile[0]}x{tile[1]} smem {tile[2]}"
        elif not a8:
            cols, ranges, blocks, smem = dequant_matmul.gemv_split(k, n, ql.bits, bs_row)
            row["split"] = dict(tile=cols, k_ranges=ranges, blocks=blocks, smem=smem)
            extra = f" | {cols}-column tiles x {ranges} K ranges, {blocks} blocks, smem {smem}"
        if a8:
            row["kernel_alone_ms"], xq = a8_kernel_alone(ql, x, out_dtype, nl)
            row["int_mm_ms"] = int_mm_ms(ql, xq, nl)
            row["tile"] = dequant_matmul.a8_tile(m, n, ql.bits, bs_row)
            extra = (f" | alone {row['kernel_alone_ms']:.4f} int_mm {row['int_mm_ms']:.4f} "
                     f"tile {row['tile'][0]}x{row['tile'][1]} smem {row['tile'][2]}")
        rows.append(row)
        print(f"  {name:18s} {row['shape']:32s} rel {rel:.2e} max_abs {err:.3g} | "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} lib {lib_ms:.4f} "
              f"bound {bound:.4f} ({bound_by}){extra}", flush=True)
        del ql, x, got, want
        torch.cuda.empty_cache()
    results[key or name] = rows


def phase_flash(dev, g, results):
    """K3 at the prefill chunks of the three requests (cache capacity 1024),
    with qwen2-0.5b's heads and, for two of the chunks, qwen1.5-moe-a2.7b's;
    the short chunk over the long cache also at batch 2, and the chunk the
    300-token request sends the mixture-of-experts model in serving. Each
    row with the tiling the kernel took (`flash_attention.prefill_tile`)."""
    # (B, H, Hkv, D, bucket, kv_len, q_offset): 17 -> 32, 300 -> 512,
    # 600 -> 512 + 128, kv_len the prompt's length. Serving appends the
    # whole padded bucket before attention (and rolls the tail back after),
    # so it runs kv_len = 32, 512 and 640: the last row is that shape for
    # the 300-token request on qwen1.5-moe-a2.7b.
    results["flash_prefill"] = [flash_row(dev, g, *shape) for shape in (
            (1, 14, 2, 64, 32, 17, 0), (1, 14, 2, 64, 512, 300, 0), (1, 14, 2, 64, 512, 512, 0),
            (1, 14, 2, 64, 128, 600, 512), (1, 16, 16, 128, 512, 300, 0),
            (1, 16, 16, 128, 128, 600, 512), (2, 16, 16, 128, 128, 600, 512),
            (1, 16, 16, 128, 512, 512, 0))]


def phase_flash_7b(dev, g, results):
    """K3 at the chunks phase 11 (jj) serves on qwen2-7b's heads (28 query
    heads, 4 KV heads, D = 128) over its 2,048 cache: the 601-token prompt's
    512-bucket, then its 128-bucket at q_offset 512 (serving appends whole
    buckets, so kv_len 512 and 640)."""
    results["flash_prefill_7b"] = [flash_row(dev, g, 1, 28, 4, 128, t, kv, q_off, cap=MM_CAP)
                                   for t, kv, q_off in ((512, 512, 0), (128, 640, 512))]


# phase 10's chain verify on K3: Tq = 5 and 8 (drafts of 4 and 7, plus the
# root) at q_offset 331 and 631, kv_len = q_offset + Tq, qwen2-0.5b's heads
VERIFY_FLASH_ROWS = [(t, q_off) for t in (5, 8) for q_off in (331, 631)]


def phase_flash_verify(dev, g, results):
    """K3 at VERIFY_FLASH_ROWS over a 1,024 cache: fewer query rows than one
    warp's 16, far into the cache."""
    results["flash_prefill_verify"] = [flash_row(dev, g, 1, 14, 2, 64, t, q_off + t, q_off)
                                       for t, q_off in VERIFY_FLASH_ROWS]


def flash_row(dev, g, b, h, hkv, d, t, kv_len, q_off, cap=1024):
    """One K3 row: the kernel against its plain version (rel-L2 2e-2), its
    time, the plain version's, SDPA's and the bound, and the tiling."""
    tol = 2e-2
    q = torch.randn((b, h, t, d), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((b, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((b, hkv, cap, d), device=dev, generator=g).to(torch.bfloat16)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    got = flash_attention.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
    want = flash_attention.flash_attention_plain(q, k, v, kl, qo)
    torch.cuda.synchronize()
    # rows past the prompt (padded bucket tail) are rolled back; the
    # kernel's contract still covers them, so they are compared too
    err, rel = max_abs(got, want), rel_l2(got, want)
    check(bool(torch.isfinite(got).all()), "flash_prefill: non-finite output")
    check(rel <= tol, f"flash_prefill B={b} T={t} kv={kv_len}: rel-L2 {rel:.3g} > {tol}")
    ms = time_ms(lambda i: flash_attention.flash_attention(
        q, k, v, kv_len=kl, q_offset=qo), calls=24)
    plain_ms = time_ms(lambda i: flash_attention.flash_attention_plain(
        q, k, v, kl, qo), calls=4, replays=2)
    mask = flash_attention._mask(b, t, cap, kl, qo, True, 0, 0, dev)
    kr = k.repeat_interleave(h // hkv, dim=1)
    vr = v.repeat_interleave(h // hkv, dim=1)
    lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask), calls=24)
    visible = sum(min(kv_len, q_off + r + 1) for r in range(t))
    flops = 4 * b * h * d * visible
    nbytes = 2 * b * (2 * h * t * d + 2 * hkv * kv_len * d)
    bound, bound_by = bound_of(flops, nbytes)
    rows_a_block, splits, bkv, smem, blocks = flash_attention.prefill_tile(b, h, t, d)
    row = dict(shape=f"B={b} H={h} Hkv={hkv} D={d} T={t} kv_len={kv_len} q_offset={q_off} "
                     f"S={cap}",
               max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by=bound_by, tile=dict(rows=rows_a_block, kv_splits=splits,
                                            kv_tile=bkv, smem=smem, blocks=blocks))
    print(f"  flash_prefill      {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} ({bound_by}) | "
          f"{rows_a_block} rows x {blocks} blocks, K/V in {splits} splits of "
          f"{bkv}-position tiles, smem {smem}",
          flush=True)
    return row


# K4's rows: (batch, Hkv, G, D, len_old per sequence) at the last decode step
# of the 17-, 300- and 600-token requests (len_old 48, 331, 631): qwen2-0.5b's
# heads at the three and qwen1.5-moe-a2.7b's at 331 first, then
# qwen1.5-moe-a2.7b's at 48 and 631, and qwen2-0.5b at batch 2 with ragged
# lengths.
DECODE_ROWS = [(1, 2, 7, 64, (48,)), (1, 2, 7, 64, (331,)), (1, 2, 7, 64, (631,)),
               (1, 16, 1, 128, (331,)), (1, 16, 1, 128, (48,)), (1, 16, 1, 128, (631,)),
               (2, 2, 7, 64, (331, 631))]
DECODE_FIRST_ROWS = 4   # the rows the kernels line summed before the last three


def phase_decode(dev, g, results, shapes=DECODE_ROWS, cap=1024, key="decode_step"):
    """K4 at `shapes` over a 24-layer int8 cache of capacity `cap`, each with
    the split the kernel took (`decode_step.split`): blocks a cluster,
    positions a tile, shared bytes a block, blocks. Two calls must give the
    same bits. The rows go to results[key]."""
    L = 24
    tol = 3e-2
    rows = []
    kq = None
    for bsz, hkv, grp, d, lens in shapes:
        if kq is None or kq.shape[1:4] != (bsz, hkv, cap):
            kq = vq = None
            kf = torch.randn((L, bsz, hkv, cap, d), device=dev, generator=g)
            kq, ks = kvcache.quantize_kv(kf)
            kf = torch.randn((L, bsz, hkv, cap, d), device=dev, generator=g)
            vq, vs = kvcache.quantize_kv(kf)
            del kf
        qkv = torch.randn((bsz, hkv, grp + 2, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ang = torch.rand((bsz, d // 2), device=dev, generator=g) * 6.28
        cos = torch.cat([ang.cos(), ang.cos()], -1)
        sin = torch.cat([ang.sin(), ang.sin()], -1)
        got = decode_step.fused_decode_attention(qkv, kq, vq, ks, vs, 3, lengths, cos, sin)
        again = decode_step.fused_decode_attention(qkv, kq, vq, ks, vs, 3, lengths, cos, sin)
        want = decode_step.fused_decode_attention_plain(qkv, kq, vq, ks, vs, 3, lengths, cos,
                                               sin, None, None, 1e-6, d ** -0.5, 0, 0, 0.0)
        torch.cuda.synchronize()
        name = f"decode_step B={bsz} len={lens}"
        err, rel = max_abs(got[0], want[0]), rel_l2(got[0], want[0])
        check(bool(torch.isfinite(got[0]).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: att rel-L2 {rel:.3g} > {tol}")
        for j, nm in ((1, "k_row"), (2, "v_row")):
            lv = max_abs(got[j], want[j])
            check(lv <= 1.0, f"{name} {nm}: {lv} int8 levels apart")
        for j, nm in ((3, "k_scale"), (4, "v_scale")):
            check(rel_l2(got[j], want[j]) <= 1e-6, f"{name} {nm} differs")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: two calls gave different bits")
        ms = time_ms(lambda i: decode_step.fused_decode_attention(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin), calls=48)
        plain_ms = time_ms(lambda i: decode_step.fused_decode_attention_plain(
            qkv, kq, vq, ks, vs, i % L, lengths, cos, sin, None, None, 1e-6,
            d ** -0.5, 0, 0, 0.0), calls=8, replays=2)
        # yardstick: SDPA of the query rows over the dequantized rows, each
        # sequence masked to its len_old + 1 positions
        q = qkv[:, :, :grp].reshape(bsz, hkv * grp, 1, d)
        n = max(lens) + 1
        kd = kvcache.dequant_kv(kq[3], ks[3], 8)[:, :, :n].repeat_interleave(grp, 1)
        vd = kvcache.dequant_kv(vq[3], vs[3], 8)[:, :, :n].repeat_interleave(grp, 1)
        mask = (torch.arange(n, device=dev)[None, :] <= lengths[:, None])[:, None, None]
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), calls=48)
        nbytes = bsz * (hkv * (grp + 2) * d * 2 + 2 * d * 4        # qkv, cos/sin
                        + hkv * grp * d * 2 + 2 * hkv * (d + 1) * 4)   # att, rows, scales
        nbytes += sum(2 * hkv * n_old * (d + 4) for n_old in lens)     # int8 K/V + scales
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_cluster, tile, smem, blocks = decode_step.split(bsz, hkv, grp, cap, d, True)
        row = dict(shape=f"B={bsz} Hkv={hkv} G={grp} D={d} len_old={','.join(map(str, lens))} "
                         f"S={cap} int8",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by="bytes", split=dict(blocks_a_cluster=blocks_a_cluster, tile=tile,
                                                smem=smem, blocks=blocks))
        rows.append(row)
        print(f"  decode_step        {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} | clusters of "
              f"{blocks_a_cluster} blocks, {tile}-position tiles, smem {smem}, {blocks} blocks",
              flush=True)
    del kq, vq
    results[key] = rows


def rand_cache(g, dev, layers, batch, hkv, cap, d, bits):
    """A cache filled with quantized random rows: (k, v, k_scale, v_scale)."""
    kf = torch.randn((layers, batch, hkv, cap, d), device=dev, generator=g)
    vf = torch.randn((layers, batch, hkv, cap, d), device=dev, generator=g)
    if bits == 16:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    kq, ks = kvcache.quantize_for(bits, kf)
    vq, vs = kvcache.quantize_for(bits, vf)
    return kq, vq, ks, vs


# K5's rows: (B, Hkv, G, D, kv bits, kv_len per sequence, capacity). The last
# decode step of the 17-, 300- and 600-token requests (kv_len counts the new
# token) with qwen2-0.5b's heads at int8 and int4 first (the six rows the
# kernels line summed before the rest), then qwen1.5-moe-a2.7b's at both
# widths, a ragged batch 2, and kv_len 4000 of a 4096 cache at int4.
FLASH_DECODE_ROWS = [(1, 2, 7, 64, bits, (n + NEW_TOKENS,), 1024)
                     for bits in (8, 4) for n in PREFILL_LENS]
FLASH_DECODE_ROWS += [(1, 16, 1, 128, bits, (n + NEW_TOKENS,), 1024)
                      for bits in (8, 4) for n in PREFILL_LENS]
FLASH_DECODE_ROWS += [(2, 2, 7, 64, 8, (332, 632), 1024), (1, 16, 1, 128, 4, (4000,), 4096)]
FLASH_DECODE_FIRST_ROWS = 6


def phase_flash_decode(dev, g, results):
    """K5 at the rows of FLASH_DECODE_ROWS over a 24-layer cache, each with
    the split the kernel took (`flash_attention.decode_split`): blocks a KV
    head, positions a tile, shared bytes a block, blocks. Two calls must give
    the same bits."""
    L = 24
    tol = 3e-2                      # tests/test_attention.py:126
    rows = []
    key = kq = None
    for bsz, hkv, grp, d, bits, lens, cap in FLASH_DECODE_ROWS:
        if kq is None or key != (bsz, hkv, d, bits, cap):
            kq = vq = ks = vs = None        # the last cache goes first
            key = (bsz, hkv, d, bits, cap)
            kq, vq, ks, vs = rand_cache(g, dev, L, bsz, hkv, cap, d, bits)
        q = torch.randn((bsz, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        name = f"flash_decode B={bsz} Hkv={hkv} int{bits} kv_len={lens}"
        got = flash_attention.decode_attention(q, kq, vq, lengths, k_scale=ks,
                                               v_scale=vs, layer_index=3)
        again = flash_attention.decode_attention(q, kq, vq, lengths, k_scale=ks,
                                                 v_scale=vs, layer_index=3)
        want = flash_attention.decode_attention_plain(q, kq, vq, lengths, ks, vs, 3)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: rel-L2 {rel:.3g} > {tol}")
        check(torch.equal(got, again), f"{name}: two calls gave different bits")
        ms = time_ms(lambda i: flash_attention.decode_attention(
            q, kq, vq, lengths, k_scale=ks, v_scale=vs, layer_index=i % L), calls=48)
        plain_ms = time_ms(lambda i: flash_attention.decode_attention_plain(
            q, kq, vq, lengths, ks, vs, i % L), calls=8, replays=2)
        # yardstick: SDPA of the query rows over the dequantized rows, each
        # sequence masked to its kv_len
        n = max(lens)
        q4 = q.reshape(bsz, hkv * grp, 1, d)
        kd = kvcache.dequant_kv(kq[3], ks[3], bits)[:, :, :n].repeat_interleave(grp, 1)
        vd = kvcache.dequant_kv(vq[3], vs[3], bits)[:, :, :n].repeat_interleave(grp, 1)
        mask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None]
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask), calls=48)
        nbytes = 2 * bsz * hkv * grp * d * 2                           # q in, out
        nbytes += sum(2 * hkv * kv_len * (d * bits // 8 + 4) for kv_len in lens)
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_head, tile, smem, blocks = flash_attention.decode_split(bsz, hkv, grp, cap,
                                                                         d, bits)
        row = dict(shape=f"B={bsz} Hkv={hkv} G={grp} D={d} kv_len={','.join(map(str, lens))} "
                         f"S={cap} int{bits}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by="bytes",
                   split=dict(blocks_a_head=blocks_a_head, tile=tile, smem=smem,
                              blocks=blocks))
        rows.append(row)
        print(f"  flash_decode       {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} | {blocks_a_head} "
              f"blocks a KV head, {tile}-position tiles, smem {smem}, {blocks} blocks",
              flush=True)
    del kq, vq, ks, vs
    results["flash_decode"] = rows


# K5 as phase 9 calls it: (one unpacked layer?, kv bits, kv_len) with
# qwen2-0.5b's heads over a capacity of 1,024: the last decode step of the
# 300- and 600-token requests over one bf16 layer without `layer_index` (a
# TQ3 / TQ4 step unpacks its layer first) and over the stacked 24-layer int8
# cache (a rotated int8 step)
FLASH_DECODE_KV_ROWS = [(True, 16, 331), (True, 16, 631), (False, 8, 331), (False, 8, 631)]
# K5 as phase 10's EAGLE draft calls it: one bf16 layer [1, Hkv, 1,024, D]
# (the draft's own cache) at kv_len 300 and 600
FLASH_DECODE_DRAFT_ROWS = [(True, 16, 300), (True, 16, 600)]


def phase_flash_decode_kv(dev, g, results, rows_of=FLASH_DECODE_KV_ROWS,
                          key="flash_decode_kv"):
    """K5 at `rows_of`, each held to its plain version (rel-L2 3e-2, the
    same bits twice), timed over 24 layers' rows (one layer a call), beside
    SDPA over the same rows and the byte bound; the rows go under `key`."""
    L, bsz, hkv, grp, d, cap = 24, 1, 2, 7, 64, 1024
    tol = 3e-2
    rows = []
    caches = {bits: rand_cache(g, dev, L, bsz, hkv, cap, d, bits) for bits in (16, 8)
              if any(b == bits for _, b, _ in rows_of)}
    for one, bits, n in rows_of:
        kq, vq, ks, vs = caches[bits]
        q = torch.randn((bsz, hkv * grp, d), device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        if one:     # one layer [B, Hkv, S, D], as `forward` unpacks a TQ layer
            args = lambda i: (kq[i % L], vq[i % L], None, None, None)
        else:
            args = lambda i: (kq, vq, ks, vs, i % L)
        call = lambda i: flash_attention.decode_attention(
            q, *args(i)[:2], lengths, k_scale=args(i)[2], v_scale=args(i)[3],
            layer_index=args(i)[4])
        name = f"flash_decode {'one bf16 layer' if one else f'stacked int{bits}'} kv_len={n}"
        before = flash_attention.KERNEL_DECODE.launches
        got, again = call(3), call(3)
        check(flash_attention.KERNEL_DECODE.launches == before + 2,
              f"{name}: not one launch a call")
        want = flash_attention.decode_attention_plain(q, *args(3)[:2], lengths, *args(3)[2:])
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: rel-L2 {rel:.3g} > {tol}")
        check(torch.equal(got, again), f"{name}: two calls gave different bits")
        ms = time_ms(call, calls=48)
        plain_ms = time_ms(lambda i: flash_attention.decode_attention_plain(
            q, *args(i)[:2], lengths, *args(i)[2:]), calls=8, replays=2)
        q4 = q.reshape(bsz, hkv * grp, 1, d)
        kd = kvcache.dequant_kv(kq[3], None if ks is None else ks[3], bits)[:, :, :n]
        vd = kvcache.dequant_kv(vq[3], None if vs is None else vs[3], bits)[:, :, :n]
        kd, vd = kd.repeat_interleave(grp, 1), vd.repeat_interleave(grp, 1)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd), calls=48)
        nbytes = 2 * bsz * hkv * grp * d * 2                           # q in, out
        nbytes += 2 * hkv * n * (d * bits // 8 + (4 if bits < 16 else 0))
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_head, tile, smem, blocks = flash_attention.decode_split(bsz, hkv, grp, cap,
                                                                         d, bits)
        row = dict(shape=f"B=1 Hkv={hkv} G={grp} D={d} kv_len={n} S={cap} "
                         f"{'one bf16 layer' if one else f'stacked int{bits}'}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by="bytes",
                   split=dict(blocks_a_head=blocks_a_head, tile=tile, smem=smem,
                              blocks=blocks))
        rows.append(row)
        print(f"  flash_decode       {row['shape']:46s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bound:.5f} | {blocks_a_head} "
              f"blocks a KV head, {tile}-position tiles, {blocks} blocks", flush=True)
    results[key] = rows


def decode_model_bytes(cfg, lay, head, batch, kv_bits, lengths) -> int:
    """Bytes one step must move: every weight, plane, bias and norm byte and
    the head once (when it is fused), the cached K/V rows and scales that this
    run's lengths make visible (`lengths`: positions read a sequence), x in,
    and x, the new rows and the logits out."""
    def ql_bytes(ql):
        return sum(t.numel() * t.element_size()
                   for t in (ql.packed, ql.scale, ql.bias, ql.out_bias) if t is not None)
    mats = (lay.wqkv, lay.wo, lay.wgu, lay.wdown) + ((head,) if head is not None else ())
    n = sum(ql_bytes(q) for q in mats)
    norms = [v for v in (lay.input_norm, lay.post_norm, lay.pre_ffn_norm, lay.post_ffn_norm)
             if v is not None]
    n += (sum(v.numel() for v in norms) + cfg.hidden_size) * 4
    row = cfg.head_dim * kv_bits // 8 + (4 if kv_bits < 16 else 0)
    n += 2 * cfg.num_layers * cfg.num_kv_heads * row * (sum(lengths) + batch)
    n += batch * (2 * cfg.hidden_size + (cfg.vocab_size if head is not None else 0)) * 4
    return int(n)


def step_inputs(params, cfg, lengths, dev, g):
    """x, lengths and rope phases of one decode step, as `forward` makes them."""
    b = len(lengths)
    tok = torch.randint(0, cfg.vocab_size, (b,), device=dev, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(lens[:, None].long(), cfg.head_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling)
    cos_f = torch.cat([cos[:, 0], cos[:, 0]], dim=-1)
    sin_f = torch.cat([sin[:, 0], sin[:, 0]], dim=-1)
    return tok, params.embedding[tok], lens, cos_f, sin_f


DECODE_MODEL_FIRST_ROWS = 7   # the rows the kernels line summed before the 28-layer one


def decode_model_row(dev, g, name, cfg, params, kv_bits, lengths, cap):
    """One K7 row of phase 2: the whole-model kernel against its plain
    version from the same random state (`lengths` positions of a cache of
    `cap`), timed beside the plain version and the per-layer path's device
    time, with the schedule the kernel walked; two calls give the same
    bits."""
    b = len(lengths)
    kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, cap,
                                cfg.head_dim, kv_bits)
    tok, x, lens, cos_f, sin_f = step_inputs(params, cfg, lengths, dev, g)
    args = (x, params.layers, kc, vc, ks, vs, lens, cos_f, sin_f)
    kw = dict(config=cfg, head=params.lm_head, final_norm=params.final_norm)
    check(decode_model.supports_head(cfg, params), f"{name}: head not fusable")
    got = decode_model.fused_decode_model(*args, **kw)
    want = decode_model.fused_decode_model_plain(*args, **kw)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
          f"decode_model {name}: non-finite output")
    m = decode_model.parity_metrics(got, want, kv_bits)
    # x_out is held at three layers by the tests; at full depth the
    # residual stream's bf16 noise compounds (x rel-L2 ~3e-2) and only
    # the logits are held. An int4 level is 18 times an int8 level's
    # size, so that noise, far below one level, still flips some: over
    # all layers int4 rows stay within one LEVEL of the plain version's,
    # and their dequantized rel-L2 within 1.5e-1 instead of 3e-2.
    deep4 = dict(rows_levels=1.0, rows_rel=1.5e-1) if kv_bits == 4 else {}
    bad = decode_model.parity_failures(m, skip=("x_rel",), **deep4)
    check(not bad, f"decode_model {name} kv{kv_bits} lengths {lengths}: {bad} in {m}")
    ms = event_ms(lambda i: decode_model.fused_decode_model(*args, **kw), calls=20)
    plain_ms = event_ms(lambda i: decode_model.fused_decode_model_plain(*args, **kw),
                        calls=2)
    # no single PyTorch call computes this function; beside it, the
    # per-layer path's device time for the same step (its kernels' sum)
    cache = kvcache.KVCache(k=kc, v=vc, k_scale=ks, v_scale=vs, length=lens,
                            bits=kv_bits)
    per_layer_ms, per_layer_n = profiled_device_ms(lambda: decoder.forward(
        params, cfg, tok[:, None], cache, megakernel=False), calls=3)
    nbytes = decode_model_bytes(cfg, params.layers, params.lm_head, b, kv_bits, lengths)
    bound = nbytes / HBM_BYTES_S * 1e3
    again = decode_model.fused_decode_model(*args, **kw)
    same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    check(same, f"decode_model {name}: two calls gave different bits")
    sched = decode_model.schedule_info(cfg, params.layers, params.lm_head, b, cap, dev)
    row = dict(shape=f"{name} B={b} kv{kv_bits} len_old={','.join(map(str, lengths))}",
               bits=params.layers.wqkv.bits, max_abs_err=m["logits_max_abs"], rel_l2=m["logits_rel"],
               tol=decode_model.PARITY_BOUNDS["logits_rel"], parity=m, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by="bytes",
               bytes=nbytes, per_layer_path_device_ms=per_layer_ms,
               per_layer_path_launches=per_layer_n, same_twice=same,
               schedule={k: v for k, v in sched.items() if k != "units"})
    print(f"  decode_model       {row['shape']:44s} logits rel {m['logits_rel']:.2e} "
          f"x {m['x_rel']:.1e} rows {m['rows_rel']:.1e} row0 {m['row0_levels']:.0f} lvl "
          f"tokens {m['tokens_compared']}/{b} | kernel {ms:.4f} ms plain {plain_ms:.2f} "
          f"bound {bound:.4f} | per-layer path (device) {per_layer_ms:.3f} ms, "
          f"{per_layer_n:.0f} launches", flush=True)
    print(f"    schedule: {sched['grid']} blocks, items a phase (layer 0) "
          f"{sched['items_a_layer']}, K ranges a cut tile {sched['k_ranges']} "
          f"(tiles cut {sched['cut_tiles']}), "
          f"{sched['grid_waits_a_layer']} grid-wide waits a layer, ring {sched['slots']} "
          f"slots ({sched['ring_bytes']} B a block, {sched['bytes_in_flight']} B in "
          f"flight), weight bytes a block {sched['max_block_bytes']} most / "
          f"{sched['mean_block_bytes']:.0f} mean", flush=True)
    del kc, vc, ks, vs, cache, got, want, again
    return row


def phase_decode_model(dev, g, results, params05):
    """K7: the whole-model decode kernel against its plain version from the
    same state. Full-size qwen2-0.5b (the serving weights) over an int8 cache
    at the three requests' last steps, an int4 and a bf16 cache, and batch 4
    with unequal lengths; then two layers at qwen2-7b widths, and qwen2-7b at
    its full 28 layers. Each row prints the schedule the kernel walked, and
    two calls must give the same bits. Returns the 28-layer qwen2-7b
    weights, which phase 11 serves."""
    cap = 1024
    cfg05 = PRESETS["qwen2-0.5b"]
    cfg7 = dataclasses.replace(PRESETS["qwen2-7b"], num_layers=2)
    t0 = time.perf_counter()
    params7 = decoder.init_random_params(
        cfg7, torch.Generator().manual_seed(SEED + 1), lm_head_bits=4, device=dev)
    print(f"  qwen2-7b widths, 2 layers: built in {time.perf_counter() - t0:.1f} s", flush=True)
    last = [n + NEW_TOKENS - 1 for n in PREFILL_LENS]
    cases = [("qwen2-0.5b", cfg05, params05, 8, (last[0],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[2],)),
             ("qwen2-0.5b", cfg05, params05, 4, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 16, (last[1],)),
             ("qwen2-0.5b", cfg05, params05, 8, (last[0], last[1], last[2], 5)),
             ("qwen2-7b x2 layers", cfg7, params7, 8, (last[1],)),
             # the whole of qwen2-7b's depth (built below): the shape held by bytes
             ("qwen2-7b", PRESETS["qwen2-7b"], None, 8, (last[1],))]
    rows = []
    for name, cfg, params, kv_bits, lengths in cases:
        if params is None:
            t0 = time.perf_counter()
            params = decoder.init_random_params(
                cfg, torch.Generator().manual_seed(SEED + 1), lm_head_bits=4, device=dev)
            print(f"  qwen2-7b, {cfg.num_layers} layers: built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows.append(decode_model_row(dev, g, name, cfg, params, kv_bits, lengths, cap))
        if name == "qwen2-7b":
            params7 = params         # phase 11 serves these weights
        del params
        torch.cuda.empty_cache()
    results["decode_model"] = rows
    return params7


def ql_nbytes(ql, count: int = 1) -> int:
    """Bytes of `count` matrices of a stack whose first axis is the matrices."""
    per = sum(t[0].numel() * t.element_size() for t in (ql.packed, ql.scale, ql.bias))
    return per * count


def rand_experts(g, dev, lead, k, n, bs=128):
    ql = rand_quantized(g, dev, k, n, layers=math.prod(lead), bs=bs)
    rs = lambda t: t.reshape(*lead, *t.shape[1:])
    return dataclasses.replace(ql, packed=rs(ql.packed), scale=rs(ql.scale), bias=rs(ql.bias))


MOE_SHAPES = {   # preset -> (E, k, mi, si); H = 2048 for both
    "qwen1.5-moe-a2.7b": (60, 4, 1408, 5632),
    "qwen3-moe-30b-a3b": (128, 8, 768, 0),
}


def phase_moe_decode(dev, g, results, presets=tuple(MOE_SHAPES), bs=128, key="moe_decode"):
    """K8 at n = 1 and n = 4: qwen1.5-moe-a2.7b's widths (shared expert
    under its gate) and qwen3-moe-30b-a3b's (none), W4 in quant blocks of
    `bs`. A call reads other experts than the one before: the layer index
    rotates over a stack larger than L2."""
    rows = []
    for preset in presets:
        e, k, mi, si = MOE_SHAPES[preset]
        cfg = PRESETS[preset]
        h = cfg.hidden_size
        check((cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size,
               cfg.shared_expert_intermediate_size) == (e, k, mi, si), f"{preset}: shapes")
        nl = 4 if si else 8
        lay = decoder.LayerParams(
            wqkv=None, wo=None, wgu=None, wdown=None, input_norm=None, post_norm=None,
            wgu_e=rand_experts(g, dev, (nl, e), h, 2 * mi, bs),
            wdown_e=rand_experts(g, dev, (nl, e), mi, h, bs),
            wgu_shared=rand_experts(g, dev, (nl,), h, 2 * si, bs) if si else None,
            wdown_shared=rand_experts(g, dev, (nl,), si, h, bs) if si else None)
        for n in (1, 4):
            check(moe_decode.supports(cfg, lay, n), f"moe_decode {preset}: unsupported")
            x = torch.randn((n, h), device=dev, generator=g) * 0.5
            sel = torch.stack([torch.randperm(e, device=dev, generator=g)[:k]
                               for _ in range(n)]).to(torch.int32)
            wsel = torch.softmax(torch.randn((n, k), device=dev, generator=g), -1)
            gate = torch.rand((n,), device=dev, generator=g) if si else None
            run = lambda i: moe_decode.moe_decode_mlp(x, lay, sel, wsel, i % nl, gate,
                                                      config=cfg)
            plain = lambda i: moe_decode.moe_decode_mlp_plain(x, lay, sel, wsel, i % nl,
                                                              gate, config=cfg)
            got, again, want = run(1), run(1), plain(1)
            torch.cuda.synchronize()
            err, rel = max_abs(got, want), rel_l2(got, want)
            check(bool(torch.isfinite(got).all()), f"moe_decode {preset}: non-finite")
            check(rel <= MOE_TOL, f"moe_decode {preset} n={n}: rel-L2 {rel:.3g} > {MOE_TOL}")
            check(torch.equal(got, again), f"moe_decode {preset} n={n}: two runs differ")
            ms = time_ms(run, calls=16)
            plain_ms = time_ms(plain, calls=2, replays=2)
            # yardstick: the four products as bmm / matmul over the selected
            # experts' weights, dequantized to bf16 beforehand
            ids = sel.reshape(-1).long()
            deq = lambda ql, idx: torch.stack([dequantize(QuantizedLinear(
                packed=ql.packed[1][j], scale=ql.scale[1][j], bias=ql.bias[1][j],
                out_bias=None, bits=ql.bits, block_size=ql.block_size),
                dtype=torch.bfloat16) for j in idx])
            wg, wd = deq(lay.wgu_e, ids.tolist()), deq(lay.wdown_e, ids.tolist())
            xr = x.to(torch.bfloat16).repeat_interleave(k, 0)[:, None]
            ar = torch.randn((n * k, 1, mi), device=dev, generator=g).to(torch.bfloat16)
            if si:
                sg = dequantize(lay.wgu_shared.layer(1), dtype=torch.bfloat16)
                sd = dequantize(lay.wdown_shared.layer(1), dtype=torch.bfloat16)
                a_s = torch.randn((n, si), device=dev, generator=g).to(torch.bfloat16)

            def lib(i):
                torch.bmm(xr, wg)
                torch.bmm(ar, wd)
                if si:
                    torch.matmul(xr[::k, 0], sg)
                    torch.matmul(a_s, sd)
            lib_ms = time_ms(lib, calls=8)
            # bytes this run's routing needs: each distinct expert once
            distinct = int(sel.unique().numel())
            nbytes = (distinct * (ql_nbytes(lay.wgu_e.flat_experts())
                                  + ql_nbytes(lay.wdown_e.flat_experts()))
                      + (ql_nbytes(lay.wgu_shared) + ql_nbytes(lay.wdown_shared) if si else 0)
                      + 2 * n * h * 4 + n * k * 8 + n * 4)
            ops = 2 * 3 * h * (n * k * mi + n * si)
            bound, bound_by = bound_of(ops, nbytes)
            row = dict(shape=f"{preset} n={n} E={e} k={k} mi={mi} si={si}"
                       + (f" block {bs}" if bs != 128 else ""),
                       bits=lay.wgu_e.bits, max_abs_err=err, rel_l2=rel, tol=MOE_TOL, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=bound_by, bytes=nbytes,
                       bound_share=bound / ms, distinct_experts=distinct)
            rows.append(row)
            print(f"  moe_decode         {row['shape']:48s} rel {rel:.2e} (tol {MOE_TOL}) | "
                  f"kernel {ms:.4f} ms plain {plain_ms:.3f} lib {lib_ms:.4f} "
                  f"bound {bound:.4f} ({bound_by}, {100 * bound / ms:.1f} % of it)", flush=True)
            del wg, wd
        del lay
        torch.cuda.empty_cache()
    results[key] = rows


MOE_PREFILL_ROWS = [("qwen1.5-moe-a2.7b", 8), ("qwen1.5-moe-a2.7b", 24),
                    ("qwen1.5-moe-a2.7b", 72), ("qwen1.5-moe-a2.7b", 144),
                    ("qwen3-moe-30b-a3b", 64)]


def phase_moe_prefill(dev, g, results, cases=MOE_PREFILL_ROWS, block=128, key="moe_prefill"):
    """K9 at the capacities of qwen1.5-moe-a2.7b's chunks: C = 8, 24 and 72
    (the 32-, 128- and 512-token buckets of the three requests: partial
    products) and C = 144 (a 1024-token chunk: dequantized blocks); and of a
    512-token chunk of qwen3-moe-30b-a3b (C = 64). Each product's quant
    block is `choose_block_size(K, block)`, as the model's weights have it."""
    rows = []
    for preset, cap in cases:
        e, k, mi, _ = MOE_SHAPES[preset]
        h = PRESETS[preset].hidden_size
        bs_h, bs_mi = choose_block_size(h, block), choose_block_size(mi, block)
        gu = rand_experts(g, dev, (e,), h, 2 * mi, bs_h)
        dn = rand_experts(g, dev, (e,), mi, h, bs_mi)
        check(moe_prefill.supports(gu, dn, h, cap), f"moe_prefill {preset}: unsupported")
        xe = (torch.randn((e, cap, h), device=dev, generator=g) * 0.5).to(torch.bfloat16)
        w_e = torch.rand((e, cap), device=dev, generator=g)
        xe[:, -cap // 8:] = 0              # empty slots: zero rows, weight 0
        w_e[:, -cap // 8:] = 0
        tile = moe_prefill.tile(e, cap, h, mi, gu.bits, bs_h)
        got = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
        again = moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn)
        want = moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"moe_prefill {preset}: non-finite")
        check(rel <= MOE_TOL, f"moe_prefill {preset} C={cap}: rel-L2 {rel:.3g} > {MOE_TOL}")
        check(bool((got[:, -cap // 8:] == 0).all()), f"moe_prefill {preset}: empty slots not 0")
        check(torch.equal(got, again), f"moe_prefill {preset} C={cap}: two runs differ")
        del want, again
        ms = time_ms(lambda i: moe_prefill.moe_prefill_mlp(xe, w_e, gu, dn), calls=4)
        plain_ms = time_ms(lambda i: moe_prefill.moe_prefill_mlp_plain(xe, w_e, gu, dn),
                           calls=1, replays=2)
        # yardstick: two bmm over all experts' weights dequantized beforehand
        deq = lambda ql: torch.stack([dequantize(ql.layer(j), dtype=torch.bfloat16)
                                      for j in range(e)])
        wg, wd = deq(gu), deq(dn)
        act = torch.randn((e, cap, mi), device=dev, generator=g).to(torch.bfloat16)
        lib_ms = time_ms(lambda i: (torch.bmm(xe, wg), torch.bmm(act, wd)), calls=4)
        del wg, wd
        nbytes = (ql_nbytes(gu, e) + ql_nbytes(dn, e) + e * cap * (h * 2 + 4 + h * 4))
        bound, bound_by = bound_of(2 * e * cap * 3 * h * mi, nbytes)
        algebra = "/".join("partial" if cap < q.block_size else "dequant" for q in (gu, dn))
        row = dict(shape=f"{preset} E={e} C={cap} H={h} mi={mi} ({algebra})"
                   + (f" blocks {bs_h} / {bs_mi}" if block != 128 else ""),
                   bits=gu.bits, max_abs_err=err, rel_l2=rel, tol=MOE_TOL, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   tile=dict(rows=tile[0], cols=tile[1], smem=tile[2]), blocks=[bs_h, bs_mi])
        rows.append(row)
        print(f"  moe_prefill        {row['shape']:58s} rel {rel:.2e} (tol {MOE_TOL}) | "
              f"kernel {ms:.4f} ms plain {plain_ms:.2f} lib {lib_ms:.4f} "
              f"bound {bound:.4f} ({bound_by}) | tile {tile[0]} x {tile[1]}, "
              f"{tile[2]} B shared", flush=True)
        del gu, dn, xe, got
        torch.cuda.empty_cache()
    results[key] = rows


DEQ_ROWS = [("moe_shared_gu", 2048, 11264, False), ("moe_shared_dn", 5632, 2048, False),
            ("moe_qkv", 2048, 6144, True)]


def phase_gemm_deq(dev, g, results, shapes=DEQ_ROWS, bs=128, key="dequant_matmul_deq"):
    """K3 behind its switch, at M = 512 (W4 in quant blocks of `bs`):
    qwen1.5-moe-a2.7b's shared expert and its qkv projection."""
    tol, m = 1e-2, 512
    rows = []
    dequant_matmul.DEQ_MIN_M = m
    try:
        for proj, k, n, with_bias in shapes:
            wbytes = k * n // 2 + 2 * (k // bs) * n * 2 + (n * 4 if with_bias else 0)
            nl = copies_for(wbytes)
            ql = rand_quantized(g, dev, k, n, layers=nl, with_bias=with_bias, act_bits=8,
                                bs=bs)
            x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
            before = dequant_matmul.KERNEL_DEQ.launches
            got = dequant_matmul.dequant_matmul(x, ql, layer_index=0)
            check(dequant_matmul.KERNEL_DEQ.launches == before + 1,
                  "dequant_matmul_deq: the switch did not route the call")
            want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), deq=True)
            torch.cuda.synchronize()
            err, rel = max_abs(got, want), rel_l2(got, want)
            check(bool(torch.isfinite(got).all()), f"dequant_matmul_deq {proj}: non-finite")
            check(rel <= tol, f"dequant_matmul_deq {proj}: rel-L2 {rel:.3g} > {tol}")
            ms = time_ms(lambda i: dequant_matmul.dequant_matmul(x, ql, layer_index=i % nl),
                         calls=max(nl, 8))
            plain_ms = time_ms(lambda i: dequant_matmul.dequant_matmul_plain(
                x, ql.layer(i % nl), deq=True), calls=2, replays=2)
            nlib = copies_for(k * n * 2, cap=nl)
            wlib = [dequantize(ql.layer(i), dtype=torch.bfloat16) for i in range(nlib)]
            ob = ql.out_bias
            lib_ms = time_ms(lambda i: (
                torch.matmul(x, wlib[i % nlib]) if ob is None
                else torch.addmm(ob[i % nlib].to(torch.bfloat16), x, wlib[i % nlib])),
                calls=max(nlib, 8))
            del wlib
            bound, bound_by = bound_of(2 * m * k * n, m * k * 2 + wbytes + m * n * 2)
            tile = dequant_matmul.bf16_tile(m, n, ql.bits, bs)   # the tile kernel's tiles
            row = dict(shape=f"{proj} M={m} K={k} N={n}" + (f" block {bs}" if bs != 128 else ""),
                       bits=ql.bits, block=bs, max_abs_err=err,
                       rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by, l2_rotation=nl,
                       tile=dict(rows=tile[0], cols=tile[1], smem=tile[2]))
            rows.append(row)
            print(f"  dequant_matmul_deq {row['shape']:36s} rel {rel:.2e} | kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} lib {lib_ms:.4f} bound {bound:.4f} ({bound_by}) | "
                  f"tile {tile[0]} x {tile[1]}", flush=True)
            del ql, x, got, want
            torch.cuda.empty_cache()
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    results[key] = rows


# --------------------------------------------------------------------------
# phases 3 and 4: the serving path, and its parity with the CPU
# --------------------------------------------------------------------------

def serving_rt(kv_bits: int = 8):
    return RuntimeConfig(
        max_seq_len=1024, prefill_chunk=512, decode_block=NEW_TOKENS,
        sampler="greedy", kv_quant=True, kv_bits=kv_bits, quant_bits=4,
        quant_block=128, lm_head_bits=4, prefill_act_bits=8,
        max_new_tokens=NEW_TOKENS)


def prompts(vocab):
    rng = np.random.default_rng(1234)
    return [rng.integers(0, vocab, size=n).tolist() for n in PREFILL_LENS]


PREFILL_KERNELS = ("mnn_dequant_matmul", "mnn_dequant_matmul_a8", "mnn_flash_prefill")


def read_launches(label, must, never=()):
    """The counts since the last reset: every kernel in `must` was launched,
    none in `never`."""
    launches = {k.name: k.launches for k in build.KERNELS}
    for kname in must:
        check(launches[kname] > 0, f"{label}: kernel {kname} was never launched")
    for kname in never:
        check(launches[kname] == 0, f"{label}: kernel {kname} launched "
              f"{launches[kname]} times on a path that does not run it")
    print(f"  launches, {label}: {launches}", flush=True)
    return launches


def serve(llm, reqs, label):
    """Answer `reqs` through `Llm.stream`; (tokens, perf) per request."""
    vocab = llm.config.vocab_size
    outs, perf = [], []
    for ids in reqs:
        llm.reset()
        toks = list(llm.stream(token_ids=ids, max_new_tokens=NEW_TOKENS))
        check(bool(torch.isfinite(llm.last_prefill_logits).all()),
              f"{label}: non-finite prefill logits")
        check(0 < len(toks) <= NEW_TOKENS, f"{label}: {len(toks)} tokens")
        check(all(0 <= t < vocab for t in toks), f"{label}: token out of range")
        p = llm.perf
        perf.append(dict(prompt_len=p.prompt_len, gen_len=p.gen_len,
                         prefill_s=p.prefill_s, decode_s=p.decode_s,
                         prefill_tok_s=p.prefill_tok_s,
                         decode_tok_s=p.decode_tok_s))
        outs.append(toks)
        print(f"  {label}: {len(ids):4d} prompt tokens: prefill {p.prefill_tok_s:10.1f} tok/s "
              f"({p.prefill_s * 1e3:.2f} ms) | decode {p.gen_len} tok "
              f"{p.decode_tok_s:8.1f} tok/s", flush=True)
    return outs, perf


def phase_serve(llm):
    """Phase 3, sub-phases (a) to (c), each with its own launch counts."""
    dev = llm.device
    reqs = prompts(llm.config.vocab_size)
    info = llm.info()
    check(info["decode_megakernel"] and info["decode_fused_head"],
          f"serve: the whole-model kernel does not serve this model: {info}")
    # warm-up request (allocator, cuBLAS handles), not counted
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))
    torch.cuda.synchronize()

    build.reset_launches()                  # (a) int8 cache, whole-model kernel
    outs, perf = serve(llm, reqs, "megakernel int8 kv")
    counts = {"megakernel_int8": read_launches(
        "megakernel int8 kv", PREFILL_KERNELS + ("mnn_decode_model",),
        never=("mnn_decode_step", "mnn_flash_decode"))}
    steps = NEW_TOKENS * len(reqs)          # a decode block runs to its end
    check(counts["megakernel_int8"]["mnn_decode_model"] == steps,
          f"serve: {counts['megakernel_int8']['mnn_decode_model']} launches of the "
          f"whole-model kernel for {steps} decode steps")

    llm4 = Llm(llm.config, llm.params, serving_rt(kv_bits=4), device=dev)
    build.reset_launches()                  # (b) int4 cache, whole-model kernel
    outs4, perf4 = serve(llm4, reqs[1:2], "megakernel int4 kv")
    counts["megakernel_int4"] = read_launches(
        "megakernel int4 kv", PREFILL_KERNELS + ("mnn_decode_model",),
        never=("mnn_decode_step", "mnn_flash_decode"))
    check(counts["megakernel_int4"]["mnn_decode_model"] == NEW_TOKENS,
          "serve: int4 request not decoded by the whole-model kernel")

    ids = reqs[1][:FALLBACK_PROMPT]
    steps = PARITY_STEPS * llm.config.num_layers
    build.reset_launches()                  # (c) the per-layer fallback, int8
    rows8, _, _ = greedy_trace(llm, ids, None, megakernel=False)
    counts["per_layer_int8"] = read_launches(
        "per-layer int8 kv", PREFILL_KERNELS + ("mnn_decode_step",),
        never=("mnn_decode_model", "mnn_flash_decode"))
    check(counts["per_layer_int8"]["mnn_decode_step"] == steps,
          "serve: per-layer int8 path did not run the decode-step kernel per layer")
    build.reset_launches()                  # (c) the per-layer fallback, int4
    rows4, _, _ = greedy_trace(llm4, ids, None, megakernel=False)
    counts["per_layer_int4"] = read_launches(
        "per-layer int4 kv", PREFILL_KERNELS + ("mnn_flash_decode",),
        never=("mnn_decode_model", "mnn_decode_step"))
    check(counts["per_layer_int4"]["mnn_flash_decode"] == steps,
          "serve: per-layer int4 path did not run the flash-decode kernel per layer")
    for rows in (rows8, rows4):
        check(all(bool(torch.isfinite(r).all()) for r in rows),
              "serve: non-finite logits on the per-layer path")
    perf = dict(megakernel_int8=perf, megakernel_int4=perf4)
    return reqs, outs, perf, counts


def phase_serve_act16(llm, reqs):
    """Phase 3 (f): the 300-token request with `prefill_act_bits=16`, the
    library's default: every prefill projection takes bf16 rows through the
    tensor-core tile kernel, four launches a layer a chunk, and none the
    int8-row kernel."""
    rt = dataclasses.replace(llm.rt, prefill_act_bits=16)
    llm16 = Llm(llm.config, llm.params, rt, device=llm.device)
    list(llm16.stream(token_ids=reqs[0][:8], max_new_tokens=2))    # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    _, perf = serve(llm16, reqs[1:2], "dense act16")
    got = read_launches("dense act16", ("mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill",
                                        "mnn_decode_model"), never=("mnn_dequant_matmul_a8",))
    chunks = len(generate.prefill_buckets(len(reqs[1]), rt.prefill_chunk))
    tiles = got["mnn_dequant_matmul_bf16_tile"]
    check(tiles == 4 * llm.config.num_layers * chunks,
          f"serve act16: {tiles} tile-kernel launches for {chunks} chunks")
    print(f"  dense act16: {len(reqs[1])}-token prefill {perf[0]['prefill_s'] * 1e3:.2f} ms, "
          f"bf16 tile kernel launched {tiles} times", flush=True)
    return perf, got


MOE_PREFILL_KERNELS = PREFILL_KERNELS + ("mnn_moe_prefill",)


def phase_serve_moe(llm):
    """Phase 3 (d) and (e): the mixture-of-experts model at full width and
    depth. Per prefill chunk one grouped-expert launch a layer; per decode
    step one fused-expert and one decode-step launch a layer."""
    cfg, dev = llm.config, llm.device
    nl = cfg.num_layers
    reqs = prompts(cfg.vocab_size)
    info = llm.info()
    check(info["decode_moe_fused"] and not info["decode_megakernel"],
          f"serve moe: unexpected decode path: {info}")
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))    # warm-up
    torch.cuda.synchronize()

    build.reset_launches()                  # (d) int8 cache, fused expert kernel
    outs, perf = serve(llm, reqs, "moe int8 kv")
    counts = {"moe_int8": read_launches(
        "moe int8 kv", MOE_PREFILL_KERNELS + ("mnn_moe_decode", "mnn_decode_step",
                                              "mnn_dequant_matmul_bf16_tile"),
        never=("mnn_decode_model", "mnn_flash_decode", "mnn_dequant_matmul_deq"))}
    chunks = sum(len(generate.prefill_buckets(len(r), llm.rt.prefill_chunk)) for r in reqs)
    steps = NEW_TOKENS * len(reqs)
    got = counts["moe_int8"]
    check(got["mnn_moe_prefill"] == nl * chunks,
          f"serve moe: {got['mnn_moe_prefill']} grouped-expert launches for {chunks} "
          f"chunks of {nl} layers")
    check(got["mnn_dequant_matmul_bf16_tile"] == 2 * nl * chunks,
          f"serve moe: {got['mnn_dequant_matmul_bf16_tile']} tile-kernel launches for the "
          f"shared expert of {chunks} chunks of {nl} layers")
    check(got["mnn_moe_decode"] == nl * steps and got["mnn_decode_step"] == nl * steps,
          f"serve moe: {got['mnn_moe_decode']} fused-expert and {got['mnn_decode_step']} "
          f"decode-step launches for {steps} steps of {nl} layers")

    # (e) the dequantize-tile switch on: every M = 512 projection of the
    # chunk (qkv, wo, the shared expert) takes K3; logits against (d)'s path
    ids = reqs[1]
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    base, _ = generate.run_prefill(llm.params, cfg, llm.rt, tokens, llm._new_cache())
    build.reset_launches()
    dequant_matmul.DEQ_MIN_M = llm.rt.prefill_chunk
    try:
        deq, _ = generate.run_prefill(llm.params, cfg, llm.rt, tokens, llm._new_cache())
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    torch.cuda.synchronize()
    counts["moe_deq_switch"] = read_launches(
        "moe, dequantize-tile switch on", ("mnn_dequant_matmul_deq", "mnn_moe_prefill"),
        never=("mnn_dequant_matmul_a8",))
    check(counts["moe_deq_switch"]["mnn_dequant_matmul_deq"] == 4 * nl,
          "serve moe: the switch did not route qkv, wo and the shared expert")
    rel = rel_l2(deq, base)
    check(bool(torch.isfinite(deq).all()) and rel <= PARITY_REL,
          f"serve moe: dequantize-tile prefill logits rel-L2 {rel:.3g} > {PARITY_REL}")
    print(f"  dequantize-tile switch on: prefill logits rel-L2 {rel:.2e} against the "
          f"default path", flush=True)
    return perf, counts, dict(deq_switch_rel_l2=rel)


def phase_parity_moe(dev):
    """Phase 4 for the mixture-of-experts model: full width, MOE_PARITY_LAYERS
    layers on both sides, the same weights from the same seed."""
    cfg = dataclasses.replace(PRESETS[MOE_PRESET], num_layers=MOE_PARITY_LAYERS)
    rt = serving_rt()

    def make(device):
        params = decoder.init_random_params(
            cfg, torch.Generator().manual_seed(SEED), quant_bits=rt.quant_bits,
            quant_block=rt.quant_block, act_bits=rt.act_bits,
            lm_head_bits=rt.lm_head_bits, device=device)
        return Llm(cfg, params, rt, device=device)

    ids = prompts(cfg.vocab_size)[0]
    build.reset_launches()
    card, fed, _ = greedy_trace(make(dev), ids, None)
    read_launches(f"moe parity, {MOE_PARITY_LAYERS} layers",
                  ("mnn_moe_prefill", "mnn_moe_decode"))
    t0 = time.perf_counter()
    cpu, _, _ = greedy_trace(make("cpu"), ids, fed)
    out = compare_traces(card, cpu, f"moe ({MOE_PARITY_LAYERS} layers, full width) ")
    print(f"    cpu run {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(out, layers=MOE_PARITY_LAYERS)


def compare_traces(card, cpu, label="", sides="card vs cpu"):
    """Logit rows of the card against the CPU's (or any rows against
    reference rows): rel-L2 per step within PARITY_REL, tokens equal where
    the reference's top-2 margin exceeds the largest difference seen."""
    rels = [rel_l2(a, b) for a, b in zip(card, cpu)]
    diff = max(max_abs(a, b) for a, b in zip(card, cpu))
    checked = 0
    for s, (a, b) in enumerate(zip(card, cpu)):
        check(bool(torch.isfinite(a).all()), f"parity: non-finite card logits at {s}")
        check(rels[s] <= PARITY_REL, f"parity: {label}step {s} rel-L2 {rels[s]:.3g} > {PARITY_REL}")
        top2 = b[0].topk(2).values
        if float(top2[0] - top2[1]) > diff:
            checked += 1
            check(int(a.argmax()) == int(b.argmax()),
                  f"parity: {label}step {s} token {int(a.argmax())} != cpu {int(b.argmax())}")
    print(f"  {label}{sides}: rel-L2 per step {[f'{r:.2e}' for r in rels]}, "
          f"max |diff| {diff:.3g}, tokens compared at {checked}/{len(rels)} steps", flush=True)
    return dict(rel_l2=rels, max_abs_diff=diff, tokens_checked=checked)


def greedy_trace(llm, ids, feed, megakernel=None, prefill=None):
    """Prefill + PARITY_STEPS decode steps on llm's device. `feed`: the
    tokens to feed (teacher forcing), or None for the own argmax;
    `prefill(llm)` -> (logits, cache), when given, replaces the prefill of
    the tokens `ids`. Returns (logit rows, fed tokens, the cache it leaves)."""
    if prefill is not None:
        logits, cache = prefill(llm)
    else:
        tokens = torch.tensor([ids], dtype=torch.int64, device=llm.device)
        logits, cache = generate.run_prefill(llm.params, llm.config, llm.rt, tokens,
                                             llm._new_cache())
    rows = [logits.float().cpu()]
    fed = []
    for s in range(PARITY_STEPS):
        tok = feed[s] if feed is not None else int(rows[-1].argmax())
        fed.append(tok)
        t = torch.tensor([[tok]], dtype=torch.int64, device=llm.device)
        logits, cache = decoder.forward(llm.params, llm.config, t, cache,
                                        megakernel=megakernel)
        rows.append(logits.float().cpu())
    return rows, fed, cache


def phase_parity(llm, reqs, outs):
    card, fed, cache = greedy_trace(llm, reqs[0], None)
    n = min(len(outs[0]), PARITY_STEPS)
    check(fed[:n] == outs[0][:n], f"parity: the card's Llm tokens {outs[0][:n]} "
          f"differ from its own decode trace {fed[:n]}")
    cpu_llm = Llm.synthetic(llm.config.name, rt=llm.rt, seed=SEED, device="cpu")
    t0 = time.perf_counter()
    cpu, _, _ = greedy_trace(cpu_llm, reqs[0], fed)
    cpu_s = time.perf_counter() - t0
    out = compare_traces(card, cpu)
    print(f"    cpu run {cpu_s:.1f} s", flush=True)
    # the whole-model kernel against the per-layer path, from the same state
    tok = torch.tensor([[int(card[-1].argmax())]], device=llm.device)
    clone = lambda: dataclasses.replace(
        cache, k=cache.k.clone(), v=cache.v.clone(), k_scale=cache.k_scale.clone(),
        v_scale=cache.v_scale.clone())
    (mk, mtok), _ = decoder.forward(llm.params, llm.config, tok, clone(),
                                    megakernel=True, return_token=True)
    ref, _ = decoder.forward(llm.params, llm.config, tok, clone(), megakernel=False)
    paths = rel_l2(mk, ref)
    check(paths <= PARITY_REL, f"parity: whole-model kernel vs per-layer path "
          f"rel-L2 {paths:.3g} > {PARITY_REL}")
    check(int(mtok[0]) == int(decode_model.lowest_argmax(mk)[0]),
          "parity: the kernel's token is not the lowest argmax of its logits")
    print(f"  whole-model kernel vs per-layer path on the card: rel-L2 {paths:.2e}",
          flush=True)
    # the prefill with prefill_act_bits=16 (the 32-row bucket on the tile kernel)
    rt16 = dataclasses.replace(llm.rt, prefill_act_bits=16)
    ids = torch.tensor([reqs[0]], dtype=torch.int64)
    before = dequant_matmul.KERNEL_BF16_TILE.launches
    card16, _ = generate.run_prefill(llm.params, llm.config, rt16, ids.to(llm.device),
                                     llm._new_cache())
    check(dequant_matmul.KERNEL_BF16_TILE.launches > before,
          "parity: the act16 prefill did not run the tile kernel")
    cpu16, _ = generate.run_prefill(cpu_llm.params, cpu_llm.config, rt16, ids,
                                    cpu_llm._new_cache())
    act16 = rel_l2(card16.float().cpu(), cpu16.float())
    check(bool(torch.isfinite(card16).all()) and act16 <= PARITY_REL,
          f"parity: act16 prefill logits rel-L2 {act16:.3g} > {PARITY_REL}")
    print(f"  prefill_act_bits=16, card vs cpu: prefill logits rel-L2 {act16:.2e}", flush=True)
    return dict(out, megakernel_vs_per_layer_rel_l2=paths, act16_prefill_rel_l2=act16)


# --------------------------------------------------------------------------
# phase 5: serving batched requests on the card
# --------------------------------------------------------------------------

def batched_trace(llm, rt, group, feeds):
    """The prompts of `group` prefilled into slots 0.. of a len(group)-slot
    cache (the engine's slot prefill), then PARITY_STEPS decode steps of
    the whole batch, row i fed feeds[i] (teacher forcing). Returns each
    row's logit rows, as `greedy_trace` gives them."""
    c, dev = llm.config, llm.device
    cache = kvcache.create(c.num_layers, len(group), c.num_kv_heads, rt.max_seq_len,
                           c.head_dim, quantized=rt.kv_quant, kv_bits=rt.kv_bits,
                           device=dev)
    rows = [[batch_engine.prefill_slot(llm.params, c, rt, cache, ids, slot).float().cpu()]
            for slot, ids in enumerate(group)]
    for s in range(PARITY_STEPS):
        tok = torch.tensor([[f[s]] for f in feeds], dtype=torch.int64, device=dev)
        logits, cache = decoder.forward(llm.params, c, tok, cache)
        for i, r in enumerate(rows):
            r.append(logits[i:i + 1].float().cpu())
    return rows


def hold_to_single_stream(llm, rt, reqs, served, label, floors):
    """Each served request's first PARITY_STEPS tokens against the same
    prompt alone at batch 1 on the card (`greedy_trace`), by phase 4's rule:
    the batched logit rows, teacher-forced with the batch-1 tokens in
    groups of the engine's width, within PARITY_REL of the batch-1 rows and
    the same tokens where the batch-1 top-2 margin exceeds the largest
    difference seen; then the engine's own tokens equal the batch-1 tokens
    at every step whose margin is above it, up to the first step where a
    token under a margin not above it differs (the contexts part there).
    Fails unless the steps compared reach `floors` (logit rows' tokens,
    served tokens), summed over the requests."""
    singles = [greedy_trace(llm, ids, None) for ids in reqs]
    out, b = [], rt.max_batch
    for g0 in range(0, len(reqs), b):
        group = list(range(g0, min(g0 + b, len(reqs))))
        rows = batched_trace(llm, rt, [reqs[i] for i in group],
                             [singles[i][1] for i in group])
        for i, batched in zip(group, rows):
            single, fed, _ = singles[i]
            res = compare_traces(batched, single, f"{label} request {i} ({len(reqs[i])} "
                                 f"tokens), ", sides=f"batch {b} vs 1 on the card")
            toks, agreed = served[i], 0
            for s in range(min(PARITY_STEPS, len(toks))):
                top2 = single[s][0].topk(2).values
                if float(top2[0] - top2[1]) <= res["max_abs_diff"]:
                    if toks[s] != fed[s]:
                        break
                    continue
                check(toks[s] == fed[s], f"{label}: request {i} step {s}: served token "
                      f"{toks[s]} != batch-1 token {fed[s]}")
                agreed += 1
            out.append(dict(res, served_tokens_checked=agreed))
    rows = sum(p["tokens_checked"] for p in out)
    toks = sum(p["served_tokens_checked"] for p in out)
    print(f"  {label}: tokens compared at {rows} of {len(reqs) * (PARITY_STEPS + 1)} "
          f"logit rows (floor {floors[0]}), served tokens at {toks} of "
          f"{len(reqs) * PARITY_STEPS} steps (floor {floors[1]})", flush=True)
    check(rows >= floors[0] and toks >= floors[1], f"{label}: {rows} logit rows and "
          f"{toks} served tokens compared, under the floors {floors}")
    return out


def engine_block_profile(eng, reqs, label, card_line):
    """One decode block of `eng` with every slot busy, after a block that
    admitted them: the wall time of an untraced block (it ends in the
    block's token read, a sync), then a traced one's device busy time and
    launches. Cancels the requests after."""
    steps = eng.steps_per_block
    live = [eng.submit(ids, 3 * steps + 1) for ids in reqs[:eng.rt.max_batch]]
    eng.step()                                   # admissions + a block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    wall = (time.perf_counter() - t0) * 1e3
    by_name, _, _ = profile_decode.traced(eng.step, 1)
    torch.cuda.synchronize()
    for r in live:
        eng.cancel(r.rid)
    eng.run_until_idle()
    busy = sum(ms for _, ms, _ in by_name)
    out = dict(steps=steps, wall_ms=wall, wall_ms_per_step=wall / steps,
               device_busy_ms=busy, device_busy_ms_per_step=busy / steps,
               device_idle_share=1 - busy / wall,
               launches_per_step=sum(n for _, _, n in by_name) / steps,
               kernels=[dict(name=k, ms=ms, launches=n) for k, ms, n in by_name])
    print(f"  {label}: decode block of {steps} steps at {eng.rt.max_batch} slots: wall "
          f"{wall:.2f} ms ({out['wall_ms_per_step']:.3f} a step), device busy "
          f"{busy:.2f} ms, idle share {out['device_idle_share']:.3f}, "
          f"{out['launches_per_step']:.1f} launches a step [{card_line}]", flush=True)
    return out


def serve_engine(eng, reqs, new_tokens, label, card_line):
    """All of `reqs` submitted at once and served to the end, with the
    launch counts and the allocator's peak set to 0 just before (the
    caller reads them just after). Returns (requests, wall seconds)."""
    eng.generate(reqs[0][:8], 2)                 # warm-up: allocator, schedules
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    served = [eng.submit(ids, new_tokens) for ids in reqs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, r in enumerate(served):
        check(r.status == batch_engine.Status.DONE and len(r.generated) == new_tokens,
              f"{label}: request {i} ended {r.status} with {len(r.generated)} tokens")
        check(all(0 <= t < eng.config.vocab_size for t in r.generated),
              f"{label}: request {i}: token out of range")
        print(f"  {label}: request {i}, {len(reqs[i]):4d} prompt tokens: time to first "
              f"token {(r.first_token_at - r.submitted_at) * 1e3:8.2f} ms, total "
              f"{(r.finished_at - r.submitted_at) * 1e3:8.2f} ms [{card_line}]", flush=True)
    return served, wall


def per_request(served) -> list:
    return [dict(prompt_len=len(r.token_ids), tokens=len(r.generated),
                 ttft_ms=(r.first_token_at - r.submitted_at) * 1e3,
                 total_ms=(r.finished_at - r.submitted_at) * 1e3) for r in served]


def chunks_of(reqs, rt) -> int:
    return sum(len(generate.prefill_buckets(len(ids), rt.prefill_chunk)) for ids in reqs)


def phase_serve_batched(llm, card_line):
    """Phase 5 (g): qwen2-0.5b through a 4-slot engine, 8 requests at once,
    so that admissions come between decode blocks; its decode steps run the
    whole-model kernel's batch-4 build over ragged lengths."""
    cfg, label = llm.config, "serve batched (g)"
    rt = dataclasses.replace(llm.rt, max_batch=SERVE_SLOTS)
    rng = np.random.default_rng(4321)
    reqs = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_DENSE_LENS]
    eng = batch_engine.BatchEngine(cfg, llm.params, rt)
    served, wall = serve_engine(eng, reqs, NEW_TOKENS, label, card_line)
    counts = read_launches(label, PREFILL_KERNELS + ("mnn_decode_model",),
                           never=("mnn_decode_step", "mnn_flash_decode",
                                  "mnn_dequant_matmul_bf16_tile", "mnn_moe_decode"))
    peak = torch.cuda.max_memory_allocated()
    waves = -(-len(reqs) // SERVE_SLOTS)
    steps = waves * -(-(NEW_TOKENS - 1) // rt.decode_block) * rt.decode_block
    chunks = chunks_of(reqs, rt)
    want = {"mnn_decode_model": steps, "mnn_dequant_matmul_a8": 4 * cfg.num_layers * chunks,
            "mnn_flash_prefill": cfg.num_layers * chunks, "mnn_dequant_matmul": chunks}
    for k, n in want.items():
        check(counts[k] == n, f"{label}: {counts[k]} launches of {k}, {n} expected "
              f"({steps} decode steps at batch {SERVE_SLOTS}, {chunks} prefill chunks)")
    gen = sum(len(r.generated) for r in served)
    # the same requests one after another through Llm at batch 1
    one = Llm(cfg, llm.params, llm.rt, device=llm.device)
    list(one.stream(token_ids=reqs[0][:8], max_new_tokens=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids in reqs:
        one.reset()
        list(one.stream(token_ids=ids, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    print(f"  {label}: {gen} tokens in {wall * 1e3:.1f} ms at {SERVE_SLOTS} slots: "
          f"{gen / wall:.1f} tok/s; one after another through Llm: "
          f"{seq_wall * 1e3:.1f} ms, {gen / seq_wall:.1f} tok/s; peak allocator "
          f"{peak} bytes [{card_line}]", flush=True)
    parity = hold_to_single_stream(llm, rt, reqs, [r.generated for r in served], label,
                                   SERVE_DENSE_FLOORS)
    block = engine_block_profile(eng, reqs[4:], label, card_line)
    b4 = [k["name"] for k in block["kernels"] if "decode_model_kernel<4" in k["name"]]
    check(bool(b4), f"{label}: no batch-4 whole-model kernel in the traced block: "
          f"{[k['name'] for k in block['kernels']][:8]}")
    return eng, dict(prompt_lens=list(SERVE_DENSE_LENS), new_tokens=NEW_TOKENS,
                     slots=SERVE_SLOTS, requests=per_request(served), wall_s=wall,
                     tok_s=gen / wall, llm_one_after_another_s=seq_wall,
                     llm_one_after_another_tok_s=gen / seq_wall, peak_allocator_bytes=peak,
                     launches=counts, decode_steps=steps, prefill_chunks=chunks,
                     whole_model_kernel=b4, parity=parity, decode_block=block)


def phase_serve_batched_moe(llm, card_line):
    """Phase 5 (h): qwen1.5-moe-a2.7b through a 4-slot engine, 4 requests:
    per decode step the fused expert and decode-step kernels once a layer
    at 4 tokens, the tile kernel for qkv, wo (M = 4) and the head; per
    prefill chunk the grouped expert kernel once a layer."""
    cfg, label = llm.config, "serve batched moe (h)"
    nl = cfg.num_layers
    rt = dataclasses.replace(llm.rt, max_batch=SERVE_SLOTS, decode_block=SERVE_MOE_NEW)
    rng = np.random.default_rng(8765)
    reqs = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_MOE_LENS]
    eng = batch_engine.BatchEngine(cfg, llm.params, rt)
    served, wall = serve_engine(eng, reqs, SERVE_MOE_NEW, label, card_line)
    counts = read_launches(label, MOE_PREFILL_KERNELS + (
        "mnn_moe_decode", "mnn_decode_step", "mnn_dequant_matmul_bf16_tile"),
        never=("mnn_decode_model", "mnn_flash_decode", "mnn_dequant_matmul_deq"))
    peak = torch.cuda.max_memory_allocated()
    steps = rt.decode_block                  # one block: every request ends in it
    chunks = chunks_of(reqs, rt)
    want = {"mnn_moe_decode": nl * steps, "mnn_decode_step": nl * steps,
            "mnn_moe_prefill": nl * chunks,
            "mnn_dequant_matmul_bf16_tile": (2 * nl + 1) * steps + 2 * nl * chunks}
    for k, n in want.items():
        check(counts[k] == n, f"{label}: {counts[k]} launches of {k}, {n} expected "
              f"({steps} decode steps of {nl} layers at batch {SERVE_SLOTS}, {chunks} "
              f"prefill chunks)")
    gen = sum(len(r.generated) for r in served)
    print(f"  {label}: {gen} tokens in {wall * 1e3:.1f} ms at {SERVE_SLOTS} slots: "
          f"{gen / wall:.1f} tok/s; peak allocator {peak} bytes [{card_line}]", flush=True)
    parity = hold_to_single_stream(llm, rt, reqs, [r.generated for r in served], label,
                                   SERVE_MOE_FLOORS)
    block = engine_block_profile(eng, reqs, label, card_line)
    return dict(prompt_lens=list(SERVE_MOE_LENS), new_tokens=SERVE_MOE_NEW,
                slots=SERVE_SLOTS, requests=per_request(served), wall_s=wall,
                tok_s=gen / wall, peak_allocator_bytes=peak, launches=counts,
                decode_steps=steps, prefill_chunks=chunks, parity=parity,
                decode_block=block)


def http_post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    return raw, time.perf_counter() - t0


def drained(eng, ids, n, logprobs=-1) -> list:
    """`eng`'s answer to `ids` alone: the items its queue gives (ints, or
    (token, logprob, tops) with logprobs on)."""
    r = eng.submit(ids, n, logprobs=logprobs)
    eng.run_until_idle()
    items = []
    while not r.out.empty():
        item = r.out.get()
        if item is not None:
            items.append(item)
    check(len(items) == n, f"server: the engine gave {len(items)} of {n} items")
    return items


def streamed_pieces(tok, ids) -> list:
    """The text of each chunk the server streams for tokens `ids`: tokens are
    held back while their text ends in U+FFFD, as the handler holds them."""
    pieces, buf = [], []
    for t in ids:
        buf.append(t)
        text = tok.decode(buf)
        if not text.endswith("\ufffd"):
            pieces.append((text, len(buf)))
            buf = []
    return pieces


def phase_server(llm, eng, card_line):
    """Phase 5 (i): the OpenAI server's handler over (g)'s engine, on
    127.0.0.1 at a free port, the engine on its scheduler thread: two
    streamed chat requests at once (the second with logprobs) and a
    /v1/completions request with logprobs 2. Each stream is, chunk for
    chunk, what the engine's own answer to the same ids gives; logprobs are
    the engine's within 1e-4."""
    tok = llm.tokenizer
    chats = [[{"role": "user", "content": c}] for c in
             ("Tell me about the H100.", "A second, longer question about serving "
              "many requests side by side on one card.")]
    prompt = "The completions route with logprobs"
    n = SERVE_HTTP_TOKENS
    want = [drained(eng, tok.encode(tok.apply_chat_template(m)), n, lp)
            for m, lp in zip(chats, (-1, 0))]
    want_lp = drained(eng, tok.encode(prompt), n, 2)

    stop = threading.Event()
    worker = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(llm, threading.Lock(), eng))
    front = threading.Thread(target=httpd.serve_forever, daemon=True)
    front.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(http_post, url + "/v1/chat/completions",
                              dict(messages=m, max_tokens=n, stream=True, logprobs=lp))
                    for m, lp in zip(chats, (False, True))]
            futs.append(ex.submit(http_post, url + "/v1/completions",
                                  dict(prompt=prompt, max_tokens=n, logprobs=2)))
            answers = [f.result(timeout=180) for f in futs]
    finally:
        httpd.shutdown()
        httpd.server_close()
        front.join(timeout=60)
        stop.set()
        worker.join(timeout=60)
    check(not front.is_alive() and not worker.is_alive(), "server: threads did not stop")
    out = []
    for i, (raw, secs) in enumerate(answers[:2]):
        lines = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
        check(len(lines) >= 2 and lines[-1] == "[DONE]"
              and json.loads(lines[-2])["choices"][0]["finish_reason"] == "stop",
              f"server: chat stream {i} did not end")
        chunks = [json.loads(ln)["choices"][0] for ln in lines[:-2]]
        got = [c["delta"].get("content") for c in chunks]
        ids = [t[0] for t in want[i]] if i else want[i]
        pieces = streamed_pieces(tok, ids)
        check(got == [p for p, _ in pieces], f"server: streamed chat {i} chunks {got!r} "
              f"differ from the engine's {[p for p, _ in pieces]!r}")
        diff = 0.0
        if i:
            # each chunk's logprobs: the tokens it carries, the engine's values
            lps = [e for c in chunks for e in c["logprobs"]["content"]]
            sent = sum(k for _, k in pieces)
            check(len(lps) == sent and [e["token"] for e in lps]
                  == [tok.decode([t]) for t in ids[:sent]],
                  f"server: streamed chat {i} logprob tokens differ from the engine's")
            diff = max((abs(e["logprob"] - w[1]) for e, w in zip(lps, want[i])),
                       default=0.0)
            check(diff <= 1e-4, f"server: streamed chat {i} logprobs differ from the "
                  f"engine's by {diff:.3g}")
        out.append(dict(route="chat stream" + (" logprobs" if i else ""),
                        events=len(lines), content_chunks=len(chunks),
                        max_logprob_diff=diff, seconds=secs))
    body = json.loads(answers[2][0])
    choice = body["choices"][0]
    lp = choice["logprobs"]
    check(choice["text"] == tok.decode([t for t, _, _ in want_lp])
          and lp["tokens"] == [tok.decode([t]) for t, _, _ in want_lp]
          and body["usage"]["completion_tokens"] == n,
          f"server: completion {choice['text']!r} differs from the engine's")
    diff = max(abs(a - b[1]) for a, b in zip(lp["token_logprobs"], want_lp))
    check(len(lp["token_logprobs"]) == n and diff <= 1e-4,
          f"server: completion logprobs differ from the engine's by {diff:.3g}")
    out.append(dict(route="completions logprobs 2", seconds=answers[2][1],
                    max_logprob_diff=diff))
    ms = ", ".join(f"{o['seconds'] * 1e3:.1f}" for o in out)
    diff = max(o["max_logprob_diff"] for o in out)
    print(f"  server (i): two streamed chats (content chunks "
          f"{[o['content_chunks'] for o in out[:2]]}, as the engine's tokens give "
          f"them) and a completion with logprobs answered in {ms} ms; logprobs within "
          f"{diff:.2e} of the engine's [{card_line}]",
          flush=True)
    return out


# --------------------------------------------------------------------------
# phase 6: a model from files, on the card
# --------------------------------------------------------------------------

CKPT_STD = 0.02             # HF's init of a linear layer's weights
CKPT_SEED = 6
CONVERT_REL = 6e-2          # W8 logits against the plain forward, tests/test_convert.py:58
NLL_TOKENS, NLL_CHUNK, NLL_REL = 256, 128, 1e-2
HEAD_ROWS = (128, 512)      # `evaluate`'s head: M = chunk rows, N = vocab (row 1b)
DECODE_FROM = 9             # (l): prefill 9 positions, then decode the rest
MOE_CKPT_LAYERS = 2         # (m): qwen1.5-moe-a2.7b at full width, 3.4 GB of bf16
MOE_CKPT_NEW = 16


def hf_config_of(cfg) -> dict:
    """The HF config.json of a qwen2 or qwen2-moe configuration."""
    d = dict(architectures=["Qwen2MoeForCausalLM" if cfg.is_moe else "Qwen2ForCausalLM"],
             vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
             intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
             num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
             max_position_embeddings=cfg.max_position_embeddings,
             rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
             tie_word_embeddings=cfg.tie_word_embeddings, hidden_act="silu",
             use_sliding_window=False, torch_dtype="bfloat16")
    if cfg.is_moe:
        d.update(num_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok,
                 moe_intermediate_size=cfg.moe_intermediate_size,
                 shared_expert_intermediate_size=cfg.shared_expert_intermediate_size,
                 norm_topk_prob=cfg.norm_topk_prob, decoder_sparse_step=1,
                 mlp_only_layers=[])
    return d


def write_hf_dir(cfg, path: str, dev, seed: int) -> int:
    """An HF-layout directory of `cfg` (HF tensor names, bf16, weights
    normal with std 0.02 made on the card from `seed`; norms about 1 and
    biases about 0 with the same spread), written with the port's own
    writer. Returns the bytes of the tensors."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.hidden_size

    def rnd(*shape, mean=0.0):
        return (torch.randn(shape, device=dev, generator=g) * CKPT_STD + mean).to(
            torch.bfloat16)

    t = {"model.embed_tokens.weight": rnd(cfg.vocab_size, h),
         "model.norm.weight": rnd(h, mean=1.0)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = rnd(cfg.vocab_size, h)

    def mlp(prefix, inter):
        t[prefix + "gate_proj.weight"] = rnd(inter, h)
        t[prefix + "up_proj.weight"] = rnd(inter, h)
        t[prefix + "down_proj.weight"] = rnd(h, inter)

    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name, n in (("q", cfg.q_dim), ("k", cfg.kv_dim), ("v", cfg.kv_dim)):
            t[p + f"self_attn.{name}_proj.weight"] = rnd(n, h)
            t[p + f"self_attn.{name}_proj.bias"] = rnd(n)
        t[p + "self_attn.o_proj.weight"] = rnd(h, cfg.q_dim)
        t[p + "input_layernorm.weight"] = rnd(h, mean=1.0)
        t[p + "post_attention_layernorm.weight"] = rnd(h, mean=1.0)
        if cfg.is_moe:
            t[p + "mlp.gate.weight"] = rnd(cfg.num_experts, h)
            for e in range(cfg.num_experts):
                mlp(p + f"mlp.experts.{e}.", cfg.moe_intermediate_size)
            mlp(p + "mlp.shared_expert.", cfg.shared_expert_intermediate_size)
            t[p + "mlp.shared_expert_gate.weight"] = rnd(1, h)
        else:
            mlp(p + "mlp.", cfg.intermediate_size)
    os.makedirs(path, exist_ok=True)
    stfile.save_file(t, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_of(cfg), f, indent=1)
    return sum(v.numel() * v.element_size() for v in t.values())


def plain_hf_forward(hf_dir: str, cfg, ids, dev) -> torch.Tensor:
    """Logits [T, V] of `ids` from the HF tensors in f32 on the card, written
    from the HF layout alone: separate q/k/v and gate/up, rope on two
    halves, GQA by repeating K/V heads, an explicit causal softmax."""
    t_n, d, hq, hkv = len(ids), cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    with stfile.StDir(hf_dir) as src:
        w = lambda name: src[name].to(dev).float()
        x = w("model.embed_tokens.weight")[torch.tensor(ids, device=dev)]      # [T, H]
        inv = 1.0 / cfg.rope_theta ** (torch.arange(0, d, 2, device=dev).float() / d)
        ang = torch.arange(t_n, device=dev).float()[:, None] * inv[None]
        cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
        mask = torch.full((t_n, t_n), float("-inf"), device=dev).triu(1)

        def norm(v, weight):
            return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * weight

        def rope(v):                                  # [heads, T, D]
            return v * cos + torch.cat([-v[..., d // 2:], v[..., :d // 2]], -1) * sin

        def proj(v, name, heads):                     # -> [heads, T, D]
            y = v @ w(name + ".weight").T + w(name + ".bias")
            return y.reshape(t_n, heads, d).transpose(0, 1)

        for i in range(cfg.num_layers):
            p = f"model.layers.{i}."
            h = norm(x, w(p + "input_layernorm.weight"))
            q = rope(proj(h, p + "self_attn.q_proj", hq))
            k = rope(proj(h, p + "self_attn.k_proj", hkv)).repeat_interleave(hq // hkv, 0)
            v = proj(h, p + "self_attn.v_proj", hkv).repeat_interleave(hq // hkv, 0)
            s = q @ k.transpose(1, 2) / math.sqrt(d) + mask
            e = (s - s.amax(-1, keepdim=True)).exp()
            att = (e / e.sum(-1, keepdim=True)) @ v                             # [Hq, T, D]
            x = x + att.transpose(0, 1).reshape(t_n, hq * d) @ w(
                p + "self_attn.o_proj.weight").T
            h = norm(x, w(p + "post_attention_layernorm.weight"))
            gate = h @ w(p + "mlp.gate_proj.weight").T
            up = h @ w(p + "mlp.up_proj.weight").T
            x = x + (torch.nn.functional.silu(gate) * up) @ w(p + "mlp.down_proj.weight").T
        x = norm(x, w("model.norm.weight"))
        head = w("model.embed_tokens.weight" if cfg.tie_word_embeddings else "lm_head.weight")
        return x @ head.T


def check_same_params(got, want, label):
    """Every tensor of two Params byte-equal, on whichever devices they lie."""
    (ta, qa), (tb, qb) = checkpoint.flatten(got), checkpoint.flatten(want)
    check(qa == qb and sorted(ta) == sorted(tb), f"{label}: different fields or quant")
    for k, a in ta.items():
        b = tb[k].to(a.device)
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)),
            f"{label}: {k} differs")
    return len(ta)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_head_rows(params, cfg):
    """(m) row 1b at the head of `evaluate`: M = chunk rows, N = vocab, f32
    logits, against its plain version and beside `torch.matmul` on the
    head's weights dequantized to bf16 beforehand."""
    head, dev = params.lm_head, params.embedding.device
    k, n = cfg.hidden_size, cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(SEED)
    wlib = dequantize(head, dtype=torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size() for t in (head.packed, head.scale, head.bias))
    rows = []
    for m in HEAD_ROWS:
        x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
        tile = dequant_matmul.bf16_tile(m, n, head.bits)
        before = dequant_matmul.KERNEL_BF16_TILE.launches
        got = dequant_matmul.dequant_matmul(x, head, out_dtype=torch.float32)
        check(dequant_matmul.KERNEL_BF16_TILE.launches == before + 1,
              f"head M={m}: the tile kernel did not take it")
        want = dequant_matmul.dequant_matmul_plain(x, head, torch.float32)
        rel = rel_l2(got, want)
        check(bool(torch.isfinite(got).all()) and rel <= 1e-2,
              f"head M={m} N={n}: rel-L2 {rel:.3g} > 1e-2")
        ms = time_ms(lambda i: dequant_matmul.dequant_matmul(x, head, out_dtype=torch.float32),
                     calls=4)
        lib_ms = time_ms(lambda i: torch.matmul(x, wlib), calls=4)
        bound, bound_by = bound_of(2 * m * k * n, m * k * 2 + wbytes + m * n * 4)
        rows.append(dict(shape=f"lm_head M={m} K={k} N={n}", m=m, rel_l2=rel,
                         max_abs_err=max_abs(got, want), ms=ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by, tile=tile,
                         column_tiles=-(-n // tile[1]), row_tiles=-(-m // tile[0])))
        print(f"  (m) row 1b head M={m} N={n}: rel {rel:.2e} | kernel {ms:.4f} ms, "
              f"matmul (bf16 weights) {lib_ms:.4f} ms, bound {bound:.4f} ({bound_by}) | "
              f"tile {tile[0]}x{tile[1]}: {rows[-1]['column_tiles']} x "
              f"{rows[-1]['row_tiles']} blocks", flush=True)
        del x, got, want
    del wlib
    torch.cuda.empty_cache()
    return rows


def phase_checkpoint_dense(dev, root):
    """(j) to (m), dense: write, convert, load, serve, hold to the plain HF
    forward, evaluate."""
    out = {}
    preset = PRESETS["qwen2-0.5b"]
    hf_dir = os.path.join(root, "qwen2-0.5b-hf")
    nbytes, s = timed(lambda: write_hf_dir(preset, hf_dir, dev, CKPT_SEED))
    cfg_hf = ModelConfig.from_hf_config(hf_config_of(preset))
    check(dataclasses.replace(cfg_hf, name=preset.name) == preset,
          "from_hf_config does not give the preset back")
    print(f"  (j) wrote {nbytes / 1e9:.3f} GB of bf16 HF tensors in {s:.1f} s", flush=True)
    out["hf_bytes"], out["write_s"] = nbytes, s

    # (j) convert on the card and on the cpu: the same bytes
    w4 = os.path.join(root, "w4")
    (cfg, params), s = timed(lambda: convert_hf(hf_dir, w4, bits=4, block_size=128,
                                                lm_head_bits=4, device=dev))
    out["convert_card_s"], out["convert_card_gb_s"] = s, nbytes / s / 1e9
    print(f"  (j) convert_hf on the card (W4, block 128, int4 head): {s:.2f} s, "
          f"{nbytes / s / 1e9:.2f} GB/s of source", flush=True)
    (_, params_cpu), s = timed(lambda: convert_hf(hf_dir, os.path.join(root, "w4cpu"),
                                                  bits=4, block_size=128, lm_head_bits=4,
                                                  device="cpu"))
    shutil.rmtree(os.path.join(root, "w4cpu"))
    n = check_same_params(params, params_cpu, "(j) card vs cpu conversion")
    out["convert_cpu_s"], out["tensors_compared"] = s, n
    print(f"  (j) convert_hf on the cpu: {s:.2f} s; all {n} tensors byte-equal to the "
          f"card's", flush=True)
    del params_cpu

    # (j) load onto the card: byte-equal to the converter's params
    ckpt_bytes = os.path.getsize(os.path.join(w4, "model.safetensors"))
    llm, s = timed(lambda: Llm.from_pretrained(w4, rt=serving_rt(), device=dev))
    check_same_params(llm.params, params, "(j) loaded vs converted")
    out["load_s"], out["load_gb_s"], out["ckpt_bytes"] = s, ckpt_bytes / s / 1e9, ckpt_bytes
    # phase 14 (ddd): the same files through the native reader
    out["native_stfile"] = native_stfile_check(
        sorted(glob.glob(os.path.join(hf_dir, "*.safetensors")))
        + [os.path.join(w4, "model.safetensors")])
    print(f"  (j) Llm.from_pretrained: {ckpt_bytes / 1e9:.3f} GB in {s:.2f} s, "
          f"{ckpt_bytes / s / 1e9:.2f} GB/s; byte-equal to the converter's", flush=True)

    # (k) serve the loaded model: phase 3 (a)'s launches, the in-memory tokens
    reqs = prompts(cfg.vocab_size)
    info = llm.info()
    check(info["decode_megakernel"] and info["decode_fused_head"],
          f"(k) the whole-model kernel does not serve the loaded model: {info}")
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))        # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    toks, perf = serve(llm, reqs, "(k) loaded")
    got = read_launches("(k) loaded qwen2-0.5b", PREFILL_KERNELS + ("mnn_decode_model",),
                        never=("mnn_decode_step", "mnn_flash_decode"))
    chunks = chunks_of(reqs, llm.rt)
    check(got["mnn_decode_model"] == NEW_TOKENS * len(reqs)
          and got["mnn_dequant_matmul_a8"] == 4 * cfg.num_layers * chunks
          and got["mnn_flash_prefill"] == cfg.num_layers * chunks,
          f"(k) launches {got} for {chunks} chunks and {NEW_TOKENS * len(reqs)} tokens")
    mem = Llm(cfg, params, serving_rt(), device=dev)
    toks_mem, _ = serve(mem, reqs, "(k) in-memory")
    check(toks == toks_mem, "(k) the loaded model's tokens differ from the in-memory model's")
    out["serve"], out["launches_k"] = perf, got
    del mem

    # (l) W8, tied bf16 head (outside the whole-model kernel) vs the plain forward
    (cfg8, params8), s = timed(lambda: convert_hf(hf_dir, os.path.join(root, "w8"), bits=8,
                                                  block_size=128, lm_head_bits=0, device=dev))
    rt = serving_rt()
    llm8 = Llm(cfg8, params8, rt, device=dev)
    info8 = llm8.info()
    check(params8.lm_head is None and info8["decode_megakernel"]
          and not info8["decode_fused_head"], f"(l) unexpected decode path: {info8}")
    ids = reqs[0]
    want = plain_hf_forward(hf_dir, preset, ids, dev)
    tokens = torch.tensor([ids], device=dev)
    got_p, _ = decoder.forward(params8, cfg8, tokens, llm8._new_cache(), all_logits=True)
    rel_p = rel_l2(got_p[0], want)
    build.reset_launches()
    logits, cache = generate.run_prefill(params8, cfg8, rt, tokens[:, :DECODE_FROM],
                                         llm8._new_cache())
    rows = [logits[0]]
    for tok in ids[DECODE_FROM:]:
        logits, cache = decoder.forward(params8, cfg8, torch.tensor([[tok]], device=dev),
                                        cache)
        rows.append(logits[0])
    got_d = read_launches("(l) W8 decode, unfused head", ("mnn_decode_model",))
    rel_d = rel_l2(torch.stack(rows), want[DECODE_FROM - 1:])
    check(got_d["mnn_decode_model"] == len(ids) - DECODE_FROM,
          f"(l) {got_d['mnn_decode_model']} whole-model launches")
    agree = float((got_p[0].argmax(-1) == want.argmax(-1)).float().mean())
    check(rel_p <= CONVERT_REL and rel_d <= CONVERT_REL,
          f"(l) rel-L2 against the plain HF forward: prefill {rel_p:.3g}, decode "
          f"{rel_d:.3g} > {CONVERT_REL}")
    print(f"  (l) W8 + tied bf16 head vs the plain HF forward ({len(ids)} positions): "
          f"prefill rel-L2 {rel_p:.2e}, decode (whole-model kernel, head outside) "
          f"{rel_d:.2e}, argmax agreement {agree:.2f}", flush=True)
    out["w8"] = dict(convert_s=s, prefill_rel_l2=rel_p, decode_rel_l2=rel_d, agree=agree)
    del llm8, params8, cache, want, got_p, rows
    torch.cuda.empty_cache()

    # (m) perplexity on the card against the cpu plain versions
    ids = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, NLL_TOKENS).tolist()
    build.reset_launches()
    (nll, count), s = timed(lambda: evaluate.sequence_nll(llm.params, cfg, ids,
                                                          chunk=NLL_CHUNK))
    got = read_launches("(m) sequence_nll", ("mnn_dequant_matmul_bf16_tile",
                                             "mnn_flash_prefill"))
    chunks = -(-NLL_TOKENS // NLL_CHUNK)
    check(got["mnn_dequant_matmul_bf16_tile"] == (4 * cfg.num_layers + 1) * chunks,
          f"(m) {got['mnn_dequant_matmul_bf16_tile']} tile-kernel launches")
    t0 = time.perf_counter()
    _, params_cpu, _ = checkpoint.load_checkpoint(w4, device="cpu")
    nll_cpu, count_cpu = evaluate.sequence_nll(params_cpu, cfg, ids, chunk=NLL_CHUNK)
    cpu_s = time.perf_counter() - t0
    gap = abs(nll - nll_cpu) / abs(nll_cpu)
    check(count == count_cpu == NLL_TOKENS - 1 and gap <= NLL_REL,
          f"(m) NLL card {nll:.6g} vs cpu {nll_cpu:.6g} ({gap:.3g} > {NLL_REL})")
    print(f"  (m) sequence_nll over {count} tokens in chunks of {NLL_CHUNK}: card "
          f"{nll:.6g} ({s:.2f} s), cpu {nll_cpu:.6g} ({cpu_s:.1f} s), gap {gap:.2e}; "
          f"perplexity {math.exp(nll / count):.2f}", flush=True)
    out["nll"] = dict(card=nll, cpu=nll_cpu, count=count, gap=gap, card_s=s, cpu_s=cpu_s,
                      launches=got)
    del params_cpu
    out["head_rows"] = phase_head_rows(llm.params, cfg)
    return out


def phase_checkpoint_moe(dev, root):
    """(m) a Qwen2-MoE-layout directory at qwen1.5-moe-a2.7b's width and
    MOE_CKPT_LAYERS layers: convert and load on the card, one 300-token
    request, the two expert kernels' launches, the in-memory tokens."""
    mcfg = dataclasses.replace(PRESETS[MOE_PRESET], num_layers=MOE_CKPT_LAYERS)
    hf_dir = os.path.join(root, "moe-hf")
    nbytes, s = timed(lambda: write_hf_dir(mcfg, hf_dir, dev, CKPT_SEED + 1))
    check(dataclasses.replace(ModelConfig.from_hf_config(hf_config_of(mcfg)),
                              name=mcfg.name) == mcfg,
          "(m) from_hf_config does not give the MoE configuration back")
    out_dir = os.path.join(root, "moe-w4")
    (cfg, params), conv_s = timed(lambda: convert_hf(hf_dir, out_dir, bits=4,
                                                     block_size=128, lm_head_bits=4,
                                                     device=dev))
    shutil.rmtree(hf_dir)
    ckpt_bytes = os.path.getsize(os.path.join(out_dir, "model.safetensors"))
    llm, load_s = timed(lambda: Llm.from_pretrained(out_dir, rt=serving_rt(), device=dev))
    check_same_params(llm.params, params, "(m) MoE loaded vs converted")
    print(f"  (m) {MOE_PRESET} at {MOE_CKPT_LAYERS} layers: wrote {nbytes / 1e9:.3f} GB in "
          f"{s:.1f} s; convert on the card {conv_s:.2f} s ({nbytes / conv_s / 1e9:.2f} GB/s); "
          f"load {ckpt_bytes / 1e9:.3f} GB in {load_s:.2f} s "
          f"({ckpt_bytes / load_s / 1e9:.2f} GB/s), byte-equal", flush=True)
    info = llm.info()
    check(info["decode_moe_fused"] and not info["decode_megakernel"],
          f"(m) unexpected MoE decode path: {info}")
    ids = prompts(cfg.vocab_size)[1]
    list(llm.stream(token_ids=ids[:8], max_new_tokens=2))            # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    llm.reset()
    toks = list(llm.stream(token_ids=ids, max_new_tokens=MOE_CKPT_NEW))
    got = read_launches("(m) loaded MoE", MOE_PREFILL_KERNELS + ("mnn_moe_decode",),
                        never=("mnn_decode_model",))
    chunks = len(generate.prefill_buckets(len(ids), llm.rt.prefill_chunk))
    check(len(toks) == MOE_CKPT_NEW and got["mnn_moe_prefill"] == MOE_CKPT_LAYERS * chunks
          and got["mnn_moe_decode"] == MOE_CKPT_LAYERS * MOE_CKPT_NEW,
          f"(m) MoE launches {got} for {len(toks)} tokens")
    mem = Llm(cfg, params, serving_rt(), device=dev)
    toks_mem = list(mem.stream(token_ids=ids, max_new_tokens=MOE_CKPT_NEW))
    check(toks == toks_mem, "(m) the loaded MoE model's tokens differ from the in-memory one's")
    print(f"  (m) MoE request of {len(ids)} tokens: {len(toks)} tokens equal to the "
          f"in-memory model's; grouped experts {got['mnn_moe_prefill']}, fused experts "
          f"{got['mnn_moe_decode']} launches", flush=True)
    return dict(hf_bytes=nbytes, write_s=s, convert_card_s=conv_s,
                convert_card_gb_s=nbytes / conv_s / 1e9, ckpt_bytes=ckpt_bytes,
                load_s=load_s, load_gb_s=ckpt_bytes / load_s / 1e9, launches=got,
                tokens=len(toks))


def phase_checkpoints(dev):
    """Phase 6: (j) to (m), each model in a temporary directory outside the
    checkout, deleted as soon as the model is done."""
    t0 = time.perf_counter()
    out = {}
    for key, fn in (("dense", phase_checkpoint_dense), ("moe", phase_checkpoint_moe)):
        root = tempfile.mkdtemp(prefix="mnn_tpu_torch_ckpt_")
        try:
            out[key] = fn(dev, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 6: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# the gemma family: phase 2's gemma rows of K6 and K7, and phase 7
# --------------------------------------------------------------------------

GEMMA2, GEMMA3 = "gemma2-2b", "gemma3-4b"
GEMMA2_CAP, GEMMA3_CAP = 1024, 2048
GEMMA_LONG, GEMMA_LONG_CAP = 4500, 8192   # past gemma2's 4,096 window
GEMMA2_LENS = (17, 300, 600)              # (n), NEW_TOKENS new each
GEMMA3_LENS = (17, 1300)                  # (o): the second crosses the 1,024 window
GEMMA_PARITY = {GEMMA2: (4, 300), GEMMA3: (6, 1100)}   # (q): layers, prompt tokens
GEMMA_SERVE_LENS = (17, 300, 600, 64)     # (r), GEMMA_SERVE_NEW new each
GEMMA_SERVE_NEW = 16
# (r): the fewest steps whose tokens the batch-1 runs must check, summed over
# the requests (logit rows' tokens, served tokens)
GEMMA_SERVE_FLOORS = (12, 11)   # about half of an H100 run's 25 of 36 and 22 of 32

# K6's gemma rows: (label, B, Hkv, G, D, len_old per sequence, capacity, int8
# cache, QK-norm, window, softcap, layers of the cache). gemma2-2b's heads
# (softcap 50) on a sliding (4,096) and a global layer at the 331-position
# request, batch 4, a bf16 cache, and 4,500 of 8,192 past the window;
# gemma3-4b's (QK-norm, no softcap) at 1,300 of 2,048 on a sliding (1,024)
# and a global layer, and batch 4 over a bf16 cache.
GEMMA_DECODE_ROWS = [
    ("gemma2-2b sliding", 1, 4, 2, 256, (331,), 1024, True, False, 4096, 50.0, 26),
    ("gemma2-2b global", 1, 4, 2, 256, (331,), 1024, True, False, 0, 50.0, 26),
    ("gemma2-2b global", 4, 4, 2, 256, (331, 17, 600, 64), 1024, True, False, 0, 50.0, 26),
    ("gemma2-2b sliding bf16", 1, 4, 2, 256, (331,), 1024, False, False, 4096, 50.0, 26),
    ("gemma2-2b sliding", 1, 4, 2, 256, (4500,), 8192, True, False, 4096, 50.0, 8),
    ("gemma2-2b global", 1, 4, 2, 256, (4500,), 8192, True, False, 0, 50.0, 8),
    ("gemma3-4b sliding", 1, 4, 2, 256, (1300,), 2048, True, True, 1024, 0.0, 34),
    ("gemma3-4b global", 1, 4, 2, 256, (1300,), 2048, True, True, 0, 0.0, 34),
    ("gemma3-4b sliding bf16", 4, 4, 2, 256, (1300, 1300, 700, 17), 2048, False, True, 1024,
     0.0, 34),
]


def visible(lens, window) -> list:
    """The cached positions a decode step reads per sequence: all of them, or
    the window's last window - 1 (col > len_old - window)."""
    return [min(n, window - 1) if window else n for n in lens]


def phase_decode_gemma(dev, g, results):
    """K6 at head_dim 256 (GEMMA_DECODE_ROWS), each with its split, against
    the plain version; two calls must give the same bits. SDPA's time where
    one call computes the same function (the rows without a softcap)."""
    tol = 3e-2
    rows = []
    for label, bsz, hkv, grp, d, lens, cap, int8, qkn, window, softcap, L in GEMMA_DECODE_ROWS:
        kc, vc, ks, vs = rand_cache(g, dev, L, bsz, hkv, cap, d, 8 if int8 else 16)
        qkv = (torch.randn((bsz, hkv, grp + 2, d), device=dev, generator=g) * 2
               ).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ang = torch.rand((bsz, d // 2), device=dev, generator=g) * 6.28
        cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
        qn = kn = None
        if qkn:
            qn = torch.rand(d, device=dev, generator=g) + 0.5
            kn = torch.rand(d, device=dev, generator=g) + 0.5
        kw = dict(q_norm=qn, k_norm=kn, sm_scale=d ** -0.5, window=window, softcap=softcap)
        call = lambda i: decode_step.fused_decode_attention(
            qkv, kc, vc, ks, vs, i % L, lengths, cos, sin, **kw)
        plain = lambda i: decode_step.fused_decode_attention_plain(
            qkv, kc, vc, ks, vs, i % L, lengths, cos, sin, qn, kn, 1e-6, d ** -0.5, window, 0,
            softcap)
        got, again, want = call(3), call(3), plain(3)
        torch.cuda.synchronize()
        name = f"decode_step {label} B={bsz} len={lens}"
        err, rel = max_abs(got[0], want[0]), rel_l2(got[0], want[0])
        check(bool(torch.isfinite(got[0]).all()), f"{name}: non-finite output")
        check(rel <= tol, f"{name}: att rel-L2 {rel:.3g} > {tol}")
        for j, nm in ((1, "k_row"), (2, "v_row")):
            lv = max_abs(got[j], want[j])
            check(lv <= (1.0 if int8 else 0.0), f"{name} {nm}: rows {lv} apart")
        if int8:
            for j, nm in ((3, "k_scale"), (4, "v_scale")):
                check(rel_l2(got[j], want[j]) <= 1e-6, f"{name} {nm} differs")
        check(all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: two calls gave different bits")
        ms = time_ms(call, calls=48)
        plain_ms = time_ms(plain, calls=8, replays=2)
        seen = visible(lens, window)
        lib_ms = None
        if not softcap:
            # SDPA of the query rows (after the kernel's norm and rope, which
            # SDPA does not do) over the dequantized rows, each sequence masked
            # to its visible positions
            q = qkv[:, :, :grp].reshape(bsz, hkv * grp, 1, d)
            n = max(lens) + 1
            deq = lambda c, s: (kvcache.dequant_kv(c[3], s[3], 8) if int8 else c[3])[:, :, :n]
            kd = deq(kc, ks).repeat_interleave(grp, 1)
            vd = deq(vc, vs).repeat_interleave(grp, 1)
            pos = torch.arange(n, device=dev)[None, :]
            mask = pos <= lengths[:, None]
            if window:
                mask &= (pos > lengths[:, None] - window) | (pos == lengths[:, None])
            lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask[:, None, None]), calls=48)
        row_b = d * (1 if int8 else 2) + (4 if int8 else 0)
        nbytes = bsz * (hkv * (grp + 2) * d * 2 + 2 * d * 4 + hkv * grp * d * 2
                        + 2 * hkv * (d + 1) * 4) + (2 * d * 4 if qkn else 0)
        nbytes += sum(2 * hkv * n * row_b for n in seen)
        bound = nbytes / HBM_BYTES_S * 1e3
        blocks_a_cluster, tile, smem, blocks = decode_step.split(bsz, hkv, grp, cap, d, int8)
        row = dict(shape=f"{label} B={bsz} Hkv={hkv} G={grp} D={d} "
                         f"len_old={','.join(map(str, lens))} S={cap} "
                         f"{'int8' if int8 else 'bf16'} window={window} softcap={softcap}",
                   max_abs_err=err, rel_l2=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by="bytes", positions_read=seen,
                   split=dict(blocks_a_cluster=blocks_a_cluster, tile=tile, smem=smem,
                              blocks=blocks))
        rows.append(row)
        sdpa = "none (softcap)" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"  decode_step gemma  {row['shape']:72s} rel {rel:.2e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} sdpa {sdpa} bound {bound:.5f} | clusters of "
              f"{blocks_a_cluster} blocks, {tile}-position tiles, smem {smem}, {blocks} blocks",
              flush=True)
        del kc, vc, ks, vs
    torch.cuda.empty_cache()
    results["decode_step_gemma"] = rows


def first_layers(params, n: int):
    """`params` cut to its first n layers (views of the same tensors)."""
    def cut(v):
        if v is None:
            return None
        if isinstance(v, QuantizedLinear):
            return dataclasses.replace(
                v, packed=v.packed[:n], scale=v.scale[:n], bias=v.bias[:n],
                out_bias=None if v.out_bias is None else v.out_bias[:n])
        return v[:n]
    lay = params.layers
    lay = dataclasses.replace(lay, **{f.name: cut(getattr(lay, f.name))
                                      for f in dataclasses.fields(lay)})
    return dataclasses.replace(params, layers=lay)


def gemma_step_inputs(params, cfg, lengths, dev, g):
    """x (scaled as `forward` scales it), lengths and both rope phase pairs
    of one decode step."""
    tok, x, lens, cos_f, sin_f = step_inputs(params, cfg, lengths, dev, g)
    x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=dev)
    local = {}
    if cfg.swa_pattern:
        cl, sl = rope_cos_sin(lens[:, None].long(), cfg.head_dim, cfg.rope_local_theta)
        local = dict(cos_l=torch.cat([cl[:, 0]] * 2, -1), sin_l=torch.cat([sl[:, 0]] * 2, -1))
    return tok, x, lens, cos_f, sin_f, local


def with_logits(outs, params, cfg):
    """A step's results with logits and token appended when the head ran
    outside the kernel (gemma3's vocabulary is not 128-aligned): the final
    norm and the head GEMV on x_out, as `forward` runs them."""
    if len(outs) == 7:
        return outs
    xn = rms_norm(outs[0].to(torch.bfloat16), params.final_norm, cfg.rms_norm_eps)
    logits = decoder.head_logits(params, xn)
    return tuple(outs) + (logits, decode_model.lowest_argmax(logits))


def phase_decode_model_gemma(dev, g, results, p2, p3):
    """K7 with gemma's flags at full width: gemma2-2b's 26 layers at batch 1
    and 4 over an int8 cache at 331 of 1,024 (its head fused), gemma3-4b's 34
    at 1,300 of 2,048 (its head on the GEMV kernel after the kernel), and
    gemma2-2b's first 2 layers at 4,500 of 8,192 (past the 4,096 window);
    each against its plain version from the same state, the same bits twice,
    the schedule it walked with blocks an SM and ring slots."""
    c2, c3 = PRESETS[GEMMA2], PRESETS[GEMMA3]
    cases = [(GEMMA2, c2, p2, 8, (331,), GEMMA2_CAP),
             (GEMMA2, c2, p2, 8, (331, 17, 600, 64), GEMMA2_CAP),
             (GEMMA3, c3, p3, 8, (1300,), GEMMA3_CAP),
             (f"{GEMMA2} x2 layers", dataclasses.replace(c2, num_layers=2), first_layers(p2, 2),
              8, (GEMMA_LONG,), GEMMA_LONG_CAP)]
    rows = []
    for name, cfg, params, kv_bits, lengths, cap in cases:
        b = len(lengths)
        kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, cap,
                                    cfg.head_dim, kv_bits)
        tok, x, lens, cos_f, sin_f, local = gemma_step_inputs(params, cfg, lengths, dev, g)
        args = (x, params.layers, kc, vc, ks, vs, lens, cos_f, sin_f)
        head = params.lm_head if decode_model.supports_head(cfg, params) else None
        check((head is not None) == (cfg.vocab_size % 128 == 0), f"{name}: head fusion")
        kw = dict(config=cfg, head=head, final_norm=params.final_norm, **local)
        got = with_logits(decode_model.fused_decode_model(*args, **kw), params, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = with_logits(decode_model.fused_decode_model_plain(*args, **kw), params, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
              f"decode_model {name}: non-finite output")
        m = decode_model.parity_metrics(got, want, kv_bits)
        bad = decode_model.parity_failures(m, skip=("x_rel",))
        check(not bad, f"decode_model {name} lengths {lengths}: {bad} in {m}")
        ms = event_ms(lambda i: decode_model.fused_decode_model(*args, **kw), calls=20)
        cache = kvcache.KVCache(k=kc, v=vc, k_scale=ks, v_scale=vs, length=lens,
                                bits=kv_bits)
        per_layer_ms, per_layer_n = profiled_device_ms(lambda: decoder.forward(
            params, cfg, tok[:, None], cache, megakernel=False), calls=1)
        nbytes = decode_model_bytes(cfg, params.layers, head, b, kv_bits,
                                    visible_model(cfg, lengths))
        bound = nbytes / HBM_BYTES_S * 1e3
        again = decode_model.fused_decode_model(*args, **kw)
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        check(same, f"decode_model {name}: two calls gave different bits")
        sched = decode_model.schedule_info(cfg, params.layers, head, b, cap, dev)
        limits = decode_model.LIMITS(decode_model.bucket(b), cfg.head_dim)
        row = dict(shape=f"{name} B={b} kv{kv_bits} len_old={','.join(map(str, lengths))} "
                         f"S={cap}", bits=params.layers.wqkv.bits,
                   max_abs_err=m["logits_max_abs"], rel_l2=m["logits_rel"],
                   tol=decode_model.PARITY_BOUNDS["logits_rel"], parity=m, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by="bytes",
                   bytes=nbytes, head_fused=head is not None,
                   per_layer_path_device_ms=per_layer_ms, per_layer_path_launches=per_layer_n,
                   same_twice=same, blocks_an_sm=limits[0], registers=limits[4],
                   local_bytes=limits[7],
                   schedule={k: v for k, v in sched.items() if k != "units"})
        rows.append(row)
        print(f"  decode_model gemma {row['shape']:48s} logits rel {m['logits_rel']:.2e} "
              f"x {m['x_rel']:.1e} rows {m['rows_rel']:.1e} row0 {m['row0_levels']:.0f} lvl "
              f"tokens {m['tokens_compared']}/{b} | kernel {ms:.4f} ms plain {plain_ms:.1f} "
              f"bound {bound:.4f} | per-layer path (device) {per_layer_ms:.3f} ms, "
              f"{per_layer_n:.0f} launches", flush=True)
        print(f"    schedule: {sched['grid']} blocks ({limits[0]} an SM, {limits[4]} registers "
              f"a thread, {limits[7]} local bytes), ring {sched['slots']} slots "
              f"({sched['ring_bytes']} B a block), items a phase (layer 0) "
              f"{sched['items_a_layer']}, {sched['grid_waits_a_layer']} grid-wide waits a "
              f"layer, weight bytes a block {sched['max_block_bytes']} most / "
              f"{sched['mean_block_bytes']:.0f} mean", flush=True)
        del kc, vc, ks, vs, cache, got, want, again
        torch.cuda.empty_cache()
    results["decode_model_gemma"] = rows


def visible_model(cfg, lengths) -> list:
    """Cached positions a whole-model step reads a sequence, averaged over
    the layers (sliding layers read their window only)."""
    per_layer = [visible(lengths, decoder.layer_window(cfg, i)) for i in range(cfg.num_layers)]
    return [sum(col) / cfg.num_layers for col in zip(*per_layer)]


def gemma_rt(cap: int, kv_bits: int = 8):
    return dataclasses.replace(serving_rt(kv_bits), max_seq_len=cap)


def decode_profile(llm, ids, steps, label, card_line, megakernel=None):
    """Prefill `ids`, then `steps` greedy decode steps from copies of that
    state, the tokens fed back on the device: the wall of an untraced run
    (ended by a synchronize), a traced run's device busy time and launches
    by kernel. Returns (profile dict, the launch counts of the traced run)."""
    cache0 = llm._new_cache()
    tokens = torch.tensor([ids], dtype=torch.int64, device=llm.device)
    logits, cache0 = generate.run_prefill(llm.params, llm.config, llm.rt, tokens, cache0)
    tok0 = decode_model.lowest_argmax(logits)[:, None].long()

    def clone():
        cl = lambda t: None if t is None else t.clone()
        return dataclasses.replace(cache0, k=cl(cache0.k), v=cl(cache0.v),
                                   k_scale=cl(cache0.k_scale), v_scale=cl(cache0.v_scale))

    def run(cache):
        tok = tok0
        for _ in range(steps):
            (_, t), cache = decoder.forward(llm.params, llm.config, tok, cache,
                                            megakernel=megakernel, return_token=True)
            tok = t[:, None].long()
        torch.cuda.synchronize()

    run(clone())                                  # warm-up
    c = clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(c)
    wall = (time.perf_counter() - t0) * 1e3
    c = clone()
    torch.cuda.synchronize()
    build.reset_launches()
    by_name, _, _ = profile_decode.traced(lambda: run(c), 1)
    counts = {k.name: k.launches for k in build.KERNELS}
    busy = sum(ms for _, ms, _ in by_name)
    out = dict(steps=steps, wall_ms_per_token=wall / steps, device_busy_ms_per_token=busy / steps,
               device_idle_share=1 - busy / wall,
               launches_per_token=sum(n for _, _, n in by_name) / steps,
               kernels=[dict(name=k, ms=ms / steps, launches=n / steps)
                        for k, ms, n in by_name[:8]])
    print(f"  {label}: {steps} decode steps after {len(ids)} prompt tokens: wall "
          f"{out['wall_ms_per_token']:.3f} ms a token, device busy "
          f"{out['device_busy_ms_per_token']:.3f} ms, idle share "
          f"{out['device_idle_share']:.3f}, {out['launches_per_token']:.1f} launches a token "
          f"[{card_line}]", flush=True)
    return out, counts


GEMMA_NEVER = ("mnn_flash_prefill", "mnn_flash_decode", "mnn_moe_decode", "mnn_moe_prefill",
               "mnn_dequant_matmul_bf16_tile")


def phase_serve_gemma(llm, lens, label, card_line):
    """Phase 7 (n) / (o): greedy requests of `lens` prompt tokens through
    `Llm.stream`, NEW_TOKENS new each: one whole-model launch a token, 4 x
    layers int8-row matmuls a prefill chunk, the head on the GEMV kernel a
    chunk (and a token where the head is not fused), no flash kernel."""
    cfg = llm.config
    info = llm.info()
    check(info["decode_megakernel"], f"{label}: the whole-model kernel does not serve it")
    rng = np.random.default_rng(2468)
    reqs = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))   # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    outs, perf = serve(llm, reqs, label)
    counts = read_launches(label, ("mnn_dequant_matmul", "mnn_dequant_matmul_a8",
                                   "mnn_decode_model"),
                           never=GEMMA_NEVER + ("mnn_decode_step",))
    steps = NEW_TOKENS * len(reqs)
    chunks = chunks_of(reqs, llm.rt)
    head = 0 if info["decode_fused_head"] else steps
    want = {"mnn_decode_model": steps, "mnn_dequant_matmul_a8": 4 * cfg.num_layers * chunks,
            "mnn_dequant_matmul": chunks + head}
    for k, n in want.items():
        check(counts[k] == n, f"{label}: {counts[k]} launches of {k}, {n} expected "
              f"({steps} decode steps, {chunks} prefill chunks)")
    prof, _ = decode_profile(llm, reqs[-1], 16, label, card_line)
    return reqs, outs, dict(requests=perf, launches=counts, decode_steps=steps,
                            prefill_chunks=chunks, head_fused=info["decode_fused_head"],
                            decode=prof)


def phase_per_layer_gemma(llm, ids, label, card_line):
    """Phase 7 (p): `forward(megakernel=False)` over an int8 cache (the
    decode-step kernel once a layer a token) and over an int4 cache (the
    eager path: no decode kernel), PARITY_STEPS steps each."""
    cfg, out = llm.config, {}
    for kv_bits in (8, 4):
        one = Llm(cfg, llm.params, dataclasses.replace(llm.rt, kv_bits=kv_bits),
                  device=llm.device)
        build.reset_launches()
        rows, _, _ = greedy_trace(one, ids, None, megakernel=False)
        lab = f"{label} per-layer int{kv_bits} kv"
        step_kernel = ("mnn_decode_step",) if kv_bits == 8 else ()
        counts = read_launches(lab, ("mnn_dequant_matmul_a8", "mnn_dequant_matmul") + step_kernel,
                               never=GEMMA_NEVER + ("mnn_decode_model",)
                               + (() if kv_bits == 8 else ("mnn_decode_step",)))
        n = PARITY_STEPS * cfg.num_layers if kv_bits == 8 else 0
        check(counts["mnn_decode_step"] == n, f"{lab}: {counts['mnn_decode_step']} "
              f"decode-step launches, {n} expected")
        check(all(bool(torch.isfinite(r).all()) for r in rows), f"{lab}: non-finite logits")
        # 4 steps: a traced step of this path is some thousands of launches
        prof, _ = decode_profile(one, ids, 4, lab, card_line, megakernel=False)
        out[f"int{kv_bits}"] = dict(launches=counts, decode=prof)
        del one
    return out


def phase_parity_gemma(llm, card_line):
    """Phase 7 (q): full width, depth cut (GEMMA_PARITY), a prompt and
    PARITY_STEPS decode steps on the card through the whole-model kernel and
    through the per-layer path, each against the CPU's plain versions with
    the same weights and the CPU's tokens."""
    name = llm.config.name
    layers, n = GEMMA_PARITY[name]
    cfg = dataclasses.replace(llm.config, num_layers=layers)
    card_llm = Llm(cfg, first_layers(llm.params, layers), llm.rt, device=llm.device)
    ids = np.random.default_rng(1357).integers(0, cfg.vocab_size, size=n).tolist()
    t0 = time.perf_counter()
    cpu_llm = Llm(cfg, decoder.params_to(card_llm.params, "cpu"), llm.rt, device="cpu")
    cpu, fed, _ = greedy_trace(cpu_llm, ids, None)
    cpu_s = time.perf_counter() - t0
    out = dict(layers=layers, prompt=n, cpu_s=cpu_s)
    for path, mk in (("whole-model", None), ("per-layer", False)):
        card, _, _ = greedy_trace(card_llm, ids, fed, megakernel=mk)
        out[path] = compare_traces(card, cpu, f"{name} ({layers} layers, {n} prompt tokens, "
                                   f"{path}) ")
    print(f"    cpu run {cpu_s:.1f} s", flush=True)
    del cpu_llm
    return out


def phase_serve_batched_gemma(llm, card_line):
    """Phase 7 (r): (n)'s model through a 4-slot engine, 4 requests at once,
    held to batch-1 runs by phase 5's rule."""
    cfg, label = llm.config, "serve batched gemma (r)"
    rt = dataclasses.replace(llm.rt, max_batch=SERVE_SLOTS)
    rng = np.random.default_rng(8642)
    reqs = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in GEMMA_SERVE_LENS]
    eng = batch_engine.BatchEngine(cfg, llm.params, rt)
    served, wall = serve_engine(eng, reqs, GEMMA_SERVE_NEW, label, card_line)
    counts = read_launches(label, ("mnn_dequant_matmul_a8", "mnn_decode_model"),
                           never=GEMMA_NEVER + ("mnn_decode_step",))
    gen = sum(len(r.generated) for r in served)
    print(f"  {label}: {gen} tokens in {wall * 1e3:.1f} ms at {SERVE_SLOTS} slots: "
          f"{gen / wall:.1f} tok/s [{card_line}]", flush=True)
    parity = hold_to_single_stream(llm, rt, reqs, [r.generated for r in served], label,
                                   GEMMA_SERVE_FLOORS)
    del eng
    return dict(prompt_lens=list(GEMMA_SERVE_LENS), new_tokens=GEMMA_SERVE_NEW,
                requests=per_request(served), wall_s=wall, tok_s=gen / wall,
                launches=counts, parity=parity)


def phase_gemma(dev, card_line, g2: "Llm", g3: "Llm"):
    """Phase 7: the gemma family served on the card, (n) to (r)."""
    t0 = time.perf_counter()
    out = {}
    _, _, out["n"] = phase_serve_gemma(g2, GEMMA2_LENS, "gemma2-2b (n)", card_line)
    _, _, out["o"] = phase_serve_gemma(g3, GEMMA3_LENS, "gemma3-4b (o)", card_line)
    out["p"] = {m.config.name: phase_per_layer_gemma(
        m, np.random.default_rng(97).integers(0, m.config.vocab_size, 300).tolist(),
        f"{m.config.name} (p)", card_line) for m in (g2, g3)}
    out["q"] = {m.config.name: phase_parity_gemma(m, card_line) for m in (g2, g3)}
    out["r"] = phase_serve_batched_gemma(g2, card_line)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 7: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 8: W3 and W2 weights (bench.py's --w-bits 3 and 2 rows)
# --------------------------------------------------------------------------

SUB4_BITS = (3, 2)
SUB4_PARITY_LAYERS = 4      # (v): full width, cut depth on both sides
SUB4_ROUTES = ("gemv", "tile", "a8", "deq")   # rows 1a, 1b, 2 and 3
SUB4_KERNEL = {"gemv": "dequant_matmul", "tile": "dequant_matmul",
               "a8": "dequant_matmul_a8", "deq": "dequant_matmul_deq"}


def sub4_rt(bits: int) -> RuntimeConfig:
    """bench.py's --w-bits rows: block 128, head bits min(bits, 4), int8 KV,
    int8 prefill activations, greedy, batch 1."""
    return dataclasses.replace(serving_rt(), quant_bits=bits, lm_head_bits=min(bits, 4))


def sub4_row(dev, g, bits, proj, k, n, with_bias, route):
    """One W2/W3 matmul on its kernel at qwen2-0.5b's shapes: M = 1 on the
    GEMV (row 1a), M = 512 bf16 rows on the tile kernel (1b), int8 rows on
    the a8 kernel (2) and the dequantize-tile kernel (3); against its plain
    version, the same bits twice, timed beside the plain version and a bf16
    `torch.matmul` on weights dequantized beforehand."""
    m = 1 if route == "gemv" else 512
    out_dtype = torch.float32 if proj == "lm_head" else torch.bfloat16
    wbytes = k * n * bits // 8 + 2 * (k // 128) * n * 2 + (n * 4 if with_bias else 0)
    nl = copies_for(wbytes)
    ql = rand_quantized(g, dev, k, n, layers=nl, bits=bits, with_bias=with_bias,
                        act_bits=8 if route == "a8" else 16)
    x = torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    kern = {"gemv": dequant_matmul.KERNEL_BF16, "tile": dequant_matmul.KERNEL_BF16_TILE,
            "a8": dequant_matmul.KERNEL_A8, "deq": dequant_matmul.KERNEL_DEQ}[route]
    dequant_matmul.DEQ_MIN_M = m if route == "deq" else 1 << 30
    try:
        call = lambda i: dequant_matmul.dequant_matmul(x, ql, layer_index=i % nl,
                                                       out_dtype=out_dtype)
        before = kern.launches
        got, again = call(0), call(0)
        check(kern.launches == before + 2, f"W{bits} {route} {proj}: {kern.name} not launched")
        want = dequant_matmul.dequant_matmul_plain(x, ql.layer(0), out_dtype,
                                                   deq=route == "deq")
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), rel_l2(got, want)
        tol = 1e-2
        check(bool(torch.isfinite(got).all()), f"W{bits} {route} {proj}: non-finite output")
        check(rel <= tol, f"W{bits} {route} {proj} M={m}: rel-L2 {rel:.3g} > {tol}")
        check(torch.equal(got, again), f"W{bits} {route} {proj}: two calls gave different bits")
        ms = time_ms(call, calls=max(nl, 8))
        plain_ms = time_ms(lambda i: dequant_matmul.dequant_matmul_plain(
            x, ql.layer(i % nl), out_dtype, deq=route == "deq"), calls=2, replays=2)
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    nlib = copies_for(k * n * 2, cap=nl)
    wlib = [dequantize(ql.layer(i), dtype=torch.bfloat16) for i in range(nlib)]
    ob = ql.out_bias
    lib_ms = time_ms(lambda i: (
        torch.matmul(x, wlib[i % nlib]) if ob is None
        else torch.addmm(ob[i % nlib].to(torch.bfloat16), x, wlib[i % nlib])),
        calls=max(nlib, 8))
    del wlib
    out_b = m * n * (4 if out_dtype == torch.float32 else 2)
    nbytes = (m * k + m * 4 if route == "a8" else m * k * 2) + wbytes + out_b
    bound, bound_by = bound_of(2 * m * k * n, nbytes,
                               INT8_OPS_S if route == "a8" else BF16_OPS_S)
    row = dict(shape=f"W{bits} {route} {proj} M={m} K={k} N={n}", m=m, bits=bits,
               route=route, kernel=kern.name, max_abs_err=err, rel_l2=rel, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
               bytes=nbytes, l2_rotation=nl)
    if route == "gemv":
        cols, ranges, blocks, smem = dequant_matmul.gemv_split(k, n, bits, 128)
        row["split"] = dict(tile=cols, k_ranges=ranges, blocks=blocks, smem=smem)
    elif route == "a8":
        row["tile"] = dequant_matmul.a8_tile(m, n, bits)
    else:
        row["tile"] = dequant_matmul.bf16_tile(m, n, bits)
    print(f"  {kern.name:30s} {row['shape']:36s} rel {rel:.2e} max_abs {err:.3g} | "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} lib {lib_ms:.4f} bound {bound:.4f} "
          f"({bound_by}) | {row.get('split') or row.get('tile')}", flush=True)
    del ql, x, got, again, want
    torch.cuda.empty_cache()
    return row


def phase_gemm_sub4(dev, g, results, bits):
    """Rows 1a, 1b, 2 and 3 at W`bits` on qwen2-0.5b's four projections, and
    row 1a on the W`bits` head (896 x 151,936), which stays on the GEMV."""
    rows = {}
    for route in SUB4_ROUTES:
        shapes = list(PROJ.items()) + ([("lm_head", (896, 151936, False))]
                                       if route == "gemv" else [])
        rows[route] = [sub4_row(dev, g, bits, proj, k, n, b, route)
                       for proj, (k, n, b) in shapes]
    results[f"w{bits}"] = rows


def phase_decode_model_sub4(dev, g, results, params, bits):
    """Row 7 at W`bits` on full-size qwen2-0.5b (the served weights) over an
    int8 cache: batch 1 at the 300-token request's last step and batch 4;
    the head runs after the kernel on the GEMV, as serving runs it (the JAX
    package keeps sub-4-bit heads out of its kernel too)."""
    cap, cfg = 1024, PRESETS["qwen2-0.5b"]
    last = [n + NEW_TOKENS - 1 for n in PREFILL_LENS]
    rows = []
    check(not decode_model.supports_head(cfg, params), f"W{bits}: a sub-4-bit head was fused")
    for lengths in ((last[1],), (last[0], last[1], last[2], 5)):
        b = len(lengths)
        kc, vc, ks, vs = rand_cache(g, dev, cfg.num_layers, b, cfg.num_kv_heads, cap,
                                    cfg.head_dim, 8)
        tok, x, lens, cos_f, sin_f = step_inputs(params, cfg, lengths, dev, g)
        args = (x, params.layers, kc, vc, ks, vs, lens, cos_f, sin_f)
        before = decode_model.KERNEL.launches
        got = with_logits(decode_model.fused_decode_model(*args, config=cfg), params, cfg)
        again = decode_model.fused_decode_model(*args, config=cfg)
        check(decode_model.KERNEL.launches == before + 2, f"W{bits}: decode_model not launched")
        want = with_logits(decode_model.fused_decode_model_plain(*args, config=cfg), params, cfg)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
              f"decode_model W{bits}: non-finite output")
        check(all(a is None or torch.equal(a, c) for a, c in zip(got[:5], again)),
              f"decode_model W{bits}: two calls gave different bits")
        m = decode_model.parity_metrics(got, want, 8)
        bad = decode_model.parity_failures(m, skip=("x_rel",))
        check(not bad, f"decode_model W{bits} lengths {lengths}: {bad} in {m}")
        ms = event_ms(lambda i: decode_model.fused_decode_model(*args, config=cfg), calls=20)
        plain_ms = event_ms(lambda i: decode_model.fused_decode_model_plain(*args, config=cfg),
                            calls=2)
        nbytes = decode_model_bytes(cfg, params.layers, None, b, 8, lengths)
        bound = nbytes / HBM_BYTES_S * 1e3
        sched = decode_model.schedule_info(cfg, params.layers, None, b, cap, dev)
        limits = decode_model.LIMITS(decode_model.bucket(b), cfg.head_dim, bits)
        row = dict(shape=f"W{bits} qwen2-0.5b B={b} kv8 len_old={','.join(map(str, lengths))}",
                   bits=bits, max_abs_err=m["logits_max_abs"], rel_l2=m["logits_rel"],
                   tol=decode_model.PARITY_BOUNDS["logits_rel"], parity=m, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by="bytes",
                   bytes=nbytes, head_fused=False, blocks_an_sm=limits[0],
                   registers=limits[4], local_bytes=limits[7],
                   schedule={k: v for k, v in sched.items() if k != "units"})
        rows.append(row)
        print(f"  decode_model W{bits} {row['shape']:40s} logits rel {m['logits_rel']:.2e} "
              f"rows {m['rows_rel']:.1e} row0 {m['row0_levels']:.0f} lvl | kernel {ms:.4f} ms "
              f"plain {plain_ms:.2f} bound {bound:.4f} | ring {sched['slots']} slots of "
              f"{sched['ring_bytes'] // sched['slots']} B, {limits[0]} blocks an SM, "
              f"{limits[4]} registers", flush=True)
        del kc, vc, ks, vs, got, want, again
        torch.cuda.empty_cache()
    results[f"w{bits}"]["model"] = rows


def phase_sub4_parity(dev, bits):
    """(v): full width, SUB4_PARITY_LAYERS layers, the first request's
    prefill and PARITY_STEPS decode steps on the card and through the plain
    versions on the CPU, the same weights from the same seed."""
    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=SUB4_PARITY_LAYERS)
    rt = sub4_rt(bits)

    def make(device):
        params = decoder.init_random_params(
            cfg, torch.Generator().manual_seed(SEED), quant_bits=bits,
            quant_block=rt.quant_block, lm_head_bits=rt.lm_head_bits, device=device)
        return Llm(cfg, params, rt, device=device)

    ids = prompts(cfg.vocab_size)[0]
    build.reset_launches()
    card, fed, _ = greedy_trace(make(dev), ids, None)
    read_launches(f"W{bits} parity, {SUB4_PARITY_LAYERS} layers",
                  ("mnn_dequant_matmul_a8", "mnn_dequant_matmul", "mnn_decode_model"))
    t0 = time.perf_counter()
    cpu, _, _ = greedy_trace(make("cpu"), ids, fed)
    out = compare_traces(card, cpu, f"W{bits} ({SUB4_PARITY_LAYERS} layers, full width) ")
    print(f"    cpu run {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(out, layers=SUB4_PARITY_LAYERS)


def phase_sub4(dev, g, results, bits):
    """Phase 8 at W`bits`: qwen2-0.5b at full width and depth as bench.py's
    --w-bits row configures it. Row 7's rows on the served weights, then
    (s) the three requests: one whole-model launch and one head GEMV a
    token, 96 a8 launches a chunk; (t) the 300-token request with
    `megakernel=False` for PARITY_STEPS steps: every projection on the GEMV;
    (u) the same request at prefill_act_bits=16: 96 tile-kernel launches;
    (w) its prefill with the dequantize-tile switch on: 96 launches of row 3;
    (v) card against CPU at SUB4_PARITY_LAYERS layers."""
    t0 = time.perf_counter()
    llm = Llm.synthetic("qwen2-0.5b", rt=sub4_rt(bits), seed=SEED, device=dev)
    cfg, rt, nl = llm.config, llm.rt, llm.config.num_layers
    info = llm.info()
    check(info["decode_megakernel"] and not info["decode_fused_head"],
          f"W{bits}: unexpected decode path {info}")
    check(llm.params.lm_head.bits == bits, f"W{bits}: head of {llm.params.lm_head.bits} bits")
    print(f"  W{bits} qwen2-0.5b built in {time.perf_counter() - t0:.1f} s; "
          f"info {json.dumps(info)}", flush=True)
    phase_decode_model_sub4(dev, g, results, llm.params, bits)
    reqs = prompts(cfg.vocab_size)
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))   # warm-up
    torch.cuda.synchronize()
    out = dict(counts={})

    build.reset_launches()                  # (s)
    outs, out["perf"] = serve(llm, reqs, f"W{bits}")
    got = out["counts"]["serve"] = read_launches(
        f"W{bits} serve", PREFILL_KERNELS + ("mnn_decode_model",),
        never=("mnn_decode_step", "mnn_flash_decode", "mnn_dequant_matmul_bf16_tile",
               "mnn_dequant_matmul_deq"))
    steps = NEW_TOKENS * len(reqs)
    chunks = sum(len(generate.prefill_buckets(len(r), rt.prefill_chunk)) for r in reqs)
    check(got["mnn_decode_model"] == steps,
          f"W{bits}: {got['mnn_decode_model']} whole-model launches for {steps} steps")
    check(got["mnn_dequant_matmul_a8"] == 4 * nl * chunks,
          f"W{bits}: {got['mnn_dequant_matmul_a8']} a8 launches for {chunks} chunks")
    # the head at M = 1: once a token, and once a prefill chunk on its last row
    check(got["mnn_dequant_matmul"] == steps + chunks,
          f"W{bits}: {got['mnn_dequant_matmul']} GEMV launches for {steps} steps "
          f"and {chunks} prefill chunks")

    ids = reqs[1][:FALLBACK_PROMPT]
    build.reset_launches()                  # (t)
    rows, _, _ = greedy_trace(llm, ids, None, megakernel=False)
    got = out["counts"]["per_layer"] = read_launches(
        f"W{bits} per-layer", PREFILL_KERNELS + ("mnn_decode_step",),
        never=("mnn_decode_model",))
    check(got["mnn_dequant_matmul"] == PARITY_STEPS * (4 * nl + 1) + 1,
          f"W{bits}: {got['mnn_dequant_matmul']} GEMV launches on the per-layer path")
    check(all(bool(torch.isfinite(r).all()) for r in rows),
          f"W{bits}: non-finite logits on the per-layer path")

    out["perf_act16"], out["counts"]["act16"] = phase_serve_act16(llm, reqs)   # (u)

    tokens = torch.tensor([reqs[1]], dtype=torch.int64, device=dev)
    base, _ = generate.run_prefill(llm.params, cfg, rt, tokens, llm._new_cache())
    build.reset_launches()                  # (w)
    dequant_matmul.DEQ_MIN_M = rt.prefill_chunk
    try:
        deq, _ = generate.run_prefill(llm.params, cfg, rt, tokens, llm._new_cache())
    finally:
        dequant_matmul.DEQ_MIN_M = 1 << 30
    torch.cuda.synchronize()
    got = out["counts"]["deq_switch"] = read_launches(
        f"W{bits}, dequantize-tile switch on", ("mnn_dequant_matmul_deq",),
        never=("mnn_dequant_matmul_a8",))
    check(got["mnn_dequant_matmul_deq"] == 4 * nl,
          f"W{bits}: {got['mnn_dequant_matmul_deq']} dequantize-tile launches")
    rel = rel_l2(deq, base)
    check(bool(torch.isfinite(deq).all()) and rel <= PARITY_REL,
          f"W{bits}: dequantize-tile prefill logits rel-L2 {rel:.3g} > {PARITY_REL}")
    out["deq_switch_rel_l2"] = rel
    del llm
    torch.cuda.empty_cache()
    out["parity"] = phase_sub4_parity(dev, bits)
    return out



# --------------------------------------------------------------------------
# phase 9: KV variants and cache tiers
# --------------------------------------------------------------------------

KV_CODEBOOKS = {"tq3": dict(kv_bits=3), "tq4": dict(kv_bits=4, kv_codebook=True)}
KV_ROTATED = {"rot_int8": dict(kv_rotate=True, kv_bits=8),
              "rot_int4": dict(kv_rotate=True, kv_bits=4)}
KV_PARITY_LAYERS = 2        # (aa): full width, cut depth on both sides
OFFLOAD_NEW = 8             # (bb): new tokens of the continued request
# (x), (y): traced decode steps. A traced step of these per-layer paths is
# some thousands of launches and costs the script about 4 s; (z) is not traced
KV_PROFILE_STEPS = 1
# (aa): the variants held against the CPU (the rotation over int4 only, to
# fit the script's time)
KV_PARITY = ("tq3", "tq4", "rot_int4")
KV_NEVER = ("mnn_decode_model", "mnn_decode_step")


def kv_rt(**flags) -> RuntimeConfig:
    return dataclasses.replace(serving_rt(), **flags)


def phase_kv_serve(llm, reqs, label, card_line, profile=True):
    """(x), (y), (z): `reqs` through `Llm.stream`, NEW_TOKENS new each: no
    whole-model or decode-step launch (both refuse these caches), flash
    decode once a layer a step, flash prefill once a layer a chunk; then,
    with `profile`, a traced decode."""
    cfg = llm.config
    info = llm.info()
    check(not info["decode_megakernel"], f"{label}: the whole-model kernel accepted it")
    list(llm.stream(token_ids=reqs[0][:8], max_new_tokens=2))     # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    outs, perf = serve(llm, reqs, label)
    counts = read_launches(label, PREFILL_KERNELS + ("mnn_flash_decode",), never=KV_NEVER)
    steps, chunks = NEW_TOKENS * len(reqs), chunks_of(reqs, llm.rt)
    want = {"mnn_flash_decode": steps * cfg.num_layers,
            "mnn_flash_prefill": chunks * cfg.num_layers,
            "mnn_dequant_matmul_a8": 4 * cfg.num_layers * chunks}
    for k, n in want.items():
        check(counts[k] == n, f"{label}: {counts[k]} launches of {k}, {n} expected "
              f"({steps} decode steps, {chunks} prefill chunks)")
    prof = (decode_profile(llm, reqs[-1], KV_PROFILE_STEPS, label, card_line)[0]
            if profile else None)
    return outs, dict(requests=perf, launches=counts, decode_steps=steps,
                      prefill_chunks=chunks, decode=prof,
                      kv_cache_bytes=info["kv_cache_bytes"])


def to_device(obj, dev):
    """Params (or any dataclass of tensors) copied onto `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    return obj


def phase_kv_parity(dev, params):
    """(aa): full width, the first KV_PARITY_LAYERS layers of `params`, the
    first request's prefill and PARITY_STEPS steps under each variant on the
    card and through the plain versions on the CPU (a copy of the same
    weights), phase 4's bounds and token rule."""
    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=KV_PARITY_LAYERS)
    cut = first_layers(params, KV_PARITY_LAYERS)
    params = {dev: cut, "cpu": to_device(cut, "cpu")}
    ids = prompts(cfg.vocab_size)[0]
    out = {}
    for name in KV_PARITY:
        flags = {**KV_CODEBOOKS, **KV_ROTATED}[name]
        make = lambda d: Llm(cfg, params[d], kv_rt(**flags), device=d)
        build.reset_launches()
        card, fed, _ = greedy_trace(make(dev), ids, None)
        read_launches(f"{name} parity, {KV_PARITY_LAYERS} layers",
                      PREFILL_KERNELS + ("mnn_flash_decode",), never=KV_NEVER)
        t0 = time.perf_counter()
        cpu, _, _ = greedy_trace(make("cpu"), ids, fed)
        out[name] = dict(compare_traces(card, cpu, f"{name} ({KV_PARITY_LAYERS} layers, "
                                                   f"full width) "),
                         layers=KV_PARITY_LAYERS)
        print(f"    cpu run {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def synced(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_offload(llm, reqs, head, card_line):
    """(bb): the context that (x)'s 600-token request left in its TQ3 cache
    (`head`: its new tokens), moved out and back three ways, each followed
    by the same request (the first prompt's first 9 tokens, OFFLOAD_NEW
    new): shelved into a host pool while the 17-token request is served (8
    new), restored; restored from that pool, shelved into a pool of
    `max_bytes=1` with another context shelved after it (so it spills to
    disk), restored from disk; saved with `save_prefix` and loaded into a
    fresh `Llm`. After each restore the rows and scales equal the context's
    own, and each continuation's tokens equal those of the same request
    from a device copy of the context that never left the card. Seconds and
    bytes of each move (set-up)."""
    ids_now = reqs[2] + head
    ctx = len(ids_now)
    check(llm.context_len == ctx, f"offload: (x) left {llm.context_len} tokens, not {ctx}")
    cont_ids = reqs[0][:9]
    names = ("k", "v", "k_scale", "v_scale")
    snap = {f: getattr(llm.cache, f).clone() for f in names}
    # dim 3 is the position in the rows [L, B, Hkv, S, D] and the scales [L, B, Hkv, S]
    same_rows = lambda cache: all(torch.equal(getattr(cache, f)[:, :, :, :ctx],
                                              snap[f][:, :, :, :ctx]) for f in names)
    cont = lambda m: list(m.stream(token_ids=cont_ids, max_new_tokens=OFFLOAD_NEW))
    out = dict(context_tokens=ctx)
    tmp = tempfile.mkdtemp(prefix="mnn_offload_")
    got = {}
    try:
        build.reset_launches()
        pool = KVOffloadPool()                                      # host pool
        n, shelve_s = synced(lambda: llm.shelve_context("A", pool, ids_now))
        check(n == ctx and llm.context_len == 0, "offload (pool): shelve")
        list(llm.stream(token_ids=reqs[0], max_new_tokens=8))
        ok, restore_s = synced(lambda: llm.restore_context("A", pool))
        check(ok and llm.context_len == ctx and same_rows(llm.cache),
              "offload (pool): the restored rows differ")
        out["pool"] = dict(shelve_s=shelve_s, restore_s=restore_s, host_bytes=pool.bytes)
        path = os.path.join(tmp, "prefix.npz")
        _, save_s = synced(lambda: save_prefix(path, llm.cache, ids_now))
        got["pool"] = cont(llm)

        check(llm.restore_context("A", pool), "offload (spill): restore")
        spill = KVOffloadPool(max_bytes=1, spill_dir=tmp)           # disk tier
        _, shelve_s = synced(lambda: llm.shelve_context("A", spill, ids_now))
        list(llm.stream(token_ids=reqs[0], max_new_tokens=1))
        _, spill_s = synced(lambda: llm.shelve_context("B", spill))
        check(spill.stats()["spilled"] == 1 and "A" in spill, "offload (spill): no spill")
        ok, reload_s = synced(lambda: llm.restore_context("A", spill))
        check(ok and llm.context_len == ctx and same_rows(llm.cache),
              "offload (spill): the reloaded rows differ")
        out["spill"] = dict(shelve_s=shelve_s, spill_s=spill_s, reload_restore_s=reload_s,
                            stats=spill.stats())
        got["spill"] = cont(llm)

        fresh = Llm(llm.config, llm.params, llm.rt, device=llm.device)   # file
        (fresh.cache, saved), load_s = synced(lambda: load_prefix(path, fresh.cache))
        check(saved == ids_now and same_rows(fresh.cache),
              "offload (prefix): the loaded rows differ")
        out["prefix"] = dict(save_s=save_s, load_s=load_s, file_bytes=os.path.getsize(path))
        got["prefix"] = cont(fresh)
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the reference: a device copy of the context, never moved off the card
    llm.cache = kvcache.with_length(
        dataclasses.replace(llm.cache, **{f: snap[f] for f in names}),
        torch.full_like(llm.cache.length, ctx))
    want = cont(llm)
    out["continued"] = want
    for how, toks in got.items():
        check(toks == want, f"offload ({how}): continued tokens {toks} differ from "
              f"the never-moved context's {want}")
    out["launches"] = read_launches("offload", ("mnn_flash_decode",), never=KV_NEVER)
    for how in got:
        print(f"  offload ({how}): {ctx} tokens, " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in out[how].items() if k != "stats")
            + f"; {OFFLOAD_NEW} continued tokens equal [{card_line}]", flush=True)
    return out


def phase_kv(dev, params, card_line):
    """Phase 9 on full-size qwen2-0.5b with phase 3's weights and runtime."""
    t0 = time.perf_counter()
    cfg = PRESETS["qwen2-0.5b"]
    reqs = prompts(cfg.vocab_size)
    out = {}
    for name, flags in KV_CODEBOOKS.items():          # (x), (y)
        t1 = time.perf_counter()
        llm = Llm(cfg, params, kv_rt(**flags), device=dev)
        check(llm.cache.bits == flags["kv_bits"]
              and llm.cache.codebook == bool(flags.get("kv_codebook")),
              f"{name}: the cache is not {flags}")
        outs, out[name] = phase_kv_serve(llm, reqs, f"{name} kv", card_line)
        out[name]["seconds"] = time.perf_counter() - t1
        if name == "tq3":
            tq3, tq3_head = llm, outs[2]
    for name, flags in KV_ROTATED.items():            # (z)
        t1 = time.perf_counter()
        llm = Llm(cfg, params, kv_rt(**flags), device=dev)
        check(llm.config.kv_rotate and llm.info()["kv_rotate"], f"{name}: not rotated")
        _, out[name] = phase_kv_serve(llm, reqs[1:2], f"{name} kv", card_line,
                                      profile=False)
        out[name]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["offload"] = phase_offload(tq3, reqs, tq3_head, card_line)   # (bb)
    out["offload"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["parity"] = phase_kv_parity(dev, params)           # (aa)
    out["parity"]["seconds"] = time.perf_counter() - t1
    print("  phase 9 by sub-phase, s: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in out.items()), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 9: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 10: speculative decoding
# --------------------------------------------------------------------------

SPEC_NEW = NEW_TOKENS       # new tokens a request
SPEC_MODES = {  # sub-phase -> (rt.speculative, draft_len)
    "cc": ("lookahead", 7), "dd": ("eagle", 4), "ee": ("eagle-tree", 4), "ff": ("mtp", 4),
    "gg": ("dflash", 4)}
# the plain trace a mode is held to: its prefill's activation bits (lookahead
# prefills as the runtime says, `prefill_act_bits=8`; the draft modes' feature
# prefill takes bf16 rows, as in the JAX package) and its verify path
SPEC_TRACE = {"lookahead": (8, "chain"), "eagle": (16, "chain"), "eagle-tree": (16, "tree"),
              "mtp": (16, "chain"), "dflash": (16, "chain")}
SPEC_TRACE_TOKENS = 2       # new tokens after the first in a traced run: 1 or 2 rounds
SPEC_FANOUT = 3             # (ee), (hh): 1 + 3 x 4 = 13 nodes
SPEC_PARITY_LAYERS = 4      # (ii): full width, cut depth on both sides
SPEC_ORACLE_ROUNDS = 3      # (hh): rounds of the oracle tree, each accepted whole
# the kernels each sub-phase must launch, and those it never may: no decode
# step of T = 1 runs (every round is one verify of T > 1); the draft modes
# prefill with bf16 rows (the features), lookahead at `prefill_act_bits=8`
SPEC_NEVER = ("mnn_decode_model", "mnn_decode_step")
SPEC_MUST = {
    "cc": (PREFILL_KERNELS + ("mnn_dequant_matmul_bf16_tile",),
           SPEC_NEVER + ("mnn_flash_decode",)),
    "dd": (("mnn_dequant_matmul", "mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill",
            "mnn_flash_decode"), SPEC_NEVER + ("mnn_dequant_matmul_a8",)),
    "ff": (("mnn_dequant_matmul", "mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill"),
           SPEC_NEVER + ("mnn_dequant_matmul_a8", "mnn_flash_decode")),
}
SPEC_MUST["ee"] = SPEC_MUST["dd"]
SPEC_MUST["gg"] = SPEC_MUST["ff"]


def spec_rt(mode: str = "none", draft_len: int = 7) -> RuntimeConfig:
    """Phase 3's runtime (W4 block 128, int4 head, int8 KV, cache 1,024,
    `prefill_act_bits=8`, greedy, batch 1) with `mode`."""
    return dataclasses.replace(serving_rt(), speculative=mode, draft_len=draft_len,
                               tree_fanout=SPEC_FANOUT)


def spec_prompts(vocab) -> dict:
    """The 300-token request, and 64 tokens of the JAX tests' [5, 6, 7]
    pattern (lookahead's n-grams hit there)."""
    return {"300": prompts(vocab)[1], "repeat64": ([5, 6, 7] * 22)[:64]}


def spec_rows(llm, ids, toks, paths):
    """The logit rows [N, V] along the plain stream's tokens `toks` on the
    card, from llm's own prefill (its `prefill_act_bits`): `decode` by
    decode steps (the plain stream's path, the whole-model kernel), and each
    of `paths` ("chain", "tree": a single-chain tree) by one verify over
    the trace from a prefill of its own. Row 0 is the prefill's."""
    p, c, dev = llm.params, llm.config, llm.device
    ids_t = torch.tensor([ids], device=dev)
    rest = torch.tensor([toks[:-1]], device=dev)
    t = len(toks) - 1
    logits, cache = generate.run_prefill(p, c, llm.rt, ids_t, llm._new_cache())
    dec = [logits[0]]
    for tok in rest[0]:
        logits, cache = decoder.forward(p, c, tok.reshape(1, 1), cache)
        dec.append(logits[0])
    out = {"decode": torch.stack(dec).float()}
    ar = torch.arange(t, device=dev)
    for name in paths:
        tree = (ar, torch.ones(t, t, dtype=torch.bool, device=dev).tril()) \
            if name == "tree" else None
        first, cache = generate.run_prefill(p, c, llm.rt, ids_t, llm._new_cache())
        rows, _ = decoder.forward(p, c, rest, cache, all_logits=True, tree=tree)
        out[name] = torch.cat([first, rows[0]]).float()
    return out


def clear_steps(rows: dict, path: str) -> dict:
    """The decode path's top-2 margins against the logit differences of
    `path` (the verify a mode runs): `steps`, the leading steps whose margin
    exceeds the largest difference of all rows (phase 4's rule), and
    `step_rule`, those whose margin exceeds the difference at that step;
    `margin` and `diff` per step."""
    dec = rows["decode"]
    per_step = (rows[path] - dec).abs().amax(dim=-1)
    top2 = dec.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    lead = lambda ok: (ok.tolist() + [False]).index(False)
    diff = float(per_step.max())
    return dict(steps=lead(margin > diff), step_rule=lead(margin > per_step),
                max_abs_diff=diff, margin=margin.tolist(), diff=per_step.tolist())


def hold_to_plain(toks, plain, clear, label):
    """A stream held to the plain stream: equal up to the first step whose
    margin is not above that step's logit difference; a first difference
    before it fails. Returns the steps equal."""
    same = next((i for i, (a, b) in enumerate(zip(toks, plain)) if a != b), len(toks))
    if same < clear["step_rule"]:
        fail(f"{label}: differs from the plain stream at step {same}, whose margin "
             f"{clear['margin'][same]:.4g} exceeds the verify paths' difference "
             f"{clear['diff'][same]:.4g} there")
    return same


class CountCalls:
    """Counts the calls of module functions (the speculative loops' verify
    passes: one a round) while it is entered."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls = module, names, 0

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(self.module, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def spec_serve(llm, ids, label, plain, clear, must, never, card_line):
    """One speculative stream through `Llm.stream`: its tokens held to the
    plain stream's (`hold_to_plain`); its launches (every kernel
    of `must`, none of `never`) and those of its rounds (the counts after
    the first token, the prefill's, taken off); the wall of its rounds and,
    from a traced second run, their device busy time."""
    list(llm.stream(token_ids=ids[:8], max_new_tokens=2))        # warm-up, the drafter
    torch.cuda.synchronize()
    llm.reset()
    build.reset_launches()
    with CountCalls(spec, "verify_step", "verify_forward") as rounds:
        stream = llm.stream(token_ids=ids, max_new_tokens=SPEC_NEW)
        toks = [next(stream)]
        prefill = {k.name: k.launches for k in build.KERNELS}
        toks += list(stream)
    torch.cuda.synchronize()
    launches = read_launches(label, must, never=never)
    n = rounds.calls
    check(len(toks) == SPEC_NEW and all(0 <= t < llm.config.vocab_size for t in toks),
          f"{label}: {len(toks)} tokens")
    same = hold_to_plain(toks, plain, clear, label)
    at = (f", first different at step {same}: margin {clear['margin'][same]:.4g}, "
          f"difference {clear['diff'][same]:.4g}" if same < len(plain) else "")
    p, stats = llm.perf, dict(llm.spec_stats)
    # the traced run: its first rounds after the first token (a traced
    # round of thousands of launches costs the script seconds)
    llm.reset()
    with CountCalls(spec, "verify_step", "verify_forward") as traced_rounds:
        stream = llm.stream(token_ids=ids, max_new_tokens=1 + SPEC_TRACE_TOKENS)
        next(stream)
        torch.cuda.synchronize()
        by_name, _, traced_s = profile_decode.traced(lambda: (list(stream),
                                                              torch.cuda.synchronize()), 1)
    nt = traced_rounds.calls
    busy = sum(ms for _, ms, _ in by_name) / nt
    wall_ms = p.decode_s * 1e3 / n
    out = dict(tokens=toks, equal_steps=same, spec_stats=stats, rounds=n,
               prefill_s=p.prefill_s, decode_s=p.decode_s, decode_tok_s=p.decode_tok_s,
               wall_ms_per_round=wall_ms, device_busy_ms_per_round=busy,
               device_idle_share=1 - busy / wall_ms, traced_rounds=nt,
               traced_wall_ms_per_round=traced_s * 1e3 / nt,
               launches=launches, prefill_launches=prefill,
               launches_per_round={k: (launches[k] - prefill[k]) / n for k in launches
                                   if launches[k] > prefill[k]},
               traced_launches_per_round=sum(c for _, _, c in by_name) / nt,
               kernels=[dict(name=k, ms=ms / nt, launches=c / nt) for k, ms, c in by_name[:8]])
    print(f"  {label}: {len(ids)} prompt tokens, {stats}, {n} rounds; prefill "
          f"{p.prefill_s * 1e3:.2f} ms, decode {p.decode_tok_s:.1f} tok/s; a round: wall "
          f"{out['wall_ms_per_round']:.3f} ms, busy {out['device_busy_ms_per_round']:.3f} ms, "
          f"idle {out['device_idle_share']:.3f}, launches "
          f"{ {k: round(v, 2) for k, v in out['launches_per_round'].items()} }; equal to the "
          f"plain stream for {same} of {SPEC_NEW} tokens (clear: {clear['steps']} by the largest "
          f"difference, {clear['step_rule']} by each step's{at}) [{card_line}]",
          flush=True)
    return out


class OracleTree(spec.TreeEagleDraft):
    """(hh): a tree whose chain `good` is the target's own greedy chain
    under this very verify (found by running the same 13-node verify ahead
    on a copy of the cache, one node at a time: a node's target depends only
    on its ancestors), the other chains junk. Accepted whole by construction,
    and, where the plain stream's margins are clear, the plain run's next
    tokens."""

    def __init__(self, llm, good: int):
        super().__init__(None, draft_len=4, fanout=SPEC_FANOUT)
        self.llm, self.good = llm, good
        self.depths, self.mask = (a.to(llm.device) for a in self.tree_layout())

    def start(self, params, config, prompt_ids, feats):
        self.params, self.config = params, config

    def propose_tree(self, last_token, last_feat):
        d, c = self.draft_len, self.llm.cache
        chains = torch.zeros((self.fanout, d), dtype=torch.int64, device=self.llm.device)
        junk = torch.arange(d, device=self.llm.device) + 7
        for j in range(d):
            cl = lambda t: None if t is None else t.clone()
            cache = dataclasses.replace(c, k=cl(c.k), v=cl(c.v), k_scale=cl(c.k_scale),
                                        v_scale=cl(c.v_scale))
            for row in range(self.fanout):
                if row != self.good:
                    chains[row] = junk + row
            nodes = torch.cat([torch.as_tensor(last_token, device=self.llm.device).long()
                               .reshape(1), chains.reshape(-1)])[None]
            targets, _, _ = spec.verify_forward(self.params, self.config, nodes, cache,
                                                tree=(self.depths, self.mask))
            src = 0 if j == 0 else 1 + self.good * d + j - 1
            chains[self.good, j] = targets[0, src]
        return chains

    def commit(self, *a, **kw):
        pass

    def rollback(self, n):
        pass


class CompactCheck:
    """Wraps `kvcache.compact_tail` while entered: the rows at start + sel[i]
    before each call must sit at start + i after it, byte for byte, for the
    m rows kept (K, V and their scales). Counts the calls and the rows that
    moved (sel[i] != i)."""

    def __enter__(self):
        self.orig, self.calls, self.moved = kvcache.compact_tail, 0, 0

        def checked(cache, start, sel, m):
            s0 = int(start)
            src = [s0 + i for i in sel[:m]]
            names = ("k", "v", "k_scale", "v_scale")
            before = [getattr(cache, f)[:, :, :, src].clone() for f in names]
            out = self.orig(cache, start, sel, m)
            after = [getattr(out, f)[:, :, :, s0:s0 + m] for f in names]
            check(all(torch.equal(a, b) for a, b in zip(before, after)),
                  "compact_tail: the kept rows are not the tree's rows")
            self.calls += 1
            self.moved += sum(i != j for i, j in enumerate(sel[:m]))
            return out
        kvcache.compact_tail = checked
        return self

    def __exit__(self, *exc):
        kvcache.compact_tail = self.orig


def phase_spec_oracle(llm, ids, plain, clear, card_line):
    """(hh): SPEC_ORACLE_ROUNDS rounds of `tree_draft_generate` with the good
    chain first and last: each round accepted whole, and (`CompactCheck`)
    the accepted rows where `compact_tail` put them on the card (in place
    for the first chain, moved for the last); the tokens held to the plain
    stream's."""
    n_tok = 1 + SPEC_ORACLE_ROUNDS * 5
    out = {}
    for good in (0, SPEC_FANOUT - 1):
        llm.reset()
        build.reset_launches()
        with CompactCheck() as compact:
            blocks = list(spec.tree_draft_generate(llm, ids, n_tok,
                                                   drafter=OracleTree(llm, good)))
        toks = [t for b in blocks for t in b]
        check(llm.spec_stats["accept_rate"] == 1.0 and [len(b) for b in blocks] ==
              [1] + [5] * SPEC_ORACLE_ROUNDS,
              f"oracle tree (good chain {good}): {llm.spec_stats}, blocks "
              f"{[len(b) for b in blocks]}")
        check(compact.calls == SPEC_ORACLE_ROUNDS
              and compact.moved == (0 if good == 0 else 4 * SPEC_ORACLE_ROUNDS),
              f"oracle tree: {compact.calls} compactions moved {compact.moved} rows")
        same = hold_to_plain(toks, plain, dict(clear, step_rule=min(clear["step_rule"], n_tok)),
                             f"oracle tree (good chain {good})")
        out[f"chain{good}"] = dict(tokens=toks, equal_steps=same, spec_stats=dict(llm.spec_stats),
                                   rows_moved=compact.moved,
                                   launches={k.name: k.launches for k in build.KERNELS})
        print(f"  oracle tree, good chain {good}: {SPEC_ORACLE_ROUNDS} rounds of 13 nodes "
              f"accepted whole, {compact.moved} rows moved by compact_tail and found in place, "
              f"equal to the plain stream for {same} of {n_tok} tokens [{card_line}]",
              flush=True)
    return out


def phase_spec_parity(dev, params):
    """(ii): full width, the first SPEC_PARITY_LAYERS layers: the 300-token
    feature prefill, then one chain verify of 8 tokens and one tree verify
    of 13 nodes from it, on the card and through the plain versions on the
    CPU: features and logits within PARITY_REL, the greedy targets equal
    where the CPU's top-2 margin exceeds the largest logit difference."""
    cfg = dataclasses.replace(PRESETS["qwen2-0.5b"], num_layers=SPEC_PARITY_LAYERS)
    cut = first_layers(params, SPEC_PARITY_LAYERS)
    params = {dev: cut, "cpu": to_device(cut, "cpu")}
    ids = prompts(cfg.vocab_size)[1]
    rng = np.random.default_rng(17)
    chain = rng.integers(0, cfg.vocab_size, 8).tolist()
    nodes = rng.integers(0, cfg.vocab_size, 1 + SPEC_FANOUT * 4).tolist()
    layout = spec.TreeEagleDraft(None, draft_len=4, fanout=SPEC_FANOUT).tree_layout()
    got = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        p, tree = params[d], tuple(a.to(d) for a in layout)
        llm = Llm(cfg, p, spec_rt(), device=d)
        ids_t = torch.tensor([ids], device=d)
        _, _, cache = spec.prefill_with_features(p, cfg, llm.rt, ids_t, llm._new_cache())
        ctx = int(cache.length[0])
        outs = []
        for toks, tr in ((chain, None), (nodes, tree)):
            targets, feats, after = spec.verify_forward(p, cfg, torch.tensor([toks], device=d),
                                                        cache, tree=tr)
            outs.append((targets[0].cpu(), feats[0].float().cpu(),
                         decoder.head_logits(p, feats[0]).float().cpu()))
            cache = kvcache.rollback(after, after.length - ctx)
        got[d] = outs
        print(f"    {d} side {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for i, name in enumerate(("chain", "tree")):
        (ct, cf, cl), (pt, pf, pl) = got[dev][i], got["cpu"][i]
        f_rel, l_rel = rel_l2(cf, pf), rel_l2(cl, pl)
        diff = max_abs(cl, pl)
        top2 = pl.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1] > diff)
        check(f_rel <= PARITY_REL and l_rel <= PARITY_REL,
              f"spec parity {name}: features rel-L2 {f_rel:.3g}, logits {l_rel:.3g}")
        check(bool(torch.isfinite(cl).all()), f"spec parity {name}: non-finite logits")
        check(bool((ct == pt)[clear].all()), f"spec parity {name}: targets {ct.tolist()} "
              f"!= cpu {pt.tolist()} at clear margins")
        out[name] = dict(features_rel_l2=f_rel, logits_rel_l2=l_rel, max_abs_diff=diff,
                         tokens_checked=int(clear.sum()), rows=len(pt))
        print(f"  {name} verify ({SPEC_PARITY_LAYERS} layers, full width, {len(pt)} rows) card "
              f"vs cpu: features rel-L2 {f_rel:.2e}, logits {l_rel:.2e}, max |diff| "
              f"{diff:.3g}, targets compared at {int(clear.sum())}/{len(pt)}", flush=True)
    return out


def phase_spec(dev, params, card_line):
    """Phase 10 on full-size qwen2-0.5b with phase 3's weights and runtime."""
    t0 = time.perf_counter()
    cfg = PRESETS["qwen2-0.5b"]
    asks = spec_prompts(cfg.vocab_size)
    out = dict(plain={})
    for bits, keys in ((8, asks), (16, ("300",))):
        plain_llm = Llm(cfg, params, dataclasses.replace(spec_rt(), prefill_act_bits=bits),
                        device=dev)
        list(plain_llm.stream(token_ids=asks["300"][:8], max_new_tokens=2))   # warm-up
        for key in keys:
            plain_llm.reset()
            ids = asks[key]
            toks = list(plain_llm.stream(token_ids=ids, max_new_tokens=SPEC_NEW))
            paths = ("chain",) if bits == 8 else ("chain", "tree")
            rows = spec_rows(plain_llm, ids, toks, paths)
            out["plain"][key, bits] = dict(
                tokens=toks, clear={pth: clear_steps(rows, pth) for pth in paths},
                prefill_s=plain_llm.perf.prefill_s, decode_tok_s=plain_llm.perf.decode_tok_s)
            print(f"  plain {key}, prefill_act_bits={bits}: decode "
                  f"{plain_llm.perf.decode_tok_s:.1f} tok/s; steps clear of the "
                  + ", ".join(f"{pth} verify: {c['steps']} of {SPEC_NEW} by its largest "
                              f"difference ({c['max_abs_diff']:.3g}), {c['step_rule']} by "
                              f"each step's" for pth, c in
                              out["plain"][key, bits]["clear"].items())
                  + f" [{card_line}]", flush=True)
    for sub, (mode, dl) in SPEC_MODES.items():
        t1 = time.perf_counter()
        llm = Llm(cfg, params, spec_rt(mode, dl), device=dev)
        must, never = SPEC_MUST[sub]
        out[sub] = {}
        bits, path = SPEC_TRACE[mode]
        for key in (("300", "repeat64") if mode == "lookahead" else ("300",)):
            pl = out["plain"][key, bits]
            out[sub][key] = spec_serve(llm, asks[key], f"({sub}) {mode} {key}", pl["tokens"],
                                       pl["clear"][path], must, never, card_line)
            out[sub][key]["equal_steps_act8"] = next(
                (i for i, (a, b) in enumerate(zip(out[sub][key]["tokens"],
                                                  out["plain"][key, 8]["tokens"])) if a != b),
                SPEC_NEW)
        if mode == "lookahead":
            check(out[sub]["repeat64"]["spec_stats"]["accepted"] > 0,
                  "lookahead: no draft accepted on the repeating prompt")
        out[sub]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    pl = out["plain"]["300", 16]
    out["hh"] = phase_spec_oracle(Llm(cfg, params, spec_rt(), device=dev), asks["300"],
                                  pl["tokens"], pl["clear"]["tree"], card_line)
    out["hh"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["ii"] = phase_spec_parity(dev, params)
    out["ii"]["seconds"] = time.perf_counter() - t1
    out["plain"] = {f"{key} act{bits}": v for (key, bits), v in out["plain"].items()}
    print("  phase 10 by sub-phase, s: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in out.items() if "seconds" in v), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 10: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 11: multimodal input on the card
# --------------------------------------------------------------------------

MM_SECTIONS = (16, 24, 24)   # Qwen2.5-VL / Omni's rope_scaling.mrope_section
MM_CAP = 2048
IMG_ID, AUD_ID = -1, -2      # the placeholders of an image and an audio run
OMNI_IMAGE = (480, 640)      # (jj): downscaled to Omni's 224 x 224
OMNI_AUDIO_S = 10            # (jj): 1,000 mel frames, 500 audio tokens
OMNI_TEXT = (17, 20)         # (jj): text tokens before the image and after the audio
VL_OMNI_GRID = (1, 16, 16)   # Omni's 224 x 224 pixels in 14-pixel patches: 64 tokens
# whisper-large-v3's encoder widths
WHISPER_L3 = AudioEncoderConfig(n_mels=128, hidden_size=1280, num_layers=32, num_heads=20,
                                ffn_size=5120, max_positions=1500)
KK_IMAGE = (700, 1036)       # (kk): grid (1, 50, 74), 25 x 37 merge units, 925 tokens
KK_STEPS = 16
LL_LAYERS, LL_PROMPT, LL_LEVELS, PLE_DIM = 2, 300, 3, 256   # (ll)
# phase 2's row of K4 at (ll)'s last per-layer PLE decode step on qwen2-7b's
# heads (28 query heads over 4 KV heads, D 128) over its int8 cache of 2,048
DECODE_ROWS_7B = [(1, 4, 7, 128, (LL_PROMPT + PARITY_STEPS - 1,))]
MM_LM_LAYERS, MM_AUDIO_LAYERS = 2, 8                          # (mm)
CLIP_VIT_L = dict(hidden=1024, heads=16, patch=14, image=224, layers=2, inter=4096)
TOWER_REL = 1e-3             # (mm): the towers, f32 on both sides
MM_QUERY = "how do cats show that they are content"
MM_DOCS = ["a purring cat is usually relaxed and content",
           "the stock market closed higher on friday",
           "dogs wag their tails when they are happy",
           "cats purr, knead and slow-blink when at ease"]
MM_YES = 89                  # the byte 'Y'
MM_NEVER = ("mnn_moe_decode", "mnn_moe_prefill", "mnn_flash_decode")


def mm_rt() -> RuntimeConfig:
    return dataclasses.replace(serving_rt(), max_seq_len=MM_CAP)


def vl_omni_encode(vlp, vcfg):
    """Omni's vision tower: its [1, 3, 224, 224] pixels cut into
    `qwen2_preprocess`'s patch layout (temporal fill 2, 14-pixel patches)."""
    p, (gt, gh, gw) = vcfg.patch_size, VL_OMNI_GRID

    def encode(pixels):
        hwc = pixels[0].permute(1, 2, 0)
        pt = torch.stack([hwc, hwc]).reshape(gt, 2, gh, p, gw, p, 3).permute(
            0, 2, 4, 1, 3, 5, 6).reshape(gt * gh * gw, -1)
        return qwen_vl_vision.qwen_vl_vision_forward(vlp, vcfg, pt, [VL_OMNI_GRID])
    return encode


def mm_inputs():
    """(jj)'s seeded image and waveform, (kk)'s image."""
    rng = np.random.default_rng(SEED + 11)
    image = rng.integers(0, 256, (*OMNI_IMAGE, 3), dtype=np.uint8)
    t = np.arange(16000 * OMNI_AUDIO_S) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 0.5 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return image, wav, rng.integers(0, 256, (*KK_IMAGE, 3), dtype=np.uint8)


def phase_omni(dev, params7, cfg7, vlp, vcfg, ap, card_line):
    """(jj): `Omni.stream_mm` of text + image + audio at qwen2-7b's 28
    layers, 32 new tokens: rows 2, 4 and 7 launched, row 6 not."""
    image, wav, _ = mm_inputs()
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    audio_proj = torch.randn((WHISPER_L3.hidden_size, cfg7.hidden_size), device=dev,
                             generator=g) * 0.02
    o = omni.Omni(cfg7, params7, mm_rt(), vision_encode=vl_omni_encode(vlp, vcfg),
                  image_token_id=IMG_ID,
                  audio_encode=lambda mel: audio_encoder.audio_encoder_forward(ap, WHISPER_L3, mel),
                  audio_proj=audio_proj, audio_token_id=AUD_ID,
                  audio_n_mels=WHISPER_L3.n_mels, device=dev)
    # each step timed on its second call (the first builds cuBLAS and cuFFT
    # plans); then one untimed request of 2 tokens (the whole-model kernel's
    # schedule for this shape is made on its first step)
    for _ in range(2):
        pixels, pre_s = synced(lambda: omni.preprocess_image(image, device=dev))
        feats, tower_s = synced(lambda: o.vision_encode(pixels))
        mel, fbank_s = synced(lambda: audio_mod.whisper_fbank(
            wav, n_mels=WHISPER_L3.n_mels, device=dev))
        afeats, audio_s = synced(lambda: o.audio_encode(mel.t()[None]))
    n_img, n_aud = feats.shape[0], afeats.shape[1]
    check(tuple(feats.shape) == (64, cfg7.hidden_size), f"(jj) tower: {tuple(feats.shape)}")
    check(tuple(mel.shape) == (100 * OMNI_AUDIO_S, WHISPER_L3.n_mels) and n_aud == 500,
          f"(jj) audio: mel {tuple(mel.shape)}, {n_aud} tokens")
    check(bool(torch.isfinite(feats).all() and torch.isfinite(afeats).all()),
          "(jj) non-finite tower output")
    rng = np.random.default_rng(SEED + 13)
    text = rng.integers(0, cfg7.vocab_size, sum(OMNI_TEXT)).tolist()
    ids = (text[:OMNI_TEXT[0]] + [IMG_ID] * n_img + [AUD_ID] * n_aud + text[OMNI_TEXT[0]:])
    list(o.stream_mm(ids, images=[image], audios=[wav], max_new_tokens=2))
    o.reset()
    build.reset_launches()
    toks = list(o.stream_mm(ids, images=[image], audios=[wav], max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    counts = read_launches("(jj) Omni.stream_mm", ("mnn_dequant_matmul_a8", "mnn_flash_prefill",
                                                   "mnn_decode_model"),
                           never=("mnn_decode_step",) + MM_NEVER)
    chunks = len(generate.prefill_buckets(len(ids), mm_rt().prefill_chunk))
    check(counts["mnn_decode_model"] == len(toks) == NEW_TOKENS,
          f"(jj) {counts['mnn_decode_model']} whole-model launches for {len(toks)} tokens")
    check(counts["mnn_flash_prefill"] == cfg7.num_layers * chunks,
          f"(jj) flash prefill {counts['mnn_flash_prefill']} != {cfg7.num_layers} x {chunks}")
    check(bool(torch.isfinite(o.last_prefill_logits).all()), "(jj) non-finite prefill logits")
    check(all(0 <= t < cfg7.vocab_size for t in toks), "(jj) token out of range")
    p = o.perf
    out = dict(prompt=dict(text=sum(OMNI_TEXT), image=n_img, audio=n_aud, total=len(ids)),
               preprocess_ms=pre_s * 1e3, tower_ms=tower_s * 1e3, fbank_ms=fbank_s * 1e3,
               audio_encoder_ms=audio_s * 1e3, prefill_s=p.prefill_s,
               prefill_tok_s=p.prefill_tok_s, decode_tok_s=p.decode_tok_s, gen_len=p.gen_len,
               prefill_chunks=chunks, launches=counts, card=card_line)
    print(f"  (jj) Omni.stream_mm, qwen2-7b x{cfg7.num_layers} + mrope {MM_SECTIONS}: prompt "
          f"{sum(OMNI_TEXT)} text + {n_img} image + {n_aud} audio = {len(ids)} | preprocess "
          f"{pre_s * 1e3:.2f} ms, tower {tower_s * 1e3:.2f} ms, fbank {fbank_s * 1e3:.2f} ms, "
          f"audio encoder {audio_s * 1e3:.2f} ms | prefill {p.prefill_s:.4f} s "
          f"({p.prefill_tok_s:.1f} tok/s) | decode {p.gen_len} tok {p.decode_tok_s:.1f} tok/s "
          f"[{card_line}]", flush=True)
    return out, dict(pixels=pixels, mel=mel, ids=ids, image=image, wav=wav,
                     audio_proj=audio_proj, omni=o)


def phase_mrope_exact(dev, params7, cfg7, vlp, vcfg, card_line):
    """(kk): the exact Qwen2.5-VL route: `qwen2_preprocess` of a 700 x 1,036
    image (25 x 37 merge units pad the 4-unit windows), the full tower,
    `splice_embeds`, one prefill at `build_mrope_positions`, then KK_STEPS
    decode steps at max(position) + 1 + s on all three components: the
    whole-model kernel with mrope phases, one launch a step."""
    _, _, image = mm_inputs()
    (vo, prep_s) = synced(lambda: vision_preprocess.qwen2_preprocess(image, device=dev))
    check(tuple(vo.grid) == (1, 50, 74) and vo.pixels.shape[0] == 3700
          and vo.num_tokens == 925, f"(kk) grid {vo.grid}, {vo.pixels.shape}, {vo.num_tokens}")
    patches = torch.from_numpy(vo.pixels).to(dev)
    feats, tower_s = synced(lambda: qwen_vl_vision.qwen_vl_vision_forward(
        vlp, vcfg, patches, [vo.grid]))
    check(tuple(feats.shape) == (925, cfg7.hidden_size) and bool(torch.isfinite(feats).all()),
          f"(kk) tower output {tuple(feats.shape)}")
    rng = np.random.default_rng(SEED + 14)
    text = rng.integers(0, cfg7.vocab_size, sum(OMNI_TEXT)).tolist()
    ids = text[:OMNI_TEXT[0]] + [IMG_ID] * 925 + text[OMNI_TEXT[0]:]
    pos = vision_encoder.build_mrope_positions(ids, IMG_ID, grid_hw=(25, 37))
    embeds = omni.splice_embeds(params7.embedding, ids, [feats], IMG_ID)
    pos_t = torch.from_numpy(pos).to(dev)
    rt = mm_rt()
    pp = generate.prefill_params_view(params7, rt)
    cache = Llm(cfg7, params7, rt, device=dev)._new_cache()
    build.reset_launches()
    zeros = torch.zeros((1, len(ids)), dtype=torch.int64, device=dev)
    (logits, cache), prefill_s = synced(lambda: decoder.forward(
        pp, cfg7, zeros, cache, inputs_embeds=embeds, position_ids=pos_t))
    tok = decode_model.lowest_argmax(logits)[:, None].long()
    nxt = int(pos.max()) + 1
    toks = []

    def steps(cache, tok):
        for s in range(KK_STEPS):
            p3 = torch.full((1, 1, 3), nxt + s, device=dev)
            (_, t), cache = decoder.forward(params7, cfg7, tok, cache, position_ids=p3,
                                            return_token=True)
            toks.append(t)
            tok = t[:, None].long()
        return cache, tok
    (cache, tok), decode_s = synced(lambda: steps(cache, tok))
    counts = read_launches("(kk) mrope prefill + decode", ("mnn_dequant_matmul_a8",
                                                          "mnn_flash_prefill", "mnn_decode_model"),
                           never=("mnn_decode_step",) + MM_NEVER)
    check(counts["mnn_decode_model"] == KK_STEPS, f"(kk) {counts['mnn_decode_model']} "
          f"whole-model launches for {KK_STEPS} steps")
    # the next step on the per-layer path (row 6) from a copy: the same mrope phases
    p3 = torch.full((1, 1, 3), nxt + KK_STEPS, device=dev)
    clone = lambda: dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                        k_scale=cache.k_scale.clone(),
                                        v_scale=cache.v_scale.clone())
    mk, _ = decoder.forward(params7, cfg7, tok, clone(), position_ids=p3, megakernel=True)
    per_layer, _ = decoder.forward(params7, cfg7, tok, clone(), position_ids=p3,
                                   megakernel=False)
    paths = rel_l2(mk, per_layer)
    check(paths <= PARITY_REL, f"(kk) whole-model vs per-layer path at mrope phases: "
          f"rel-L2 {paths:.3g}")
    out = dict(grid=list(vo.grid), patches=int(vo.pixels.shape[0]), image_tokens=925,
               prompt=len(ids), max_position=int(pos.max()), preprocess_ms=prep_s * 1e3,
               tower_ms=tower_s * 1e3, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=decode_s * 1e3 / KK_STEPS,
               megakernel_vs_per_layer_rel_l2=paths, launches=counts, card=card_line)
    print(f"  (kk) qwen2_preprocess {KK_IMAGE} -> grid {tuple(vo.grid)}, {vo.pixels.shape[0]} "
          f"patches, 925 tokens; prompt {len(ids)}, max position {int(pos.max())} | preprocess "
          f"(host) {prep_s * 1e3:.1f} ms, tower {tower_s * 1e3:.2f} ms, prefill "
          f"{prefill_s * 1e3:.2f} ms, decode {decode_s * 1e3 / KK_STEPS:.3f} ms a step | "
          f"whole-model vs per-layer path rel-L2 {paths:.2e} [{card_line}]", flush=True)
    return out


def timed_cpu(fn):
    """A CPU side for the pool: (fn(), seconds)."""
    def job():
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0
    return job


def phase_ple_deepstack(dev, params7, cfg7, pool, card_line):
    """(ll): deepstack (LL_LEVELS levels on the image rows) and a PLE table
    (PLE_DIM) at qwen2-7b widths and LL_LAYERS layers, a LL_PROMPT-token
    prefill and PARITY_STEPS decode steps on the card, then through the
    plain versions on the CPU (submitted to `pool`; the returned function
    waits for it): phase 4's bounds and token rule; the PLE steps run the
    decode-step kernel (row 6), never the whole-model kernel."""
    cfg = dataclasses.replace(cfg7, num_layers=LL_LAYERS)
    g = torch.Generator().manual_seed(SEED + 15)
    table = torch.randn((cfg.vocab_size, LL_LAYERS, PLE_DIM), generator=g) * 0.02
    proj = torch.randn((LL_LAYERS, PLE_DIM, cfg.hidden_size), generator=g) * 0.02
    ds = torch.randn((LL_LEVELS, 1, LL_PROMPT, cfg.hidden_size), generator=g) * 0.02
    ds[:, :, :100] = 0
    ds[:, :, 200:] = 0                   # the image rows 100..199 only
    cut = first_layers(params7, LL_LAYERS)
    cut = dataclasses.replace(cut, ple_table=table.to(dev), layers=dataclasses.replace(
        cut.layers, ple_proj=proj.to(dev)))
    ids = np.random.default_rng(SEED + 16).integers(0, cfg.vocab_size, LL_PROMPT).tolist()

    def prefill(llm):
        d = llm.device
        return decoder.forward(generate.prefill_params_view(llm.params, llm.rt), cfg,
                               torch.tensor([ids], device=d), llm._new_cache(),
                               deepstack=ds.to(d))

    build.reset_launches()
    card, fed, _ = greedy_trace(Llm(cfg, cut, mm_rt(), device=dev), None, None,
                                prefill=prefill)
    torch.cuda.synchronize()
    counts = read_launches("(ll) PLE + deepstack", ("mnn_dequant_matmul_a8", "mnn_flash_prefill",
                                                    "mnn_decode_step"),
                           never=("mnn_decode_model",) + MM_NEVER)
    check(counts["mnn_decode_step"] == LL_LAYERS * PARITY_STEPS,
          f"(ll) decode-step launches {counts['mnn_decode_step']}")
    cpu_params = to_device(cut, "cpu")
    job = pool.submit(timed_cpu(lambda: greedy_trace(
        Llm(cfg, cpu_params, mm_rt(), device="cpu"), None, fed, prefill=prefill)[0]))

    def finish():
        cpu, cpu_s = job.result()
        res = compare_traces(card, cpu, f"(ll) PLE dim {PLE_DIM} + deepstack x{LL_LEVELS}, "
                                        f"{LL_LAYERS} layers, full width ")
        print(f"    cpu side {cpu_s:.1f} s", flush=True)
        return dict(res, launches=counts, layers=LL_LAYERS, ple_dim=PLE_DIM,
                    ple_table_bytes=table.numel() * 4, cpu_s=cpu_s, card=card_line)
    return finish


def phase_mm_parity(dev, params7, cfg7, vlp, vcfg, ap, jj, pool, card_line):
    """(mm): the card against the plain versions on the CPU (each CPU side
    submitted to `pool`; the returned function waits for them): the full
    32-block tower on (jj)'s 256 patches, the audio encoder at
    MM_AUDIO_LAYERS layers on (jj)'s mel (rel-L2 TOWER_REL each, f32 on
    both sides), a CLIP ViT-L/14 at 2 layers on (jj)'s pixels, and the LM
    at MM_LM_LAYERS layers under (jj)'s embeddings (prefill + PARITY_STEPS
    steps, phase 4's bounds and token rule)."""
    cpu_of = lambda d: {k: v.cpu() for k, v in d.items()}
    towers = []

    def tower_pair(name, fn_card, fn_cpu):
        a = fn_card().float().cpu()
        towers.append((name, a, pool.submit(timed_cpu(fn_cpu))))

    vlp_cpu, pix = cpu_of(vlp), jj["pixels"].cpu()
    enc_cpu = vl_omni_encode(vlp_cpu, vcfg)
    tower_pair("qwen2.5-vl tower, 32 blocks, 256 patches",
               lambda: vl_omni_encode(vlp, vcfg)(jj["pixels"]), lambda: enc_cpu(pix))
    acfg = dataclasses.replace(WHISPER_L3, num_layers=MM_AUDIO_LAYERS)
    ap_cpu = cpu_of({k: v for k, v in ap.items() if not k.startswith("layers.")
                     or int(k.split(".")[1]) < MM_AUDIO_LAYERS})
    mel = jj["mel"].t()[None]
    mel_cpu = mel.cpu()
    tower_pair(f"whisper encoder, {MM_AUDIO_LAYERS} layers, {mel.shape[2]} frames",
               lambda: audio_encoder.audio_encoder_forward(ap, acfg, mel),
               lambda: audio_encoder.audio_encoder_forward(ap_cpu, acfg, mel_cpu))
    cp = vision_encoder.from_hf_clip(*vision_encoder.random_hf_clip(
        torch.Generator(device=dev).manual_seed(SEED + 17), **CLIP_VIT_L))
    cp_cpu = to_device(cp, "cpu")
    tower_pair("clip vit-l/14, 2 layers, 224 px", lambda: vision_encoder.vit_forward(cp, jj["pixels"]),
               lambda: vision_encoder.vit_forward(cp_cpu, pix))

    # the LM at MM_LM_LAYERS layers under (jj)'s spliced embeddings
    o = jj["omni"]
    embeds = omni._splice_embeds_mixed(
        params7.embedding, jj["ids"], [o.embed_image(jj["image"])], IMG_ID,
        [o.embed_audio(jj["wav"])], AUD_ID).to(torch.bfloat16)
    cfg = dataclasses.replace(cfg7, num_layers=MM_LM_LAYERS)
    cut = first_layers(params7, MM_LM_LAYERS)

    def prefill(llm):
        return generate.run_prefill_embeds(llm.params, cfg, llm.rt, embeds.to(llm.device),
                                           llm._new_cache())

    build.reset_launches()
    card, fed, _ = greedy_trace(Llm(cfg, cut, mm_rt(), device=dev), None, None,
                                prefill=prefill)
    torch.cuda.synchronize()
    counts = read_launches(f"(mm) LM, {MM_LM_LAYERS} layers", (
        "mnn_dequant_matmul_a8", "mnn_flash_prefill", "mnn_decode_model"),
        never=("mnn_decode_step",) + MM_NEVER)
    cpu_params = to_device(cut, "cpu")
    lm_job = pool.submit(timed_cpu(lambda: greedy_trace(
        Llm(cfg, cpu_params, mm_rt(), device="cpu"), None, fed, prefill=prefill)[0]))

    def finish():
        out = {}
        for name, a, job in towers:
            b, cpu_s = job.result()
            r = rel_l2(a, b.float())
            check(bool(torch.isfinite(a).all()) and r <= TOWER_REL,
                  f"(mm) {name}: rel-L2 {r:.3g} > {TOWER_REL}")
            out[name] = dict(rel_l2=r, tol=TOWER_REL, shape=list(a.shape), cpu_s=cpu_s)
            print(f"  (mm) {name}: card vs cpu rel-L2 {r:.2e} (bound {TOWER_REL}), shape "
                  f"{tuple(a.shape)}, cpu side {cpu_s:.1f} s", flush=True)
        cpu, cpu_s = lm_job.result()
        out["lm"] = dict(compare_traces(card, cpu, f"(mm) LM under (jj)'s embeddings, "
                                                   f"{MM_LM_LAYERS} layers, full width "),
                         layers=MM_LM_LAYERS, cpu_s=cpu_s)
        print(f"    LM cpu side {cpu_s:.1f} s", flush=True)
        out["card"] = card_line
        out["launches"] = counts
        return out
    return finish


def phase_embed_rerank(dev, params05, pool, card_line):
    """(nn): `Llm.embed` (last, mean) and `Llm.rerank` (yes-token, cosine)
    on full-size qwen2-0.5b, the card, then the plain versions on the CPU
    (submitted to `pool`; the returned function waits for it): vectors
    within rel-L2 5e-2, each rerank's order equal wherever the CPU's score
    gaps exceed the largest score difference."""
    cfg = PRESETS["qwen2-0.5b"]

    def run(llm):
        vecs = {pool_: torch.from_numpy(llm.embed(MM_QUERY, pooling=pool_))
                for pool_ in ("last", "mean")}
        return vecs, dict(yes=llm.rerank(MM_QUERY, MM_DOCS, yes_token_id=MM_YES),
                          cosine=llm.rerank(MM_QUERY, MM_DOCS))

    llm = Llm(cfg, params05, serving_rt(), device=dev)
    build.reset_launches()
    (cv, cs), card_s = synced(lambda: run(llm))
    counts = read_launches("(nn) embed + rerank", (
        "mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill", "mnn_dequant_matmul"),
        never=("mnn_decode_model", "mnn_decode_step") + MM_NEVER)
    check(llm.context_len == 0, "(nn) the chat cache was touched")
    cpu_params = to_device(params05, "cpu")
    job = pool.submit(timed_cpu(lambda: run(Llm(cfg, cpu_params, serving_rt(), device="cpu"))))

    def finish():
        (pv, ps), cpu_s = job.result()
        out = dict(launches=counts, card_s=card_s, cpu_s=cpu_s, card=card_line)
        for pool_ in cv:
            r = rel_l2(cv[pool_], pv[pool_])
            check(r <= PARITY_REL, f"(nn) embed {pool_}: rel-L2 {r:.3g} > {PARITY_REL}")
            out[f"embed_{pool_}_rel_l2"] = r
        for kind in cs:
            a, b = np.asarray(cs[kind]), np.asarray(ps[kind])
            diff = float(np.abs(a - b).max())
            pairs = [(i, j) for i in range(len(b)) for j in range(i + 1, len(b))
                     if abs(b[i] - b[j]) > diff]
            bad = [(i, j) for i, j in pairs if (a[i] > a[j]) != (b[i] > b[j])]
            check(not bad, f"(nn) rerank {kind}: order differs at {bad}")
            out[f"rerank_{kind}"] = dict(card=a.tolist(), cpu=b.tolist(), max_abs_diff=diff,
                                         pairs_compared=len(pairs))
        print(f"  (nn) embed rel-L2 last {out['embed_last_rel_l2']:.2e} mean "
              f"{out['embed_mean_rel_l2']:.2e}; rerank yes-token {np.round(cs['yes'], 3).tolist()} "
              f"(cpu {np.round(ps['yes'], 3).tolist()}, {out['rerank_yes']['pairs_compared']} "
              f"pairs ordered), cosine {np.round(cs['cosine'], 4).tolist()} "
              f"({out['rerank_cosine']['pairs_compared']} pairs) | card {card_s:.2f} s, cpu "
              f"{cpu_s:.1f} s [{card_line}]", flush=True)
        return out
    return finish


# the CPU sides of (ll), (mm) and (nn) run on this many threads at once,
# beside each other and the card: the plain versions are bound by the host's
# memory more than by its cores, so two streams finish sooner than one
MM_CPU_STREAMS = 2


def phase_multimodal(dev, params7, params05, card_line):
    """Phase 11, (jj) to (nn), each sub-phase with its launch counts set to
    0 before and read after. `params7`: phase 2's 28-layer qwen2-7b weights
    (W4 block 128, int4 head), served with mrope_section MM_SECTIONS. The
    card sides run first, in order; the CPU sides of (ll), (mm) and (nn) run
    in a pool of MM_CPU_STREAMS threads as they are submitted, and their
    comparisons come last."""
    t11 = time.perf_counter()
    cfg7 = dataclasses.replace(PRESETS["qwen2-7b"], mrope_section=MM_SECTIONS)
    vcfg = qwen_vl_vision.QwenVLVisionConfig()
    check(vcfg.out_hidden_size == cfg7.hidden_size, "tower width != LM width")
    t0 = time.perf_counter()
    gv = torch.Generator(device=dev).manual_seed(SEED + 18)
    vlp = qwen_vl_vision.from_hf_qwen_vl_vision(qwen_vl_vision.random_hf_state_dict(vcfg, gv))
    ap = audio_encoder.from_hf_whisper_encoder(audio_encoder.random_hf_whisper_encoder(
        WHISPER_L3, torch.Generator(device=dev).manual_seed(SEED + 19)))
    torch.cuda.synchronize()
    print(f"  towers: qwen2.5-vl {vcfg.depth} blocks x {vcfg.hidden_size}, whisper encoder "
          f"{WHISPER_L3.num_layers} x {WHISPER_L3.hidden_size}: HF-layout weights made on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    out, secs = {}, {}
    with ThreadPoolExecutor(MM_CPU_STREAMS) as pool:
        t0 = time.perf_counter()
        out["jj"], jj = phase_omni(dev, params7, cfg7, vlp, vcfg, ap, card_line)
        secs["jj"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["kk"] = phase_mrope_exact(dev, params7, cfg7, vlp, vcfg, card_line)
        secs["kk"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        finish = dict(ll=phase_ple_deepstack(dev, params7, cfg7, pool, card_line),
                      mm=phase_mm_parity(dev, params7, cfg7, vlp, vcfg, ap, jj, pool, card_line),
                      nn=phase_embed_rerank(dev, params05, pool, card_line))
        secs["card sides of ll, mm, nn"] = time.perf_counter() - t0
        del jj
        t0 = time.perf_counter()
        for sub, fn in finish.items():
            out[sub] = fn()
        secs["cpu sides, after the card's"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t11
    print("  phase 11 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 11: {out['seconds']:.1f} s", flush=True)
    return out


def mm_launches(mm: dict) -> dict:
    """Phase 11's launches by C entry, summed over (jj) to (nn)."""
    total: dict = {}
    for sub in ("jj", "kk", "ll", "mm", "nn"):
        for k, v in mm[sub]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# phase 12: training and quantization tools
# --------------------------------------------------------------------------

TRAIN_RANK, TRAIN_LR, TRAIN_STEPS = 8, 5e-3, 12
TRAIN_BATCH, TRAIN_PERIOD = (4, 256), 16    # 4 sequences of a seeded 16-token pattern
TRAIN_DROP = 0.9            # the last loss below 0.9 x the first, tests/test_train.py:55
TRAIN_PARITY_LAYERS = 2     # (pp), (rr): full width, cut depth on both sides
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_DX_REL = 1e-2, 5e-2, 1e-2
MERGE_REL = 5e-2            # W8 merged vs adapter logits, tests/test_train.py:75
AWQ_CALIB = (4, 128)        # seeded calibration ids, as the JAX CLI's default
AWQ_REL = 5e-2              # (rr): the card's conversion against the cpu's
TRAIN_M = TRAIN_BATCH[0] * TRAIN_BATCH[1]
# row 1b at the training forward's shapes: qwen2-0.5b's four projections and
# its int4 head (f32 out) at M = B x T rows
TRAIN_GEMM = ([(p, k, n, b, TRAIN_M) for p, (k, n, b) in PROJ.items()]
              + [("lm_head", 896, 151936, False, TRAIN_M)])
TOOLS_KN = (3584, 18944)    # (ss): qwen2-7b's gate (or up) projection
TOOLS_ROWS = 512            # (ss): OmniQuant's calibration rows


def train_tokens(vocab: int, dev) -> torch.Tensor:
    """(oo)'s batch: each row a seeded random 16-token pattern, repeated."""
    pat = np.random.default_rng(SEED + 20).integers(0, vocab, (TRAIN_BATCH[0], TRAIN_PERIOD))
    return torch.from_numpy(np.tile(pat, (1, TRAIN_BATCH[1] // TRAIN_PERIOD))).to(dev)


def numpy_lora(cfg, dev) -> decoder.LoraParams:
    """(pp)'s adapters, made with numpy: a ~ N(0, 1/r), b ~ N(0, 0.01^2)."""
    rng = np.random.default_rng(SEED + 21)
    fields = {}
    for name, (k, n) in lora.lora_dims(cfg).items():
        fields["a_" + name] = torch.from_numpy(
            (rng.standard_normal((cfg.num_layers, k, TRAIN_RANK)) / TRAIN_RANK ** 0.5)
            .astype(np.float32)).to(dev)
        fields["b_" + name] = torch.from_numpy(
            (rng.standard_normal((cfg.num_layers, TRAIN_RANK, n)) * 0.01)
            .astype(np.float32)).to(dev)
    return decoder.LoraParams(scaling=16.0 / TRAIN_RANK, **fields)


def loss_and_grads(params, cfg, adapters, tokens):
    """lm_loss and every adapter's gradient (the adapters are copied)."""
    lo = dataclasses.replace(adapters, **{
        f.name: getattr(adapters, f.name).clone().requires_grad_(True)
        for f in dataclasses.fields(adapters) if f.name != "scaling"})
    loss = trainer.lm_loss(params, lo, cfg, tokens)
    loss.backward()
    return float(loss.detach()), {f.name: getattr(lo, f.name).grad.float().cpu()
                                  for f in dataclasses.fields(lo) if f.name != "scaling"}


def vjp_dx(x, ql, out_dtype, g):
    """dx of `DequantMatmulFn` at rows x for the cotangent g."""
    xs = x.clone().requires_grad_(True)
    dequant_matmul.dequant_matmul(xs, ql, out_dtype=out_dtype).backward(g)
    return xs.grad.float().cpu()


def phase_train(params, cfg, pool, card_line):
    """(oo) LoRA fine-tuning at full depth, and (pp) card against CPU at
    TRAIN_PARITY_LAYERS layers (its CPU side submitted to `pool` after
    (oo))."""
    dev = params.embedding.device
    tokens = train_tokens(cfg.vocab_size, dev)
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_PARITY_LAYERS)
    p2 = first_layers(params, TRAIN_PARITY_LAYERS)
    p2_cpu = to_device(p2, "cpu")
    lora_np = numpy_lora(cfg2, "cpu")
    g = torch.Generator(device="cpu").manual_seed(SEED + 22)
    projs = [(name, getattr(p2.layers, attr).layer(0), torch.bfloat16)
             for name, attr in (("qkv", "wqkv"), ("wo", "wo"), ("wgu", "wgu"),
                                ("wdown", "wdown"))] + [("lm_head", p2.lm_head, torch.float32)]
    dx_in = [(torch.randn((TRAIN_M, ql.packed.shape[0] * 8 // ql.bits), generator=g)
              .to(torch.bfloat16), torch.randn((TRAIN_M, ql.out_features), generator=g).to(odt))
             for _, ql, odt in projs]

    def cpu_side():
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(p2_cpu, cfg2, lora_np, tokens.cpu())
        dxs = [vjp_dx(x, ql.to("cpu"), odt, gy)
               for (_, ql, odt), (x, gy) in zip(projs, dx_in)]
        return loss, grads, dxs, time.perf_counter() - t0

    # (oo) rank-8 adapters on all four targets, adamw, 12 steps
    t_oo = time.perf_counter()
    adapters = lora.init_lora(cfg, torch.Generator().manual_seed(SEED), rank=TRAIN_RANK,
                              device=dev)
    opt = trainer.make_optimizer("adamw", lr=TRAIN_LR)
    state = opt.init(adapters)
    step = trainer.make_lora_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = [], [], []
    build.reset_launches()
    for _ in range(TRAIN_STEPS):
        before = {k.name: k.launches for k in build.KERNELS}
        t0 = time.perf_counter()
        adapters, state, loss = step(params, adapters, state, tokens)
        losses.append(float(loss))          # a host read: the step's end
        secs.append(time.perf_counter() - t0)
        per_step.append({k.name: k.launches - before[k.name] for k in build.KERNELS
                         if k.launches != before[k.name]})
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches("(oo) LoRA training", ("mnn_dequant_matmul_bf16_tile",),
                             never=("mnn_flash_prefill", "mnn_dequant_matmul_a8",
                                    "mnn_decode_model", "mnn_decode_step"))
    want = {"mnn_dequant_matmul_bf16_tile": 4 * cfg.num_layers + 1}
    check(all(n == want for n in per_step),
          f"(oo) launches a step {per_step[0]}, expected {want} (every projection and the "
          f"head on the tile kernel, forward only)")
    for i, (lv, s) in enumerate(zip(losses, secs)):
        print(f"  (oo) step {i:2d}: loss {lv:.4f} | {s * 1e3:.1f} ms", flush=True)
    check(all(math.isfinite(v) for v in losses), f"(oo) non-finite loss: {losses}")
    check(losses[-1] < TRAIN_DROP * losses[0],
          f"(oo) loss {losses[0]:.4f} -> {losses[-1]:.4f}, not below {TRAIN_DROP} x the first")
    oo = dict(losses=losses, step_s=secs, peak_bytes=peak, launches=launches,
              launches_per_step=per_step[0], tokens=list(TRAIN_BATCH), rank=TRAIN_RANK,
              lr=TRAIN_LR, seconds=time.perf_counter() - t_oo)
    print(f"  (oo) {cfg.num_layers} layers, rank {TRAIN_RANK}, {TRAIN_BATCH[0]} x "
          f"{TRAIN_BATCH[1]} tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{np.median(secs[1:]) * 1e3:.1f} ms a step (median after the first); peak "
          f"{peak / 1e9:.2f} GB allocated; {per_step[0]} launches a step | {card_line}",
          flush=True)

    # (pp): its CPU side in the pool once (oo)'s steps are timed (a step is
    # host-bound, and the host's cores would be shared), then the card's
    fut = pool.submit(cpu_side)
    loss, grads = loss_and_grads(p2, cfg2, numpy_lora(cfg2, dev), tokens)
    dxs = [vjp_dx(x.to(dev), ql, odt, gy.to(dev))
           for (_, ql, odt), (x, gy) in zip(projs, dx_in)]
    loss_cpu, grads_cpu, dxs_cpu, cpu_s = fut.result()
    gap = abs(loss - loss_cpu) / abs(loss_cpu)
    grad_rel = {f: rel_l2(grads[f], grads_cpu[f]) for f in grads}
    dx_rel = {name: rel_l2(a, b) for (name, _, _), a, b in zip(projs, dxs, dxs_cpu)}
    print(f"  (pp) {TRAIN_PARITY_LAYERS} layers, card vs cpu: loss {loss:.5f} vs "
          f"{loss_cpu:.5f} (rel {gap:.2e}); adapter gradients rel-L2 max "
          f"{max(grad_rel.values()):.2e}; VJP dx rel-L2 {json.dumps(dx_rel)} at M = "
          f"{TRAIN_M}; cpu side {cpu_s:.1f} s", flush=True)
    check(gap <= TRAIN_LOSS_REL, f"(pp) loss rel {gap:.3g} > {TRAIN_LOSS_REL}")
    check(max(grad_rel.values()) <= TRAIN_GRAD_REL,
          f"(pp) adapter gradients rel-L2 {grad_rel} > {TRAIN_GRAD_REL}")
    check(max(dx_rel.values()) <= TRAIN_DX_REL, f"(pp) dx rel-L2 {dx_rel} > {TRAIN_DX_REL}")
    pp = dict(loss=loss, loss_cpu=loss_cpu, loss_rel=gap, grad_rel_l2=grad_rel,
              dx_rel_l2=dx_rel, cpu_s=cpu_s)
    return adapters, oo, pp


def phase_merge(params, cfg, adapters, card_line):
    """(qq) the trained adapters merged into the weights, at their own 4
    bits and at 8, and each merged model served. The 8-bit merge is held to
    the JAX test's bound (its weights are 8-bit); the 4-bit one is printed:
    there every weight is rounded again on a grid that the delta moved."""
    dev = params.embedding.device
    ids = prompts(cfg.vocab_size)[1]
    tok = torch.tensor([ids], device=dev)

    def prefill(p, lo):
        cache = kvcache.create(cfg.num_layers, 1, cfg.num_kv_heads, len(ids), cfg.head_dim,
                               quantized=False, device=dev)
        with torch.no_grad():
            return decoder.forward(p, cfg, tok, cache, all_logits=True, lora=lo)[0]

    want = prefill(params, adapters)
    moved = rel_l2(prefill(params, None), want)
    out = dict(adapters_moved=moved)
    for bits in (4, 8):
        merged, s = timed(lambda: lora.merge_lora(params, adapters, bits=bits))
        rel = rel_l2(prefill(merged, None), want)
        llm = Llm(cfg, merged, serving_rt(), device=dev)
        check(llm.info()["decode_megakernel"],
              f"(qq) the W{bits} merged model is not on the whole-model kernel")
        list(llm.stream(token_ids=ids[:8], max_new_tokens=2))          # warm-up
        torch.cuda.synchronize()
        build.reset_launches()
        _, perf = serve(llm, [ids], f"(qq) merged W{bits}")
        got_n = read_launches(f"(qq) merged W{bits}", PREFILL_KERNELS + ("mnn_decode_model",),
                              never=("mnn_decode_step", "mnn_flash_decode"))
        check(got_n["mnn_decode_model"] == NEW_TOKENS,
              f"(qq) {got_n['mnn_decode_model']} whole-model launches for {NEW_TOKENS} tokens")
        print(f"  (qq) merge_lora at W{bits} on the card {s:.2f} s; prefill logits of the "
              f"{len(ids)}-token request, merged vs adapters: rel-L2 {rel:.2e} (the adapters "
              f"moved them {moved:.2e} from the base model) | {card_line}", flush=True)
        out[f"w{bits}"] = dict(merge_s=s, rel_l2=rel, serve=perf, launches=got_n)
        del llm, merged
    check(out["w8"]["rel_l2"] <= MERGE_REL,
          f"(qq) W8 merged vs adapter logits rel-L2 {out['w8']['rel_l2']:.3g} > {MERGE_REL}")
    out["launches"] = {k: out["w4"]["launches"][k] + out["w8"]["launches"][k]
                       for k in out["w4"]["launches"]}
    return out


def awq_ratios(out_dir) -> list:
    with open(os.path.join(out_dir, "awq_search.json")) as f:
        return [layer["ratios"] for layer in json.load(f)["layers"]]


def phase_awq(dev, root, pool, card_line):
    """(rr) AWQ conversion on the card at full depth, its NLL beside round
    to nearest's, a served request; at TRAIN_PARITY_LAYERS layers the card's
    conversion against the CPU's (its CPU side submitted to `pool` once the
    card's conversions are timed)."""
    preset = PRESETS["qwen2-0.5b"]
    calib = np.random.default_rng(SEED + 23).integers(0, 1000, AWQ_CALIB).astype(np.int32)
    kw = dict(bits=4, block_size=128, lm_head_bits=4)
    cfg2 = dataclasses.replace(preset, num_layers=TRAIN_PARITY_LAYERS)
    hf2 = os.path.join(root, "hf2")
    write_hf_dir(cfg2, hf2, dev, CKPT_SEED)
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(preset, hf_dir, dev, CKPT_SEED)
    _, rtn_s = timed(lambda: convert_hf(hf_dir, os.path.join(root, "rtn"), device=dev, **kw))
    (cfg, _), awq_s = timed(lambda: convert_hf(hf_dir, os.path.join(root, "awq"), awq=True,
                                               calib_tokens=calib, device=dev, **kw))
    # the CPU side once the card's conversions are timed
    fut = pool.submit(timed_cpu(lambda: convert_hf(
        hf2, os.path.join(root, "awq2cpu"), awq=True, calib_tokens=calib, device="cpu", **kw)))
    ids = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, NLL_TOKENS).tolist()
    nll = {}
    for name in ("rtn", "awq"):
        _, p, _ = checkpoint.load_checkpoint(os.path.join(root, name), device=dev)
        total, count = evaluate.sequence_nll(p, cfg, ids, chunk=NLL_CHUNK)
        nll[name] = total / count
        del p
    print(f"  (rr) convert_hf on the card, {cfg.num_layers} layers: round to nearest "
          f"{rtn_s:.2f} s, AWQ (calibration {AWQ_CALIB[0]} x {AWQ_CALIB[1]}) {awq_s:.2f} s; "
          f"mean NLL of {NLL_TOKENS} seeded tokens: rtn {nll['rtn']:.5f}, awq "
          f"{nll['awq']:.5f} | {card_line}", flush=True)
    llm = Llm.from_pretrained(os.path.join(root, "awq"), rt=serving_rt(), device=dev)
    check(llm.info()["decode_megakernel"], "(rr) the AWQ model is not on the whole-model kernel")
    ids300 = prompts(cfg.vocab_size)[1]
    list(llm.stream(token_ids=ids300[:8], max_new_tokens=2))          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    _, perf = serve(llm, [ids300], "(rr) awq")
    got_n = read_launches("(rr) AWQ model", PREFILL_KERNELS + ("mnn_decode_model",),
                          never=("mnn_decode_step", "mnn_flash_decode"))
    check(got_n["mnn_decode_model"] == NEW_TOKENS,
          f"(rr) {got_n['mnn_decode_model']} whole-model launches for {NEW_TOKENS} tokens")
    del llm
    # the card's 2-layer conversion against the cpu's
    convert_hf(hf2, os.path.join(root, "awq2"), awq=True, calib_tokens=calib, device=dev, **kw)
    _, cpu_s = fut.result()
    card_r, cpu_r = awq_ratios(os.path.join(root, "awq2")), awq_ratios(os.path.join(root, "awq2cpu"))
    for i, (a, b) in enumerate(zip(card_r, cpu_r)):
        print(f"  (rr) layer {i} scale ratios, card | cpu: " + ", ".join(
            f"{k} {a[k]:.2f} | {b[k]:.2f}" for k in a), flush=True)
    logits = []
    for name, d in (("awq2", dev), ("awq2cpu", "cpu")):
        c2, p, _ = checkpoint.load_checkpoint(os.path.join(root, name), device=d)
        cache = kvcache.create(c2.num_layers, 1, c2.num_kv_heads, len(ids300), c2.head_dim,
                               quantized=False, device=d)
        with torch.no_grad():
            logits.append(decoder.forward(p, c2, torch.tensor([ids300], device=d), cache,
                                          all_logits=True)[0].float().cpu())
    rel = rel_l2(logits[0], logits[1])
    print(f"  (rr) {TRAIN_PARITY_LAYERS} layers, AWQ on the card vs the cpu ({cpu_s:.1f} s): "
          f"logits of the {len(ids300)}-token request rel-L2 {rel:.2e}", flush=True)
    check(rel <= AWQ_REL, f"(rr) card vs cpu AWQ conversion: logits rel-L2 {rel:.3g} > {AWQ_REL}")
    return dict(rtn_s=rtn_s, awq_s=awq_s, nll=nll, serve=perf, launches=got_n,
                ratios_card=card_r, ratios_cpu=cpu_r, parity_rel_l2=rel, cpu_s=cpu_s)


def phase_quant_tools(dev, card_line):
    """(ss) HQQ, ADMM and OmniQuant on one qwen2-7b-width projection
    against round to nearest; `fake_quant_weight` on the card against
    dequantize(quantize(w)), bit for bit."""
    k, n = TOOLS_KN
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    w = torch.randn((k, n), device=dev, generator=g) * 0.02
    # heavy tails: a few large weights and a few salient input channels
    w.view(-1)[torch.randint(0, k * n, (k * n // 1000,), device=dev, generator=g)] *= 8
    x = torch.randn((TOOLS_ROWS, k), device=dev, generator=g)
    x[:, torch.randint(0, k, (16,), device=dev, generator=g)] *= 20
    y_ref = x @ w
    out = {}

    def report(name, fn):
        ql_s, s = timed(fn)
        ql, sv = ql_s if isinstance(ql_s, tuple) else (ql_s, None)
        deq = dequantize(ql)
        xs = x if sv is None else x / sv
        out[name] = dict(seconds=s, weight_mse=float(((deq - w) ** 2).mean()),
                         output_mse=float(((xs @ deq - y_ref) ** 2).mean()))
        print(f"  (ss) {name:10s} {k} x {n}: {s:.3f} s | weight MSE "
              f"{out[name]['weight_mse']:.4e}, output MSE {out[name]['output_mse']:.4e}",
              flush=True)

    report("rtn", lambda: quantize(w, bits=4, block_size=128))
    report("rtn_sym", lambda: quantize(w, bits=4, block_size=128, sym=True))
    report("hqq", lambda: hqq.quantize_hqq(w, bits=4, block_size=128))
    report("admm", lambda: calibrate.admm_quantize_weight(w, bits=4, block_size=128))
    report("omniquant", lambda: omni_quant.omni_quantize(w, x, bits=4, block_size=128))
    check(out["hqq"]["weight_mse"] < out["rtn"]["weight_mse"]
          and out["admm"]["weight_mse"] < out["rtn_sym"]["weight_mse"]
          and out["omniquant"]["output_mse"] < out["rtn"]["output_mse"],
          f"(ss) a tool does not beat round to nearest: {out}")
    fq = compress.fake_quant_weight(w, bits=4, block_size=128)
    deq = dequantize(quantize(w, bits=4, block_size=128))
    check(torch.equal(fq, deq), "(ss) fake_quant_weight differs from dequantize(quantize(w))")
    print(f"  (ss) fake_quant_weight on the card: bit for bit dequantize(quantize(w)) | "
          f"{card_line}", flush=True)
    out["fake_quant_equal"] = True
    return out


def phase_training(dev, params05, card_line):
    """Phase 12, (oo) to (ss), each sub-phase with its launch counts set to
    0 before and read after; the CPU sides of (pp) and (rr) run in a pool of
    two threads while the card works."""
    t12 = time.perf_counter()
    cfg = PRESETS["qwen2-0.5b"]
    root = tempfile.mkdtemp(prefix="mnn_tpu_torch_train_")
    try:
        with ThreadPoolExecutor(2) as pool:
            adapters, oo, pp = phase_train(params05, cfg, pool, card_line)
            out = dict(oo=oo, pp=pp)
            out["qq"] = phase_merge(params05, cfg, adapters, card_line)
            del adapters
            torch.cuda.empty_cache()
            out["rr"] = phase_awq(dev, root, pool, card_line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["ss"] = phase_quant_tools(dev, card_line)
    out["seconds"] = time.perf_counter() - t12
    print(f"  phase 12: {out['seconds']:.1f} s", flush=True)
    return out


def training_launches(tr: dict) -> dict:
    """Phase 12's launches by C entry, summed over (oo), (qq) and (rr)."""
    total: dict = {}
    for sub in ("oo", "qq", "rr"):
        for k, v in tr[sub]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# phase 13: generative output (speech out, Stable Diffusion)
# --------------------------------------------------------------------------

TALKER_VOCAB = 8448          # the codec vocabulary, 66 x 128: the head fuses into row 7
TALKER_EOS = (8292, 8294)    # the JAX package's stop ids, inside it
TALKER_CAP = 2048            # the talker's bf16 cache
TALKER_NEW = 128             # (tt): the talker's max_new_tokens
SPEAK_NEW = 32               # (tt): the thinker's new tokens
MEL_STEPS = 10               # the flow-matching ODE's steps
UU_LAYERS, UU_FRAMES = 2, 16  # (uu): the talker's depth, the vocoder's mel frames
MEL_TOL, VOC_TOL = 1e-4, 1e-3  # (uu): mel and waveform, max |card - cpu|
SD_PROMPT = "a photograph of an astronaut riding a horse"
SD_SIZE, SD_STEPS, SD_CFG = 512, 20, 7.5   # (vv)
WW_LATENT, WW_REL = 32, 1e-3  # (ww): a 32 x 32 latent, f32 on both sides
XX_SIZE, XX_STEPS = 64, 3    # (xx)
GEN_NEVER = ("mnn_moe_decode", "mnn_moe_prefill", "mnn_decode_step", "mnn_flash_decode")


def launch_counts() -> dict:
    return {k.name: k.launches for k in build.KERNELS}


def counted(obj, name: str, store: dict):
    """Wrap obj.name: the launches of each call go to store[name]."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        before = launch_counts()
        out = fn(*a, **k)
        after = launch_counts()
        store[name] = {n: after[n] - before[n] for n in after}
        return out
    setattr(obj, name, wrapped)


def vocoder_weights(g, dev) -> dict:
    """BigVGAN at `VocoderConfig()` from `g`, every convolution weight at 0.75
    / sqrt(fan-in): a waveform of std about 0.15, not saturated in tanh (the
    init's 0.05 puts every sample at +-1 at this width)."""
    p = vocoder.init_vocoder_params(vocoder.VocoderConfig(), g, dev)
    return {k: v * 0.75 / (0.05 * math.sqrt(v.shape[1] * v.shape[2])) if v.dim() == 3 else v
            for k, v in p.items()}


def make_talker(dev, params, thinker_hidden, vocoder_params, denoiser, in_proj):
    """A talker on `params` (qwen2-0.5b's stack on the codec vocabulary, at
    the depth `params` has) with the conv mel denoiser and BigVGAN."""
    tm = dataclasses.replace(PRESETS["qwen2-0.5b"], vocab_size=TALKER_VOCAB,
                             num_layers=params.layers.input_norm.shape[0])
    tcfg = talker_mod.TalkerConfig(model=tm, thinker_hidden=thinker_hidden,
                                   codec_eos_ids=TALKER_EOS, max_new_tokens=TALKER_NEW)
    return talker_mod.Talker(tcfg, params, in_proj,
                             mel_denoiser=talker_mod.conv_mel_denoiser(denoiser, tcfg),
                             vocoder_params=vocoder_params, vocoder_cfg=vocoder.VocoderConfig(),
                             device=dev)


def talker_rows(tk, hidden, thinker_tokens, feed):
    """The talker's logit rows, as `generate_codec` makes them: its prefill
    over the reply's embeddings, then a decode step fed each of `feed`."""
    m, dev = tk.cfg.model, tk.device
    with no_tf32():
        embeds = hidden.to(dev).float() @ tk.in_proj
    ids = torch.as_tensor(np.asarray(thinker_tokens) % m.vocab_size, device=dev)
    embeds = embeds + tk.params.embedding[ids].float()
    cache = kvcache.create(m.num_layers, 1, m.num_kv_heads, TALKER_CAP, m.head_dim,
                           quantized=False, device=dev)
    logits, cache = decoder.forward(tk.params, m, torch.zeros(
        (1, embeds.shape[0]), dtype=torch.int64, device=dev), cache,
        inputs_embeds=embeds[None].to(torch.bfloat16))
    rows = [logits.float().cpu()]
    for tok in feed:
        logits, cache = decoder.forward(tk.params, m, torch.tensor([[tok]], device=dev), cache)
        rows.append(logits.float().cpu())
    return rows


def phase_speech(dev, params7, cfg7, card_line):
    """(tt) `Omni.respond_mm(speak=True)` on the 28-layer qwen2-7b thinker
    with a full-width talker, the mel ODE and BigVGAN; (uu) the talker at
    2 layers, the ODE and the vocoder on 16 mel frames, card against CPU."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    t0 = time.perf_counter()
    tm = dataclasses.replace(PRESETS["qwen2-0.5b"], vocab_size=TALKER_VOCAB)
    tparams = decoder.init_random_params(tm, torch.Generator().manual_seed(SEED + 31),
                                         quant_bits=4, quant_block=128, lm_head_bits=4,
                                         act_bits=16, device=dev)
    check(decode_model.supports_head(tm, tparams), "(tt) the talker's head does not fuse")
    in_proj = torch.randn((cfg7.hidden_size, tm.hidden_size), device=dev, generator=g) * 0.02
    probe = talker_mod.TalkerConfig(model=tm)
    denoiser = talker_mod.init_conv_mel_denoiser(probe, TALKER_VOCAB, g, device=dev)
    vparams = vocoder_weights(g, dev)
    tk = make_talker(dev, tparams, cfg7.hidden_size, vparams, denoiser, in_proj)
    o = omni.Omni(cfg7, params7, mm_rt(), talker=tk, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = np.random.default_rng(SEED + 13).integers(0, cfg7.vocab_size, sum(OMNI_TEXT)).tolist()
    # one untimed call first: cuBLAS and cuDNN plans, the talker cache's
    # whole-model schedule
    o.respond_mm(text, max_new_tokens=2, speak=True)
    o.reset()
    parts: dict = {}
    counted(tk, "generate_codec", parts)
    counted(tk, "token2wav", parts)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    (toks, wav), total_s = synced(lambda: o.respond_mm(text, max_new_tokens=SPEAK_NEW,
                                                       speak=True))
    counts = read_launches("(tt) Omni.respond_mm(speak=True)",
                           ("mnn_dequant_matmul_a8", "mnn_flash_prefill", "mnn_decode_model",
                            "mnn_dequant_matmul", "mnn_dequant_matmul_bf16_tile"),
                           never=GEN_NEVER)
    peak = torch.cuda.max_memory_allocated()
    talk = parts["generate_codec"]
    thinker = {k: counts[k] - talk[k] - parts["token2wav"][k] for k in counts}
    codec_n = tk.perf.codec_tokens
    chunks = len(generate.prefill_buckets(len(text), mm_rt().prefill_chunk))
    check(len(toks) == SPEAK_NEW, f"(tt) {len(toks)} thinker tokens")
    check(thinker["mnn_decode_model"] == SPEAK_NEW,
          f"(tt) thinker: {thinker['mnn_decode_model']} whole-model launches")
    check(thinker["mnn_dequant_matmul_a8"] == 4 * cfg7.num_layers * chunks
          and thinker["mnn_flash_prefill"] == cfg7.num_layers * chunks,
          f"(tt) thinker prefill launches {thinker}")
    check(talk["mnn_dequant_matmul_bf16_tile"] == 4 * tm.num_layers
          and talk["mnn_flash_prefill"] == tm.num_layers and talk["mnn_dequant_matmul"] == 1
          and talk["mnn_dequant_matmul_a8"] == 0,
          f"(tt) talker prefill launches {talk}")
    check(talk["mnn_decode_model"] == codec_n and 0 < codec_n <= TALKER_NEW,
          f"(tt) {talk['mnn_decode_model']} whole-model launches for {codec_n} codec tokens")
    check(not any(parts["token2wav"].values()), "(tt) token2wav launched a kernel")
    check(isinstance(wav, np.ndarray) and wav.dtype == np.float32 and wav.ndim == 1
          and wav.shape[0] == 2 * codec_n * 256 and bool(np.isfinite(wav).all())
          and float(np.abs(wav).max()) <= 1.0, f"(tt) wav {getattr(wav, 'shape', None)}")
    saturated = float((np.abs(wav) > 0.99).mean())
    p, tp = o.perf, tk.perf
    out = dict(thinker_prefill_s=p.prefill_s, thinker_decode_tok_s=p.decode_tok_s,
               thinker_tokens=len(toks), talker_prompt=tp.prompt_len,
               talker_prefill_s=tp.prefill_s, codec_tokens=codec_n,
               codec_tok_s=tp.codec_tok_s, mel_ms=tp.mel_s * 1e3, vocoder_ms=tp.vocoder_s * 1e3,
               samples=tp.samples, samples_per_s=tp.samples / tp.vocoder_s,
               wav_std=float(wav.std()), wav_saturated=saturated,
               total_s=total_s, peak_bytes=peak, build_s=build_s,
               launches=counts, launches_thinker=thinker, launches_talker=talk,
               card=card_line)
    print(f"  (tt) speech out: thinker qwen2-7b x{cfg7.num_layers} prefill {p.prefill_s:.4f} s "
          f"(37 tokens), decode {p.decode_tok_s:.1f} tok/s | talker x{tm.num_layers} "
          f"prefill {tp.prefill_s:.4f} s ({tp.prompt_len} positions), {codec_n} codec tokens "
          f"at {tp.codec_tok_s:.1f} tok/s | mel ODE {tp.mel_s * 1e3:.2f} ms, vocoder "
          f"{tp.vocoder_s * 1e3:.2f} ms, {tp.samples} samples ({tp.samples / tp.vocoder_s:.0f} "
          f"samples/s, std {wav.std():.3f}, {saturated:.4f} at +-1) | {total_s:.3f} s in all, "
          f"peak {peak} B [{card_line}]", flush=True)

    # (uu): card against CPU at full width, the talker cut to UU_LAYERS
    t0 = time.perf_counter()
    hidden = params7.embedding[torch.tensor(toks, device=dev)].float()
    p2 = first_layers(tparams, UU_LAYERS)
    sides = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        mv = (lambda v: v.to(d)) if side == "cpu" else (lambda v: v)
        tk2 = make_talker(d, decoder.params_to(p2, d) if side == "cpu" else p2,
                          cfg7.hidden_size, {k: mv(v) for k, v in vparams.items()},
                          {k: mv(v) for k, v in denoiser.items()}, mv(in_proj))
        codec = tk2.generate_codec(hidden.to(d), thinker_tokens=toks, max_new=PARITY_STEPS)
        sides[side] = (tk2, codec)
    (tk_card, codec_card), (tk_cpu, codec_cpu) = sides["card"], sides["cpu"]
    check(len(codec_cpu) > 0, "(uu) the CPU talker stopped at once")
    rows = {s: talker_rows(tk2_, hidden, toks, codec_cpu) for s, (tk2_, _) in sides.items()}
    par = compare_traces(rows["card"], rows["cpu"], "(uu) talker ")
    diff = par["max_abs_diff"]
    same = 0
    for s, row in enumerate(rows["cpu"][:len(codec_cpu)]):
        top2 = row[0].topk(2).values
        if float(top2[0] - top2[1]) <= diff or s >= len(codec_card):
            break
        check(codec_card[s] == codec_cpu[s], f"(uu) codec token {s}: {codec_card[s]} != "
              f"cpu {codec_cpu[s]}")
        same += 1
    mel = {s: tk2_.codec_to_mel(codec_cpu, num_steps=MEL_STEPS).cpu()
           for s, (tk2_, _) in sides.items()}
    mel_err = max_abs(mel["card"], mel["cpu"])
    check(mel_err <= MEL_TOL, f"(uu) mel ODE: max |diff| {mel_err:.3g} > {MEL_TOL}")
    frames = torch.randn((1, 80, UU_FRAMES), generator=torch.Generator().manual_seed(SEED + 32))
    wavs = {s: vocoder.vocoder_forward(tk2_.vocoder_params, vocoder.VocoderConfig(),
                                       frames.to(tk2_.device)).cpu()
            for s, (tk2_, _) in sides.items()}
    voc_err = max_abs(wavs["card"], wavs["cpu"])
    check(tuple(wavs["card"].shape) == (1, UU_FRAMES * 256) and voc_err <= VOC_TOL,
          f"(uu) vocoder: max |diff| {voc_err:.3g} > {VOC_TOL}")
    # the bound means something only where tanh has not saturated
    check(float((wavs["cpu"].abs() > 0.99).float().mean()) < 0.01
          and float(wavs["cpu"].std()) > 0.05, f"(uu) the CPU waveform is saturated or flat "
          f"(std {float(wavs['cpu'].std()):.3g})")
    uu = dict(parity=par, codec_card=codec_card, codec_cpu=codec_cpu, tokens_compared=same,
              mel_max_abs=mel_err, vocoder_max_abs=voc_err, seconds=time.perf_counter() - t0)
    print(f"  (uu) card vs cpu, talker x{UU_LAYERS}: codec {codec_card} / {codec_cpu} "
          f"({same} compared) | mel max |diff| {mel_err:.3g} | vocoder on {UU_FRAMES} frames "
          f"max |diff| {voc_err:.3g} | {uu['seconds']:.1f} s", flush=True)
    return out, uu


def sd_state_dict(params: dict, shapes: dict) -> dict:
    """Port-layout parameters back in a diffusers checkpoint's layouts
    (linears [out, in]), on the CPU."""
    return {k: (v.t() if len(shapes[k]) == 2 else v).contiguous().cpu() for k, v in params.items()}


def write_sd_dir(root: str, g) -> None:
    """A tiny diffusers-layout directory (the JAX tests' tiny UNet, VAE and
    CLIP text) written with the port's safetensors writer."""
    ucfg, vcfg = unet_mod.UNetConfig.tiny(), vae_mod.VAEConfig.tiny()
    tcfg = clip_text.ClipTextConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                    num_layers=1, num_heads=2, max_position_embeddings=8,
                                    eos_token_id=2)
    parts = {
        "unet": (unet_mod.init_unet_params(ucfg, g, "cpu"), unet_mod.param_shapes(ucfg),
                 dict(in_channels=4, out_channels=4, block_out_channels=[32, 64],
                      down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                      layers_per_block=1, cross_attention_dim=32, attention_head_dim=2,
                      norm_num_groups=8), "diffusion_pytorch_model.safetensors"),
        "vae": (vae_mod.init_vae_params(vcfg, g, "cpu"), vae_mod.param_shapes(vcfg),
                dict(latent_channels=4, block_out_channels=[16, 32], layers_per_block=1,
                     norm_num_groups=4), "diffusion_pytorch_model.safetensors"),
    }
    tp = clip_text.init_clip_text_params(tcfg, g, "cpu")
    parts["text_encoder"] = (tp, {k: tuple(v.shape) for k, v in tp.items()},
                             dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=1, num_attention_heads=2,
                                  max_position_embeddings=8, eos_token_id=2), "model.safetensors")
    for sub, (params, shapes, cfg, fname) in parts.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
        sd = sd_state_dict(params, shapes)
        if sub == "text_encoder":   # embeddings stay [rows, dim]
            sd = {("text_model." + k): (params[k].cpu() if "embedding" in k else v)
                  for k, v in sd.items()}
        stfile.save_file(sd, os.path.join(root, sub, fname))


def phase_sd(dev, card_line):
    """(vv) SD 1.5 at its published widths in bf16, txt2img 512 x 512, 20
    DDIM steps, CFG 7.5; (ww) one CFG step, the VAE decode of a 32 x 32
    latent and CLIP on 77 tokens in f32, card against CPU; (xx) `cli
    txt2img` from a tiny directory written here."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    ucfg, vcfg, tcfg = unet_mod.UNetConfig(), vae_mod.VAEConfig(), clip_text.ClipTextConfig()
    f32 = dict(unet_params=unet_mod.init_unet_params(ucfg, g, dev), unet_cfg=ucfg,
               text_params=clip_text.init_clip_text_params(tcfg, g, dev), text_cfg=tcfg,
               vae_params=vae_mod.init_vae_params(vcfg, g, dev), vae_cfg=vcfg)
    sd = StableDiffusion(**f32, scheduler="ddim", dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(v.numel() for k in ("unet_params", "text_params", "vae_params")
                   for v in f32[k].values())
    # one untimed 1-step image first: cuDNN and cuBLAS plans for these shapes
    sd.txt2img(SD_PROMPT, num_steps=1, height=SD_SIZE, width=SD_SIZE, guidance_scale=SD_CFG)
    _, enc_s = synced(lambda: sd.encode_prompt(SD_PROMPT))
    stamps, last = [], {}

    def cb(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        last["latent"] = latent

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = sd.txt2img(SD_PROMPT, num_steps=SD_STEPS, height=SD_SIZE, width=SD_SIZE,
                     guidance_scale=SD_CFG, callback=cb)
    total_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    counts = read_launches("(vv) StableDiffusion.txt2img", ())
    check(not any(counts.values()), f"(vv) a hand-written kernel ran: {counts}")
    _, dec_s = synced(lambda: vae_mod.vae_decode(sd.vae_params, vcfg,
                                                 last["latent"].to(torch.bfloat16)))
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    check(len(stamps) == SD_STEPS and bool(torch.isfinite(last["latent"]).all()),
          "(vv) non-finite latent")
    check(img.dtype == np.uint8 and img.shape == (SD_SIZE, SD_SIZE, 3), f"(vv) image {img.shape}")
    vv = dict(seconds=total_s, it_s=SD_STEPS / total_s, step_ms=step_ms,
              step_ms_median=float(np.median(step_ms)), text_encoder_ms=enc_s * 1e3,
              vae_decode_ms=dec_s * 1e3, peak_bytes=peak, params=n_params, build_s=build_s,
              image_mean=float(img.mean()), launches=counts, card=card_line)
    print(f"  (vv) SD 1.5 bf16 {SD_SIZE} x {SD_SIZE}, {SD_STEPS} DDIM steps, CFG {SD_CFG}: "
          f"{total_s:.3f} s ({vv['it_s']:.2f} it/s) | CFG step (UNet at batch 2) median "
          f"{vv['step_ms_median']:.2f} ms | text encoder {enc_s * 1e3:.2f} ms | VAE decode "
          f"{dec_s * 1e3:.2f} ms | peak {peak} B | {n_params} params [{card_line}]", flush=True)
    del sd
    torch.cuda.empty_cache()

    # (ww): f32 on both sides, the same weights
    t0 = time.perf_counter()
    cpu = {k: ({n: v.cpu() for n, v in p.items()} if k.endswith("params") else p)
           for k, p in f32.items()}
    res = {}
    lat = torch.randn((1, 4, WW_LATENT, WW_LATENT), generator=torch.Generator().manual_seed(SEED + 41))
    for side, d, parts in (("card", dev, f32), ("cpu", torch.device("cpu"), cpu)):
        s = StableDiffusion(**parts, scheduler="ddim", dtype=torch.float32, device=d)
        ids = torch.tensor([s.prompt_ids(SD_PROMPT)], device=d)
        text, _ = clip_text.clip_text_forward(s.text_params, tcfg, ids)
        ctx2 = torch.cat([s.encode_prompt(""), text])
        step = s.denoise_step(lat.to(d), 951, 901, ctx2, SD_CFG, torch.Generator())
        img = vae_mod.vae_decode(s.vae_params, vcfg, lat.to(d))
        res[side] = [x.float().cpu() for x in (text, step, img)]
        del s
    rels = {n: rel_l2(a, b) for n, a, b in zip(("clip_77", "cfg_step", "vae_decode"),
                                                res["card"], res["cpu"])}
    for n, r in rels.items():
        check(r <= WW_REL, f"(ww) {n}: rel-L2 {r:.3g} > {WW_REL}")
    ww = dict(rel_l2=rels, seconds=time.perf_counter() - t0)
    print(f"  (ww) SD 1.5 f32 card vs cpu: CLIP on 77 tokens {rels['clip_77']:.3g}, one CFG "
          f"step on a {WW_LATENT} x {WW_LATENT} latent {rels['cfg_step']:.3g}, its VAE decode "
          f"{rels['vae_decode']:.3g} | {ww['seconds']:.1f} s", flush=True)
    del cpu, f32
    torch.cuda.empty_cache()

    # (xx): the CLI on a tiny directory
    root = tempfile.mkdtemp(prefix="mnn_tpu_torch_sd_")
    try:
        write_sd_dir(root, torch.Generator().manual_seed(SEED + 42))
        out = os.path.join(root, "out.png")
        t0 = time.perf_counter()
        cli.main(["txt2img", "--model", root, "--steps", str(XX_STEPS), "--size", str(XX_SIZE),
                  "--out", out, SD_PROMPT])
        xx_s = time.perf_counter() - t0
        saved = out if os.path.exists(out) else out + ".npy"
        check(os.path.exists(saved) and os.path.getsize(saved) > 0, "(xx) no image written")
        xx = dict(seconds=xx_s, file=os.path.basename(saved), bytes=os.path.getsize(saved))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  (xx) cli txt2img {XX_SIZE} px, {XX_STEPS} steps on the card: {xx['file']} "
          f"({xx['bytes']} B) in {xx_s:.2f} s", flush=True)
    return vv, ww, xx


def phase_generative(dev, params7, card_line):
    """Phase 13, (tt) to (xx), each sub-phase with its launch counts set to
    0 before and read after."""
    t13 = time.perf_counter()
    cfg7 = dataclasses.replace(PRESETS["qwen2-7b"], mrope_section=MM_SECTIONS)
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["tt"], out["uu"] = phase_speech(dev, params7, cfg7, card_line)
    secs["tt, uu"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["vv"], out["ww"], out["xx"] = phase_sd(dev, card_line)
    secs["vv, ww, xx"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t13
    print("  phase 13 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 13: {out['seconds']:.1f} s", flush=True)
    return out


def generative_launches(gen: dict) -> dict:
    """Phase 13's launches by C entry: (tt)'s (the others launch none)."""
    return dict(gen["tt"]["launches"])


# --------------------------------------------------------------------------
# phase 14: the diffusion transformers and the CV library on the card
# --------------------------------------------------------------------------

MMDIT_LATENT = (16, 128, 128)   # (yy): a 1,024 x 1,024 image under SD3's 8x VAE
MMDIT_CTX = 333                 # 77 CLIP + 256 T5 tokens
MMDIT_STEPS, MMDIT_SHIFT, MMDIT_CFG = 4, 3.0, 7.0
SANA_LATENT = (64, 64)          # (zz): 2,048 x 2,048 under the 32x DC-AE
SANA_TEXT, SANA_STEPS, SANA_CFG = 300, 4, 4.5
DCAE_STAGES = 5                 # 2^5 = 32x
WAN_LATENT = (5, 60, 104)       # (aaa): 7,800 tokens at the (1, 2, 2) patch
WAN_TEXT, WAN_LIVE, WAN_STEPS, WAN_CFG = 512, 40, 2, 5.0
WAN_VAE_STAGES = 3              # 8x: 60 x 104 -> 480 x 832
DIT_PARITY_BLOCKS = 2           # (bbb): full widths, cut depth on both sides
DIT_REL = 1e-3
CV_SIZE = (1080, 1920)          # (ccc)
CV_REL = 1e-5
CV_RUNS = 5                     # (ccc): timed calls of ImageProcess
CV_MIN_LABELS = 100             # (ccc): the blob mask's components, at least
IP_SIZE = (224, 224)


def lin_ops(tokens: int, din: int, dout: int) -> float:
    return 2.0 * tokens * din * dout


def mmdit_ops(cfg, n_img: int, n_ctx: int, batch: int) -> float:
    """Multiply-adds x 2 of one `mmdit_forward`: every linear on its rows,
    and QK^T and AV over the joint stream."""
    d, cp = cfg.hidden_size, cfg.in_channels * cfg.patch_size ** 2
    ops = lin_ops(n_img, cp, d) + lin_ops(n_ctx, cfg.context_dim, d) + lin_ops(n_img, d, cp)
    for i in range(cfg.depth):
        last = i == cfg.depth - 1
        ops += lin_ops(n_img, d, 12 * d) + lin_ops(n_ctx, d, (3 if last else 12) * d)
        ops += 4.0 * (n_img + n_ctx) ** 2 * d
    return ops * batch


def sana_ops(cfg, n: int, n_text: int, batch: int) -> float:
    d, e = cfg.dim, int(cfg.dim * cfg.ffn_expand)
    hd = d // cfg.num_heads
    ops = lin_ops(n, cfg.in_channels, d) * 2 + lin_ops(n_text, cfg.text_dim, d)
    per = (lin_ops(n, d, 4 * d) + 4.0 * n * hd * d      # q k v o, K^T V and the product
           + lin_ops(n, d, 2 * d) + lin_ops(n_text, d, 2 * d) + 4.0 * n * n_text * d
           + lin_ops(n, d, 2 * e) + 18.0 * n * 2 * e + lin_ops(n, e, d))
    return (ops + cfg.depth * per) * batch


def wan_ops(cfg, n: int, n_text: int, batch: int) -> float:
    d, e = cfg.dim, int(cfg.dim * cfg.ffn_expand)
    pdim = int(np.prod(cfg.patch)) * cfg.in_channels
    ops = lin_ops(n, pdim, d) * 2 + lin_ops(n_text, cfg.text_dim, d)
    per = (lin_ops(n, d, 4 * d) + 4.0 * n * n * d
           + lin_ops(n, d, 2 * d) + lin_ops(n_text, d, 2 * d) + 4.0 * n * n_text * d
           + lin_ops(n, d, e) + lin_ops(n, e, d))
    return (ops + cfg.depth * per) * batch


def bf16_params(params: dict) -> dict:
    return {k: v.to(torch.bfloat16) for k, v in params.items()}


def stamped_run(fn):
    """fn(callback) on the card: (its result, seconds from the start to each
    callback, the total seconds), each stamp after a synchronize."""
    stamps = []

    def cb(i, latent):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(cb)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return out, [b - a for a, b in zip([t0] + stamps, stamps)], t1 - stamps[-1], t1 - t0


def phase_mmdit(dev, card_line):
    """(yy) SD3-medium's MMDiT at `MMDiTConfig()` in bf16 weights (f32
    products), a 16 x 128 x 128 latent and 333 context tokens, CFG at batch
    2, 4 flow-matching Euler steps at shift 3."""
    cfg = mmdit.MMDiTConfig()
    t0 = time.perf_counter()
    p = bf16_params(mmdit.init_mmdit_params(cfg, torch.Generator(dev).manual_seed(SEED + 50), dev))
    torch.cuda.empty_cache()
    n_params = sum(v.numel() for v in p.values())
    gen = torch.Generator().manual_seed(SEED + 51)
    ctx2 = sched_noise(gen, (2, MMDIT_CTX, cfg.context_dim), dev).to(torch.bfloat16)
    pooled2 = sched_noise(gen, (2, cfg.pooled_dim), dev).to(torch.bfloat16)
    x0 = sched_noise(gen, (1, *MMDIT_LATENT), dev)
    build_s = time.perf_counter() - t0
    sch = FlowMatchEulerScheduler(shift=MMDIT_SHIFT)
    sch.set_timesteps(MMDIT_STEPS)

    def run(cb, steps=MMDIT_STEPS):
        x = x0
        for i in range(steps):
            v = mmdit.mmdit_forward(p, cfg, torch.cat([x, x]).to(torch.bfloat16),
                                    float(sch.timesteps[i]), ctx2, pooled2).float()
            v_u, v_c = v.chunk(2)
            x = sch.step_index(v_u + MMDIT_CFG * (v_c - v_u), i, x)
            cb(i, x)
        return x

    run(lambda i, x: None, 1)          # cuBLAS plans for these shapes
    torch.cuda.reset_peak_memory_stats()
    x, step_s, _, total_s = stamped_run(run)
    peak = torch.cuda.max_memory_allocated()
    check(tuple(x.shape) == (1, *MMDIT_LATENT) and bool(torch.isfinite(x).all()),
          "(yy) MMDiT latent not finite")
    n_img = (MMDIT_LATENT[1] // cfg.patch_size) * (MMDIT_LATENT[2] // cfg.patch_size)
    ops = mmdit_ops(cfg, n_img, MMDIT_CTX, 2)
    step_ms = [s * 1e3 for s in step_s]
    med = float(np.median(step_ms))
    yy = dict(step_ms=step_ms, step_ms_median=med, tflop_step=ops / 1e12,
              tflop_s=ops / (med * 1e-3) / 1e12, peak_bytes=peak, params=n_params,
              seconds=total_s, build_s=build_s, image_tokens=n_img, card=card_line)
    print(f"  (yy) MMDiT (SD3-medium, {cfg.depth} blocks of {cfg.hidden_size}) bf16 weights, "
          f"latent {MMDIT_LATENT}, {n_img} + {MMDIT_CTX} tokens, CFG {MMDIT_CFG} at batch 2, "
          f"{MMDIT_STEPS} flow-match steps (shift {MMDIT_SHIFT}): median {med:.2f} ms a step, "
          f"{ops / 1e12:.2f} TFLOP a step, {yy['tflop_s']:.2f} TFLOP/s | peak {peak} B | "
          f"{n_params} params [{card_line}]", flush=True)
    del p
    torch.cuda.empty_cache()
    return yy


def phase_sana(dev, card_line):
    """(zz) Sana at `SanaConfig()` in bf16 weights: a 64 x 64 x 32 latent
    and 300 text tokens, `SanaPipeline` for 4 steps and the DC-AE decode at
    32x (the init's width 32, 5 stages)."""
    cfg = sana.SanaConfig()
    g = torch.Generator(dev).manual_seed(SEED + 52)
    p = bf16_params(sana.init_sana_params(cfg, g, dev))
    dc = bf16_params(sana.init_dcae_decoder(g, latent_ch=cfg.in_channels, stages=DCAE_STAGES,
                                            device=dev))
    gen = torch.Generator().manual_seed(SEED + 53)
    text = sched_noise(gen, (1, SANA_TEXT, cfg.text_dim), dev)
    uncond = sched_noise(gen, (1, SANA_TEXT, cfg.text_dim), dev)
    pipe = sana.SanaPipeline(cfg, p, dc, dcae_stages=DCAE_STAGES)
    kw = dict(latent_hw=SANA_LATENT, guidance=SANA_CFG, seed=SEED)
    pipe(text, uncond, steps=1, **kw)  # cuBLAS / cuDNN plans for these shapes
    torch.cuda.reset_peak_memory_stats()
    img, step_s, dec_s, total_s = stamped_run(
        lambda cb: pipe(text, uncond, steps=SANA_STEPS, callback=cb, **kw))
    peak = torch.cuda.max_memory_allocated()
    side = SANA_LATENT[0] * 2 ** DCAE_STAGES
    check(tuple(img.shape) == (1, side, side, 3) and bool(torch.isfinite(img).all()),
          f"(zz) Sana image {tuple(img.shape)}")
    n = SANA_LATENT[0] * SANA_LATENT[1]
    ops = sana_ops(cfg, n, SANA_TEXT, 2)
    step_ms = [s * 1e3 for s in step_s]
    med = float(np.median(step_ms))
    zz = dict(step_ms=step_ms, step_ms_median=med, decode_ms=dec_s * 1e3, seconds=total_s,
              tflop_step=ops / 1e12, tflop_s=ops / (med * 1e-3) / 1e12, peak_bytes=peak,
              params=sum(v.numel() for v in p.values()), image=side, card=card_line)
    print(f"  (zz) Sana ({cfg.depth} blocks of {cfg.dim}) bf16 weights, latent "
          f"{SANA_LATENT} x {cfg.in_channels}, {SANA_TEXT} text tokens, {SANA_STEPS} steps: "
          f"median {med:.2f} ms a CFG step, {zz['tflop_s']:.2f} TFLOP/s | DC-AE decode to "
          f"{side} x {side}: {dec_s * 1e3:.2f} ms | peak {peak} B [{card_line}]", flush=True)
    del p, dc, pipe
    torch.cuda.empty_cache()
    return zz


def wan_mask(dev) -> torch.Tensor:
    m = torch.zeros((1, WAN_TEXT), device=dev)
    m[:, :WAN_LIVE] = 1
    return m


def phase_wan(dev, card_line):
    """(aaa) Wan 2.1 at `WanConfig()` in bf16 weights: a (5, 60, 104) latent
    (7,800 tokens), 512 text tokens of which 40 live under the mask,
    `WanPipeline` for 2 steps and the causal 3-D VAE decode (width 16, 3
    spatial stages: 10 frames of 480 x 832)."""
    cfg = wan.WanConfig()
    g = torch.Generator(dev).manual_seed(SEED + 54)
    p = bf16_params(wan.init_wan_params(cfg, g, dev))
    vae = bf16_params(wan.init_wan_vae(g, latent_ch=cfg.in_channels, width=16,
                                       spatial_stages=WAN_VAE_STAGES, device=dev))
    gen = torch.Generator().manual_seed(SEED + 55)
    text = sched_noise(gen, (1, WAN_TEXT, cfg.text_dim), dev)
    uncond = sched_noise(gen, (1, WAN_TEXT, cfg.text_dim), dev)
    pipe = wan.WanPipeline(cfg, p, vae, vae_stages=WAN_VAE_STAGES)
    kw = dict(latent_thw=WAN_LATENT, guidance=WAN_CFG, seed=SEED, text_mask=wan_mask(dev))
    pipe(text, uncond, steps=1, **kw)  # cuBLAS / cuDNN plans for these shapes
    torch.cuda.reset_peak_memory_stats()
    vid, step_s, dec_s, total_s = stamped_run(
        lambda cb: pipe(text, uncond, steps=WAN_STEPS, callback=cb, **kw))
    peak = torch.cuda.max_memory_allocated()
    t, h, w = WAN_LATENT
    want = (1, 2 * t, h * 2 ** WAN_VAE_STAGES, w * 2 ** WAN_VAE_STAGES, 3)
    check(tuple(vid.shape) == want and bool(torch.isfinite(vid).all()),
          f"(aaa) Wan frames {tuple(vid.shape)}")
    pt, ph, pw = cfg.patch
    n = (t // pt) * (h // ph) * (w // pw)
    ops = wan_ops(cfg, n, WAN_TEXT, 2)
    step_ms = [s * 1e3 for s in step_s]
    med = float(np.median(step_ms))
    aaa = dict(step_ms=step_ms, step_ms_median=med, decode_ms=dec_s * 1e3, seconds=total_s,
               tokens=n, tflop_step=ops / 1e12, tflop_s=ops / (med * 1e-3) / 1e12,
               peak_bytes=peak, params=sum(v.numel() for v in p.values()), frames=want[1:4],
               card=card_line)
    print(f"  (aaa) Wan ({cfg.depth} blocks of {cfg.dim}) bf16 weights, latent {WAN_LATENT} "
          f"({n} tokens), {WAN_TEXT} text tokens ({WAN_LIVE} live), {WAN_STEPS} steps: median "
          f"{med:.2f} ms a CFG step, {ops / 1e12:.2f} TFLOP a step, {aaa['tflop_s']:.2f} "
          f"TFLOP/s | 3-D VAE decode to {want[1]} x {want[2]} x {want[3]}: {dec_s * 1e3:.2f} "
          f"ms | peak {peak} B [{card_line}]", flush=True)
    del p, vae, pipe
    torch.cuda.empty_cache()
    return aaa


def phase_dit_parity(dev):
    """(bbb) f32 on both sides, card against CPU: each DiT at its full
    widths and 2 blocks, one CFG forward at batch 2 on a small latent, and
    both decoders."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 56)
    cpu = torch.device("cpu")
    runs = {}
    mcfg = dataclasses.replace(mmdit.MMDiTConfig(), depth=DIT_PARITY_BLOCKS)
    scfg = dataclasses.replace(sana.SanaConfig(), depth=DIT_PARITY_BLOCKS)
    wcfg = dataclasses.replace(wan.WanConfig(), depth=DIT_PARITY_BLOCKS)
    g = torch.Generator(dev).manual_seed(SEED + 57)
    params = {"mmdit": mmdit.init_mmdit_params(mcfg, g, dev),
              "sana": sana.init_sana_params(scfg, g, dev),
              "wan": wan.init_wan_params(wcfg, g, dev),
              "dcae": sana.init_dcae_decoder(g, latent_ch=scfg.in_channels, stages=DCAE_STAGES,
                                             device=dev),
              "wan_vae": wan.init_wan_vae(g, latent_ch=wcfg.in_channels, width=16,
                                          spatial_stages=WAN_VAE_STAGES, device=dev)}
    shapes = {
        "mmdit": ((2, mcfg.in_channels, 32, 32), (2, MMDIT_CTX, mcfg.context_dim),
                  (2, mcfg.pooled_dim)),
        "sana": ((2, 16, 16, scfg.in_channels), (2, SANA_TEXT, scfg.text_dim)),
        "wan": ((2, 2, 16, 16, wcfg.in_channels), (2, WAN_TEXT, wcfg.text_dim)),
        "dcae": ((1, 16, 16, scfg.in_channels),),
        "wan_vae": ((1, 2, 16, 16, wcfg.in_channels),),
    }
    inputs = {k: [sched_noise(gen, s, cpu) for s in v] for k, v in shapes.items()}
    mask = torch.cat([wan_mask(cpu), torch.ones((1, WAN_TEXT))])
    calls = {
        "mmdit": lambda p, x, c, pl: mmdit.mmdit_forward(p, mcfg, x, 951.0, c, pl),
        "sana": lambda p, x, c: sana.sana_forward(p, scfg, x, torch.full((2,), 951.0,
                                                                         device=x.device), c),
        "wan": lambda p, x, c: wan.wan_forward(p, wcfg, x, torch.full((2,), 951.0,
                                                                      device=x.device), c,
                                               mask.to(x.device)),
        "dcae": lambda p, z: sana.dcae_decode(p, z, stages=DCAE_STAGES),
        "wan_vae": lambda p, z: wan.wan_vae_decode(p, z, spatial_stages=WAN_VAE_STAGES),
    }
    for name, fn in calls.items():
        card = fn(params[name], *[a.to(dev) for a in inputs[name]]).cpu()
        p_cpu = {k: v.cpu() for k, v in params[name].items()}
        t1 = time.perf_counter()
        want = fn(p_cpu, *inputs[name])
        r = rel_l2(card, want)
        check(bool(torch.isfinite(card).all()) and r <= DIT_REL,
              f"(bbb) {name}: rel-L2 {r:.3g} > {DIT_REL}")
        runs[name] = dict(rel_l2=r, shape=list(want.shape), cpu_s=time.perf_counter() - t1)
    del params
    torch.cuda.empty_cache()
    bbb = dict(runs=runs, seconds=time.perf_counter() - t0)
    print(f"  (bbb) f32 card vs cpu, {DIT_PARITY_BLOCKS} blocks at full widths: " + ", ".join(
        f"{k} {v['rel_l2']:.3g}" for k, v in runs.items()) + f" | {bbb['seconds']:.1f} s",
        flush=True)
    return bbb


def cv_inputs(img: torch.Tensor, dev) -> tuple:
    """(ccc)'s inputs, made on the CPU from one seeded uint8 RGB image, and
    the same tensors on `dev`: its gray, a [0, 1) float copy, a second
    image, a mask, NV12 planes, and a blob mask (the blurred gray above
    147: about a tenth of the pixels, in components of tens of pixels, not
    one spanning cluster)."""
    img = img.cpu()
    gray = cvlib.rgb_to_gray(img)
    blurred = cvlib.gaussian_blur(gray, (7, 7), 0.0)
    cpu = dict(img=img, gray=gray, fimg=img.float() / 255.0, img2=img.flip(0),
               mask=(gray > 127).to(torch.uint8), binary=(blurred > 147).to(torch.uint8),
               uv=img[::2, ::2, :2].contiguous())
    return {k: v.to(dev) for k, v in cpu.items()}, cpu


CV_ROT = np.array([[0.8, 0.45, -100.0], [-0.45, 0.8, 400.0]], np.float32)
CV_IP = dict(source_format="bgr", mean=(123.675, 116.28, 103.53),
             normal=(1 / 58.395, 1 / 57.12, 1 / 57.375), target_size=IP_SIZE)
# (ccc): name -> (bound kind, the call on a side's inputs)
CV_CASES = {
    "cvt_color": ("int", lambda d: [cvlib.cvt_color(d["img"], "rgb", "bgr"),
                                    cvlib.cvt_color(d["img"], "bgr", "gray"),
                                    cvlib.cvt_color(d["gray"], "gray", "rgb"),
                                    cvlib.cvt_color(cvlib.cvt_color(d["img"], "rgb", "rgba"), "rgba",
                                                 "rgb")]),
    "rgb_to_bgr": ("int", lambda d: cvlib.rgb_to_bgr(d["img"])),
    "rgb_to_gray": (("int", "float"), lambda d: [cvlib.rgb_to_gray(d["img"]),
                                                 cvlib.rgb_to_gray(d["fimg"])]),
    "yuv_nv12_to_rgb": ("int", lambda d: cvlib.yuv_nv12_to_rgb(d["gray"], d["uv"])),
    "yuv_nv21_to_rgb": ("int", lambda d: cvlib.yuv_nv21_to_rgb(d["gray"], d["uv"])),
    "crop": ("int", lambda d: cvlib.crop(d["img"], 100, 200, 500, 700)),
    "center_crop": ("int", lambda d: cvlib.center_crop(d["img"], (720, 1280))),
    "flip": ("int", lambda d: [cvlib.flip(d["img"]), cvlib.flip(d["img"], False)]),
    "rotate90": ("int", lambda d: cvlib.rotate90(d["img"], 3)),
    "pad": ("int", lambda d: cvlib.pad(d["img"], 4, 8, 16, 0, 114)),
    "resize": ("resample", lambda d: [cvlib.resize(d["img"], (540, 960)),
                                      cvlib.resize(d["img"], (1440, 2560)),
                                      cvlib.resize(d["gray"], (333, 777), "nearest")]),
    "warp_affine": ("resample", lambda d: [cvlib.warp_affine(d["img"], CV_ROT, (1080, 1920)),
                                           cvlib.warp_affine(d["img"], CV_ROT, (720, 1280),
                                                          method="nearest", fill=7.0)]),
    "filter2d": ("float", lambda d: cvlib.filter2d(d["img"], np.array(
        [[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32))),
    "sep_filter2d": ("float", lambda d: cvlib.sep_filter2d(d["gray"], [1.0, 2.0, 1.0],
                                                        [0.5, 0.0, -0.5])),
    "gaussian_blur": ("float", lambda d: [cvlib.gaussian_blur(d["img"], (5, 5), 0.0),
                                          cvlib.gaussian_blur(d["img"], (9, 9), 2.0)]),
    "box_filter": ("float", lambda d: cvlib.box_filter(d["img"], (5, 5))),
    "blur": ("float", lambda d: cvlib.blur(d["fimg"], (3, 3))),
    "sqr_box_filter": ("float", lambda d: cvlib.sqr_box_filter(d["gray"], (3, 3))),
    "sobel": ("float", lambda d: [cvlib.sobel(d["gray"], 1, 0), cvlib.sobel(d["gray"], 0, 2, 5)]),
    "scharr": ("float", lambda d: cvlib.scharr(d["gray"], 1, 0)),
    "laplacian": ("float", lambda d: [cvlib.laplacian(d["gray"]), cvlib.laplacian(d["gray"], 3)]),
    "spatial_gradient": ("float", lambda d: list(cvlib.spatial_gradient(d["gray"]))),
    "erode": ("int", lambda d: cvlib.erode(d["img"], cvlib.get_structuring_element(2, (5, 5)))),
    "dilate": ("int", lambda d: cvlib.dilate(d["gray"], cvlib.get_structuring_element(1, (3, 3)))),
    "morphology_ex": ("float", lambda d: [cvlib.morphology_ex(d["gray"], op, np.ones((3, 3)))
                                          for op in ("open", "close", "gradient", "tophat",
                                                     "blackhat")]),
    "pyr_down": ("float", lambda d: cvlib.pyr_down(d["img"])),
    "pyr_up": ("float", lambda d: cvlib.pyr_up(d["gray"][:540, :960])),
    "bilateral_filter": ("float", lambda d: cvlib.bilateral_filter(d["img"], 5, 30.0, 2.0)),
    "calc_hist": ("int", lambda d: [cvlib.calc_hist(d["img"], c) for c in range(3)]
                  + [cvlib.calc_hist(d["gray"], bins=32, mask=d["mask"])]),
    "equalize_hist": ("int", lambda d: cvlib.equalize_hist(d["gray"])),
    "threshold": ("int", lambda d: [cvlib.threshold(d["gray"], 100.0, 255.0, t) for t in range(5)]),
    "adaptive_threshold": ("int", lambda d: [cvlib.adaptive_threshold(d["gray"], 255.0, 0, 0, 5, 2.5),
                                             cvlib.adaptive_threshold(d["gray"], 255.0, 1, 1, 5, 3.0)]),
    "integral": ("float", lambda d: cvlib.integral(d["gray"])),
    "blend_linear": ("float", lambda d: cvlib.blend_linear(d["img"], d["img2"], d["fimg"][..., 0],
                                                        d["fimg"][..., 1])),
    "connected_components": ("int", lambda d: cvlib.connected_components(d["binary"])),
    "connected_components_with_stats": (("int", "int", "int", "float"), lambda d: list(
        cvlib.connected_components_with_stats(d["binary"], 4))),
    "ImageProcess": ("resample", lambda d: cvlib.ImageProcess(cvlib.ImageProcessConfig(
        source_format="bgr", target_size=IP_SIZE))(d["img"])),
}
# exported but not run on the card: the codecs (PIL, not on the card's
# machine), host-side numpy geometry, and the small kernel helpers (CPU
# tensors; every filter above runs them)
CV_HOST = {"imread", "imwrite", "bounding_rect", "box_points", "contour_area", "convex_hull",
           "min_area_rect", "get_affine_transform", "get_deriv_kernels", "get_gaussian_kernel",
           "get_structuring_element", "ImageProcessConfig"}


def flat_outputs(out) -> list:
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in flat_outputs(x)]
    return [out if isinstance(out, torch.Tensor) else torch.tensor(out)]


CV_BOUNDS = {"int": 0.0, "resample": 1.0, "float": CV_REL}


def cv_compare(name, kinds, card, cpu) -> dict:
    """The largest difference of each kind (levels for ints and uint8
    resamples, rel-L2 for floats) over a case's outputs; fails past its
    bound. `kinds`: one kind for every output, or one for each."""
    card, cpu = flat_outputs(card), flat_outputs(cpu)
    kinds = [kinds] * len(cpu) if isinstance(kinds, str) else list(kinds)
    check(len(card) == len(cpu) == len(kinds), f"(ccc) {name}: {len(card)} outputs")
    worst = {}
    for kind, a, b in zip(kinds, card, cpu):
        a = a.cpu()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"(ccc) {name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if kind == "float":
            d = rel_l2(a, b)
        else:
            d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        check(d <= CV_BOUNDS[kind], f"(ccc) {name}: {d:.3g} > {CV_BOUNDS[kind]} ({kind})")
        worst[kind] = max(worst.get(kind, 0.0), d)
    return worst


def phase_cv(dev, card_line):
    """(ccc) every exported `cv` function on a seeded 1,080 x 1,920 x 3
    uint8 image, card against CPU; `ImageProcess` to a 224 x 224 NCHW
    input, ms a call; `solve_pnp` on the card against the CPU."""
    t0 = time.perf_counter()
    exported = set(cvlib.__all__) | {n for n in dir(cvlib) if not n.startswith("_")
                                     and callable(getattr(cvlib, n))}
    missing = sorted(exported - set(CV_CASES) - CV_HOST - {"ImageProcess"})
    check(not missing, f"(ccc) exported functions not run: {missing}")
    g = torch.Generator(dev).manual_seed(SEED + 58)
    img = torch.randint(0, 256, (*CV_SIZE, 3), generator=g, device=dev, dtype=torch.uint8)
    sides = dict(zip(("card", "cpu"), cv_inputs(img, dev)))
    rows = {}
    for name, (kind, fn) in CV_CASES.items():
        fn(sides["card"])                         # plans, caches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card = fn(sides["card"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        cpu = fn(sides["cpu"])
        cpu_ms = (time.perf_counter() - t1) * 1e3
        rows[name] = dict(worst=cv_compare(name, kind, card, cpu), ms=ms, cpu_ms=cpu_ms)
    n_cc = int(cvlib.connected_components(sides["card"]["binary"])[0])
    check(n_cc > CV_MIN_LABELS, f"(ccc) only {n_cc} labels in the blob mask")
    ip = cvlib.ImageProcess(cvlib.ImageProcessConfig(**CV_IP))
    ip(img)
    times = []
    for _ in range(CV_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ip(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    check(tuple(out.shape) == (1, 3, *IP_SIZE), f"(ccc) ImageProcess {tuple(out.shape)}")
    # solve_pnp: a known pose from 12 seeded points, half a pixel of noise
    r = np.random.default_rng(SEED + 59)
    obj = r.uniform(-1, 1, (12, 3)).astype(np.float32)
    cam = np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]], np.float32)
    rvec, tvec = np.array([0.2, -0.1, 0.05], np.float32), np.array([0.1, -0.2, 5.0], np.float32)
    pts = (calib3d._project(torch.from_numpy(obj), torch.from_numpy(rvec), torch.from_numpy(tvec),
                            torch.from_numpy(cam)).numpy() + r.normal(0, 0.5, (12, 2)))
    pnp_ms = []
    for _ in range(2):      # the first call pays for cuSOLVER's and torch.func's set-up
        t1 = time.perf_counter()
        pose_card = calib3d.solve_pnp(obj, pts, cam, device=dev)
        pnp_ms.append((time.perf_counter() - t1) * 1e3)
    pose_cpu = calib3d.solve_pnp(obj, pts, cam, device="cpu")
    pnp_diff = max(float(np.abs(a - b).max()) for a, b in zip(pose_card, pose_cpu))
    check(pnp_diff <= 1e-3 and float(np.abs(pose_card[1] - tvec).max()) < 0.1,
          f"(ccc) solve_pnp: card vs cpu {pnp_diff:.3g}")
    ccc = dict(rows=rows, labels=n_cc, image_process_ms=times,
               image_process_ms_median=float(np.median(times)), solve_pnp_ms=pnp_ms,
               solve_pnp_diff=pnp_diff, seconds=time.perf_counter() - t0, card=card_line)
    worst = {k: max((v["worst"].get(k, 0.0) for v in rows.values()), default=0.0)
             for k in CV_BOUNDS}
    print(f"  (ccc) cv on a {CV_SIZE[0]} x {CV_SIZE[1]} x 3 image, {len(rows)} functions card "
          f"vs cpu: ints equal ({worst['int']:.3g}), uint8 resamples within "
          f"{worst['resample']:.3g} level, floats within rel-L2 {worst['float']:.3g}; "
          f"{n_cc} components | ImageProcess {CV_SIZE[0]}p -> {IP_SIZE[0]} NCHW median "
          f"{ccc['image_process_ms_median']:.3f} ms a call | solve_pnp {pnp_ms[1]:.1f} ms "
          f"(first call {pnp_ms[0]:.1f}), "
          f"card vs cpu {pnp_diff:.3g} | {ccc['seconds']:.1f} s [{card_line}]", flush=True)
    print("  (ccc) card ms a call: " + ", ".join(f"{k} {v['ms']:.3f}" for k, v in rows.items()),
          flush=True)
    return ccc


def native_stfile_check(paths) -> dict:
    """Every tensor of each safetensors file through the native reader and
    through `convert/stfile`: the same names, dtypes, shapes and bytes."""
    t0 = time.perf_counter()
    native.load(raise_on_error=True)
    n = nbytes = 0
    for path in paths:
        ref = stfile.StFile(path)
        with native.StFile(path) as nf:
            check(nf.names == ref.names and nf.metadata() == ref.metadata(),
                  f"native StFile: {path}: names or metadata differ")
            for name in ref.names:
                a, b = nf.tensor(name), ref.tensor(name)
                check(a.dtype == b.dtype and a.shape == b.shape
                      and torch.equal(a.reshape(-1).view(torch.uint8),
                                      b.reshape(-1).view(torch.uint8)),
                      f"native StFile: {path}: {name} differs")
                n += 1
                nbytes += b.numel() * b.element_size()
        ref.close()
    return dict(files=len(paths), tensors=n, bytes=nbytes, seconds=time.perf_counter() - t0)


def phase_native(ckpt_check: dict, specd: dict, native_indexes: int):
    """(ddd) the library built from `native/` (a failed build fails), phase
    6's checkpoint read by the native `StFile` to the same bytes as
    `convert/stfile`, and phase 10 (cc)'s lookahead through the native
    n-gram index."""
    t0 = time.perf_counter()
    native.load(raise_on_error=True)
    check(native.available(), "(ddd) native library unavailable")
    check(native_indexes > 0, "(ddd) phase 10's lookahead did not take the native index")
    cc = {key: dict(equal_steps=run["equal_steps"], spec_stats=run["spec_stats"])
          for key, run in specd["cc"].items() if key != "seconds"}
    ddd = dict(library=str(native._lib_path().relative_to(HERE)), stfile=ckpt_check,
               native_indexes=native_indexes, lookahead=cc, seconds=time.perf_counter() - t0)
    print(f"  (ddd) native library {ddd['library']}: StFile read {ckpt_check['tensors']} tensors "
          f"({ckpt_check['bytes']} B) of phase 6's checkpoints byte-equal to convert/stfile in "
          f"{ckpt_check['seconds']:.2f} s; phase 10 (cc) built {native_indexes} native n-gram "
          f"indexes; its streams equal to plain greedy for " + ", ".join(
              f"{k}: {v['equal_steps']} of {SPEC_NEW} steps" for k, v in cc.items()), flush=True)
    return ddd


def phase_dit_cv(dev, card_line, ckpt_check, specd, native_indexes):
    """Phase 14, (yy) to (ddd), each sub-phase with its launch counts set to
    0 before and read after: none launches a hand-written kernel."""
    t14 = time.perf_counter()
    out, secs = {}, {}
    for key, fn in (("yy", lambda: phase_mmdit(dev, card_line)),
                    ("zz", lambda: phase_sana(dev, card_line)),
                    ("aaa", lambda: phase_wan(dev, card_line)),
                    ("bbb", lambda: phase_dit_parity(dev)),
                    ("ccc", lambda: phase_cv(dev, card_line)),
                    ("ddd", lambda: phase_native(ckpt_check, specd, native_indexes))):
        t0 = time.perf_counter()
        build.reset_launches()
        out[key] = fn()
        counts = launch_counts()
        check(not any(counts.values()), f"({key}) a hand-written kernel ran: {counts}")
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t14
    print("  phase 14 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 14: {out['seconds']:.1f} s; no hand-written kernel launched", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 15: the graph frontends and CNN inference on the card
# --------------------------------------------------------------------------

ONNX_DTYPE = {np.dtype(np.float32): onnx_pb2.TensorProto.FLOAT,
              np.dtype(np.int64): onnx_pb2.TensorProto.INT64,
              np.dtype(np.int32): onnx_pb2.TensorProto.INT32,
              np.dtype(np.int8): onnx_pb2.TensorProto.INT8,
              np.dtype(np.uint8): onnx_pb2.TensorProto.UINT8,
              np.dtype(np.bool_): onnx_pb2.TensorProto.BOOL}


def onnx_tensor(name: str, arr) -> "onnx_pb2.TensorProto":
    arr = np.asarray(arr)
    t = onnx_pb2.TensorProto(name=name, data_type=ONNX_DTYPE[arr.dtype])
    t.dims.extend(arr.shape)
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def onnx_node(op_type: str, inputs, outputs, **attrs) -> "onnx_pb2.NodeProto":
    """A NodeProto; attributes by their Python type (a GraphProto is a
    GRAPH attribute, an array a TENSOR)."""
    O = onnx_pb2
    n = O.NodeProto(op_type=op_type)
    n.input.extend(inputs)
    n.output.extend(outputs)
    for k, v in attrs.items():
        a = n.attribute.add(name=k)
        if isinstance(v, float):
            a.type, a.f = O.AttributeProto.FLOAT, v
        elif isinstance(v, (bool, int)):
            a.type, a.i = O.AttributeProto.INT, int(v)
        elif isinstance(v, str):
            a.type, a.s = O.AttributeProto.STRING, v.encode()
        elif isinstance(v, O.GraphProto):
            a.type = O.AttributeProto.GRAPH
            a.g.CopyFrom(v)
        elif isinstance(v, np.ndarray):
            a.type = O.AttributeProto.TENSOR
            a.t.CopyFrom(onnx_tensor("", v))
        elif all(isinstance(x, int) for x in v):
            a.type = O.AttributeProto.INTS
            a.ints.extend(v)
        else:
            a.type = O.AttributeProto.FLOATS
            a.floats.extend(v)
    return n


def onnx_graph(name, nodes, inputs, outputs, inits=()) -> "onnx_pb2.GraphProto":
    g = onnx_pb2.GraphProto(name=name)
    for n in nodes:
        g.node.append(n)
    for i in inputs:
        g.input.add(name=i)
    for o in outputs:
        g.output.add(name=o)
    for t in inits:
        g.initializer.append(t)
    return g


def onnx_model(nodes, inputs, outputs, inits=()) -> bytes:
    """A ModelProto (opset 17) serialized: what a file would hold."""
    m = onnx_pb2.ModelProto(ir_version=8, producer_name="chip_smoke")
    m.opset_import.add(version=17)
    m.graph.CopyFrom(onnx_graph("g", nodes, inputs, outputs, inits))
    return m.SerializeToString()


def onnx_cases(seed: int = SEED + 70) -> dict:
    """The breadth graphs: every op of the ONNX frontend's table at least
    once (also inside If / Loop / Scan bodies), on seeded inputs. name ->
    (model bytes, [(input name, array, static)], output names). A static
    input is fed as a numpy array, the rest as tensors."""
    r = np.random.default_rng(seed)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)
    i64 = lambda v: np.asarray(v, np.int64)
    T, node = onnx_tensor, onnx_node
    cases = {}

    def case(name, nodes, feeds, outputs, inits=()):
        cases[name] = (onnx_model(nodes, [f[0] for f in feeds], outputs, inits),
                       [(n, a, s) for n, a, s in feeds], list(outputs))

    x, q, k = f32(5, 8), f32(1, 4, 8), f32(1, 4, 8)
    case("mlp", [
        node("Gemm", ["x", "w1", "b1"], ["h"], transB=1),
        node("Relu", ["h"], ["a"]),
        node("Gemm", ["a", "w2", "c"], ["gemm"], transB=1, alpha=0.5, beta=2.0),
        node("Transpose", ["x"], ["xt"]),
        node("Gemm", ["xt", "e"], ["gemm_ta"], transA=1),
        node("Transpose", ["k"], ["kt"], perm=[0, 2, 1]),
        node("MatMul", ["q", "kt"], ["s"]),
        node("Softmax", ["s"], ["p"], axis=-1),
        node("MatMul", ["p", "k"], ["att"]),
        node("LogSoftmax", ["s"], ["lsm"], axis=1),
        node("Einsum", ["q", "kt"], ["ein"], equation="bij,bjk->bik")],
        [("x", x, False), ("q", q, False), ("k", k, False)],
        ["gemm", "gemm_ta", "att", "lsm", "ein"],
        [T("w1", f32(16, 8)), T("b1", f32(16)), T("w2", f32(4, 16)), T("c", f32(4)),
         T("e", f32(8, 6))])

    pos = lambda *s: (r.random(s) + 0.5).astype(np.float32)
    conv_inits = [
        T("w", f32(8, 3, 3, 3) * 0.2), T("b", f32(8) * 0.1), T("bs", pos(8)),
        T("bb", f32(8) * 0.1), T("bm", f32(8) * 0.1), T("bv", pos(8))]
    stem = [node("Conv", ["x", "w", "b"], ["c"], pads=[1, 1, 1, 1], kernel_shape=[3, 3]),
            node("BatchNormalization", ["c", "bs", "bb", "bm", "bv"], ["n"], epsilon=1e-5),
            node("Relu", ["n"], ["r"]),
            node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2])]
    xc = f32(2, 3, 16, 16)
    case("convnet", stem + [
        node("GlobalAveragePool", ["p"], ["g"]),
        node("Flatten", ["g"], ["f"], axis=1),
        node("Gemm", ["f", "wfc"], ["logits"], transB=1),
        node("Conv", ["r", "wg"], ["conv_grouped"], group=4, pads=[0, 1, 2, 1], strides=[2, 2]),
        node("Conv", ["r", "wd"], ["conv_dilated"], dilations=[2, 2], auto_pad="SAME_UPPER"),
        node("Conv", ["x1", "w1d"], ["conv_1d"], pads=[1, 1], strides=[2]),
        node("ConvTranspose", ["p", "wt", "bt"], ["convt"], strides=[2, 2], pads=[1, 1, 1, 1],
             output_padding=[1, 1]),
        node("ConvTranspose", ["p", "wtg"], ["convt_grouped"], group=2, strides=[2, 2],
             pads=[1, 0, 0, 1], output_padding=[1, 0]),
        node("AveragePool", ["r"], ["avgpool"], kernel_shape=[3, 3], strides=[2, 2],
             pads=[1, 1, 1, 1]),
        node("GlobalMaxPool", ["r"], ["gmaxpool"]),
        node("MaxPool", ["r"], ["maxpool_ceil"], kernel_shape=[3, 3], strides=[2, 2],
             ceil_mode=1),
        node("MaxPool", ["r"], ["maxpool_asym"], kernel_shape=[3, 3], pads=[1, 0, 1, 2],
             strides=[1, 1]),
        node("Dropout", ["c"], ["dropout"])],
        [("x", xc, False), ("x1", f32(2, 3, 20), False)],
        ["logits", "conv_grouped", "conv_dilated", "conv_1d", "convt", "convt_grouped",
         "avgpool", "gmaxpool", "maxpool_ceil", "maxpool_asym", "dropout"],
        conv_inits + [
            T("wfc", f32(10, 8) * 0.3), T("wg", f32(8, 2, 3, 3) * 0.3),
            T("wd", f32(8, 8, 3, 3) * 0.2), T("w1d", f32(4, 3, 3)),
            T("wt", f32(8, 3, 3, 3) * 0.3), T("bt", f32(3)), T("wtg", f32(8, 2, 3, 3) * 0.3)])
    case("norm_resize", stem + [
        node("PRelu", ["c", "slope"], ["prelu"]),
        node("InstanceNormalization", ["c", "is", "ib"], ["inorm"]),
        node("LayerNormalization", ["c", "ls", "lb"], ["lnorm"], axis=-1, epsilon=1e-5),
        node("GroupNormalization", ["c", "gs", "gb"], ["gnorm"], num_groups=4),
        node("LRN", ["c"], ["lrn"], size=3, alpha=2e-4, beta=0.6, bias=1.2),
        node("Resize", ["p", "", "", "sizes"], ["resize_nearest"], mode="nearest"),
        node("Resize", ["p", "", "down"], ["resize_down"], mode="linear"),
        node("Resize", ["p", "", "up"], ["resize_up"], mode="linear",
             coordinate_transformation_mode="align_corners"),
        node("Upsample", ["p", "up"], ["upsample"], mode="nearest"),
        node("DepthToSpace", ["c"], ["d2s_dcr"], blocksize=2, mode="DCR"),
        node("DepthToSpace", ["c"], ["d2s_crd"], blocksize=2, mode="CRD"),
        node("SpaceToDepth", ["c"], ["s2d"], blocksize=2)],
        [("x", xc, False)],
        ["prelu", "inorm", "lnorm", "gnorm", "lrn", "resize_nearest", "resize_down",
         "resize_up", "upsample", "d2s_dcr", "d2s_crd", "s2d"],
        conv_inits + [
            T("slope", f32(8, 1, 1) * 0.2), T("is", pos(8)), T("ib", f32(8)), T("ls", pos(16)),
            T("lb", f32(16)), T("gs", pos(8)), T("gb", f32(8)), T("sizes", i64([2, 8, 20, 12])),
            T("down", np.asarray([1, 1, 0.5, 0.5], np.float32)),
            T("up", np.asarray([1, 1, 2, 2], np.float32))])

    x4 = f32(3, 4, 5, 2)
    case("shapes", [
        node("Shape", ["x"], ["sh"]),
        node("Gather", ["sh", "zero"], ["b0"], axis=0),
        node("Unsqueeze", ["b0", "ax0"], ["b1"]),
        node("Concat", ["b1", "neg1"], ["tgt"], axis=0),
        node("Reshape", ["x", "tgt"], ["flat"]),
        node("Size", ["x"], ["size"]),
        node("Slice", ["x", "st", "en", "axs", "steps"], ["slice"]),
        node("Slice", ["x", "rst", "ren", "rax", "rsteps"], ["slice_rev"]),
        node("Split", ["x", "split"], ["split_a", "split_b"], axis=1),
        node("Split", ["x"], ["half_a", "half_b"], axis=3),
        node("Squeeze", ["half_a", "ax3"], ["squeezed"]),
        node("Unsqueeze", ["squeezed", "ax0m1"], ["unsqueezed"]),
        node("Transpose", ["x"], ["transposed"]),
        node("Expand", ["small", "exshape"], ["expanded"]),
        node("Tile", ["x", "reps"], ["tiled"]),
        node("ConstantOfShape", ["cshape"], ["filled"], value=np.asarray([1.5], np.float32)),
        node("Range", ["r0", "r1", "r2"], ["range_static"]),
        node("Range", ["fs", "fl", "fd"], ["range_dynamic"]),
        node("Constant", [], ["kconst"], value=f32(1, 4, 1, 1)),
        node("Constant", [], ["kfloats"], value_floats=[0.5, -1.5]),
        node("Add", ["x", "kconst"], ["plus_const"]),
        node("Cast", ["x"], ["cast_i64"], to=onnx_pb2.TensorProto.INT64),
        node("Cast", ["sh"], ["cast_static"], to=onnx_pb2.TensorProto.FLOAT),
        node("Cast", ["x"], ["cast_bool"], to=onnx_pb2.TensorProto.BOOL),
        node("Cast", ["x"], ["cast_f64"], to=onnx_pb2.TensorProto.DOUBLE),
        node("CastLike", ["x", "iref"], ["castlike"]),
        node("Identity", ["kfloats"], ["identity"]),
        node("Pad", ["x", "pads", "pval"], ["pad_const"]),
        node("Pad", ["x", "pads"], ["pad_reflect"], mode="reflect"),
        node("Pad", ["x", "pads"], ["pad_edge"], mode="edge"),
        node("Flatten", ["x"], ["flatten2"], axis=2),
        node("Flatten", ["x"], ["flatten0"], axis=0)],
        [("x", x4, False), ("small", f32(4, 1, 1), False),
         ("fs", np.asarray(0.5, np.float32), False), ("fl", np.asarray(3.0, np.float32), False),
         ("fd", np.asarray(0.75, np.float32), False),
         ("iref", np.asarray([1], np.int32), False)],
        ["flat", "size", "slice", "slice_rev", "split_a", "split_b", "half_a", "unsqueezed",
         "transposed", "expanded", "tiled", "filled", "range_static", "range_dynamic",
         "plus_const", "cast_i64", "cast_static", "cast_bool", "cast_f64", "castlike",
         "identity", "pad_const", "pad_reflect", "pad_edge", "flatten2", "flatten0"],
        [T("zero", i64(0)), T("ax0", i64([0])), T("neg1", i64([-1])), T("st", i64([1, 0])),
         T("en", i64([3, -1])), T("axs", i64([1, 2])), T("steps", i64([1, 2])),
         T("rst", i64([-1])), T("ren", i64([-1000])), T("rax", i64([1])), T("rsteps", i64([-1])),
         T("split", i64([1, 3])), T("ax3", i64([3])), T("ax0m1", i64([0, -1])),
         T("exshape", i64([2, 1, 4, 5, 2])), T("reps", i64([1, 2, 1, 1])),
         T("cshape", i64([2, 3])), T("r0", i64(1)), T("r1", i64(10)), T("r2", i64(3)),
         T("pads", i64([0, 1, 0, 1, 0, 0, 1, 0])), T("pval", np.asarray(0.5, np.float32))])

    xu = (r.random((4, 6)) * 1.8 - 0.9).astype(np.float32)
    xp = (r.random((4, 6)) * 3 + 0.1).astype(np.float32)
    xa = (r.random((4, 6)) * 2 + 1.1).astype(np.float32)
    xn = f32(4, 6)
    xn[1, 2] = np.nan
    un = ["Relu", "Sigmoid", "Tanh", "Exp", "Neg", "Abs", "Floor", "Ceil", "Erf", "Softplus",
          "Sin", "Cos", "Sign", "Mish", "Tan", "Atan", "Asin", "Acos", "Sinh", "Cosh",
          "Asinh", "Atanh", "Softsign", "HardSwish", "Selu"]
    nodes = [node(o, ["x"], [o.lower()]) for o in un]
    nodes += [
        node("Log", ["xp"], ["log"]), node("Sqrt", ["xp"], ["sqrt"]),
        node("Reciprocal", ["xp"], ["reciprocal"]), node("Acosh", ["xa"], ["acosh"]),
        node("Round", ["x5"], ["round"]), node("IsNaN", ["xn"], ["isnan"]),
        node("Not", ["xb"], ["not"]),
        node("Gelu", ["x"], ["gelu"]), node("Gelu", ["x"], ["gelu_tanh"], approximate="tanh"),
        node("LeakyRelu", ["x"], ["leakyrelu"], alpha=0.2),
        node("Elu", ["x"], ["elu"], alpha=0.7),
        node("HardSigmoid", ["x"], ["hardsigmoid"], alpha=0.3, beta=0.4),
        node("Clip", ["x", "lo", "hi"], ["clip"]), node("Clip", ["x", "", "hi"], ["clip_hi"]),
        node("Clip", ["x"], ["clip_none"]),
        node("Celu", ["x"], ["celu"], alpha=0.5),
        node("ThresholdedRelu", ["x"], ["thresholdedrelu"], alpha=0.3),
        node("Shrink", ["x"], ["shrink"], lambd=0.5, bias=0.1),
        node("Hardmax", ["x"], ["hardmax"], axis=-1),
        node("Hardmax", ["x"], ["hardmax0"], axis=0)]
    outs = [o.lower() for o in un] + [
        "log", "sqrt", "reciprocal", "acosh", "round", "isnan", "not", "gelu", "gelu_tanh",
        "leakyrelu", "elu", "hardsigmoid", "clip", "clip_hi", "clip_none", "celu",
        "thresholdedrelu", "shrink", "hardmax", "hardmax0"]
    case("unary", nodes,
         [("x", xu, False), ("xp", xp, False), ("xa", xa, False),
          ("x5", (f32(4, 6) * 5).astype(np.float32), False), ("xn", xn, False),
          ("xb", r.random((4, 6)) > 0.5, False)],
         outs, [T("lo", np.asarray(-0.4, np.float32)), T("hi", np.asarray(0.6, np.float32))])

    a, b = f32(3, 4), f32(3, 4)
    bpos = pos(3, 4)
    ia = r.integers(-9, 10, (3, 4)).astype(np.int32)
    ib = r.integers(1, 5, (3, 4)).astype(np.int32) * np.where(r.random((3, 4)) > 0.5, 1, -1)
    ba, bb = r.random((3, 4)) > 0.5, r.random((3, 4)) > 0.5
    case("binary", [
        node("Add", ["a", "b"], ["add"]), node("Sub", ["a", "v"], ["sub"]),
        node("Mul", ["a", "b"], ["mul"]), node("Div", ["a", "bpos"], ["div"]),
        node("Pow", ["bpos", "b"], ["pow"]), node("Greater", ["a", "b"], ["greater"]),
        node("Less", ["a", "v"], ["less"]), node("Equal", ["ia", "ib"], ["equal"]),
        node("Min", ["a", "b", "v"], ["min"]), node("Max", ["a", "b"], ["max"]),
        node("And", ["ba", "bb"], ["and"]), node("Or", ["ba", "bb"], ["or"]),
        node("Xor", ["ba", "bb"], ["xor"]), node("Mod", ["ia", "ib"], ["mod_int"]),
        node("Mod", ["a", "bpos"], ["mod_float"], fmod=1),
        node("Sum", ["a", "b", "v"], ["sum"]), node("Mean", ["a", "b", "v"], ["mean"]),
        node("Where", ["ba", "a", "b"], ["where"]),
        node("Add", ["k3", "k4"], ["add_static"]), node("Mul", ["ia", "k3"], ["mul_mixed"])],
        [("a", a, False), ("b", b, False), ("v", f32(4), False), ("bpos", bpos, False),
         ("ia", ia, False), ("ib", ib.astype(np.int32), False), ("ba", ba, False),
         ("bb", bb, False)],
        ["add", "sub", "mul", "div", "pow", "greater", "less", "equal", "min", "max", "and",
         "or", "xor", "mod_int", "mod_float", "sum", "mean", "where", "add_static", "mul_mixed"],
        [T("k3", i64(3)), T("k4", i64([1, 2]))])

    xr = pos(3, 4, 5)
    xt = np.round(f32(3, 7) * 2).astype(np.float32)        # ties for TopK
    case("reduce", [
        node("ReduceMean", ["x"], ["mean"], axes=[1]),
        node("ReduceSum", ["x", "ax02"], ["sum"], keepdims=0),
        node("ReduceMax", ["x"], ["max"]),
        node("ReduceMin", ["x"], ["min"], axes=[-1]),
        node("ReduceProd", ["x"], ["prod"], axes=[1, 2]),
        node("ReduceL2", ["x"], ["l2"], axes=[2]),
        node("ReduceL1", ["x"], ["l1"], axes=[0]),
        node("ReduceSumSquare", ["x"], ["sumsq"], axes=[1]),
        node("ReduceLogSum", ["x"], ["logsum"], axes=[1]),
        node("ReduceLogSumExp", ["x"], ["logsumexp"], axes=[2]),
        node("ReduceSum", ["xi"], ["sum_int"], axes=[1]),
        node("ArgMax", ["x"], ["argmax"], axis=1, keepdims=0),
        node("ArgMin", ["x"], ["argmin"], axis=2),
        node("TopK", ["xt", "k3"], ["topk_v", "topk_i"]),
        node("CumSum", ["xt", "ax1"], ["cumsum"]),
        node("CumSum", ["xt", "ax1"], ["cumsum_ex"], exclusive=1),
        node("CumSum", ["xt", "ax1"], ["cumsum_rev"], reverse=1),
        node("CumSum", ["xi", "ax1"], ["cumsum_ex_rev_int"], exclusive=1, reverse=1)],
        [("x", xr, False), ("xi", r.integers(-5, 6, (3, 4, 5)).astype(np.int32), False),
         ("xt", xt, False)],
        ["mean", "sum", "max", "min", "prod", "l2", "l1", "sumsq", "logsum", "logsumexp",
         "sum_int", "argmax", "argmin", "topk_v", "topk_i", "cumsum", "cumsum_ex",
         "cumsum_rev", "cumsum_ex_rev_int"],
        [T("ax02", i64([0, 2])), T("k3", i64([3])), T("ax1", i64([1]))])

    data = f32(2, 3, 4)
    case("index", [
        node("Gather", ["d", "gi"], ["gather"], axis=1),
        node("GatherElements", ["d", "ge"], ["gather_elements"], axis=2),
        node("GatherND", ["d", "gnd"], ["gather_nd"]),
        node("ScatterND", ["z", "snd", "supd"], ["scatter_nd"]),
        node("ScatterElements", ["z", "se", "seu"], ["scatter_elements"], axis=1),
        node("ScatterElements", ["d", "se2", "seu2"], ["scatter_add"], axis=2, reduction="add"),
        node("OneHot", ["oi", "depth", "ovals"], ["onehot"], axis=-1),
        node("OneHot", ["oi", "depth", "ovals"], ["onehot0"], axis=0),
        node("Trilu", ["m"], ["tril"], upper=0),
        node("Trilu", ["m", "one"], ["triu1"]),
        node("EyeLike", ["m"], ["eyelike"], k=1)],
        [("d", data, False), ("gi", i64([[0, -1], [2, 1]]), False),
         ("ge", r.integers(0, 4, (2, 3, 2)).astype(np.int64), False),
         ("gnd", i64([[0, 1], [1, 2]]), False), ("z", np.zeros((4, 3), np.float32), False),
         ("snd", i64([[1], [3]]), False), ("supd", f32(2, 3), False),
         ("se", i64([[0, 2], [1, 0], [2, 1], [0, 1]]), False), ("seu", f32(4, 2), False),
         ("se2", r.integers(0, 4, (2, 3, 3)).astype(np.int64), False),
         ("seu2", f32(2, 3, 3), False), ("oi", i64([0, 2, -1, 3]), False),
         ("m", f32(4, 5), False)],
        ["gather", "gather_elements", "gather_nd", "scatter_nd", "scatter_elements",
         "scatter_add", "onehot", "onehot0", "tril", "triu1", "eyelike"],
        [T("depth", i64([4])), T("ovals", np.asarray([-1.0, 2.0], np.float32)),
         T("one", i64(1))])

    n_box = 200
    xy = r.uniform(0, 100, (n_box, 2)).astype(np.float32)
    wh = r.uniform(5, 30, (n_box, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)[None]
    case("quant_nms", [
        node("QuantizeLinear", ["xq", "s", "zq"], ["quant"]),
        node("QuantizeLinear", ["xq", "s"], ["quant_nozero"]),
        node("QuantizeLinear", ["xs", "sv", "zv"], ["quant_axis"], axis=1),
        node("DequantizeLinear", ["qi", "s", "zi"], ["dequant"]),
        node("DequantizeLinear", ["q8", "sv", "zv"], ["dequant_axis"], axis=1),
        node("NonMaxSuppression", ["boxes", "scores", "maxo", "iou", "sth"], ["nms"])],
        [("xq", (r.random((3, 4)) * 10).astype(np.float32), False), ("xs", f32(3, 4), False),
         ("qi", r.integers(0, 256, (3, 4)).astype(np.int32), False),
         ("q8", r.integers(-128, 128, (3, 4)).astype(np.int8), False),
         ("boxes", boxes, False), ("scores", r.random((1, 2, n_box)).astype(np.float32), False)],
        ["quant", "quant_nozero", "quant_axis", "dequant", "dequant_axis", "nms"],
        [T("s", np.asarray(0.1, np.float32)), T("zq", np.asarray(5, np.uint8)),
         T("sv", np.asarray([0.01, 0.02, 0.05, 0.1], np.float32)),
         T("zv", np.asarray([0, 3, -2, 1], np.int8)), T("zi", np.asarray(5, np.int32)),
         T("maxo", i64([20])), T("iou", np.asarray([0.5], np.float32)),
         T("sth", np.asarray([0.2], np.float32))])

    then_g = onnx_graph("then", [node("Mul", ["xc", "xc"], ["o"])], [], ["o"])
    else_g = onnx_graph("else", [node("Neg", ["xc"], ["o"])], [], ["o"])
    loop_body = onnx_graph("body", [
        node("Add", ["s", "lv"], ["s2"]),
        node("Identity", ["cond_in"], ["cond_out"]),
        node("Cast", ["iter"], ["itf"], to=onnx_pb2.TensorProto.FLOAT),
        node("Mul", ["itf", "s2"], ["y_out"])],
        ["iter", "cond_in", "s"], ["cond_out", "s2", "y_out"])
    skip_body = onnx_graph("skip", [node("Identity", ["cond_in"], ["cond_out"]),
                                    node("Add", ["s", "s"], ["s2"])],
                           ["iter", "cond_in", "s"], ["cond_out", "s2"])
    scan_body = onnx_graph("scan", [node("Add", ["st", "xi"], ["st2"]),
                                    node("Identity", ["st2"], ["yi"])],
                           ["st", "xi"], ["st2", "yi"])
    for name, dyn in (("control_static", False), ("control_dynamic", True)):
        case(name, [
            node("If", ["cond"], ["if_out"], then_branch=then_g, else_branch=else_g),
            node("If", ["ncond"], ["if_else"], then_branch=then_g, else_branch=else_g),
            node("Loop", ["trip", "go", "s0"], ["loop_final", "loop_ys"], body=loop_body),
            node("Loop", ["trip", "stop", "s0"], ["loop_skipped"], body=skip_body),
            node("Scan", ["s0", "xs"], ["scan_final", "scan_ys"], body=scan_body,
                 num_scan_inputs=1, scan_input_directions=[1], scan_output_directions=[1])],
            [("cond", np.asarray(True), not dyn), ("ncond", np.asarray(False), not dyn),
             ("go", np.asarray(True), True), ("stop", np.asarray(False), True),
             ("xc", f32(2, 3), False), ("lv", f32(3), False), ("s0", f32(3), False),
             ("xs", f32(5, 3), False)],
            ["if_out", "if_else", "loop_final", "loop_ys", "loop_skipped", "scan_final",
             "scan_ys"],
            [T("trip", i64(4))])

    nodes, outs = [], []
    for mode in ("bilinear", "nearest"):
        for padding in ("zeros", "border"):
            for align in (0, 1):
                nm = f"grid_{mode}_{padding}_{align}"
                nodes.append(node("GridSample", ["gx", "grid"], [nm], mode=mode,
                                  padding_mode=padding, align_corners=align))
                outs.append(nm)
    nodes += [node("RoiAlign", ["rx", "rois", "bi"], ["roi_avg"], output_height=4,
                   output_width=4, sampling_ratio=2, spatial_scale=0.5,
                   coordinate_transformation_mode="half_pixel"),
              node("RoiAlign", ["rx", "rois", "bi"], ["roi_max"], output_height=3,
                   output_width=5, mode="max", coordinate_transformation_mode="output_half_pixel")]
    case("sample", nodes,
         [("gx", f32(2, 3, 8, 9), False),
          ("grid", r.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32), False),
          ("rx", f32(2, 3, 16, 16), False),
          ("rois", np.asarray([[1, 1, 10, 12], [0, 2, 15, 9], [3, 0, 7, 4]], np.float32), False),
          ("bi", i64([0, 1, 1]), False)],
         outs + ["roi_avg", "roi_max"])
    return cases


def onnx_ops_of(model_bytes: bytes) -> set:
    """Every op type of a model, If / Loop / Scan bodies included."""
    def walk(g):
        for n in g.node:
            yield n.op_type
            for a in n.attribute:
                if a.type == onnx_pb2.AttributeProto.GRAPH:
                    yield from walk(a.g)
    return set(walk(onnx_pb2.ModelProto.FromString(model_bytes).graph))


def run_onnx_case(case, dev) -> list:
    """Convert and run one case on `dev`; the outputs as numpy arrays."""
    model, feeds, outs = case
    fn, params = convert_onnx(onnx_pb2.ModelProto.FromString(model), device=dev)
    args = [a if static else torch.from_numpy(np.array(a)).to(dev) for _, a, static in feeds]
    with no_tf32():
        got = fn(params, *args)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g)
            for g in got]


def onnx_worst(got: list, want: list, names) -> float:
    """Integer and bool outputs must be equal (value and dtype); the worst
    float difference, max |got - want| over max(1, max |want|)."""
    worst = 0.0
    for g, w, name in zip(got, want, names):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"onnx {name}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
        if w.dtype.kind in "biu":
            check(np.array_equal(g, w),
                  f"onnx {name}: {g.dtype} {g.ravel()[:8]} vs {w.dtype} {w.ravel()[:8]}")
            continue
        same_nan = np.array_equal(np.isnan(g), np.isnan(w))
        check(same_nan, f"onnx {name}: NaNs differ")
        ok = ~np.isnan(w)
        if ok.any():
            scale = max(1.0, float(np.abs(w[ok]).max()))
            worst = max(worst, float(np.abs(g[ok].astype(np.float64) - w[ok]).max()) / scale)
    return worst


def onnx_of_module(mod) -> bytes:
    """A ResNet-style module (eval mode) written node by node as an ONNX
    model with the port's own `onnx_pb2`, one input "x" and one output "y",
    from a torch.fx trace: Conv, BatchNormalization, Relu, MaxPool, Add,
    GlobalAveragePool, Flatten, Gemm."""
    import operator

    import torch.fx as fx
    import torch.nn as nn

    gm = fx.symbolic_trace(mod.eval())
    modules = dict(gm.named_modules())
    nodes, inits, names = [], [], {}

    def init(name, t):
        inits.append(onnx_tensor(name, t.detach().float().cpu().numpy()))
        return name

    def arg(a):
        return names[a.name]

    for n in gm.graph.nodes:
        out = n.name
        if n.op == "placeholder":
            names[n.name] = "x"
            continue
        if n.op == "output":        # the last node writes the graph output
            last = arg(n.args[0])
            for nd in nodes:
                for field in (nd.input, nd.output):
                    for i, v in enumerate(field):
                        if v == last:
                            field[i] = "y"
            continue
        names[n.name] = out
        if n.op == "call_module":
            m, src, p = modules[n.target], arg(n.args[0]), n.target.replace(".", "_")
            if isinstance(m, nn.Conv2d):
                ins = [src, init(p + "_w", m.weight)] + (
                    [init(p + "_b", m.bias)] if m.bias is not None else [])
                nodes.append(onnx_node(
                    "Conv", ins, [out], kernel_shape=list(m.kernel_size), strides=list(m.stride),
                    pads=[m.padding[0], m.padding[1]] * 2, dilations=list(m.dilation),
                    group=m.groups))
            elif isinstance(m, nn.BatchNorm2d):
                nodes.append(onnx_node(
                    "BatchNormalization", [src, init(p + "_s", m.weight), init(p + "_b", m.bias),
                                           init(p + "_m", m.running_mean),
                                           init(p + "_v", m.running_var)],
                    [out], epsilon=float(m.eps)))
            elif isinstance(m, nn.ReLU):
                nodes.append(onnx_node("Relu", [src], [out]))
            elif isinstance(m, nn.MaxPool2d):
                k, s, pd = (v if isinstance(v, tuple) else (v, v)
                            for v in (m.kernel_size, m.stride, m.padding))
                nodes.append(onnx_node("MaxPool", [src], [out], kernel_shape=list(k),
                                       strides=list(s), pads=[pd[0], pd[1]] * 2,
                                       ceil_mode=int(m.ceil_mode)))
            elif isinstance(m, nn.AdaptiveAvgPool2d) and m.output_size in (1, (1, 1)):
                nodes.append(onnx_node("GlobalAveragePool", [src], [out]))
            elif isinstance(m, nn.Linear):
                nodes.append(onnx_node("Gemm", [src, init(p + "_w", m.weight),
                                                init(p + "_b", m.bias)], [out], transB=1))
            else:
                raise NotImplementedError(f"onnx_of_module: {type(m).__name__}")
        elif n.target in (operator.add, torch.add):
            nodes.append(onnx_node("Add", [arg(n.args[0]), arg(n.args[1])], [out]))
        elif n.target is torch.flatten and n.args[1:] == (1,):
            nodes.append(onnx_node("Flatten", [arg(n.args[0])], [out], axis=1))
        else:
            raise NotImplementedError(f"onnx_of_module: {n.op} {n.target}")
    return onnx_model(nodes, ["x"], ["y"], inits)


CNN_NAMES = ("mobilenet_v2", "squeezenet_v1.0", "resnet50")
CNN_SIZE = 224               # the published input
CNN_CLASSES = 1000
CNN_BATCHES = (1, 32)        # (eee)
CNN_PARITY_BATCH = 2         # (fff), (ggg)
CNN_F32_REL = 1e-4           # (fff): f32 card vs the CPU run, TF32 off
CNN_BF16_REL = 5e-2          # (fff): bf16 card vs f32 CPU
ONNX_TOL = 1e-5              # (ggg): floats card vs CPU (ints equal)
NMS_BOXES = 5000             # (hhh)
NMS_MAX_OUT = 300
CLS_IMAGES = 64              # (hhh)
CLS_IMAGE = (240, 320)
SOFTSHRINK_LAM = 0.3         # tests/test_plugin.py's
SOFTSHRINK_SHAPES = (((2, 8, 128), torch.float32), ((2, 8, 128), torch.bfloat16),
                     ((32, 256, 56, 56), torch.bfloat16))   # the last: a ResNet-50 activation
PLUGIN_OP = "MnnTpuSoftShrink"


def cnn_macs(mod, size: int) -> int:
    """Multiply-adds of one image, from each Conv2d's and Linear's shapes
    (a forward pass on the meta device, no weights read)."""
    import copy

    import torch.nn as nn

    macs = [0]

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            macs[0] += out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
        else:
            macs[0] += out.numel() * m.in_features

    meta = copy.deepcopy(mod).to("meta")
    for m in meta.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        meta(torch.empty(1, 3, size, size, device="meta"))
    return macs[0]


def seeded_module(name: str):
    torch.manual_seed(SEED)
    return VISION_MODELS[name](CNN_CLASSES).eval()


def phase_bench_cnn(dev, card_line):
    """(eee) `cli bench-cnn` per model and batch (bf16 params, the seeded
    torch init), with the allocator's peak and TFLOP/s from the MAC count."""
    rows = {}
    for name in CNN_NAMES:
        macs = cnn_macs(seeded_module(name), CNN_SIZE)
        for batch in CNN_BATCHES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["bench-cnn", "--models", name, "--batch", str(batch),
                          "--size", str(CNN_SIZE)])
            rep = json.loads(buf.getvalue().strip().splitlines()[-1])
            check(rep["model"] == name and rep["batch"] == batch, f"(eee) report {rep}")
            sec = rep["latency_ms"] / 1e3
            rows[f"{name}_b{batch}"] = dict(
                rep, macs_per_image=macs, tflops=2 * macs * batch / sec / 1e12,
                peak_bytes=torch.cuda.max_memory_allocated())
            print(f"  (eee) {name} batch {batch}: {rep['latency_ms']:.3f} ms, "
                  f"{rep['images_per_s']:.1f} images/s, "
                  f"{rows[f'{name}_b{batch}']['tflops']:.2f} TFLOP/s "
                  f"({2 * macs / 1e9:.3f} GFLOP an image), peak "
                  f"{rows[f'{name}_b{batch}']['peak_bytes']} B [{card_line}]", flush=True)
    return rows


def top1_rule(card: torch.Tensor, cpu: torch.Tensor) -> dict:
    """Top-1 equal wherever the CPU's top-2 margin exceeds the largest logit
    difference (phase 4's token rule, for logits)."""
    diff = float((card.double() - cpu.double()).abs().max())
    top2 = torch.topk(cpu.double(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > diff
    same = card.argmax(-1) == cpu.argmax(-1)
    return dict(max_diff=diff, clear=int(clear.sum()), rows=int(cpu.shape[0]),
                equal_where_clear=bool(same[clear].all()), equal=int(same.sum()))


def phase_cnn_parity(dev):
    """(fff) the three CNNs at full width, batch 2, card against the CPU run
    of the same converted function: f32 with TF32 off within rel-L2 1e-4;
    bf16 params and input within 5e-2 of the f32 CPU logits, top-1 by
    `top1_rule`. Returns the rows and ResNet-50's card f32 logits."""
    g = torch.Generator().manual_seed(SEED + 71)
    x = torch.randn(CNN_PARITY_BATCH, 3, CNN_SIZE, CNN_SIZE, generator=g)
    rows, logits = {}, {}
    for name in CNN_NAMES:
        mod = seeded_module(name)
        fn_card, p_card = convert_torch_module(mod, device=dev)
        fn_cpu, p_cpu = convert_torch_module(mod, device="cpu")
        with torch.no_grad(), no_tf32():
            card = fn_card(p_card, x.to(dev)).float().cpu()
            cpu = fn_cpu(p_cpu, x)
            card16 = fn_card(cli._bf16_params(p_card), x.to(dev, torch.bfloat16)).float().cpu()
        rows[name] = dict(f32_rel=rel_l2(card, cpu), bf16_rel=rel_l2(card16, cpu),
                          top1=top1_rule(card16, cpu))
        logits[name] = card
        check(rows[name]["f32_rel"] <= CNN_F32_REL,
              f"(fff) {name} f32 card vs cpu rel-L2 {rows[name]['f32_rel']:.3g}")
        check(rows[name]["bf16_rel"] <= CNN_BF16_REL and rows[name]["top1"]["equal_where_clear"],
              f"(fff) {name} bf16 vs f32 cpu {rows[name]}")
        print(f"  (fff) {name} batch {CNN_PARITY_BATCH}: f32 card vs cpu rel-L2 "
              f"{rows[name]['f32_rel']:.3g}; bf16 card vs f32 cpu {rows[name]['bf16_rel']:.3g}, "
              f"top-1 {rows[name]['top1']}", flush=True)
    return rows, x, logits["resnet50"]


def phase_onnx(dev, x, fx_logits):
    """(ggg) ResNet-50 written by `onnx_of_module`, parsed and converted by
    the port on the card, against the fx path's card logits (f32, 1e-4);
    then every breadth case card against CPU (ints equal, floats 1e-5)."""
    t0 = time.perf_counter()
    model = onnx_of_module(seeded_module("resnet50"))
    parsed = onnx_pb2.ModelProto.FromString(model)
    check(parsed.SerializeToString() == model, "(ggg) ResNet-50 bytes do not round-trip")
    fn, params = convert_onnx(parsed, device=dev)
    with torch.no_grad(), no_tf32():
        got = fn(params, x.to(dev)).float().cpu()
    resnet = dict(bytes=len(model), nodes=len(parsed.graph.node), ops=sorted(onnx_ops_of(model)),
                  rel_to_fx=rel_l2(got, fx_logits))
    check(resnet["rel_to_fx"] <= CNN_F32_REL,
          f"(ggg) ONNX ResNet-50 vs the fx path rel-L2 {resnet['rel_to_fx']:.3g}")
    cases, worst = onnx_cases(), {}
    covered = set().union(*(onnx_ops_of(m) for m, _, _ in cases.values()))
    check(covered == set(onnx_frontend._OPS) - {PLUGIN_OP},
          f"(ggg) ops not covered: {sorted(set(onnx_frontend._OPS) - covered)}")
    for name, case in cases.items():
        worst[name] = onnx_worst(run_onnx_case(case, dev), run_onnx_case(case, "cpu"), case[2])
        check(worst[name] <= ONNX_TOL, f"(ggg) {name}: card vs cpu {worst[name]:.3g}")
    out = dict(resnet50=resnet, cases=worst, ops=len(covered), seconds=time.perf_counter() - t0)
    print(f"  (ggg) ONNX ResNet-50 ({len(model)} B, {resnet['nodes']} nodes, written and read by "
          f"the port's codec) vs the fx path rel-L2 {resnet['rel_to_fx']:.3g}; {len(cases)} "
          f"breadth graphs over all {len(covered)} ops card vs cpu, ints equal, floats within "
          f"{max(worst.values()):.3g} | {out['seconds']:.1f} s", flush=True)
    return out


def plugin_model() -> bytes:
    """x -> MnnTpuSoftShrink -> y, the plugin example's graph."""
    n = onnx_node(PLUGIN_OP, ["x"], ["y"])
    n.domain = "custom"
    return onnx_model([n], ["x"], ["y"])


def phase_plugin(dev):
    """(ggg) the plugin path: `MnnTpuSoftShrink` registered, backed by row
    10, converted and run at the plugin test's (2, 8, 128) in f32 and bf16
    and on a ResNet-50 activation [32, 256, 56, 56] bf16; each output the
    plain version's bits."""
    model = onnx_pb2.ModelProto.FromString(plugin_model())
    try:
        convert_onnx(model, device=dev)
        fail("(ggg) the unregistered plugin op converted")
    except NotImplementedError:
        pass
    plugin.register_op(PLUGIN_OP, lambda ctx, node, x: softshrink.softshrink(
        ctx.t(x), SOFTSHRINK_LAM))
    try:
        fn, params = convert_onnx(model, device=dev)
        g = torch.Generator(dev).manual_seed(SEED + 72)
        for shape, dt in SOFTSHRINK_SHAPES:
            xin = torch.randn(shape, generator=g, device=dev).to(dt)
            y = fn(params, xin)
            check(torch.equal(y.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                              softshrink.softshrink_plain(xin, SOFTSHRINK_LAM).view(
                                  torch.int16 if dt == torch.bfloat16 else torch.int32)),
                  f"(ggg) plugin {shape} {dt}: not the plain version's bits")
    finally:
        plugin.unregister_op(PLUGIN_OP)
    check(PLUGIN_OP not in plugin.registered_ops(), "(ggg) plugin op still registered")
    return dict(shapes=[list(s) for s, _ in SOFTSHRINK_SHAPES])


# row 10's own rows: phase 15's three, then [32, 256, 56, 56] f32, a bf16 view
# off 16 bytes (x[1:] of a flat tensor) and a ragged length: (shape, dtype,
# elements off the allocation's start)
SOFTSHRINK_ROWS = [(s, dt, 0) for s, dt in SOFTSHRINK_SHAPES] + [
    ((32, 256, 56, 56), torch.float32, 0), ((32 * 256 * 56 * 56,), torch.bfloat16, 1),
    (((1 << 20) + 7,), torch.bfloat16, 0)]


def phase_softshrink_rows(dev, results):
    """Row 10 against its plain version (equal bits, signed zeros, +-lam and
    a NaN planted) at SOFTSHRINK_ROWS; its time, the plain version's,
    `F.softshrink`'s and the byte bound."""
    g = torch.Generator(dev).manual_seed(SEED + 73)
    rows = []
    for shape, dt, off in SOFTSHRINK_ROWS:
        n = math.prod(shape)
        esz = torch.finfo(dt).bits // 8
        copies = copies_for(2 * n * esz, cap=64)
        bufs = [torch.randn(n + off, generator=g, device=dev).to(dt) for _ in range(copies)]
        bufs[0][off:off + 5] = torch.tensor([0.0, -0.0, SOFTSHRINK_LAM, -SOFTSHRINK_LAM,
                                             float("nan")], device=dev).to(dt)
        xs = [b[off:].view(shape) for b in bufs]
        ys = [torch.empty_like(b)[off:] for b in bufs]      # at x's offset, as the wrapper places y
        got = softshrink.softshrink(xs[0], SOFTSHRINK_LAM)
        want = softshrink.softshrink_plain(xs[0], SOFTSHRINK_LAM)
        ib = torch.int16 if dt == torch.bfloat16 else torch.int32
        check(torch.equal(got.view(ib), want.view(ib)), f"row 10 {shape} {dt} off {off}: bits differ")
        lam = float(torch.tensor(SOFTSHRINK_LAM, dtype=dt))
        ms = time_ms(lambda i: softshrink._KERNEL(xs[i % copies].data_ptr(),
                                                  ys[i % copies].data_ptr(), n, lam,
                                                  softshrink.DTYPES[dt]), 20)
        plain_ms = time_ms(lambda i: softshrink.softshrink_plain(xs[i % copies], SOFTSHRINK_LAM), 20)
        lib_ms = time_ms(lambda i: torch.nn.functional.softshrink(xs[i % copies], SOFTSHRINK_LAM), 20)
        bound, by = bound_of(4.0 * n, 2.0 * n * esz, F32_OPS_S)   # abs, sub, max, mul
        ok = ~torch.isnan(want.float())
        rows.append(dict(shape=list(shape), dtype=str(dt).split(".")[-1], off=off,
                         max_abs_err=max_abs(got.float()[ok], want.float()[ok]), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by))
        print(f"  row 10 softshrink {list(shape)} {rows[-1]['dtype']} off {off}: same bits; "
              f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, F.softshrink "
              f"{lib_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by})", flush=True)
    results["softshrink"] = rows


def cls_images(seed: int) -> tuple:
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (*CLS_IMAGE, 3), dtype=np.uint8) for _ in range(CLS_IMAGES)]


def phase_nms_cls(dev, card_line):
    """(hhh) `ops/nms.nms` over 5,000 seeded boxes, card against CPU (kept
    indices equal), its ms; `preprocess_classification` + `topk_eval` of 64
    seeded 240 x 320 images through MobileNetV2 in f32, card against CPU
    (top-1 by `top1_rule`)."""
    r = np.random.default_rng(SEED + 74)
    xy = r.uniform(0, 1000, (NMS_BOXES, 2)).astype(np.float32)
    wh = r.uniform(10, 80, (NMS_BOXES, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1))
    scores = torch.from_numpy(r.random(NMS_BOXES).astype(np.float32))
    want, _ = nms_mod.nms(boxes, scores, 0.5, 0.05, NMS_MAX_OUT)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, valid = nms_mod.nms(boxes.to(dev), scores.to(dev), 0.5, 0.05, NMS_MAX_OUT)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    check(torch.equal(got.cpu(), want), "(hhh) nms: kept indices differ from the cpu's")
    nms_row = dict(boxes=NMS_BOXES, kept=int(valid.sum()), ms=times)

    images = cls_images(SEED + 75)
    mod = seeded_module("mobilenet_v2")
    sides = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        fn, params = convert_torch_module(mod, device=d)
        xs = [classify.preprocess_classification(im, device=d) for im in images]
        with torch.no_grad(), no_tf32():
            logits = torch.cat([fn(params, torch.stack(xs[i:i + 32])).float().cpu()
                                for i in range(0, CLS_IMAGES, 32)])
        sides[side] = (fn, params, xs, logits)
    labels = sides["cpu"][3].argmax(-1).tolist()
    evals = {side: classify.topk_eval(lambda x, s=side: sides[s][0](sides[s][1], x),
                                      sides[side][2], labels, k=5, batch_size=32,
                                      device=dev if side == "card" else "cpu")
             for side in sides}
    rule = top1_rule(sides["card"][3], sides["cpu"][3])
    pre = max(rel_l2(a.cpu(), b) for a, b in zip(sides["card"][2], sides["cpu"][2]))
    check(rule["equal_where_clear"] and evals["cpu"]["top1"] == 1.0
          and evals["card"]["top1"] >= rule["clear"] / CLS_IMAGES,
          f"(hhh) classification card vs cpu: {rule} {evals}")
    out = dict(nms=nms_row, preprocess_rel=pre, top1=rule, topk_eval=evals)
    print(f"  (hhh) nms over {NMS_BOXES} boxes: {nms_row['kept']} kept, indices equal to the "
          f"cpu's, {min(times):.2f} ms (calls {', '.join(f'{t:.2f}' for t in times)}) | "
          f"{CLS_IMAGES} images {CLS_IMAGE}: preprocess card vs cpu rel-L2 {pre:.3g}; top-1 "
          f"{rule['equal']} of {CLS_IMAGES} equal ({rule['clear']} clear), topk_eval card "
          f"{evals['card']}, cpu {evals['cpu']} [{card_line}]", flush=True)
    return out


def phase_cnn(dev, card_line, results):
    """Phase 15, (eee) to (hhh), each sub-phase with its launch counts set to
    0 before and read after: only the plugin path launches row 10."""
    t15 = time.perf_counter()
    out, secs, counts = {}, {}, {}
    shared = {}

    def parity():
        rows, shared["x"], shared["fx"] = phase_cnn_parity(dev)
        return rows

    for key, fn in (("eee", lambda: phase_bench_cnn(dev, card_line)),
                    ("fff", parity),
                    ("ggg", lambda: phase_onnx(dev, shared["x"], shared["fx"])),
                    ("plugin", lambda: phase_plugin(dev)),
                    ("hhh", lambda: phase_nms_cls(dev, card_line))):
        t0 = time.perf_counter()
        build.reset_launches()
        out[key] = fn()
        counts[key] = launch_counts()
        must = {"mnn_softshrink"} if key == "plugin" else set()
        check(all(counts[key][k] > 0 for k in must)
              and not any(v for k, v in counts[key].items() if k not in must),
              f"({key}) launches {counts[key]}")
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["launches"] = counts
    t0 = time.perf_counter()
    phase_softshrink_rows(dev, results)
    secs["row10"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t15
    print("  phase 15 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 15: {out['seconds']:.1f} s; row 10 launched "
          f"{counts['plugin']['mnn_softshrink']} times on the plugin path", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 16: quant blocks of 256 (bench.py's qwen2-7b --q-block 256 row)
# --------------------------------------------------------------------------

B256_PROMPT = 512           # (iii): bench.py's pp512 ...
B256_NEW = 128              # ... and tg128, one prompt
B256_PARITY_LAYERS = 2      # (jjj): full width, cut depth on both sides
B256_NEVER = ("mnn_moe_decode", "mnn_moe_prefill", "mnn_flash_decode")
# phase 2's block-256 rows: qwen2-7b's projections and head at M = 1 (row
# 1a) and at the 512-row chunk (rows 1b and 2), row 2 also at block 176 on
# qwen1.5-moe-a2.7b's down projection (K = 1,408: `choose_block_size(1408,
# 256)`), one qwen2-7b projection on row 3
QWEN7B_PREFILL_B256 = QWEN7B_PREFILL + [("moe_down", 1408, 2048, False, 512, 176)]
DEQ_ROWS_B256 = [("qwen7b_wo", 3584, 3584, False)]
MOE_PREFILL_ROWS_B256 = [("qwen1.5-moe-a2.7b", 72), ("qwen3-moe-30b-a3b", 64)]


def b256_rt(block: int) -> RuntimeConfig:
    """bench.py:78-99's runtime at --q-block `block`: W4, an int4 head, an
    int8 cache of 1,024, int8 prefill rows in chunks of 512, greedy."""
    return RuntimeConfig(
        max_seq_len=1024, prefill_chunk=512, decode_block=B256_NEW, sampler="greedy",
        kv_quant=True, kv_bits=8, quant_bits=4, quant_block=block, lm_head_bits=4,
        prefill_act_bits=8, max_new_tokens=B256_NEW)


def b256_serve(llm, ids, label, card_line):
    """(iii): one request of `ids` and B256_NEW greedy tokens through
    `Llm.stream`, launch counts set to 0 before and read after: rows 2 and
    4 in the prefill, row 1a for the head after it, row 7 a token."""
    build.reset_launches()
    llm.reset()
    toks = list(llm.stream(token_ids=ids, max_new_tokens=B256_NEW))
    counts = read_launches(label, ("mnn_dequant_matmul_a8", "mnn_flash_prefill",
                                   "mnn_dequant_matmul", "mnn_decode_model"),
                           never=B256_NEVER + ("mnn_decode_step", "mnn_dequant_matmul_bf16_tile",
                                               "mnn_dequant_matmul_deq"))
    check(len(toks) == B256_NEW and counts["mnn_decode_model"] == B256_NEW,
          f"{label}: {len(toks)} tokens, {counts['mnn_decode_model']} whole-model launches")
    check(bool(torch.isfinite(llm.last_prefill_logits).all()), f"{label}: non-finite logits")
    p = llm.perf
    print(f"  {label}: {p.prompt_len} prompt tokens, prefill {p.prefill_s:.4f} s "
          f"({p.prefill_tok_s:.1f} tok/s) | decode {p.gen_len} tokens {p.decode_tok_s:.1f} "
          f"tok/s [{card_line}]", flush=True)
    return toks, dict(prefill_s=p.prefill_s, prefill_tok_s=p.prefill_tok_s, gen_len=p.gen_len,
                      decode_s=p.decode_s, decode_tok_s=p.decode_tok_s, launches=counts)


def b256_prefill(llm, ids, rt, label, must, never):
    """One prefill of `ids` under `rt` on llm's weights, host-timed to a
    synchronize, with its launch counts."""
    tokens = torch.tensor([ids], dtype=torch.int64, device=llm.device)
    build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = generate.run_prefill(llm.params, llm.config, rt, tokens, llm._new_cache())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launches(label, must, never=never)
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"  {label}: {len(ids)} tokens in {secs:.4f} s", flush=True)
    return dict(prefill_s=secs, launches=counts), logits


def phase_block256(dev, g, results, params7, card_line):
    """Phase 16: qwen2-7b at quant_block 256 as bench.py:261 runs it (28
    layers, published widths, random weights from seed 0), each sub-phase
    with its launch counts set to 0 before and read after. (iii) one
    512-token prompt and 128 greedy tokens, beside the same model at block
    128 (`params7`, phase 2's 28-layer weights), in the order 128, 256, 256,
    128; then on the block-256 weights 8 decode steps with megakernel=False
    (rows 1a and 6), a prefill at prefill_act_bits=16 (row 1b) and one with
    `DEQ_MIN_M = 512` (row 3). (jjj) the first two layers on the card and on
    the CPU, a bf16-row prefill (row 1b) and both decode paths, by phase 4's
    bounds and token rule; beside it, not held, the int8-row prefill's
    logits card against CPU at block 256 and at block 128 (row 2 gives the
    plain version's bits, but its int8 rows quantize the attention's output,
    whose summation order differs, and a level flipped there moves the
    logits by 3e-2 to 6e-2 at these widths, at either block). Its CPU side
    runs in a thread while phase 2's block-256 rows (rows 1a, 1b, 2, 3, 7,
    8, 9, and 1b and 3 at block 128 on the same shapes) take the card."""
    t16 = time.perf_counter()
    secs, out = {}, {}
    cfg = PRESETS["qwen2-7b"]
    t0 = time.perf_counter()
    params256 = decoder.init_random_params(cfg, torch.Generator().manual_seed(SEED),
                                           quant_block=256, lm_head_bits=4, device=dev)
    lay = params256.layers
    blocks = {n: getattr(lay, n).block_size for n in ("wqkv", "wo", "wgu", "wdown")}
    blocks["lm_head"] = params256.lm_head.block_size
    check(set(blocks.values()) == {256}, f"block-256 qwen2-7b: blocks {blocks}")
    secs["weights"] = time.perf_counter() - t0
    print(f"  qwen2-7b at quant_block 256: {cfg.num_layers} layers built in "
          f"{secs['weights']:.1f} s; blocks {blocks}", flush=True)
    ids = np.random.default_rng(SEED + 24).integers(0, cfg.vocab_size, B256_PROMPT).tolist()

    # (iii) block 128 and block 256, each after an untimed request of 2
    # tokens (cuBLAS handles, the whole-model schedule at this capacity)
    t0 = time.perf_counter()
    llms = {b: Llm(cfg, p, b256_rt(b), device=dev) for b, p in ((128, params7), (256, params256))}
    for llm in llms.values():
        list(llm.stream(token_ids=ids[:8], max_new_tokens=2))
    torch.cuda.synchronize()
    runs = {128: [], 256: []}
    toks = {}
    for b in (128, 256, 256, 128):
        toks[b], perf = b256_serve(llms[b], ids, f"(iii) qwen2-7b block {b}", card_line)
        runs[b].append(perf)
    out["iii"] = dict(prompt=B256_PROMPT, new_tokens=B256_NEW, card=card_line, block=runs,
                      blocks=blocks)
    for b in (128, 256):
        pre = [r["prefill_s"] for r in runs[b]]
        dec = [r["decode_tok_s"] for r in runs[b]]
        print(f"  (iii) block {b}: prefill {pre[0]:.4f} / {pre[1]:.4f} s, decode "
              f"{dec[0]:.1f} / {dec[1]:.1f} tok/s [{card_line}]", flush=True)
    secs["iii"] = time.perf_counter() - t0

    # (jjj) the card's two paths from the same bf16-row prefill, then the
    # CPU's plain versions fed the card's tokens, in a thread; beside them,
    # unheld, the int8-row prefill's logits at block 256 and at block 128
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=B256_PARITY_LAYERS)
    rt16 = dataclasses.replace(b256_rt(256), prefill_act_bits=16)
    card2 = Llm(cfg2, first_layers(params256, B256_PARITY_LAYERS), rt16, device=dev)
    card_mk, fed, _ = greedy_trace(card2, ids, None)
    card_pl, _, _ = greedy_trace(card2, ids, fed, megakernel=False)
    cpu_llm = Llm(cfg2, decoder.params_to(card2.params, "cpu"), rt16, device="cpu")
    act8 = {}
    for b, p in ((256, card2.params), (128, first_layers(params7, B256_PARITY_LAYERS))):
        llm8 = Llm(cfg2, p, b256_rt(b), device=dev)
        logits, _ = generate.run_prefill(p, cfg2, llm8.rt, torch.tensor([ids], device=dev),
                                         llm8._new_cache())
        act8[b] = (logits.float().cpu(), Llm(cfg2, decoder.params_to(p, "cpu"), b256_rt(b),
                                             device="cpu"))

    def cpu_side():
        rows = greedy_trace(cpu_llm, ids, fed)[0]
        prefills = {b: generate.run_prefill(llm.params, cfg2, llm.rt, torch.tensor([ids]),
                                            llm._new_cache())[0].float()
                    for b, (_, llm) in act8.items()}
        return rows, prefills
    secs["jjj card"] = time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(timed_cpu(cpu_side))

        # the block-256 model's other paths
        t0 = time.perf_counter()
        llm = llms[256]
        build.reset_launches()
        rows, _, _ = greedy_trace(llm, ids, None, megakernel=False)
        torch.cuda.synchronize()
        steps = read_launches("(iii) per-layer decode, block 256",
                              ("mnn_dequant_matmul", "mnn_decode_step"),
                              never=B256_NEVER + ("mnn_decode_model",))
        check(steps["mnn_decode_step"] == cfg.num_layers * PARITY_STEPS
              and all(bool(torch.isfinite(r).all()) for r in rows),
              f"(iii) per-layer decode: {steps['mnn_decode_step']} decode-step launches")
        out["iii"]["per_layer"] = dict(steps=PARITY_STEPS, launches=steps)
        out["iii"]["act16"], _ = b256_prefill(
            llm, ids, dataclasses.replace(llm.rt, prefill_act_bits=16),
            "(iii) prefill_act_bits=16, block 256",
            ("mnn_dequant_matmul_bf16_tile", "mnn_flash_prefill"),
            B256_NEVER + ("mnn_dequant_matmul_a8", "mnn_dequant_matmul_deq"))
        check(out["iii"]["act16"]["launches"]["mnn_dequant_matmul_bf16_tile"]
              == 4 * cfg.num_layers, "(iii) act16: tile-kernel launches")
        dequant_matmul.DEQ_MIN_M = B256_PROMPT
        try:
            out["iii"]["deq"], _ = b256_prefill(
                llm, ids, llm.rt, "(iii) DEQ_MIN_M = 512, block 256",
                ("mnn_dequant_matmul_deq", "mnn_flash_prefill"),
                B256_NEVER + ("mnn_dequant_matmul_a8", "mnn_dequant_matmul_bf16_tile"))
        finally:
            dequant_matmul.DEQ_MIN_M = 1 << 30
        check(out["iii"]["deq"]["launches"]["mnn_dequant_matmul_deq"] == 4 * cfg.num_layers,
              "(iii) DEQ_MIN_M: dequantize-tile launches")
        del llms, llm
        secs["iii other paths"] = time.perf_counter() - t0

        # phase 2's block-256 rows
        t0 = time.perf_counter()
        print("phase 2, block-256 rows of rows 1a, 1b, 2, 3, 7, 8 and 9", flush=True)
        results["decode_model_b256"] = [
            decode_model_row(dev, g, "qwen2-7b x2 layers, block 256", cfg2,
                             first_layers(params256, B256_PARITY_LAYERS), 8,
                             (B256_PROMPT + 7,), 1024),
            decode_model_row(dev, g, "qwen2-7b, block 256", cfg, params256, 8,
                             (B256_PROMPT + 7,), 1024)]
        del params256
        torch.cuda.empty_cache()
        phase_gemm(dev, g, results, a8=False, shapes=QWEN7B_GEMV, bs=256,
                   key="dequant_matmul_b256")
        # rows 1b and 3 at block 128 on the same shapes, beside their block-256
        # rows (rows 1a, 2, 7, 8 and 9 have theirs in phase 2)
        phase_gemm(dev, g, results, a8=False, shapes=QWEN7B_PREFILL, key="dequant_matmul_tile_7b")
        phase_gemm(dev, g, results, a8=False, shapes=QWEN7B_PREFILL, bs=256,
                   key="dequant_matmul_tile_b256")
        phase_gemm_deq(dev, g, results, DEQ_ROWS_B256, key="dequant_matmul_deq_7b")
        phase_gemm(dev, g, results, a8=True, shapes=QWEN7B_PREFILL_B256, bs=256,
                   key="dequant_matmul_a8_b256")
        phase_gemm_deq(dev, g, results, DEQ_ROWS_B256, bs=256, key="dequant_matmul_deq_b256")
        phase_moe_prefill(dev, g, results, MOE_PREFILL_ROWS_B256, block=256,
                          key="moe_prefill_b256")
        phase_moe_decode(dev, g, results, ("qwen3-moe-30b-a3b",), bs=256, key="moe_decode_b256")
        secs["phase 2 rows"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        (cpu, cpu_act8), cpu_s = job.result()
    secs["jjj cpu wait"] = time.perf_counter() - t0
    label = (f"(jjj) qwen2-7b block 256, {B256_PARITY_LAYERS} layers, {B256_PROMPT} prompt "
             f"tokens, bf16 prefill rows, ")
    out["jjj"] = dict(layers=B256_PARITY_LAYERS, prompt=B256_PROMPT, prefill_act_bits=16,
                      cpu_s=cpu_s, **{path: compare_traces(card_rows, cpu, f"{label}{path} ")
                                      for path, card_rows in (("whole-model", card_mk),
                                                              ("per-layer", card_pl))})
    out["jjj"]["act8_prefill_rel_l2"] = {b: rel_l2(act8[b][0], cpu_act8[b]) for b in act8}
    print("  (jjj) int8-row prefill logits, card vs cpu, not held: " + ", ".join(
        f"block {b} rel-L2 {v:.3e}" for b, v in out["jjj"]["act8_prefill_rel_l2"].items()),
        flush=True)
    print(f"    cpu side {cpu_s:.1f} s", flush=True)
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t16
    print("  phase 16 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 16: {out['seconds']:.1f} s", flush=True)
    return out


def block256_launches(b256: dict) -> dict:
    """Phase 16's launches by C entry, summed over its sub-phases."""
    iii = b256["iii"]
    parts = [r["launches"] for runs in iii["block"].values() for r in runs]
    parts += [iii[k]["launches"] for k in ("per_layer", "act16", "deq")]
    total: dict = {}
    for counts in parts:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# phase 17: the TF, TFLite and Caffe frontends on the card
# --------------------------------------------------------------------------

# -- a GraphDef writer (the port's codec) --------------------------------------

TF_DTYPE = {np.dtype(np.float32): graphdef_pb2.DT_FLOAT, np.dtype(np.int32): graphdef_pb2.DT_INT32,
            np.dtype(np.int64): graphdef_pb2.DT_INT64, np.dtype(np.bool_): graphdef_pb2.DT_BOOL,
            np.dtype(np.float16): graphdef_pb2.DT_HALF, np.dtype(np.uint8): graphdef_pb2.DT_UINT8}


class TfType(int):
    """An attr value that is a DataType (`type`), not an int (`i`)."""


def tf_tensor(arr) -> "graphdef_pb2.TensorProto":
    arr = np.asarray(arr)
    t = graphdef_pb2.TensorProto(dtype=TF_DTYPE[arr.dtype])
    for d in arr.shape:
        t.tensor_shape.dim.add(size=d)
    t.tensor_shape._mark()
    t.tensor_content = np.ascontiguousarray(arr).tobytes()
    return t


def tf_node(op: str, name: str, inputs=(), **attrs) -> "graphdef_pb2.NodeDef":
    """A NodeDef; attributes by their Python type (TfType a DataType, an
    array a tensor, a list of ints `list.i`, of floats `list.f`)."""
    n = graphdef_pb2.NodeDef(name=name, op=op)
    n.input.extend(inputs)
    for k, v in attrs.items():
        a = n.attr[k]
        if isinstance(v, TfType):
            a.type = int(v)
        elif isinstance(v, bool):
            a.b = v
        elif isinstance(v, int):
            a.i = v
        elif isinstance(v, float):
            a.f = v
        elif isinstance(v, str):
            a.s = v.encode()
        elif isinstance(v, np.ndarray):
            a.tensor.CopyFrom(tf_tensor(v))
            a.tensor._mark()
        elif all(isinstance(x, int) for x in v):
            a.list.i.extend(v)
        else:
            a.list.f.extend(v)
    return n


def tf_const(name: str, arr) -> "graphdef_pb2.NodeDef":
    arr = np.asarray(arr)
    return tf_node("Const", name, value=arr, dtype=TfType(TF_DTYPE[arr.dtype]))


def tf_placeholder(name: str, dtype=np.float32) -> "graphdef_pb2.NodeDef":
    return tf_node("Placeholder", name, dtype=TfType(TF_DTYPE[np.dtype(dtype)]))


def tf_graph(nodes) -> bytes:
    g = graphdef_pb2.GraphDef()
    for n in nodes:
        g.node.append(n)
    g.versions.producer = 1882
    return g.SerializeToString()


# -- a minimal FlatBuffers writer and a TFLite model writer --------------------

class FbTable:
    """A FlatBuffers table: {field id: (struct format, value) or a child}."""

    def __init__(self, fields=None):
        self.fields = dict(fields or {})


class FbVec:
    """A vector: of scalars (a struct format and the items) or of tables."""

    def __init__(self, fmt, items):
        self.fmt, self.items = fmt, items


class FbStr:
    def __init__(self, s: str):
        self.s = s


class FbWriter:
    """Lays objects out parent first and children after, so every offset
    points forward, as the TFLite reader (`tflite_frontend._FB`) follows
    them: a vtable before each table, little-endian scalars aligned to
    their size."""

    def __init__(self):
        self.buf = bytearray(4)                       # the root offset

    def _pad(self, n: int, extra: int = 0):
        self.buf += bytes(-(len(self.buf) + extra) % n)

    def finish(self, root: FbTable) -> bytes:
        pos = self._emit(root)
        struct.pack_into("<I", self.buf, 0, pos)
        return bytes(self.buf)

    def _emit(self, obj) -> int:
        if isinstance(obj, FbStr):
            self._pad(4)
            pos = len(self.buf)
            data = obj.s.encode()
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos
        if isinstance(obj, FbVec):
            if obj.fmt == "t":
                self._pad(4)
                pos = len(self.buf)
                self.buf += struct.pack("<I", len(obj.items)) + bytes(4 * len(obj.items))
                for i, child in enumerate(obj.items):
                    cpos = self._emit(child)
                    struct.pack_into("<I", self.buf, pos + 4 + 4 * i, cpos - (pos + 4 + 4 * i))
                return pos
            data = np.asarray(obj.items, np.dtype(obj.fmt).newbyteorder("<")).tobytes()
            self._pad(max(4, np.dtype(obj.fmt).itemsize), 4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.items)) + data
            return pos
        fids = sorted(obj.fields)
        offs, off = {}, 4
        for fid in fids:
            v = obj.fields[fid]
            size = struct.calcsize("<" + v[0]) if isinstance(v, tuple) else 4
            off += -off % size
            offs[fid] = off
            off += size
        self._pad(2)
        vt = len(self.buf)
        nslots = (fids[-1] + 1) if fids else 0
        self.buf += struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, off,
                                *[offs.get(f, 0) for f in range(nslots)])
        self._pad(8)
        pos = len(self.buf)
        self.buf += struct.pack("<i", pos - vt) + bytes(off - 4)
        children = []
        for fid in fids:
            v = obj.fields[fid]
            if isinstance(v, tuple):
                struct.pack_into("<" + v[0], self.buf, pos + offs[fid], v[1])
            else:
                children.append((pos + offs[fid], v))
        for at, child in children:
            struct.pack_into("<I", self.buf, at, self._emit(child) - at)
        return pos


TFL_TYPE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1, np.dtype(np.int32): 2,
            np.dtype(np.uint8): 3, np.dtype(np.int64): 4, np.dtype(np.bool_): 6,
            np.dtype(np.int16): 7, np.dtype(np.int8): 9}


class TflModel:
    """A one-subgraph TFLite model, built op by op: what the TFLite reader
    (`tflite_frontend._parse`) reads, field ids of schema.fbs."""

    def __init__(self):
        self.tensors, self.buffers, self.ops, self.codes = [], [None], [], []
        self.inputs, self.outputs = [], []

    def tensor(self, shape=(), dtype=np.float32, data=None, name="", quant=None) -> int:
        fields = {0: FbVec("i4", list(shape)), 1: ("b", TFL_TYPE[np.dtype(dtype)]),
                  3: FbStr(name or f"t{len(self.tensors)}")}
        if data is not None:
            self.buffers.append(np.ascontiguousarray(data).view(np.uint8).reshape(-1))
            fields[2] = ("I", len(self.buffers) - 1)
        if quant is not None:
            scale, zero, dim = quant
            fields[4] = FbTable({2: FbVec("f4", list(np.atleast_1d(scale))),
                                 3: FbVec("i8", list(np.atleast_1d(zero))), 6: ("i", dim)})
        self.tensors.append(FbTable(fields))
        return len(self.tensors) - 1

    def const(self, arr, name="", quant=None) -> int:
        arr = np.asarray(arr)
        return self.tensor(arr.shape, arr.dtype, arr, name, quant)

    def input(self, shape, dtype=np.float32, name="") -> int:
        i = self.tensor(shape, dtype, name=name)
        self.inputs.append(i)
        return i

    def op(self, code: int, ins, n_out: int = 1, opts=None, out_dtype=np.float32):
        """Add an operator; `opts` is its options table {field id: (format,
        value) or FbVec}. Returns the output index (a list if n_out > 1)."""
        if code not in self.codes:
            self.codes.append(code)
        outs = [self.tensor((), out_dtype) for _ in range(n_out)]
        fields = {0: ("I", self.codes.index(code)), 1: FbVec("i4", list(ins)),
                  2: FbVec("i4", outs)}
        if opts:
            fields[4] = FbTable(opts)
        self.ops.append(FbTable(fields))
        return outs[0] if n_out == 1 else outs

    def to_bytes(self) -> bytes:
        sub = FbTable({0: FbVec("t", self.tensors), 1: FbVec("i4", self.inputs),
                       2: FbVec("i4", self.outputs), 3: FbVec("t", self.ops),
                       4: FbStr("main")})
        codes = [FbTable({0: ("b", min(c, 127)), 2: ("i", 1), 3: ("i", c)}) for c in self.codes]
        bufs = [FbTable({} if b is None else {0: FbVec("u1", b)}) for b in self.buffers]
        model = FbTable({0: ("I", 3), 1: FbVec("t", codes), 2: FbVec("t", [sub]),
                         3: FbStr("chip_smoke"), 4: FbVec("t", bufs)})
        return FbWriter().finish(model)


def quantize_per_channel(w: np.ndarray, dim: int):
    """Symmetric int8 weights along `dim`: (q, scales, zero points)."""
    axes = tuple(a for a in range(w.ndim) if a != dim)
    scale = (np.abs(w).max(axis=axes) / 127.0).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    shape = [1] * w.ndim
    shape[dim] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale, np.zeros_like(scale, dtype=np.int64)


# -- the breadth graphs of the three tables ------------------------------------

def tf_cases(seed: int = SEED + 80) -> dict:
    """Every op of the TF frontend's table at least once, on seeded inputs.
    name -> (GraphDef bytes, [(placeholder, array)], output refs)."""
    r = np.random.default_rng(seed)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)
    pos = lambda *s: (r.random(s) + 0.5).astype(np.float32)
    i32 = lambda v: np.asarray(v, np.int32)
    N_, C_ = tf_node, tf_const
    cases = {}

    def case(name, nodes, feeds, outputs):
        ph = [tf_placeholder(n, a.dtype) for n, a in feeds]
        cases[name] = (tf_graph(ph + nodes), list(feeds), list(outputs))

    unary = ["Relu", "Relu6", "Sigmoid", "Tanh", "Elu", "Selu", "Softplus", "Softsign", "Exp",
             "Neg", "Abs", "Square", "Erf", "Floor", "Ceil", "Round", "Sign", "Sin", "Cos",
             "Identity", "StopGradient", "ZerosLike", "OnesLike", "Softmax", "LogSoftmax"]
    positive = ["Log", "Sqrt", "Rsqrt", "Reciprocal"]
    binary = ["AddV2", "Add", "Sub", "Mul", "RealDiv", "Div", "Maximum", "Minimum",
              "SquaredDifference", "FloorDiv", "FloorMod"]
    compare = ["Equal", "NotEqual", "Less", "LessEqual", "Greater", "GreaterEqual"]
    x = f32(3, 5)
    x[0, :3] = [0.0, -0.0, 2.5]
    nodes = ([N_(op, f"u_{op}", ["x"]) for op in unary]
             + [N_(op, f"p_{op}", ["y"]) for op in positive]
             + [N_(op, f"b_{op}", ["x", "y"]) for op in binary]
             + [N_(op, f"c_{op}", ["x", "y"]) for op in compare]
             + [N_("Pow", "pow", ["y", "x"]), N_("LeakyRelu", "leaky", ["x"], alpha=0.1),
                C_("bias", f32(5)), N_("BiasAdd", "biasadd", ["x", "bias"]),
                N_("LogicalAnd", "and", ["c_Less", "c_GreaterEqual"]),
                N_("LogicalOr", "or", ["c_Less", "c_Equal"]),
                N_("LogicalNot", "not", ["c_Less"]),
                N_("Select", "select", ["c_Less", "x", "y"]),
                N_("SelectV2", "selectv2", ["c_Greater", "x", "y"]),
                N_("FloorDiv", "floordiv_i", ["i", "j"]), N_("FloorMod", "floormod_i", ["i", "j"])])
    outs = ([f"u_{op}" for op in unary] + [f"p_{op}" for op in positive]
            + [f"b_{op}" for op in binary] + [f"c_{op}" for op in compare]
            + ["pow", "leaky", "biasadd", "and", "or", "not", "select", "selectv2",
               "floordiv_i", "floormod_i"])
    case("elementwise", nodes,
         [("x", x), ("y", pos(3, 5)), ("i", i32(r.integers(-9, 9, (3, 5)))),
          ("j", i32(r.integers(1, 4, (3, 5)) * r.choice([-1, 1], (3, 5))))], outs)

    xc = f32(2, 9, 9, 3)
    bn = [C_(f"bn_{k}", pos(8) if k in ("s", "v") else f32(8) * 0.1) for k in "sbmv"]
    nodes = [
        C_("w", f32(3, 3, 3, 8) * 0.3), C_("wd", f32(3, 3, 3, 2) * 0.3),
        C_("wt", f32(3, 3, 4, 8) * 0.3), C_("tshape", i32([2, 10, 10, 4])),
        N_("Conv2D", "conv_same", ["x", "w"], strides=[1, 2, 2, 1], padding="SAME",
           data_format="NHWC"),
        N_("Conv2D", "conv_dil", ["x", "w"], strides=[1, 1, 1, 1], padding="VALID",
           dilations=[1, 2, 2, 1]),
        N_("Conv2D", "conv_explicit", ["x", "w"], strides=[1, 1, 2, 1], padding="EXPLICIT",
           explicit_paddings=[0, 0, 1, 2, 0, 1, 0, 0]),
        N_("DepthwiseConv2dNative", "dwconv", ["x", "wd"], strides=[1, 2, 2, 1],
           padding="SAME"),
        N_("Conv2DBackpropInput", "deconv", ["tshape", "wt", "conv_same"],
           strides=[1, 2, 2, 1], padding="SAME"),
        N_("MaxPool", "maxpool", ["conv_dil"], ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1],
           padding="SAME"),
        N_("AvgPool", "avgpool_same", ["conv_dil"], ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1],
           padding="SAME"),
        N_("AvgPool", "avgpool_valid", ["conv_dil"], ksize=[1, 2, 2, 1],
           strides=[1, 2, 2, 1], padding="VALID")] + bn + [
        N_(op, f"bn_{op}", ["conv_same"] + [f"bn_{k}" for k in "sbmv"], epsilon=1e-3,
           is_training=False)
        for op in ("FusedBatchNormV3", "FusedBatchNorm", "FusedBatchNormV2")] + [
        C_("mw", f32(5, 4)), C_("ma", f32(2, 3, 5)), C_("mb", f32(2, 4, 5)),
        N_("MatMul", "matmul", ["m", "mw"]),
        N_("MatMul", "matmul_t", ["mw", "m"], transpose_a=True, transpose_b=True),
        N_("BatchMatMulV2", "bmm2", ["ma", "mb"], adj_y=True),
        N_("BatchMatMul", "bmm", ["mb", "ma"], adj_x=False, adj_y=True),
        N_("BatchMatMulV3", "bmm3", ["ma", "mb"], adj_y=True)]
    case("convnet", nodes, [("x", xc), ("m", f32(3, 5))],
         ["conv_same", "conv_dil", "conv_explicit", "dwconv", "deconv", "maxpool",
          "avgpool_same", "avgpool_valid", "bn_FusedBatchNormV3", "bn_FusedBatchNorm",
          "bn_FusedBatchNormV2", "matmul", "matmul_t", "bmm2", "bmm", "bmm3"])

    xs = f32(2, 4, 6)
    nodes = [
        C_("shape", i32([4, 12])), N_("Reshape", "reshape", ["x", "shape"]),
        C_("perm", i32([2, 0, 1])), N_("Transpose", "transpose", ["x", "perm"]),
        C_("ax1", i32(1)), C_("ax0", i32(0)), C_("ax2", i32(2)), C_("axm1", i32(-1)),
        N_("ConcatV2", "concat", ["x", "x", "ax1"]),
        N_("Split", "split", ["ax2", "x"], num_split=2),
        C_("sizes", i32([1, 3, 2])), N_("SplitV", "splitv", ["x", "sizes", "ax2"]),
        C_("pads", i32([[0, 1], [2, 0], [1, 1]])), C_("padval", np.float32(1.5)),
        N_("Pad", "pad", ["x", "pads"]), N_("PadV2", "padv2", ["x", "pads", "padval"]),
        N_("MirrorPad", "mpad_r", ["x", "pads"], mode="REFLECT"),
        N_("MirrorPad", "mpad_s", ["x", "pads"], mode="SYMMETRIC"),
        N_("ExpandDims", "expand", ["x", "ax1"]),
        N_("Squeeze", "squeeze", ["expand"], squeeze_dims=[1]),
        C_("b", i32([1, 0, 5])), C_("e", i32([2, 4, 0])), C_("s", i32([1, 1, -2])),
        N_("StridedSlice", "sslice", ["x", "b", "e", "s"], begin_mask=2, end_mask=0,
           shrink_axis_mask=1, new_axis_mask=0),
        C_("b2", i32([0, 0, 0])), C_("e2", i32([2, 3, 6])), C_("s2", i32([1, 2, 1])),
        N_("StridedSlice", "sslice_new", ["x", "b2", "e2", "s2"], new_axis_mask=4),
        C_("sb", i32([0, 1, 2])), C_("ss", i32([-1, 2, 3])),
        N_("Slice", "slice", ["x", "sb", "ss"]),
        N_("Pack", "pack", ["x", "x"], axis=1), N_("Unpack", "unpack", ["x"], num=4, axis=1),
        C_("idx", i32([3, 0, 2])), N_("GatherV2", "gather", ["x", "idx", "ax1"]),
        N_("Gather", "gather1", ["t", "idx"]),
        C_("ndi", i32([[1, 2], [0, 3]])), N_("GatherNd", "gathernd", ["x", "ndi"]),
        C_("reps", i32([1, 2, 1])), N_("Tile", "tile", ["x", "reps"]),
        C_("fshape", i32([2, 3])), C_("fval", np.float32(0.25)),
        N_("Fill", "fill", ["fshape", "fval"]),
        N_("Shape", "shapeof", ["x"]), N_("Rank", "rank", ["x"]), N_("Size", "size", ["x"]),
        C_("r0", i32(1)), C_("r1", i32(9)), C_("r2", i32(3)),
        N_("Range", "range", ["r0", "r1", "r2"]),
        N_("Cast", "cast_i", ["x"], DstT=TfType(graphdef_pb2.DT_INT32)),
        N_("Cast", "cast_f", ["cast_i"], DstT=TfType(graphdef_pb2.DT_FLOAT)),
        N_("Cast", "cast_b", ["cast_i"], DstT=TfType(graphdef_pb2.DT_BOOL)),
        C_("rax", i32([0, 2])),
        N_("Mean", "mean", ["x", "rax"], keep_dims=True), N_("Sum", "sum", ["x", "rax"]),
        N_("Max", "max", ["x", "ax1"]), N_("Min", "min", ["x", "axm1"], keep_dims=True),
        N_("Prod", "prod", ["x", "ax2"]), N_("All", "all", ["cast_b", "rax"]),
        N_("Any", "any", ["cast_b", "ax1"]),
        N_("ArgMax", "argmax", ["x", "ax2"]), N_("ArgMin", "argmin", ["x", "ax1"]),
        C_("rsize", i32([7, 5])), C_("dsize", i32([3, 2])),
        N_("ResizeBilinear", "resize_bl", ["img", "rsize"]),
        N_("ResizeBilinear", "resize_bl_down", ["img", "dsize"]),
        N_("ResizeNearestNeighbor", "resize_nn", ["img", "rsize"])]
    case("shapes", nodes, [("x", xs), ("t", f32(5, 3)), ("img", f32(1, 4, 6, 2))],
         ["reshape", "transpose", "concat", "split:0", "split:1", "splitv:0", "splitv:1",
          "splitv:2", "pad", "padv2", "mpad_r", "mpad_s", "squeeze", "sslice", "sslice_new",
          "slice", "pack", "unpack:0", "unpack:3", "gather", "gather1", "gathernd", "tile",
          "fill", "shapeof", "rank", "size", "range", "cast_f", "cast_b", "mean", "sum", "max",
          "min", "prod", "all", "any", "argmax", "argmin", "resize_bl", "resize_bl_down",
          "resize_nn"])
    return cases


def tf_ops_of(graph: bytes) -> set:
    return {n.op for n in graphdef_pb2.GraphDef.FromString(graph).node} - {"Const", "Placeholder"}


def run_tf_case(case, dev) -> list:
    """Convert and run one TF case on `dev`; the outputs as numpy arrays."""
    graph, feeds, outs = case
    fn, params = tf_frontend.convert_graphdef(graph, outputs=outs, device=dev)
    with no_tf32():
        got = fn(params, *[torch.from_numpy(np.array(a)).to(dev) for _, a in feeds])
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g)
            for g in got]


def tfl_cases(seed: int = SEED + 81) -> dict:
    """Every builtin code of the TFLite frontend's table at least once, on
    seeded inputs. name -> (model bytes, [(input name, array)], output names)."""
    r = np.random.default_rng(seed)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)
    pos = lambda *s: (r.random(s) + 0.5).astype(np.float32)
    i32 = lambda v: np.asarray(v, np.int32)
    cases = {}

    def finish(name, m, feeds, outs: dict):
        m.outputs = list(outs.values())
        for n, i in outs.items():
            m.tensors[i].fields[3] = FbStr(n)
        cases[name] = (m.to_bytes(), feeds, list(outs))

    m = TflModel()
    x, y = m.input((3, 5), name="x"), m.input((3, 5), name="y")
    bi = m.input((3, 5), np.bool_, name="c")
    act = lambda a: {0: ("b", a)}
    outs = {}
    for name, code, ins, opts in [
            ("add_relu", 0, [x, y], act(1)), ("sub", 41, [x, y], act(0)),
            ("mul_relu6", 18, [x, y], act(3)), ("div_tanh", 42, [x, y], act(4)),
            ("add_n1", 0, [x, y], act(2)),
            ("logistic", 14, [x], None), ("relu", 19, [x], None), ("relu6", 21, [x], None),
            ("tanh", 28, [x], None), ("softmax", 25, [x], {0: ("f", 0.5)}),
            ("log_softmax", 50, [x], None), ("exp", 47, [x], None), ("log", 73, [y], None),
            ("sqrt", 75, [y], None), ("rsqrt", 76, [y], None), ("pow", 78, [y, x], None),
            ("neg", 59, [x], None), ("abs", 101, [x], None), ("square", 92, [x], None),
            ("sqdiff", 99, [x, y], None), ("floor", 8, [x], None), ("ceil", 104, [x], None),
            ("round", 116, [x], None), ("floordiv", 90, [x, y], None),
            ("floormod", 95, [x, y], None), ("maximum", 55, [x, y], None),
            ("minimum", 57, [x, y], None), ("less", 58, [x, y], None),
            ("greater", 61, [x, y], None), ("equal", 71, [x, x], None),
            ("not_equal", 72, [x, y], None), ("greater_equal", 62, [x, y], None),
            ("less_equal", 63, [x, y], None), ("prelu", 54, [x, y], None),
            ("leaky", 98, [x], {0: ("f", 0.2)}), ("elu", 111, [x], None),
            ("hard_swish", 117, [x], None), ("gelu", 150, [x], {0: ("B", 1)}),
            ("gelu_exact", 150, [x], None), ("l2norm", 11, [x], None), ("sin", 66, [x], None),
            ("cos", 108, [x], None), ("zeros_like", 93, [x], None),
            ("add_n", 106, [x, y, x], None), ("select", 64, [bi, x, y], None),
            ("select_v2", 123, [bi, x, y], None)]:
        outs[name] = m.op(code, ins, opts=opts)
    lo, gt = outs["less"], outs["greater"]
    outs["or"] = m.op(84, [lo, gt])
    outs["and"] = m.op(86, [lo, bi])
    outs["not"] = m.op(87, [lo])
    outs["cast_i"] = m.op(53, [x], opts={0: ("b", 0), 1: ("b", 2)}, out_dtype=np.int32)
    wq, sc, zp = quantize_per_channel(f32(3, 5), 0)
    outs["dequantize"] = m.op(6, [m.const(wq, "wq", (sc, zp, 0))])
    outs["quantize"] = m.op(114, [x])
    finish("elementwise", m, [("x", f32(3, 5)), ("y", pos(3, 5)),
                              ("c", r.random((3, 5)) > 0.5)], outs)

    m = TflModel()
    x = m.input((2, 9, 9, 3), name="x")
    w = m.const(f32(8, 3, 3, 3) * 0.3, "w")                 # OHWI
    b = m.const(f32(8) * 0.1, "b")
    wd = m.const(f32(1, 3, 3, 6) * 0.3, "wd")               # [1, kh, kw, c x 2]
    wq, sc, zp = quantize_per_channel(f32(8, 3, 3, 3) * 0.3, 0)
    wq8 = m.const(wq, "wq8", (sc, zp, 0))
    wu = (r.integers(0, 256, (8, 3, 3, 3))).astype(np.uint8)
    wu8 = m.const(wu, "wu8", (np.float32(0.01), np.int64(128), 0))
    conv = lambda pad, sw, sh, act_, dw=1, dh=1: {0: ("b", pad), 1: ("i", sw), 2: ("i", sh),
                                                  3: ("b", act_), 4: ("i", dw), 5: ("i", dh)}
    outs = {}
    outs["conv_same"] = m.op(3, [x, w, b], opts=conv(0, 2, 2, 1))
    outs["conv_dil"] = m.op(3, [x, w], opts=conv(1, 1, 1, 0, 2, 2))
    outs["conv_int8"] = m.op(3, [x, wq8, b], opts=conv(0, 1, 1, 3))
    outs["conv_uint8"] = m.op(3, [x, wu8], opts=conv(1, 2, 1, 0))
    outs["dwconv"] = m.op(4, [x, wd], opts={0: ("b", 0), 1: ("i", 2), 2: ("i", 2),
                                             3: ("i", 2), 4: ("b", 1)})
    tshape = m.const(i32([2, 10, 10, 8]), "tshape")
    wt = m.const(f32(8, 3, 3, 8) * 0.3, "wt")
    outs["tconv"] = m.op(67, [tshape, wt, outs["conv_same"]],
                         opts={0: ("b", 0), 1: ("i", 2), 2: ("i", 2)})
    pool = lambda pad, s, k, act_: {0: ("b", pad), 1: ("i", s), 2: ("i", s), 3: ("i", k),
                                     4: ("i", k), 5: ("b", act_)}
    outs["avgpool"] = m.op(1, [outs["conv_dil"]], opts=pool(0, 2, 3, 0))
    outs["maxpool"] = m.op(17, [outs["conv_dil"]], opts=pool(1, 1, 2, 1))
    fw = m.const(f32(4, 8 * 5 * 5) * 0.1, "fw")
    outs["fc"] = m.op(9, [outs["conv_same"], fw, m.const(f32(4), "fb")], opts={0: ("b", 1)})
    ax12, ax3 = m.const(i32([1, 2]), "ax12"), m.const(i32([3]), "ax3")
    outs["mean"] = m.op(40, [outs["conv_same"], ax12], opts={0: ("B", 1)})
    outs["sum"] = m.op(74, [outs["conv_same"], ax3])
    outs["rmax"] = m.op(82, [outs["conv_same"], ax12])
    outs["rmin"] = m.op(89, [outs["conv_same"], ax3], opts={0: ("B", 1)})
    outs["rprod"] = m.op(81, [outs["dwconv"], ax3])
    size = m.const(i32([7, 11]), "size")
    outs["resize_bl"] = m.op(23, [outs["conv_same"], size])
    outs["resize_nn"] = m.op(97, [outs["conv_same"], size])
    s2d = m.op(26, [m.input((1, 4, 6, 2), name="img")], opts={0: ("i", 2)})
    outs["space_to_depth"] = s2d
    outs["depth_to_space"] = m.op(5, [s2d], opts={0: ("i", 2)})
    outs["concat"] = m.op(2, [outs["conv_same"], outs["conv_same"]],
                          opts={0: ("i", 3), 1: ("b", 1)})
    ba, bb = m.const(f32(2, 3, 4), "ba"), m.const(f32(2, 5, 4), "bb")
    outs["bmm"] = m.op(126, [ba, bb], opts={1: ("B", 1)})
    finish("convnet", m, [("x", f32(2, 9, 9, 3)), ("img", f32(1, 4, 6, 2))], outs)

    m = TflModel()
    x = m.input((2, 4, 6), name="x")
    t = m.input((5, 3), name="t")
    c = m.const
    outs = {}
    outs["reshape_opt"] = m.op(22, [x], opts={0: FbVec("i4", [4, 12])})
    outs["reshape_in"] = m.op(22, [x, c(i32([6, -1]), "rs")])
    pads = c(i32([[0, 1], [2, 0], [1, 1]]), "pads")
    outs["pad"] = m.op(34, [x, pads])
    outs["padv2"] = m.op(60, [x, pads, c(np.float32(-2.0), "pv")])
    outs["mpad_r"] = m.op(100, [x, pads], opts={0: ("b", 0)})
    outs["mpad_s"] = m.op(100, [x, pads], opts={0: ("b", 1)})
    outs["transpose"] = m.op(39, [x, c(i32([2, 0, 1]), "perm")])
    ex = m.op(70, [x, c(i32(1), "one")])
    outs["squeeze"] = m.op(43, [ex], opts={0: FbVec("i4", [1])})
    outs["sslice"] = m.op(45, [x, c(i32([1, 0, 5]), "sb"), c(i32([2, 4, 0]), "se"),
                               c(i32([1, 1, -2]), "ss")],
                          opts={0: ("i", 2), 1: ("i", 0), 4: ("i", 1)})
    outs["slice"] = m.op(65, [x, c(i32([0, 1, 2]), "lb"), c(i32([-1, 2, 3]), "ls")])
    outs["gather"] = m.op(36, [x, c(i32([3, 0, 2]), "gi")], opts={0: ("i", 1)})
    outs["gather_nd"] = m.op(107, [x, c(i32([[1, 2], [0, 3]]), "ndi")])
    outs["tile"] = m.op(69, [t, c(i32([2, 1]), "reps")])
    outs["shape"] = m.op(77, [x], out_dtype=np.int32)
    outs["rank"] = m.op(110, [x], out_dtype=np.int32)
    outs["fill"] = m.op(94, [c(i32([2, 3]), "fs"), c(np.float32(0.5), "fv")])
    outs["pack"] = m.op(83, [t, t], opts={0: ("i", 2), 1: ("i", 1)})
    un = m.op(88, [x], n_out=4, opts={0: ("i", 4), 1: ("i", 1)})
    outs["unpack0"], outs["unpack3"] = un[0], un[3]
    sp = m.op(49, [c(i32(2), "two"), x], n_out=2, opts={0: ("i", 2)})
    outs["split0"], outs["split1"] = sp
    sv = m.op(102, [x, c(i32([1, 3, 2]), "svs"), c(i32(2), "two2")], n_out=3,
              opts={0: ("i", 3)})
    outs["splitv0"], outs["splitv2"] = sv[0], sv[2]
    outs["argmax"] = m.op(56, [x, c(i32(2), "a2")], out_dtype=np.int32)
    outs["argmin"] = m.op(79, [x, c(i32(1), "a1")], out_dtype=np.int32)
    finish("shapes", m, [("x", f32(2, 4, 6)), ("t", f32(5, 3))], outs)
    return cases


def tfl_codes_of(model: bytes) -> set:
    from mnn_tpu_torch.convert.tflite_frontend import _parse
    return {o.code for o in _parse(model)[4]}


def run_tfl_case(case, dev) -> list:
    model, feeds, outs = case
    fn, params = tflite_frontend.convert_tflite(model, device=dev)
    with no_tf32():
        got = fn(params, *[torch.from_numpy(np.array(a)).to(dev) for _, a in feeds])
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g)
            for g in got]


def caffe_layer(net, name, type_, bottoms, tops, blobs=(), **params):
    """Add a LayerParameter; `params` maps a `*_param` field to a dict of
    its fields (a list extends a repeated field, a dict fills a message)."""
    layer = net.layer.add(name=name, type=type_)
    layer.bottom.extend(bottoms)
    layer.top.extend(tops)
    for arr in blobs:
        b = layer.blobs.add()
        b.shape.dim.extend(arr.shape)
        b.data.extend(np.asarray(arr, np.float32).reshape(-1))
    for pname, fields in params.items():
        p = getattr(layer, pname)
        for k, v in fields.items():
            if isinstance(v, (list, tuple)):
                getattr(p, k).extend(v)
            elif isinstance(v, dict):
                for kk, vv in v.items():
                    getattr(getattr(p, k), kk).extend(vv)
            else:
                setattr(p, k, v)
        p._mark()
    return layer


def caffe_cases(seed: int = SEED + 82) -> dict:
    """Every layer type of the Caffe frontend's table at least once, as
    NetParameters with their blobs. name -> (NetParameter bytes,
    [(input, array)], output tops)."""
    r = np.random.default_rng(seed)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)
    pos = lambda *s: (r.random(s) + 0.5).astype(np.float32)
    cases = {}
    net = caffe_pb2.NetParameter(name="breadth")
    net.input.append("data")
    net.input_shape.add().dim.extend([2, 4, 9, 9])
    L = lambda *a, **k: caffe_layer(net, *a, **k)
    L("conv", "Convolution", ["data"], ["conv"], [f32(6, 2, 3, 3) * 0.3, f32(6) * 0.1],
      convolution_param=dict(num_output=6, kernel_size=[3], pad=[1], stride=[2], group=2))
    L("conv_dil", "Convolution", ["data"], ["conv_dil"], [f32(4, 4, 3, 3) * 0.3],
      convolution_param=dict(num_output=4, kernel_size=[3], dilation=[2], bias_term=False,
                             pad_h=1, pad_w=0))
    L("deconv", "Deconvolution", ["conv"], ["deconv"], [f32(6, 2, 4, 4) * 0.2, f32(4) * 0.1],
      convolution_param=dict(num_output=4, kernel_size=[4], stride=[2], pad=[1], group=2))
    L("pool_max", "Pooling", ["data"], ["pool_max"],
      pooling_param=dict(pool=caffe_pb2.PoolingParameter.MAX, kernel_size=3, stride=2))
    L("pool_ave", "Pooling", ["data"], ["pool_ave"],
      pooling_param=dict(pool=caffe_pb2.PoolingParameter.AVE, kernel_size=3, stride=2, pad=1))
    L("pool_floor", "Pooling", ["data"], ["pool_floor"],
      pooling_param=dict(pool=caffe_pb2.PoolingParameter.AVE, kernel_h=2, kernel_w=3, stride_h=2,
                         stride_w=1, pad=1, round_mode=caffe_pb2.PoolingParameter.FLOOR))
    L("pool_global", "Pooling", ["conv"], ["pool_global"],
      pooling_param=dict(pool=caffe_pb2.PoolingParameter.MAX, global_pooling=True))
    L("ip", "InnerProduct", ["pool_max"], ["ip"], [f32(5, 64) * 0.1, f32(5)],
      inner_product_param=dict(num_output=5))
    L("ip_t", "InnerProduct", ["pool_max"], ["ip_t"], [f32(16, 7) * 0.1],
      inner_product_param=dict(num_output=7, axis=2, transpose=True, bias_term=False))
    L("bn", "BatchNorm", ["conv"], ["bn"], [f32(6) * 2, pos(6) * 2, np.float32([2.0])])
    L("scale", "Scale", ["bn"], ["scale"], [f32(6), f32(6)], scale_param=dict(bias_term=True))
    L("ip6", "InnerProduct", ["pool_max"], ["ip6"], [f32(6, 64) * 0.1, f32(6)],
      inner_product_param=dict(num_output=6))
    L("scale2", "Scale", ["conv", "ip6"], ["scale2"], scale_param=dict(axis=0))
    L("lrn", "LRN", ["data"], ["lrn"], lrn_param=dict(local_size=3, alpha=1e-2, beta=0.75,
                                                      k=2.0))
    L("split", "Split", ["data"], ["sa", "sb"])
    L("sum", "Eltwise", ["sa", "sb", "data"], ["sum"], eltwise_param=dict(coeff=[0.5, -1.0, 2.0]))
    L("prod", "Eltwise", ["sa", "sb"], ["prod"],
      eltwise_param=dict(operation=caffe_pb2.EltwiseParameter.PROD))
    L("emax", "Eltwise", ["sa", "sb"], ["emax"],
      eltwise_param=dict(operation=caffe_pb2.EltwiseParameter.MAX))
    L("relu", "ReLU", ["data"], ["relu"], relu_param=dict(negative_slope=0.1))
    L("relu0", "ReLU", ["data"], ["relu0"])
    L("relu6", "ReLU6", ["data"], ["relu6"])
    L("prelu", "PReLU", ["data"], ["prelu"], [f32(4)])
    L("prelu_s", "PReLU", ["data"], ["prelu_s"], [np.float32([0.25])])
    L("elu", "ELU", ["data"], ["elu"], elu_param=dict(alpha=0.5))
    for t in ("Sigmoid", "TanH", "AbsVal", "BNLL", "Exp"):
        L(t.lower(), t, ["data"], [t.lower()])
    L("log", "Log", ["exp"], ["log"])
    L("power", "Power", ["absval"], ["power"], power_param=dict(power=1.5, scale=0.5,
                                                               shift=0.25))
    L("softmax", "Softmax", ["data"], ["softmax"])
    L("concat", "Concat", ["data", "relu"], ["concat"], concat_param=dict(axis=1))
    L("slice", "Slice", ["data"], ["s1", "s2", "s3"], slice_param=dict(slice_point=[1, 3],
                                                                        axis=1))
    L("slice_even", "Slice", ["data"], ["e1", "e2"], slice_param=dict(axis=1))
    L("reshape", "Reshape", ["data"], ["reshape"],
      reshape_param=dict(shape={"dim": [0, -1]}, axis=1))
    L("flatten", "Flatten", ["data"], ["flatten"])
    L("drop", "Dropout", ["data"], ["drop"])
    L("argmax", "ArgMax", ["data"], ["argmax"], argmax_param=dict(axis=1))
    consumed = {b for layer in net.layer for b in layer.bottom}
    outs = [t for layer in net.layer for t in layer.top if t not in consumed]
    cases["breadth"] = (net.SerializeToString(), [("data", f32(2, 4, 9, 9))], outs)
    return cases


# -- the three models, written from `models/vision.py`'s modules ---------------

SQUEEZE_SIZE = 227           # SqueezeNet 1.0's deploy net input
P17_BATCHES = (1, 32)        # (kkk), (lll), (mmm): card ms at these batches
P17_PARITY_BATCH = 2         # (lll), (mmm): card against the CPU and the fx path
# a unary builtin code the TFLite table lacks (RELU_N1_TO_1), the plugin standing
# in for it; not CUSTOM (32): the table reads no custom_code, so a plugin there
# would take every custom op of a model
PLUGIN_TFLITE_CODE = 20


def _fire_names(i: int):
    return [f"fire{i}/{n}" for n in ("squeeze1x1", "expand1x1", "expand3x3")]


def squeezenet_prototxt(batch: int) -> str:
    """SqueezeNet 1.0's published deploy net (github.com/forresti/SqueezeNet,
    SqueezeNet_v1.0/deploy.prototxt), written out at `batch` x 3 x 227 x 227,
    fillers and all, as the text a user would hand over."""
    out = ['# SqueezeNet v1.0 deploy net', 'name: "SqueezeNet_v1.0"',
           'layer {', '  name: "data"', '  type: "Input"', '  top: "data"',
           f'  input_param {{ shape: {{ dim: {batch} dim: 3 dim: {SQUEEZE_SIZE} '
           f'dim: {SQUEEZE_SIZE} }} }}', '}']

    def conv(name, bottom, n, k, stride=1, pad=0):
        out.extend(['layer {', f'  name: "{name}"', '  type: "Convolution"',
                    f'  bottom: "{bottom}"', f'  top: "{name}"',
                    '  convolution_param {', f'    num_output: {n}']
                   + ([f'    pad: {pad}'] if pad else []) + [f'    kernel_size: {k}']
                   + ([f'    stride: {stride}'] if stride != 1 else [])
                   + ['    weight_filler {', '      type: "xavier"', '    }', '  }', '}'])

    def relu(name, top):
        out.extend(['layer {', f'  name: "{name}"', '  type: "ReLU"', f'  bottom: "{top}"',
                    f'  top: "{top}"', '}'])

    def pool(name, bottom, kind="MAX", k=3, stride=2, glob=False):
        body = ([f'    pool: {kind}', '    global_pooling: true'] if glob else
                [f'    pool: {kind}', f'    kernel_size: {k}', f'    stride: {stride}'])
        out.extend(['layer {', f'  name: "{name}"', '  type: "Pooling"', f'  bottom: "{bottom}"',
                    f'  top: "{name}"', '  pooling_param {'] + body + ['  }', '}'])

    def fire(i, bottom, s, e):
        sq, e1, e3 = _fire_names(i)
        conv(sq, bottom, s, 1)
        relu(f"fire{i}/relu_squeeze1x1", sq)
        conv(e1, sq, e, 1)
        relu(f"fire{i}/relu_expand1x1", e1)
        conv(e3, sq, e, 3, pad=1)
        relu(f"fire{i}/relu_expand3x3", e3)
        out.extend(['layer {', f'  name: "fire{i}/concat"', '  type: "Concat"',
                    f'  bottom: "{e1}"', f'  bottom: "{e3}"', f'  top: "fire{i}/concat"', '}'])
        return f"fire{i}/concat"

    conv("conv1", "data", 96, 7, stride=2)
    relu("relu_conv1", "conv1")
    pool("pool1", "conv1")
    x = fire(2, "pool1", 16, 64)
    x = fire(3, x, 16, 64)
    x = fire(4, x, 32, 128)
    pool("pool4", x)
    x = fire(5, "pool4", 32, 128)
    x = fire(6, x, 48, 192)
    x = fire(7, x, 48, 192)
    x = fire(8, x, 64, 256)
    pool("pool8", x)
    x = fire(9, "pool8", 64, 256)
    out.extend(['layer {', '  name: "drop9"', '  type: "Dropout"', f'  bottom: "{x}"',
                f'  top: "{x}"', '  dropout_param {', '    dropout_ratio: 0.5', '  }', '}'])
    conv("conv10", x, 1000, 1)
    relu("relu_conv10", "conv10")
    pool("pool10", "conv10", "AVE", glob=True)
    out.extend(['layer {', '  name: "prob"', '  type: "Softmax"', '  bottom: "pool10"',
                '  top: "prob"', '}'])
    return "\n".join(out) + "\n"


def squeezenet_caffemodel(mod) -> bytes:
    """The weights of `models/vision.squeezenet_v1_0` as a caffemodel (a
    NetParameter of named layers with their blobs), by the port's codec."""
    import torch.nn as nn

    net = caffe_pb2.NetParameter(name="SqueezeNet_v1.0")
    feats = list(mod.features)
    convs = [("conv1", feats[0])]
    fires = [m for m in feats if not isinstance(m, (nn.Conv2d, nn.ReLU, nn.MaxPool2d))]
    for i, f in zip(range(2, 10), fires):
        convs += list(zip(_fire_names(i), (f.squeeze, f.e1, f.e3)))
    convs.append(("conv10", mod.classifier[1]))
    for name, conv in convs:
        caffe_layer(net, name, "Convolution", [], [],
                    [conv.weight.detach().numpy(), conv.bias.detach().numpy()])
    return net.SerializeToString()


def resnet50_graphdef(mod) -> bytes:
    """`models/vision.resnet50` as a frozen NHWC GraphDef: Conv2D (a Pad op
    first where TF's SAME would pad otherwise than the module),
    FusedBatchNormV3, Relu, MaxPool, AddV2, Mean, MatMul, BiasAdd, Softmax;
    outputs "logits" and "prob"."""
    nodes = [tf_placeholder("input")]
    t = lambda v: np.ascontiguousarray(v.detach().numpy())

    def conv_bn(x, name, conv, bn, relu):
        k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
        nodes.append(tf_const(f"{name}/w", t(conv.weight).transpose(2, 3, 1, 0)))
        pad = "VALID"
        if p and (k == 1 or s == 1) and 2 * p == k - 1:
            pad = "SAME"                     # TF's SAME is the module's padding here
        elif p:
            nodes.append(tf_const(f"{name}/pads", np.asarray(
                [[0, 0], [p, p], [p, p], [0, 0]], np.int32)))
            nodes.append(tf_node("Pad", f"{name}/pad", [x, f"{name}/pads"]))
            x = f"{name}/pad"
        nodes.append(tf_node("Conv2D", f"{name}/conv", [x, f"{name}/w"],
                             strides=[1, s, s, 1], padding=pad, data_format="NHWC",
                             T=TfType(graphdef_pb2.DT_FLOAT)))
        for k_, v in (("gamma", bn.weight), ("beta", bn.bias), ("mean", bn.running_mean),
                      ("var", bn.running_var)):
            nodes.append(tf_const(f"{name}/bn/{k_}", t(v)))
        nodes.append(tf_node("FusedBatchNormV3", f"{name}/bn",
                             [f"{name}/conv"] + [f"{name}/bn/{k_}" for k_ in
                                                 ("gamma", "beta", "mean", "var")],
                             epsilon=float(bn.eps), is_training=False, data_format="NHWC"))
        if not relu:
            return f"{name}/bn"
        nodes.append(tf_node("Relu", f"{name}/relu", [f"{name}/bn"]))
        return f"{name}/relu"

    x = conv_bn("input", "stem", mod.stem[0], mod.stem[1], True)
    nodes.append(tf_const("stem/pool/pads", np.asarray([[0, 0], [1, 1], [1, 1], [0, 0]],
                                                       np.int32)))
    nodes.append(tf_node("Pad", "stem/pool/pad", [x, "stem/pool/pads"]))   # 0 after a ReLU
    nodes.append(tf_node("MaxPool", "stem/pool", ["stem/pool/pad"], ksize=[1, 3, 3, 1],
                         strides=[1, 2, 2, 1], padding="VALID", data_format="NHWC"))
    x = "stem/pool"
    for li, layer in enumerate((mod.layer1, mod.layer2, mod.layer3, mod.layer4), 1):
        for bi, blk in enumerate(layer):
            p = f"layer{li}/{bi}"
            idn = x if blk.down is None else conv_bn(x, f"{p}/down", blk.down[0],
                                                     blk.down[1], False)
            y = conv_bn(x, f"{p}/c1", blk.c1, blk.b1, True)
            y = conv_bn(y, f"{p}/c2", blk.c2, blk.b2, True)
            y = conv_bn(y, f"{p}/c3", blk.c3, blk.b3, False)
            nodes.append(tf_node("AddV2", f"{p}/add", [y, idn]))
            nodes.append(tf_node("Relu", f"{p}/out", [f"{p}/add"]))
            x = f"{p}/out"
    nodes += [tf_const("pool/axes", np.asarray([1, 2], np.int32)),
              tf_node("Mean", "pool", [x, "pool/axes"], keep_dims=False),
              tf_const("fc/w", t(mod.fc.weight).T), tf_const("fc/b", t(mod.fc.bias)),
              tf_node("MatMul", "fc/matmul", ["pool", "fc/w"]),
              tf_node("BiasAdd", "logits", ["fc/matmul", "fc/b"], data_format="NHWC"),
              tf_node("Softmax", "prob", ["logits"])]
    return tf_graph(nodes)


def mobilenet_v2_tflite(mod, int8: bool = False) -> bytes:
    """`models/vision.mobilenet_v2` as a TFLite model, batch norm folded into
    the convolutions (f64, then f32), as TFLite's converter folds it:
    CONV_2D and DEPTHWISE_CONV_2D with fused RELU6, a PAD before each
    stride-2 3 x 3 (TFLite's SAME would pad otherwise than the module), ADD,
    MEAN, FULLY_CONNECTED, SOFTMAX; outputs "logits" and "prob". `int8`:
    every weight int8 per output channel (symmetric, TFLite's
    `quantized_dimension`)."""
    import torch.nn as nn

    m = TflModel()
    x = m.input((1, 224, 224, 3), name="input")
    n_w = [0]

    def weight(arr, qdim):
        n_w[0] += 1
        if not int8:
            return m.const(arr.astype(np.float32), f"w{n_w[0]}")
        q, sc, zp = quantize_per_channel(arr.astype(np.float32), qdim)
        return m.const(q, f"w{n_w[0]}", (sc, zp, qdim))

    def conv_bn(x, conv, bn, act):
        w = conv.weight.detach().double().numpy()
        s = (bn.weight.detach().double() / torch.sqrt(bn.running_var.detach().double()
                                                       + bn.eps)).numpy()
        b = (bn.bias.detach().double().numpy() - bn.running_mean.detach().double().numpy() * s)
        w = w * s[:, None, None, None]
        k, st = conv.kernel_size[0], conv.stride[0]
        pad = 1 if k == 1 else 0                       # VALID / SAME
        if k == 3 and st == 2:
            x = m.op(34, [x, m.const(np.asarray([[0, 0], [1, 1], [1, 1], [0, 0]], np.int32))])
            pad = 1
        bias = m.const(b.astype(np.float32), f"b{n_w[0] + 1}")
        if conv.groups == 1:
            opts = {0: ("b", pad), 1: ("i", st), 2: ("i", st), 3: ("b", act)}
            return m.op(3, [x, weight(w.transpose(0, 2, 3, 1), 0), bias], opts=opts)
        opts = {0: ("b", pad), 1: ("i", st), 2: ("i", st), 3: ("i", 1), 4: ("b", act)}
        return m.op(4, [x, weight(w[:, 0].transpose(1, 2, 0)[None], 3), bias], opts=opts)

    def seq(x, mods):
        i = 0
        while i < len(mods):
            relu6 = i + 2 < len(mods) and isinstance(mods[i + 2], nn.ReLU6)
            x = conv_bn(x, mods[i], mods[i + 1], 3 if relu6 else 0)
            i += 3 if relu6 else 2
        return x

    for blk in mod.features:
        if isinstance(blk, nn.Sequential):               # conv_bn
            x = seq(x, list(blk))
        else:                                            # an inverted residual
            mods = [mm for sub in blk.conv for mm in (sub if isinstance(sub, nn.Sequential)
                                                       else [sub])]
            y = seq(x, mods)
            x = m.op(0, [x, y], opts={0: ("b", 0)}) if blk.use_res else y
    x = m.op(40, [x, m.const(np.asarray([1, 2], np.int32))], opts={0: ("B", 0)})
    fw = mod.classifier.weight.detach().numpy()
    logits = m.op(9, [x, weight(fw, 0), m.const(mod.classifier.bias.detach().numpy(), "fc_b")],
                  opts={0: ("b", 0)})
    prob = m.op(25, [logits], opts={0: ("f", 1.0)})
    m.outputs = [logits, prob]
    m.tensors[logits].fields[3] = FbStr("logits")
    m.tensors[prob].fields[3] = FbStr("prob")
    return m.to_bytes()


def fx_logits(mod, x: torch.Tensor, dev):
    """Phase 15's fx path of the same module on the card, f32, TF32 off."""
    fn, p = convert_torch_module(mod, device=dev)
    with torch.no_grad(), no_tf32():
        return fn(p, x.to(dev)).float().cpu()


def layout_share(fn, calls: int = 3) -> dict:
    """Device time of one call by torch.profiler, and the share of it in
    layout kernels: copies (a weight laid out for cuDNN, a permuted tensor
    made contiguous) and cuDNN's NCHW / NHWC transposes."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(evs), "the profiler recorded no device time")
    layout = [e for e in evs if any(s in e.key for s in ("copy", "nchwToNhwc", "nhwcToNchw",
                                                         "ranspose"))]
    total = sum(e.self_device_time_total for e in evs) / 1e3 / calls
    lay = sum(e.self_device_time_total for e in layout) / 1e3 / calls
    return dict(device_ms=total, layout_ms=lay, layout_share=lay / total,
                layout_kernels={e.key[:120]: e.self_device_time_total / 1e3 / calls
                                for e in layout})


def calibrated_mobilenet_v2():
    """`models/vision.mobilenet_v2` (seeded) with batch norms as trained
    weights have them: seeded gamma / beta and the running statistics of one
    training-mode pass over a seeded batch. With the default statistics its
    activations vanish and the logits are the classifier's bias."""
    import torch.nn as nn

    mod = seeded_module("mobilenet_v2")
    g = torch.Generator().manual_seed(SEED + 94)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = 1.0
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
        mod.train()
        mod(torch.randn(8, 3, CNN_SIZE, CNN_SIZE, generator=g))
    return mod.eval()


def _frontend_model(label, convert, run, x_of, mod, fx_x, dev, card_line, cpu_batches):
    """Convert on the card and the CPU, hold card logits to the CPU's at the
    given batches and to the fx path's (all within rel-L2 1e-4, TF32 off),
    and time the card at P17_BATCHES."""
    t0 = time.perf_counter()
    fn_card, p_card = convert(dev)
    convert_s = time.perf_counter() - t0
    fn_cpu, p_cpu = convert("cpu")
    row = dict(convert_s=convert_s, rel_to_cpu={}, ms={})
    g = torch.Generator().manual_seed(SEED + 90)
    for b in cpu_batches:
        xb = x_of(torch.randn(b, 3, *fx_x.shape[2:], generator=g))
        with torch.no_grad(), no_tf32():
            card = run(fn_card, p_card, xb.to(dev)).float().cpu()
            cpu = run(fn_cpu, p_cpu, xb).float()
        row["rel_to_cpu"][b] = rel_l2(card, cpu)
        check(row["rel_to_cpu"][b] <= CNN_F32_REL,
              f"({label}) batch {b} card vs cpu rel-L2 {row['rel_to_cpu'][b]:.3g}")
    with torch.no_grad(), no_tf32():
        card = run(fn_card, p_card, x_of(fx_x).to(dev)).float().cpu()
    row["rel_to_fx"] = rel_l2(card, fx_logits(mod, fx_x, dev))
    check(row["rel_to_fx"] <= CNN_F32_REL,
          f"({label}) vs the fx path rel-L2 {row['rel_to_fx']:.3g}")
    for b in P17_BATCHES:
        xb = x_of(torch.randn(b, 3, *fx_x.shape[2:], generator=g)).to(dev)
        with torch.no_grad():
            row["ms"][b] = event_ms(lambda i: run(fn_card, p_card, xb), 10)
    return fn_card, p_card, row


def phase_caffe_squeezenet(dev, card_line):
    """(kkk) SqueezeNet 1.0's deploy prototxt and a caffemodel of
    `models/vision.squeezenet_v1_0`'s weights, read and converted by the
    port; logits (the net without its `prob` layer) card against CPU at
    batch 1 and 32 and against the fx path; the read seconds; card ms."""
    mod = seeded_module("squeezenet_v1.0")
    model = squeezenet_caffemodel(mod)
    t0 = time.perf_counter()
    parsed = caffe_pb2.NetParameter.FromString(model)
    read_s = time.perf_counter() - t0
    check(parsed.SerializeToString() == model, "(kkk) caffemodel bytes do not round-trip")
    net = caffe_frontend.load_prototxt(squeezenet_prototxt(1))
    check(len(net.layer) == 67 and net.layer[-1].type == "Softmax",
          f"(kkk) the deploy net parsed to {len(net.layer)} layers")
    logits_net = caffe_pb2.NetParameter()
    logits_net.CopyFrom(net)
    del logits_net.layer[-1]                  # pool10's output: the logits

    def convert(d):
        return caffe_frontend.convert_caffe(logits_net, model, device=d)

    run = lambda fn, p, x: fn(p, x).reshape(x.shape[0], -1)
    x = torch.randn(P17_PARITY_BATCH, 3, SQUEEZE_SIZE, SQUEEZE_SIZE,
                    generator=torch.Generator().manual_seed(SEED + 91))
    fn, p, row = _frontend_model("kkk", convert, run, lambda v: v, mod, x, dev, card_line,
                                 P17_BATCHES)
    fnp, pp = caffe_frontend.convert_caffe(net, model, device=dev)
    with torch.no_grad(), no_tf32():
        prob = fnp(pp, x.to(dev)).reshape(x.shape[0], -1).float().cpu()
        want = torch.softmax(run(fn, p, x.to(dev)).float().cpu(), -1)
    row.update(caffemodel_bytes=len(model), caffemodel_read_s=read_s, layers=len(net.layer),
               prob_rel=rel_l2(prob, want))
    check(row["prob_rel"] <= 1e-5, f"(kkk) prob vs softmax(logits) {row['prob_rel']:.3g}")
    print(f"  (kkk) Caffe SqueezeNet 1.0 ({len(net.layer)} layers, caffemodel {len(model)} B "
          f"read in {read_s:.3f} s): card vs cpu rel-L2 {row['rel_to_cpu']}, vs the fx path "
          f"{row['rel_to_fx']:.3g}; ms {row['ms']} [{card_line}]", flush=True)
    return row


def phase_tf_resnet50(dev, card_line):
    """(lll) ResNet-50 as a frozen NHWC GraphDef written by the port's codec:
    logits card against CPU and against the fx path; ms at batch 1 and 32;
    the layout kernels' share of the card's time at batch 32."""
    mod = seeded_module("resnet50")
    t0 = time.perf_counter()
    graph = resnet50_graphdef(mod)
    write_s = time.perf_counter() - t0
    check(graphdef_pb2.GraphDef.FromString(graph).SerializeToString() == graph,
          "(lll) GraphDef bytes do not round-trip")

    def convert(d):
        return tf_frontend.convert_graphdef(graph, outputs=["logits"], device=d)

    nhwc = lambda v: v.permute(0, 2, 3, 1).contiguous()
    x = torch.randn(P17_PARITY_BATCH, 3, CNN_SIZE, CNN_SIZE,
                    generator=torch.Generator().manual_seed(SEED + 71))
    fn, p, row = _frontend_model("lll", convert, lambda f, pp, v: f(pp, v), nhwc, mod, x, dev,
                                 card_line, (P17_PARITY_BATCH,))
    x32 = nhwc(torch.randn(32, 3, CNN_SIZE, CNN_SIZE)).to(dev)
    fx_fn, fx_p = convert_torch_module(mod, device=dev)
    x32n = torch.randn(32, 3, CNN_SIZE, CNN_SIZE).to(dev)
    with torch.no_grad():
        row["layout_b32"] = layout_share(lambda: fn(p, x32))
        row["fx_b32"] = layout_share(lambda: fx_fn(fx_p, x32n))
    row.update(graph_bytes=len(graph), write_s=write_s,
               nodes=len(graphdef_pb2.GraphDef.FromString(graph).node), ops=sorted(tf_ops_of(graph)))
    print(f"  (lll) TF ResNet-50 ({row['nodes']} nodes, {len(graph)} B): card vs cpu rel-L2 "
          f"{row['rel_to_cpu']}, vs the fx path {row['rel_to_fx']:.3g}; ms {row['ms']}; at "
          f"batch 32 device {row['layout_b32']['device_ms']:.2f} ms, layout kernels "
          f"{row['layout_b32']['layout_ms']:.2f} ms ({100 * row['layout_b32']['layout_share']:.1f} "
          f"%), the fx path (NCHW) {row['fx_b32']['device_ms']:.2f} ms [{card_line}]", flush=True)
    return row


def phase_tflite_mobilenet(dev, card_line):
    """(mmm) MobileNetV2 1.0 at 224 as a TFLite model (batch norm folded),
    written by `mobilenet_v2_tflite` from `calibrated_mobilenet_v2`: logits
    card against CPU and against the fx path of the same module; then the
    int8 per-channel model card against CPU."""
    mod = calibrated_mobilenet_v2()
    model = mobilenet_v2_tflite(mod)
    nhwc = lambda v: v.permute(0, 2, 3, 1).contiguous()
    run = lambda f, p, v: f(p, v)[0]

    def convert(d, m=model):
        return tflite_frontend.convert_tflite(m, device=d)

    x = torch.randn(P17_PARITY_BATCH, 3, CNN_SIZE, CNN_SIZE,
                    generator=torch.Generator().manual_seed(SEED + 92))
    _, _, row = _frontend_model("mmm", convert, run, nhwc, mod, x, dev, card_line,
                                (P17_PARITY_BATCH,))
    q = mobilenet_v2_tflite(mod, int8=True)
    fq, pq = convert(dev, q)
    fc, pc = convert("cpu", q)
    with torch.no_grad(), no_tf32():
        card = run(fq, pq, nhwc(x).to(dev)).float().cpu()
        cpu = run(fc, pc, nhwc(x)).float()
        f32_card = run(*convert(dev), nhwc(x).to(dev)).float().cpu()
    row.update(model_bytes=len(model), int8_bytes=len(q), int8_rel_to_cpu=rel_l2(card, cpu),
               int8_rel_to_f32=rel_l2(card, f32_card), codes=sorted(tfl_codes_of(model)))
    check(row["int8_rel_to_cpu"] <= CNN_F32_REL,
          f"(mmm) int8 card vs cpu rel-L2 {row['int8_rel_to_cpu']:.3g}")
    print(f"  (mmm) TFLite MobileNetV2 ({len(model)} B): card vs cpu rel-L2 {row['rel_to_cpu']}, "
          f"vs the fx path {row['rel_to_fx']:.3g}; ms {row['ms']}; int8 per-channel ({len(q)} B) "
          f"card vs cpu {row['int8_rel_to_cpu']:.3g}, vs the f32 model "
          f"{row['int8_rel_to_f32']:.3g} [{card_line}]", flush=True)
    return row


def phase_frontend_breadth(dev):
    """(nnn) every entry of the three tables in small graphs, card against
    CPU: integers equal, floats within 1e-5."""
    out = {}
    for label, cases, ops_of, table, runner in (
            ("tf", tf_cases(), tf_ops_of, tf_frontend._OPS, run_tf_case),
            ("tflite", tfl_cases(), tfl_codes_of, tflite_frontend._OPS, run_tfl_case),
            ("caffe", caffe_cases(), caffe_types_of, caffe_frontend._LAYERS, run_caffe_case)):
        covered = set().union(*(ops_of(c[0]) for c in cases.values()))
        check(covered == set(table), f"(nnn) {label} entries not covered: "
                                     f"{sorted(set(table) - covered, key=str)}")
        worst = {}
        for name, case in cases.items():
            worst[name] = onnx_worst(runner(case, dev), runner(case, "cpu"), case[2])
            check(worst[name] <= ONNX_TOL, f"(nnn) {label} {name}: card vs cpu {worst[name]:.3g}")
        out[label] = dict(cases=worst, entries=len(covered))
    print("  (nnn) breadth, card vs cpu (ints equal): " + "; ".join(
        f"{k} {v['entries']} entries, floats within {max(v['cases'].values()):.3g}"
        for k, v in out.items()), flush=True)
    return out


def caffe_types_of(net: bytes) -> set:
    return {layer.type for layer in caffe_pb2.NetParameter.FromString(net).layer}


def run_caffe_case(case, dev) -> list:
    net, feeds, outs = case
    fn, params = caffe_frontend.convert_caffe(caffe_pb2.NetParameter.FromString(net), device=dev)
    with no_tf32():
        got = fn(params, *[torch.from_numpy(np.array(a)).to(dev) for _, a in feeds])
    got = got if isinstance(got, tuple) else (got,)
    return [g.detach().cpu().numpy() for g in got]


def plugin_graphs(shape) -> dict:
    """x -> the plugin op -> y in each of the three formats: a NodeDef op
    `MnnTpuSoftShrink`, a Caffe layer type `MnnTpuSoftShrink`, a TFLite
    operator of builtin code `PLUGIN_TFLITE_CODE`."""
    net = caffe_pb2.NetParameter(name="plugin")
    net.input.append("x")
    net.input_shape.add().dim.extend(shape)
    caffe_layer(net, "shrink", PLUGIN_OP, ["x"], ["y"])
    m = TflModel()
    x = m.input(shape, name="x")
    m.outputs = [m.op(PLUGIN_TFLITE_CODE, [x])]
    return dict(tf=tf_graph([tf_placeholder("x"), tf_node(PLUGIN_OP, "y", ["x"])]),
                caffe=net.SerializeToString(), tflite=m.to_bytes())


def convert_plugin_graph(frontend: str, graph: bytes, dev):
    if frontend == "tf":
        return tf_frontend.convert_graphdef(graph, device=dev)
    if frontend == "caffe":
        return caffe_frontend.convert_caffe(caffe_pb2.NetParameter.FromString(graph), device=dev)
    return tflite_frontend.convert_tflite(graph, device=dev)


PLUGIN_KEYS = {"tf": PLUGIN_OP, "caffe": PLUGIN_OP, "tflite": PLUGIN_TFLITE_CODE}
PLUGIN_FNS = {  # softshrink backed by row 10, in each table's signature
    "tf": lambda ctx, node, x: softshrink.softshrink(ctx.t(x), SOFTSHRINK_LAM),
    "tflite": lambda ctx, op, x: softshrink.softshrink(ctx.t(x), SOFTSHRINK_LAM),
    "caffe": lambda ctx, layer, blobs, x: softshrink.softshrink(x, SOFTSHRINK_LAM)}


def phase_frontend_plugins(dev, shape=(32, 256, 56, 56)):
    """(ooo) softshrink registered in the tf, caffe and tflite tables, backed
    by row 10: each converted graph refused before registration, then run on
    a [32, 256, 56, 56] bf16 activation with the plain version's bits."""
    out = {}
    g = torch.Generator(dev).manual_seed(SEED + 93)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    want = softshrink.softshrink_plain(x, SOFTSHRINK_LAM).view(torch.int16)
    for frontend, graph in plugin_graphs(list(shape)).items():
        key = PLUGIN_KEYS[frontend]
        try:
            convert_plugin_graph(frontend, graph, dev)
            fail(f"(ooo) the unregistered {frontend} plugin op converted")
        except NotImplementedError:
            pass
        plugin.register_op(key, PLUGIN_FNS[frontend], frontend=frontend)
        try:
            fn, params = convert_plugin_graph(frontend, graph, dev)
            y = fn(params, x)
            check(torch.equal(y.view(torch.int16), want),
                  f"(ooo) {frontend} plugin: not the plain version's bits")
        finally:
            plugin.unregister_op(key, frontend=frontend)
        check(key not in plugin.registered_ops(frontend), f"(ooo) {frontend} still registered")
        out[frontend] = dict(key=key, shape=list(shape))
    return out


def phase_frontends(dev, card_line):
    """Phase 17, (kkk) to (ooo), each sub-phase with its launch counts set
    to 0 before and read after: only the plugin path launches row 10."""
    t17 = time.perf_counter()
    out, secs, counts = {}, {}, {}
    for key, fn in (("kkk", lambda: phase_caffe_squeezenet(dev, card_line)),
                    ("lll", lambda: phase_tf_resnet50(dev, card_line)),
                    ("mmm", lambda: phase_tflite_mobilenet(dev, card_line)),
                    ("nnn", lambda: phase_frontend_breadth(dev)),
                    ("ooo", lambda: phase_frontend_plugins(dev))):
        t0 = time.perf_counter()
        build.reset_launches()
        out[key] = fn()
        counts[key] = launch_counts()
        must = {"mnn_softshrink"} if key == "ooo" else set()
        check(all(counts[key][k] > 0 for k in must)
              and not any(v for k, v in counts[key].items() if k not in must),
              f"({key}) launches {counts[key]}")
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["launches"] = counts
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t17
    print("  phase 17 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    print(f"  phase 17: {out['seconds']:.1f} s; row 10 launched "
          f"{counts['ooo']['mnn_softshrink']} times on the three plugin paths", flush=True)
    return out


KERNEL_INFO = {  # kernel -> (source, TPU kernel it replaces, C entry)
    "dequant_matmul": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                       "mnn_tpu/kernels/dequant_matmul.py:156", "mnn_dequant_matmul"),
    "dequant_matmul_a8": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                          "mnn_tpu/kernels/dequant_matmul.py:67", "mnn_dequant_matmul_a8"),
    "flash_prefill": ("mnn_tpu_torch/csrc/flash_prefill.cu",
                      "mnn_tpu/kernels/flash_attention.py:86", "mnn_flash_prefill"),
    "decode_step": ("mnn_tpu_torch/csrc/decode_step.cu",
                    "mnn_tpu/kernels/decode_step.py:57", "mnn_decode_step"),
    "flash_decode": ("mnn_tpu_torch/csrc/flash_decode.cu",
                     "mnn_tpu/kernels/flash_attention.py:252", "mnn_flash_decode"),
    "decode_model": ("mnn_tpu_torch/csrc/decode_model.cuh",
                     "mnn_tpu/kernels/decode_model.py:581", "mnn_decode_model"),
    "dequant_matmul_deq": ("mnn_tpu_torch/csrc/dequant_matmul.cu",
                           "mnn_tpu/kernels/dequant_matmul.py:115", "mnn_dequant_matmul_deq"),
    "moe_decode": ("mnn_tpu_torch/csrc/moe_decode.cu",
                   "mnn_tpu/kernels/moe_decode.py:115", "mnn_moe_decode"),
    "moe_prefill": ("mnn_tpu_torch/csrc/moe_prefill.cu",
                    "mnn_tpu/kernels/moe_prefill.py:80", "mnn_moe_prefill"),
}
# phase 8: a kernel's W3/W2 rows by route, and the sub-phase and C entry
# whose count is the route's launches
SUB4_ROWS_OF = {"dequant_matmul": ("gemv", "tile"), "dequant_matmul_a8": ("a8",),
                "dequant_matmul_deq": ("deq",), "decode_model": ("model",)}
SUB4_COUNTED = {"gemv": ("serve", "mnn_dequant_matmul"),
                "tile": ("act16", "mnn_dequant_matmul_bf16_tile"),
                "a8": ("serve", "mnn_dequant_matmul_a8"),
                "deq": ("deq_switch", "mnn_dequant_matmul_deq"),
                "model": ("serve", "mnn_decode_model")}
# the sub-phase of phase 3 whose run gives a kernel its launch count
COUNTED_IN = {"mnn_decode_step": "per_layer_int8", "mnn_flash_decode": "per_layer_int4",
              "mnn_moe_decode": "moe_int8", "mnn_moe_prefill": "moe_int8",
              "mnn_dequant_matmul_deq": "moe_deq_switch",
              "mnn_dequant_matmul_bf16_tile": "dense_act16"}


# phase 16's block-256 rows (and row 2's block-176 one) by kernel
B256_ROWS = {"dequant_matmul": ("dequant_matmul_b256", "dequant_matmul_tile_b256"),
             "dequant_matmul_a8": ("dequant_matmul_a8_b256",),
             "dequant_matmul_deq": ("dequant_matmul_deq_b256",),
             "decode_model": ("decode_model_b256",), "moe_decode": ("moe_decode_b256",),
             "moe_prefill": ("moe_prefill_b256",)}


# phase 10's rows in the kernels line: kernel -> (key, results key, C entry)
SPEC_ROWS = {"dequant_matmul": ("verify", "dequant_matmul_verify",
                                "mnn_dequant_matmul_bf16_tile"),
             "flash_prefill": ("verify", "flash_prefill_verify", "mnn_flash_prefill"),
             "flash_decode": ("draft_cache", "flash_decode_draft", "mnn_flash_decode")}


def spec_launches(specd: dict, entry: str) -> int:
    """The launches of `entry` in phase 10's streams, (cc) to (gg)."""
    return sum(run["launches"][entry] for sub in SPEC_MODES
               for key, run in specd[sub].items() if key != "seconds")


def row_sums(rows) -> dict:
    """A kernel's numbers in the kernels line: sums of one call at each shape."""
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=(None if rows[0]["library_ms"] is None
                            else sum(r["library_ms"] for r in rows)),
                shapes=len(rows))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    check(Path(mnn_tpu_torch.__file__).resolve().is_relative_to(HERE),
          f"mnn_tpu_torch imported from {mnn_tpu_torch.__file__}, not this checkout")
    for mod in ("jax", "mnn_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card_line = smi[0] if smi else "unknown"
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (nvcc sm_90a, {build.lib_path})",
          flush=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "nvcc_log.txt").write_text(build.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results: dict = {}
    print("phase 2: kernels against their plain versions", flush=True)
    phase_gemm(dev, g, results, a8=False)
    phase_gemm(dev, g, results, a8=True)
    phase_gemm(dev, g, results, a8=False, shapes=VERIFY_GEMM, key="dequant_matmul_verify")
    phase_gemm(dev, g, results, a8=True, shapes=QWEN7B_PREFILL, key="dequant_matmul_a8_7b")
    phase_gemm(dev, g, results, a8=False, shapes=QWEN7B_GEMV, key="dequant_matmul_7b")
    phase_flash(dev, g, results)
    phase_flash_verify(dev, g, results)
    phase_flash_7b(dev, g, results)
    phase_decode(dev, g, results)
    phase_decode(dev, g, results, DECODE_ROWS_7B, MM_CAP, "decode_step_7b")
    phase_decode_gemma(dev, g, results)
    phase_flash_decode(dev, g, results)
    phase_flash_decode_kv(dev, g, results)
    phase_flash_decode_kv(dev, g, results, FLASH_DECODE_DRAFT_ROWS, "flash_decode_draft")
    phase_gemm_deq(dev, g, results)
    phase_moe_decode(dev, g, results)
    phase_moe_prefill(dev, g, results)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llm = Llm.synthetic("qwen2-0.5b", rt=serving_rt(), seed=SEED, device=dev)
    cfg = llm.config
    print(f"  model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, vocab "
          f"{cfg.vocab_size}; built in {time.perf_counter() - t0:.1f} s; "
          f"info {json.dumps(llm.info())}", flush=True)
    params7 = phase_decode_model(dev, g, results, llm.params)
    torch.cuda.empty_cache()

    # phase 11 runs here, on the qwen2-7b weights phase 2 built (28 layers)
    print("phase 11: multimodal input on the card (qwen2-7b + mrope, Qwen2.5-VL and "
          "whisper towers)", flush=True)
    multimodal = phase_multimodal(dev, params7, llm.params, card_line)
    torch.cuda.empty_cache()
    # phase 13 runs here too, on the same qwen2-7b thinker
    print("phase 13: generative output on the card (speech out through the talker, "
          "BigVGAN and the mel ODE; Stable Diffusion 1.5)", flush=True)
    generative = phase_generative(dev, params7, card_line)
    torch.cuda.empty_cache()       # params7 stays for phase 16's block-128 run

    print("phase 3: serving qwen2-0.5b on the card", flush=True)
    reqs, outs, perf, counts = phase_serve(llm)
    perf["dense_act16"], counts["dense_act16"] = phase_serve_act16(llm, reqs)

    print("phase 4: the first request on the card and on the cpu", flush=True)
    parity = phase_parity(llm, reqs, outs)

    print("phase 5 (g, i): serving batched requests of qwen2-0.5b on the card", flush=True)
    t5 = time.perf_counter()
    eng, serve_batched = phase_serve_batched(llm, card_line)
    serve_batched["server"] = phase_server(llm, eng, card_line)
    del eng
    phase5_s = time.perf_counter() - t5
    params05 = llm.params           # phase 9's weights
    del llm
    torch.cuda.empty_cache()

    print(f"phase 3 (d, e): serving {MOE_PRESET} on the card", flush=True)
    t0 = time.perf_counter()
    moe = Llm.synthetic(MOE_PRESET, rt=serving_rt(), seed=SEED, device=dev)
    mcfg = moe.config
    print(f"  model: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
          f"{mcfg.num_experts} experts top-{mcfg.num_experts_per_tok} of "
          f"{mcfg.moe_intermediate_size}, shared {mcfg.shared_expert_intermediate_size}; "
          f"built in {time.perf_counter() - t0:.1f} s; info {json.dumps(moe.info())}",
          flush=True)
    moe_perf, moe_counts, moe_extra = phase_serve_moe(moe)
    print(f"phase 5 (h): serving batched requests of {MOE_PRESET} on the card", flush=True)
    t5 = time.perf_counter()
    serve_batched["moe"] = phase_serve_batched_moe(moe, card_line)
    serve_batched["seconds"] = phase5_s + time.perf_counter() - t5
    print(f"  phase 5: {serve_batched['seconds']:.1f} s", flush=True)
    perf["moe_int8"] = moe_perf
    counts.update(moe_counts)
    launches = {k: counts[COUNTED_IN.get(k, "megakernel_int8")][k] for k in
                counts["megakernel_int8"]}
    del moe
    torch.cuda.empty_cache()
    print(f"phase 4, {MOE_PRESET}: the first request on the card and on the cpu",
          flush=True)
    parity["moe"] = dict(phase_parity_moe(dev), **moe_extra)

    print("phase 6: models from files on the card (convert, load, serve, evaluate)",
          flush=True)
    checkpoints = phase_checkpoints(dev)

    print("phase 7: the gemma family on the card", flush=True)
    t0 = time.perf_counter()
    g2 = Llm.synthetic(GEMMA2, rt=gemma_rt(GEMMA2_CAP), seed=SEED, device=dev)
    g3 = Llm.synthetic(GEMMA3, rt=gemma_rt(GEMMA3_CAP), seed=SEED, device=dev)
    print(f"  models: {GEMMA2} and {GEMMA3} built in {time.perf_counter() - t0:.1f} s; "
          f"info {json.dumps(g2.info())} {json.dumps(g3.info())}", flush=True)
    print("phase 2, gemma rows of the whole-model kernel", flush=True)
    phase_decode_model_gemma(dev, g, results, g2.params, g3.params)
    gemma = phase_gemma(dev, card_line, g2, g3)
    del g2, g3
    torch.cuda.empty_cache()

    print("phase 8: W3 and W2 weights on qwen2-0.5b (bench.py's --w-bits rows)", flush=True)
    t8 = time.perf_counter()
    sub4 = {}
    for bits in SUB4_BITS:
        print(f"phase 2, W{bits} rows of rows 1a, 1b, 2 and 3", flush=True)
        phase_gemm_sub4(dev, g, results, bits)
        sub4[f"w{bits}"] = phase_sub4(dev, g, results, bits)
    sub4["seconds"] = time.perf_counter() - t8
    print(f"  phase 8: {sub4['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    print("phase 9: KV variants and cache tiers on qwen2-0.5b", flush=True)
    kv = phase_kv(dev, params05, card_line)
    torch.cuda.empty_cache()

    print("phase 10: speculative decoding on qwen2-0.5b", flush=True)
    with CountCalls(native, "NativeNgramIndex") as native_indexes:
        specd = phase_spec(dev, params05, card_line)
    torch.cuda.empty_cache()

    print("phase 12: training and quantization tools on qwen2-0.5b", flush=True)
    print("phase 2, row 1b at the training forward's shapes", flush=True)
    phase_gemm(dev, g, results, a8=False, shapes=TRAIN_GEMM, key="dequant_matmul_train")
    training = phase_training(dev, params05, card_line)
    del params05
    torch.cuda.empty_cache()

    print("phase 14: the diffusion transformers (SD3's MMDiT, Sana and its DC-AE, Wan and "
          "its 3-D VAE), the CV library and the native library on the card", flush=True)
    dit_cv = phase_dit_cv(dev, card_line, checkpoints["dense"]["native_stfile"], specd,
                          native_indexes.calls)

    print("phase 15: the graph frontends and CNN inference on the card (torch.fx and ONNX, "
          "MobileNetV2 / SqueezeNet / ResNet-50, NMS, classification, the plugin kernel)",
          flush=True)
    cnn = phase_cnn(dev, card_line, results)

    print("phase 16: qwen2-7b at quant_block 256 on the card (bench.py's --q-block 256 row: "
          "pp512 + tg128 beside block 128, the per-layer, act-16 and dequantize-tile paths, "
          "2 layers against the CPU; phase 2's block-256 rows)", flush=True)
    torch.cuda.empty_cache()
    b256 = phase_block256(dev, g, results, params7, card_line)
    del params7
    torch.cuda.empty_cache()

    print("phase 17: the TF, TFLite and Caffe frontends on the card (SqueezeNet 1.0 from a "
          "prototxt and caffemodel, ResNet-50 from a GraphDef, MobileNetV2 from a .tflite "
          "f32 and int8, every table entry, softshrink plugins in each table)", flush=True)
    frontends = phase_frontends(dev, card_line)

    gen_tokens = sum(len(o) for o in outs) + sum(p["gen_len"] for p in moe_perf)
    mm_counts = mm_launches(multimodal)
    tr_counts = training_launches(training)
    gen_counts = generative_launches(generative)
    b256_counts = block256_launches(b256)
    kernels = []
    for kname, (src, repl, entry) in KERNEL_INFO.items():
        rows = results[kname]
        k = dict(name=kname, route="cuda", source=src, replaces=repl,
                 launches=launches[entry], **row_sums(rows))
        # the weight bits of the rows that ran this kernel in this run (the
        # attention kernels read no weights, and their rows carry none)
        ran = rows + results.get(f"{kname}_gemma", []) + [
            r for bits in SUB4_BITS for route in SUB4_ROWS_OF.get(kname, ())
            for r in results[f"w{bits}"][route]]
        k["weight_bits"] = sorted({r["bits"] for r in ran if "bits" in r})
        for bits in SUB4_BITS:    # phase 8's rows and launches at W3 and W2
            for route in SUB4_ROWS_OF.get(kname, ()):
                sub, ent = SUB4_COUNTED[route]
                k.setdefault(f"w{bits}", {})[route] = dict(
                    row_sums(results[f"w{bits}"][route]), entry=ent,
                    launches=sub4[f"w{bits}"]["counts"][sub][ent])
        if kname == "decode_step":
            # the first four rows alone, so a table compares like with like
            k["four_shapes"] = row_sums(rows[:DECODE_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[DECODE_FIRST_ROWS:])
        # phase 10: the verify shapes and the draft cache, with the launches
        # of (cc) to (gg)
        spec_key, spec_rows_key, spec_entry = SPEC_ROWS.get(kname, (None,) * 3)
        if spec_key:
            k[spec_key] = dict(row_sums(results[spec_rows_key]), entry=spec_entry,
                               launches=spec_launches(specd, spec_entry))
        if kname == "flash_decode":
            k["six_shapes"] = row_sums(rows[:FLASH_DECODE_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[FLASH_DECODE_FIRST_ROWS:])
            # phase 9: one bf16 layer and the stacked int8 cache; the
            # launches of (x), (y) and (z), 24 a token
            k["kv_variants"] = dict(row_sums(results["flash_decode_kv"]), launches=sum(
                kv[v]["launches"][entry] for v in (*KV_CODEBOOKS, *KV_ROTATED)))
        if kname == "decode_model":
            k["seven_shapes"] = row_sums(rows[:DECODE_MODEL_FIRST_ROWS])
            k["added_rows"] = row_sums(rows[DECODE_MODEL_FIRST_ROWS:])
            # phase 7: (n) and (o), one launch a token
            k["gemma"] = dict(row_sums(results["decode_model_gemma"]),
                              launches=sum(gemma[p]["launches"][entry] for p in "no"))
        if kname == "decode_step":
            # phase 7 (p): one launch a layer a token over the int8 caches
            k["gemma"] = dict(row_sums(results["decode_step_gemma"]), launches=sum(
                v["int8"]["launches"][entry] for v in gemma["p"].values()))
        if kname in ("dequant_matmul", "dequant_matmul_a8"):
            k["gemma_launches"] = sum(gemma[p]["launches"][entry] for p in "no")
        # phase 11's launches, (jj) to (nn), added to the row's count
        k["multimodal_launches"] = mm_counts.get(entry, 0)
        if kname == "dequant_matmul":
            k["multimodal_launches"] += mm_counts.get("mnn_dequant_matmul_bf16_tile", 0)
        k["launches"] += k["multimodal_launches"]
        # phase 12's launches, (oo) to (rr), added too; row 1b's rows at the
        # training forward's shapes with (oo)'s launches
        k["training_launches"] = tr_counts.get(entry, 0)
        if kname == "dequant_matmul":
            k["training_launches"] += tr_counts.get("mnn_dequant_matmul_bf16_tile", 0)
            k["train"] = dict(row_sums(results["dequant_matmul_train"]),
                              entry="mnn_dequant_matmul_bf16_tile",
                              launches=training["oo"]["launches"]["mnn_dequant_matmul_bf16_tile"])
        k["launches"] += k["training_launches"]
        # phase 13's launches, (tt)'s (thinker and talker), added too
        k["generative_launches"] = gen_counts.get(entry, 0)
        if kname == "dequant_matmul":
            k["generative_launches"] += gen_counts.get("mnn_dequant_matmul_bf16_tile", 0)
        k["launches"] += k["generative_launches"]
        # phase 16's launches, (iii), added too; the kernel's block-256 rows
        k["block256_launches"] = b256_counts.get(entry, 0)
        if kname == "dequant_matmul":
            k["block256_launches"] += b256_counts.get("mnn_dequant_matmul_bf16_tile", 0)
        k["launches"] += k["block256_launches"]
        b256_rows = [r for key in B256_ROWS.get(kname, ()) for r in results[key]]
        if b256_rows:
            k["block256"] = dict(row_sums(b256_rows), blocks=sorted(
                {b for r in b256_rows for b in r.get("blocks", [r.get("block", 256)])}))
        # phase 2's rows at the qwen2-7b shapes phase 11 serves
        if f"{kname}_7b" in results:
            k["qwen2_7b"] = row_sums(results[f"{kname}_7b"])
        if kname == "dequant_matmul":
            # one TPU kernel, two CUDA kernels: the GEMV kernel at M = 1 (the
            # decode GEMVs and the head) and the tensor-core tile kernel above
            k["launches"] += launches["mnn_dequant_matmul_bf16_tile"]
            for key, sub, ent in (
                    ("m1", [r for r in rows if r["m"] == 1], "mnn_dequant_matmul"),
                    ("m_gt1", [r for r in rows if r["m"] > 1], "mnn_dequant_matmul_bf16_tile")):
                k[key] = dict(entry=ent, launches=launches[ent], **row_sums(sub))
        kernels.append(k)
    # row 10, the plugin example kernel: launched by the plugin paths only,
    # phase 15's (ONNX) and phase 17's (TF, TFLite, Caffe)
    kernels.append(dict(name="softshrink", route="cuda",
                        source="mnn_tpu_torch/csrc/plugin_softshrink.cu",
                        replaces="tests/test_plugin.py:19",
                        launches=cnn["launches"]["plugin"]["mnn_softshrink"]
                        + frontends["launches"]["ooo"]["mnn_softshrink"],
                        onnx_launches=cnn["launches"]["plugin"]["mnn_softshrink"],
                        frontends_launches=frontends["launches"]["ooo"]["mnn_softshrink"],
                        **row_sums(results["softshrink"])))
    detail = dict(card=card_line, torch=torch.__version__, build_s=build_s,
                  kernels=results, serve=perf, serve_batched=serve_batched,
                  launches=launches,
                  launches_by_path=counts,
                  generated_tokens=gen_tokens, parity=parity, checkpoints=checkpoints,
                  gemma=gemma, sub4=sub4, kv=kv, speculative=specd, multimodal=multimodal,
                  training=training, generative=generative, dit_cv=dit_cv, cnn=cnn,
                  block256=b256, frontends=frontends,
                  seconds=time.perf_counter() - t_start,
                  note="kernel ms/plain_ms/library_ms/bound_ms in the kernels "
                       "line are sums of one call at each listed shape")
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"chip_smoke: {detail['seconds']:.1f} s in all", flush=True)
    print(card_line, flush=True)             # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
