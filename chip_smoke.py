#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, needs one CUDA card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure raises, and the script exits non-zero):
  build    nvcc-builds every kernel of `tensorrt_model_optimizer_tpu_torch/csrc`
           (one process per source, in parallel, started before any other
           phase; the kernels phase runs while they compile, each wrapper's
           first launch waiting for its own source) and prints each
           source's compile seconds.
  kernels  each kernel against its plain PyTorch version on the card, at the
           Llama-3.1-8B shapes of the served path, with CUDA-event timings,
           the bound (bytes or operations) and, where PyTorch has one call for
           the same function (flash, int4 and int8 weight-only, SDPA for the
           bf16 format of the three KV attention kernels and for skip-softmax
           at threshold 1e-30), its time. Flash (tensor cores) also runs with
           q as the engine passes it, at a ragged T and at head_dim 64 and 32.
           Paged prefill runs through both routes: the tensor cores (bf16 q)
           in every stored form at T = 64 and T = 5, the CUDA cores (f32 q)
           at T = 64; KV decode (split over the cache, pos a device tensor,
           the grid sized from the cache's 2080 rows) at the 8B pos 2048 and
           at pos 0, 1, 255, 256 and 257; paged decode (split over
           each sequence's rows) at 2048 rows, at ragged lengths and at
           lengths on each side of its splits' edges. The W4A8 and the
           weight-only GEMMs run at gate_proj, down_proj and k_proj, N = 8
           (the decode route, split over K) and N = 16384; W4A8 is held to
           its plain version bit for bit on both routes, with torch._int_mm
           (int8 x int8, no block scales) timed beside it at N = 16384. A
           second call of each split kernel (paged decode, the GEMMs) on
           the same inputs must give the first call's bits.
           Skip-softmax runs through both routes: the tensor cores at the 8B
           shape (128- and 64-tiles), on spiked inputs and at a calibrated
           threshold; the CUDA cores at the RULER anchor's shape (f32) and at
           ragged tile sizes. Both report the share of bf16 outputs one ulp
           from the plain version's; flash holds it to ULP_OFF_MAX at the
           anchor's prefill shape. Their phase rows also carry the time of
           the CUDA-core kernels they replaced (`cuda_core_ms`, a constant,
           not printed in the kernels line). At the MoE shapes
           (`_phase_kernels_moe`): the W4A8, INT4 and NVFP4 GEMMs at
           Qwen3-30B-A3B's experts (O 768 / K 2048, O 2048 / K 768) for N =
           2048 and N = 1, flash and kv decode at 32 / 4 heads (rep 8).
  anchor   the in-repo trained checkpoint `artifacts/anchor-llama` through
           load -> PTQ -> compress -> int8-KV engine, once for each served
           path (W4A8; INT4, NVFP4, MXFP4, INT8 weight-only; FP8 and NVFP4 with
           their activation quantizers), the
           kernels against the plain versions: each projection's GEMM at the
           checkpoint's shapes, the logits at every greedy step against an
           f32 yardstick, and for W4A8 equal tokens. Then `Engine.serve` over
           int8 pages and over packed NVFP4 pages (NVFP4_KV_CFG): page 8, 2
           slots, 4 requests behind a shared prefix, prefix cache, unroll 1 and
           4; the paged kernels against their plain versions in lock step, and
           every served token against the dense-cache engine. Then the einsum
           engine (kv_attention_kernel=False) with int8 and packed NVFP4
           caches, dense and sparse prefill and decode, kernel against plain;
           and the RULER threshold curve on `artifacts/anchor-ruler` through
           the skip-softmax kernel and its plain version.
  full     Llama-3.1-8B at full width (seeded random bf16 weights on the
           card, made once): for each path of `FULL_PATHS`, PTQ -> compress ->
           engine, batch 8 x 2048-token prompts then 32 decode steps. W4A8,
           INT4 and NVFP4 run on FULL_DEPTH (8) of the 32 layers, the other
           four paths on the first 4 layers. Launch counts are set to 0 before each path
           and read after it; the prefill logits are held against the plain
           version of that path's GEMM at depths 1 and 2, and for W4A8 at
           depths 1, 2, 4 and 8 against the all-plain engine and an engine
           that runs only flash attention on its plain version. The INT4 path
           then serves 12 requests (1024-token prompts behind a 256-token
           shared prefix) through `Engine.serve` over int8 pages: 8 slots,
           page 16, prefix cache, unroll 4, all its FULL_DEPTH layers; runs the einsum
           engine on 8 layers with dense and sparse prefill of 8 x 2048
           tokens and 32 decode steps; and on 4 layers NVFP4_KV_CFG serves
           packed NVFP4 pages and generates over the dense NVFP4 KV cache at
           batch 8 x 2048. Every path of FULL_PATHS also runs its 32 decode
           steps through the fused `decode_step` (one CUDA-graph replay a
           call) at unroll 1 and 8 from the state the eager steps started
           from; its tokens and final cache must equal the eager steps' bit
           for bit; each way's wall per token step, device time, idle share
           and launches are printed ("full_graphs"). The serve runs are
           repeated with the steps launched eagerly: the served tokens must be equal.
  calib    the calibration algorithms at full width (`CALIB_PATHS`): each
           preset this slice unlocks calibrated on the card on 4 seeded
           batches of [2, 512] tokens (seconds and peak memory printed),
           compressed and served by the kernel engine (int8 KV, fp8 where the
           preset quantizes the KV cache so): 8 x 2048 prefill (TTFT), 32 steps
           through decode_step(unroll=8) (wall per token step), the graphed
           tokens and cache equal to the eager steps' bit for bit, the prefill
           logits against the all-plain engine's at 2 layers (relative error
           <= CALIB_PLAIN_REL_MAX, input quantizers off, as the full phase
           holds its paths), and their error against the unquantized engine
           beside the max-calibrated counterpart's (informational).
           INT4_AWQ_CFG and INT4_BLOCKWISE_WEIGHT_ONLY_CFG run 8 layers,
           every other preset the first 2; W4A8_AWQ_BETA_CFG serves with
           int4_layout="a8". INT4_AWQ, W4A8_AWQ_BETA, INT8_SMOOTHQUANT and
           NVFP4_SVDQUANT also export -> load -> serve at 4 layers or their
           own depth, if less (loaded
           against the export's tensors held in memory, DEPLOY_GAP_MAX). Then
           on artifacts/anchor-llama every calibration module runs on the
           card and on the CPU over the same f32 captures under the parity
           rules (`card_cpu_calib_modules`; AWQ clip skips down_proj's 704,
           no whole number of 128-blocks, as JAX raises there), and each
           preset calibrated on the card in bf16 is served against its own
           fake-quant forward (ENGINE_VS_FAKE_QUANT_MAX). The paths' launch
           counts are added to the kernels line's; each of CALIB_KERNELS
           must have launched.
  deploy   the deploy loop at full width on 4 layers, for W4A8 (INT4 weights,
           int8 KV, kernel attention) and NVFP4 weight-only: PTQ -> unified
           HF export (1 GiB shards, into a temporary directory removed after
           each path) -> `load_quantized_checkpoint` -> engine, 8 x 2048
           prefill and 32 steps through `decode_step(unroll=8)`. The loaded
           packs are held against `compress`'s (equal, or the differences
           `_deploy_packs` names) and the loaded model against `compress`'s
           as the checkpoint stores it (moved scales, fp16 storage; equal),
           the loaded engine's logits against the engines over the export's
           tensors held in memory and over that `compress` model (median
           gap <= DEPLOY_GAP_MAX of the logits' scale); the gap to
           `compress`'s own engine and its fp16 controls, and export, load
           and serve seconds are printed.
  accuracy the accuracy harness, the last formats and the PTQ entry point
           (`phase_accuracy`): (a) artifacts/anchor-llama in f32, the
           unquantized ppl within ACC_BF16_REL of JAX's record
           (artifacts/accuracy_table.json), every preset's Δppl under JAX's
           pinned budget, MMLU choices card against CPU, NF4 / MXFP6 / MXFP8
           and the int4x / int8a8 layouts served against their fake-quant
           forward; (b) the 8B shape: ACC_PATHS calibrated and served as the
           calib phase serves its paths (NF4 on the INT4 kernel at 64-blocks,
           8 layers too), perplexity and KL at full width, layerwise
           calibration of 32 layers brought from host memory one at a time
           (its amax equal to the one-shot calibration's on 4 layers); (c)
           examples/hf_ptq_torch.py on the anchor: nvfp4_ptq exported,
           loaded (equal to compress's model as stored) and served; w4a8_awq
           served under "a8" (its export refuses K = 704, as JAX's does).
           Each of ACCURACY_KERNELS must have launched.
  moe      the routed-expert families (`phase_moe`): the dispatch against
           JAX's capacity rule (host loop) at Qwen3-30B-A3B's and
           Mixtral-8x7B's served shapes; (a) artifacts/anchor-moe (qwen3_moe,
           6 layers, 4 experts, top-2): `quantize_family` under INT4, NVFP4,
           W4A8, INT4_AWQ and INT8_SMOOTHQUANT, each served by the kernel
           engine in lock step with the all-plain engine (the anchor phase's
           margin rule; W4A8 tokens equal), `Engine.serve` over int8 pages
           against the dense engine (held on f32 activations), export ->
           load -> serve for INT4 and NVFP4 (arrays, logits and tokens equal
           to the engine over the export's tensors in memory), the
           unquantized ppl and NVFP4's Δppl against JAX's pin; (b)
           Qwen3-30B-A3B at full width on MOE_FULL_DEPTH (2) of its 48 layers
           (seeded random bf16), W4A8, INT4 and NVFP4: TTFT of 8 x 2048, eager
           and graphed (unroll 1 and 8) token steps (tokens and cache equal),
           prefill and step profiled under `profile`, peak memory, launches per kernel, the depth-2
           prefill against the all-plain engine on the kernel engine's
           routing; (c) Mixtral-8x7B's widths on 2 layers, INT4.
  families GPT-OSS and Llama4 on the einsum engine, the one JAX serves them
           on (`phase_families`): (a) small bf16 configs (hidden 256, 4
           layers, window / chunk / floor_scale 8, GPT-OSS's sinks N(0, 1)):
           GPT-OSS under MXFP4 and NVFP4, Llama4 under NVFP4 and W4A8, each in
           lock step with the all-plain engine (the anchor's margin rule;
           W4A8 tokens equal), the f32 plain engine against the model's own
           forward (FAMILY_VS_FORWARD_MAX), graphed decode equal to eager,
           every refusal, and GPT-OSS's deploy loop (native MXFP4 export ->
           `load_hf_moe_checkpoint` -> `quantize_family` -> serve, equal to
           the export's tensors held in memory; alone: `--phases
           build,families_small`); (c) Llama-4-Scout's widths on 4 of 48
           layers, NVFP4 / W4A8, and an 8448-token prompt past position 8192
           held against the all-plain engine on all 4 layers; (b)
           GPT-OSS-20B at full width on 2 of its 24 layers, MXFP4 / NVFP4 / INT4
           ((c) and (b) alone: `--phases build,families_full`): TTFT of 8 x
           2048, eager and graphed (unroll 1 and 8) steps over 32 decode
           steps, peak memory, launches, and the depth-2 prefill against the
           all-plain engine on the kernel engine's routing. The kernels phase
           gains the GEMMs at both models' shapes (`FAMILY_GEMMS`; alone:
           `--phases build,kernels_families`).
  deepseek DeepSeek-V3 on its own engine over the MLA latent cache
           (`phase_deepseek`): (a) a small bf16 config (hidden 256, 4 layers:
           1 dense, 3 MoE; 16 experts of 128, top-4 in 2 of 4 groups, the
           routers' bias N(0, 0.05^2)) under INT4, NVFP4 (W4A4), FP8, INT8
           and NVFP4_KV: the routing against a host loop of the rule, the
           absorbed form against the naive one (f32, JAX's 2e-4 / 1e-3), the
           kernel engine against the all-plain engine on its routing
           (MOE_PLAIN_MEDIAN_MAX), the graphed decode (unroll 1 and 8)
           bit-equal to the eager steps, the cached latent on kv_b's input
           quantizer's grid, the f32 plain engine against the model's
           fake-quant forward (DEEPSEEK_VS_FORWARD_MAX; alone: `--phases
           build,deepseek_small`); (b) DeepSeek-V3's widths (its
           config.json: yarn factor 40, the softmax factor 1.874) on 2 of
           its 61 layers (1 dense, 1 MoE), INT4 and NVFP4 W4A4: calibration
           on 4 seeded [2, 512] batches, TTFT of 8 x 2048, the MLA einsums'
           and the expert GEMMs' ms (CUDA events), eager and graphed (unroll
           1 and 8) steps over 32 decode steps (INT4's prefill and eager step
           profiled under `profile`), peak memory, launches, and the prefill against the
           all-plain engine on both layers on the kernel engine's routing,
           input quantizers off, and W4A4 as served on the MoE layer alone
           (alone: `--phases build,deepseek_full`). The kernels phase gains the GEMMs at V3's
           shapes (`DEEPSEEK_GEMMS`; alone: `--phases build,kernels_deepseek`).
  speculative
           tree-speculative decoding and the drafters (`phase_speculative`):
           (a) artifacts/anchor-llama in f32 as tools/bench_specdec.py runs it:
           Medusa (3 heads), EAGLE-1 TTT, EAGLE-3 TTT and DFlash trained on
           the card (the first 100 of JAX's 300 steps of 8 x 65 synthlang
           tokens, lr 1e-3, TTT 3;
           seconds and last-step accuracies), each drafter's acceptance and
           tokens per step with the unquantized and the W4A8_AWQ_BETA
           fake-quant base beside JAX's CPU record
           (artifacts/specdec_r02.jsonl); W4A8_AWQ_BETA compressed and served
           by the einsum engine (W4A8 GEMM, int8 KV): `generate_speculative`
           with the trained heads for 64 tokens, equal to `generate_host`'s,
           the verify forward against the all-plain engine, and the oracle
           round (`_spec_oracle`: the greedy continuation on the tree's
           deepest path, the logits at its nodes and its compacted rows
           against eager 1-row steps, SPEC_ANCHOR_ORACLE_MAX; alone:
           `--phases build,speculative_anchor`); (b) Llama-3.1-8B at full
           width (32 layers, seeded bf16), INT4 weight-only, the einsum
           engine with a bf16 cache, batch 1, a 128-token prompt, 3 seeded
           Medusa heads: `generate_speculative` for 32 tokens, the verify
           round's wall, device time and idle share, GEMM launches a round,
           the graphed batch-1 step (unroll 8) and r = verify / step, peak
           memory, the verify forward against the plain GEMMs at depths 1
           and 2 (SPEC_PLAIN_MAX), the oracle round (SPEC_ORACLE_MAX,
           SPEC_ROWS_MAX), the tokens against `generate_host`'s (a mismatch
           traced to a near tie); the INT4 and W4A8 GEMMs at N = 7 and N = 1
           (SPEC_GEMMS) join the kernels line (alone: `--phases
           build,speculative_full`). Raises unless qmm_w4a8 and qmm_int4_wo
           launched on its served runs.
  train    the training side: (a) Llama-3.1-8B's widths on
           TRAIN_DEPTH (4) layers, seeded bf16 weights on the card,
           W4A8_AWQ_BETA calibrated, then Adam steps on one 4 x 512 batch
           in four modes: QAT, LSQ (learn_amax on the int sites, the amax
           trained), QAD (KD against the unquantized teacher) and QLoRA
           (rank-16 adapters over the frozen fake-quant base): losses finite
           and falling, step ms, tokens/s, peak memory; the QAT'd model
           compressed and served, W4A8 (tokens equal to the plain engine's)
           and INT4 weight-only (the anchors' near-tie rule); (d)
           AutoQuantize of the same weights (W4A8_AWQ_BETA against
           FP8_DEFAULT at 6 bits): within the budget, the mixed forward
           finite (alone: `--phases build,train_full`). On the anchor (f32):
           (b) a QAT and an LSQ step card against CPU (gradients and updated
           tensors, TRAIN_CARD_CPU_FROB_MAX); (c) the QATTrainer stopped at
           step 3 and resumed, equal to the uninterrupted run under
           deterministic algorithms, its saved state restoring to equal
           logits; (e) JAX's QAT recovery (INT8_SMOOTHQUANT, the first
           QAT_RECOVERY_STEPS of the 600 Adam steps of
           tools/torch_accuracy_table.py's recipe): ppl and MMLU before and
           after beside JAX's, the ppl down by at least QAT_RECOVERY_MIN
           (alone: `--phases build,train_anchor`). The training steps launch
           no kernel of the port (no kernel has a backward: the wrappers
           refuse under grad); the served runs launch rows 1 and 4.
  prune    weight sparsity and Minitron pruning (`phase_prune`): (a)
           Llama-3.1-8B's widths on 4 layers (the first 4 of a seeded
           8-layer bf16 model), 2:4 by magnitude and by SparseGPT from 4
           seeded [2, 512] batches (seconds a layer, peak memory); the dense
           and the SparseGPT model under INT4 served W4A8 and weight-only:
           TTFT of 8 x 2048 and the graphed step side by side (A B B A), the
           packed weights decoded by the plain dequantizer 0 wherever the
           mask is off, W4A8's logits equal to its plain GEMM's at every
           one of 32 steps, INT4 by the calib phase's depth-2 rule; (b)
           Minitron importance from the same batches, the model cut to
           Llama-3.1-Minitron-4B-Width's widths (hidden 3072, FFN 9216, 32 /
           8 heads of 128) and the 8-layer one to 4 layers by depth; KD Adam
           steps of the student against the dense teacher (falling loss);
           the student served both ways and held the same way, W4A8
           exported -> loaded -> served (logits equal to the engine over the
           export's tensors in memory); rows 1 and 4 at its GEMM shapes
           (`MINITRON_GEMMS`, joining the kernels line's shapes); (c) masked
           QAT: 3 Adam steps of W4A8_AWQ_BETA through
           `make_optax_train_step(masks=...)`, every masked-off weight 0
           after each; (d) Qwen3-30B-A3B's widths on 2 layers, experts
           pruned 128 -> 64 by routing importance, W4A8 on the MoE engine
           (`_moe_full_path`: held on pinned routes); (e) on
           artifacts/anchor-llama in f32: both sparsifiers card against CPU
           (PRUNE_OUT_ERR_REL, PRUNE_MASK_APART_MAX), ppl dense -> 2:4 ->
           2:4 + FP8, that FP8 model served against its fake-quant forward,
           FastNAS's ratio and an AutoNAS search's best config card against
           CPU. `--phases build,prune_full` / `build,prune_anchor` run the
           parts. Raises unless each of PRUNE_KERNELS launched.
  diffusion the diffusion family (`phase_diffusion`): (a) DiT-XL/2
           (facebookresearch/DiT `DiT_XL_2`: hidden 1152, 28 blocks, 16
           heads, patch 2, 32 x 32 x 4 latents) in bf16, seeded weights with
           the adaLN-zero tensors drawn at random, 8 latents a step: for
           INT8 (W8A8, `int8_mm`), FP8, NVFP4, INT4_AWQ and MXFP4, PTQ over
           4 seeded (x, t) batches, `compress_dit` -> `serving_layouts`, 12
           chained denoise steps and the CUDA-event median step on the
           weight-only GEMM kernels (the launches counted), each step's eps
           and the drift of x against the bf16 trajectory
           (tools/bench_diffusion.py's quality proxy), the step against the
           all-plain step at depth 2 (<= DIFF_PLAIN_MAX) and at depth 28
           (printed); peak memory; (b) the UNet at SD-1.5's channel widths
           (bf16, 2 x 64 x 64 x 4): FP8 and INT8 PTQ, correlation with the
           unquantized eps, a 4-step sample finite; (c) fastgen in f32 at
           DiT-XL/2's widths on 4 blocks: flow-matching SGD steps (the loss
           falls), a few-step-distillation step, 3 DMD2 alternations; (d)
           tiny DiT / UNet / fastgen card against CPU. Raises unless each of
           DIFFUSION_KERNELS launched. `--phases build,kernels_dit` runs
           the kernels at DiT-XL/2's GEMM shapes alone (DIT_GEMMS).
  vision   the VLM at LLaVA-1.5-7B's widths (a ViT-L/14 at 336 px, the
           projector, Llama-2-7B's widths on 4 of 32 layers; bf16, 2 images
           and 64 tokens): NVFP4 and FP8 PTQ, the logits' correlation with
           bf16, the image still moving the text logits,
           `export_vlm_checkpoint` (sizes); LSTM and GRU (hidden 1024, 2
           layers, 8 x 256) under INT8; CV FastNAS card against CPU. It runs
           no kernel and raises if any launched.
  hybrid   the Mamba2 hybrid family (`phase_hybrid`): (a) Nemotron-H-8B at
           full width and depth (52 blocks, seeded bf16): an 8 x 2048
           prefill into the cache and 32 greedy steps through
           `mamba.generate` (TTFT, median step, peak), prefill + 4 recurrent
           steps against the full forward and a two-chunk prefill against
           the one-shot one; (b) FP8 / NVFP4 PTQ at all 52 blocks, max
           calibration on 2 x [2, 512] (seconds, fake-quant TTFT and step,
           the logits' correlation with bf16 against JAX's bars); (c) hybrid
           Minitron on blocks 12-19 (`M-M*-M-M`): heads 128 -> 64, FFN
           21504 -> 10752, hidden 4096 -> 3072, 8 -> 6 blocks, TTFT and step
           beside the unpruned 8; (d) Puzzletron at Llama-3.1-8B's widths on
           4 layers (an attn2mamba candidate a layer), `run_puzzle`,
           `run_puzzle_constrained` on the H100's roofline, a saved child
           reloaded; (e) tiny configs card against CPU in f32; (f)
           `find_max_batch_size` through the card's real OOM on (c)'s 8
           blocks at 2048 tokens, the host packer against the torch packers.
           It runs no kernel and raises if any launched.
  tp       multi-GPU serving on the one card (`phase_tp`): the GEMMs at
           the local shapes of Llama-3.1-8B at TP 4 and 2 (TP_GEMMS), flash
           and kv decode at TP 4's heads, paged decode and prefill at TP
           2's (TP_ATTN, TP_PAGED), each against its plain version and
           timed; then TP_WORLD ranks, each a process (nccl with a card a
           rank where there are that many cards, else gloo with every rank
           on cuda:0; printed), the parent building each model once, running
           its single-card reference and handing each rank only its shard:
           (a) Llama-3.1-8B on 4 layers at TP 4 in W4A8, INT4 and NVFP4 and
           W4A8 at TP 2, int8 KV, kernel attention, 8 x 2048 prefill and 32
           eager steps; (b) paged serving at TP 2 (INT4, int8 pages, the
           full phase's 12 requests behind a shared prefix; then 8 of them
           a slot each, a paged chunk step and 15 paged decode steps); (c)
           Qwen3-30B-A3B on 2 layers at EP 4, INT4, calibrated through
           `quant.sharded` (amaxes equal to the single card's), then served;
           (d) DeepSeek-V3 on 2 layers (1 dense, 1 MoE) at TP / EP 4, INT4;
           (e) ring attention (8B heads, 4 x 2048 tokens a rank, f32,
           against SDPA) and the 4-stage pipeline against the unsharded
           forward; (f) save_sharded -> restore_sharded of the INT4 model
           (2 layers), each rank's shards and the gathered model equal to
           it. The decode steps are teacher-forced: each rank is fed the
           single card's greedy tokens. Held: the median over rows of the
           prefill's and every step's logits' max gap to the single card's
           within TP_LOGITS_MAX of its scale; (c) and (d) on the single
           card's expert choices (`_pinned_routes`) within TP_MOE_PINNED_MAX
           and MOE_PLAIN_MEDIAN_MAX, the unpinned prefill's gap reported; W4A8's
           row site alone (layer 0's down_proj on an f32 input) within
           TP_ROWSITE_MAX; (b)'s serve: a request's first token apart only
           at a near-tie (TP_TIE_MAX); equal greedy tokens counted. Timings
           are one card's, collectives on the host. `tp_full` runs (a) at
           8 layers, `tp_llama` (a) alone, `tp_moe` (c) and (d) alone.
Add `profile` to --phases for device time by kernel (torch.profiler) of
the paths' prefills and decode steps; the default run profiles nothing.
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense tensor-core peaks; f32 off the tensor cores
ANCHOR = os.path.join(HERE, "artifacts", "anchor-llama")
ANCHOR_RULER = os.path.join(HERE, "artifacts", "anchor-ruler")
RULER_CURVE = os.path.join(HERE, "artifacts", "ruler_curve.json")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of each phase; `full` is the served configuration."""

    qmm_shapes: tuple = ((14336, 4096, "gate_proj"), (4096, 14336, "down_proj"), (1024, 4096, "k_proj"))
    qmm_rows: tuple = (8, 16384)
    kv: tuple = (8, 8, 4, 128, 2080, 2048)  # B, n_kv, rep, hd, S (the 8 x 2048 prompt + 32 steps), pos
    flash: tuple = (8, 32, 8, 2048, 128)  # B, H, Hkv, T, d
    skip: tuple = (256, 2048, 128, 128)  # BH (8 sequences x 32 heads), S, d, tile
    page: int = 16      # rows of a KV page
    chunk: int = 64     # tokens of a paged prefill chunk (`Engine.prefill_chunked`)
    batch: int = 8
    prompt: int = 2048
    decode_steps: int = 32
    max_seq: int = 2560
    reps: int = 20


# whether `_profile` runs the profiler: set by main when --phases names
# `profile`
PROFILING = False


def log(*a):
    print(*a, flush=True)


def bound(bytes_moved: float, ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of `fn` over `reps` launches after warm-up,
    with the 50 MB L2 flushed before each launch (the served path meets
    every layer's weights and cache cold).

    The device is held back by a spin kernel while the host enqueues all
    the timed launches: without it a launch shorter than its wrapper's host
    time (the KV kernels' 20-70 us against ~0.1 ms of Python) is timed from
    an event the idle device stamped before the launch arrived, so its
    reading is the host's enqueue time (on an H100 the same kv decode read
    0.035 and 0.066 ms in two runs of this script before the spin). A call
    that takes SLOW_S or more after the warm-up (the library's int8 GEMM at N =
    16384: 2 s) is timed by that one call alone."""

    CLOCK_HZ = 2.0e9  # at least the card's clock: the spin lasts at least as long as asked

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    SLOW_S = 0.25  # a call at least this long (the first timed one's wall) is its own timing

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()  # warm-up: first-call work (plans, caches) stays out of the timings
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.flush_buf.add_(1)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        host_s = time.perf_counter() - t0  # one rep's enqueue on the host
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= self.SLOW_S:  # the host's enqueue is a sliver of such a call
            return s.elapsed_time(e)
        torch.cuda._sleep(int(min(2.0 * reps * host_s + 1e-3, 0.2) * self.CLOCK_HZ))
        pairs = []
        for _ in range(reps):
            self.flush_buf.add_(1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_build():
    """Wait for the nvcc processes main started (`_build.start_all`; a
    wrapper's first launch waits for its own source) and print each
    source's compile seconds and the longest."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build

    report = _build.wait()
    log(json.dumps({"phase": "build", "seconds": round(max(v["seconds"] for v in report.values()), 3),
                    "per_source_s": {k: round(v["seconds"], 3) for k, v in report.items()}}))
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def phase_kernels(torch, dev, sz: Sizes, timer: Timer, rows: dict):
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm

    g = torch.Generator(device=dev).manual_seed(0)
    # --- W4A8 GEMM: bit-exact with its plain version on both routes (exact
    # int32 block sums; the same f32 fold order, the decode route's split of
    # K included, which the plain version takes too), held with torch.equal;
    # a second call of the split route must give the first call's bits. At
    # N = 16384 `torch._int_mm` on the same M, N, K with the int8 weights
    # unpacked in advance is timed beside it: int8 x int8 with no block
    # scales, not the same function (library_ms stays null).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for O, K, label in sz.qmm_shapes:
        nblk = K // 128
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((nblk, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        for N in sz.qmm_rows:
            x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
            n_split = qmm.w4a8_decode_splits(N, nblk * 128, O, sms)
            out = qmm.w4a8_matmul(x8, packed, scales)
            torch.cuda.synchronize()
            ref = qmm.w4a8_matmul_plain(x8, packed, scales, n_split=n_split)
            err = float((out - ref).abs().max())
            rel = _rel(out, ref)
            if not torch.equal(out, ref):
                raise AssertionError(f"w4a8 {label} N={N} ({n_split} splits): not bit-exact with the plain "
                                     f"version, max abs err {err}, rel err {rel}")
            if N <= 16:
                _same_again(torch, f"w4a8 {label} N={N}", out, qmm.w4a8_matmul(x8, packed, scales))
            ms = timer(lambda: qmm.w4a8_matmul(x8, packed, scales), sz.reps)
            plain_ms = timer(lambda: qmm.w4a8_matmul_plain(x8, packed, scales), max(2, sz.reps // 8))
            b_ms, b_by = bound(N * K + O * K / 2 + nblk * O * 2 + N * O * 4, 2.0 * N * O * K, "int8")
            row = {"shape": f"{label} N={N} O={O} K={K}", "route": "decode" if N <= 16 else "prefill",
                   "n_split": n_split, "max_abs_err": err, "rel_err": rel, "bit_exact": True, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                   "library_ms": None}
            if N > 16:
                del ref
                w8 = qmm.int4_a8_codes(packed)[:, :K].t()  # [K, O] int8, column-major
                row["int8_mm_ref_ms"] = timer(lambda: torch._int_mm(x8, w8), sz.reps)
                row["int8_mm_ref"] = "torch._int_mm, int8 x int8, no block scales: not the same function"
                del w8
            shapes.append(row)
            log(json.dumps({"kernel": "qmm_w4a8", **row}))
            del x8, out
        del packed, scales
    rows["qmm_w4a8"] = dict(shapes[0], shapes=shapes)

    _phase_kernels_wo(torch, dev, sz, timer, rows, g)
    # in the order their sources finish compiling (`phase_build`): the
    # GEMMs', flash's and skip-softmax's first, the paged kernels' last
    _phase_kernels_flash(torch, dev, sz, timer, rows, g)
    _phase_kernels_skip(torch, dev, sz, timer, rows, g)
    _phase_kernels_families(torch, dev, sz, timer, rows, g)
    _phase_kernels_families(torch, dev, sz, timer, rows, g, DEEPSEEK_GEMMS)
    _phase_kernels_families(torch, dev, sz, timer, rows, g, DIT_GEMMS)
    _phase_kernels_kv(torch, dev, sz, timer, rows, g)
    _phase_kernels_moe(torch, dev, sz, timer, rows, g)


# The new shapes the MoE paths give the ported kernels: Qwen3-30B-A3B's
# experts (gate / up O 768, K 2048; down O 2048, K 768) at N = 2048 (the
# rows a prefill expert takes: C = 2 S k / E) and N = 1 (a decode step's
# C), and its attention at 32 query heads over 4 kv heads of 128 (rep 8).
MOE_EXPERT_SHAPES = ((768, 2048, "expert gate"), (2048, 768, "expert down"))
MOE_EXPERT_ROWS = (2048, 1)
MOE_ATTN = (8, 32, 4, 128, 2080, 2048)  # B, H, Hkv, hd, S, pos (flash at T = 2048)


def _phase_kernels_moe(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """The expert GEMMs (W4A8 bit-exact; INT4 and NVFP4 weight-only under
    `_held`) at MOE_EXPERT_SHAPES x MOE_EXPERT_ROWS, and flash and kv decode
    at rep 8 (MOE_ATTN), each against its plain version and timed; the rows
    join each kernel's `shapes`."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, qmm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for O, K, label in MOE_EXPERT_SHAPES:
        nblk = K // 128
        packed = torch.randint(0, 256, (O, K // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (torch.rand((nblk, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        for N in MOE_EXPERT_ROWS:
            x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
            n_split = qmm.w4a8_decode_splits(N, K, O, sms)
            out = qmm.w4a8_matmul(x8, packed, scales)
            ref = qmm.w4a8_matmul_plain(x8, packed, scales, n_split=n_split)
            if not torch.equal(out, ref):
                raise AssertionError(f"w4a8 {label} N={N}: not bit-exact with the plain version")
            ms = timer(lambda: qmm.w4a8_matmul(x8, packed, scales), sz.reps)
            plain_ms = timer(lambda: qmm.w4a8_matmul_plain(x8, packed, scales), max(2, sz.reps // 8))
            b_ms, b_by = bound(N * K + O * K / 2 + nblk * O * 2 + N * O * 4, 2.0 * N * O * K, "int8")
            row = {"shape": f"{label} N={N} O={O} K={K}", "route": "decode" if N <= 16 else "prefill",
                   "n_split": n_split, "max_abs_err": 0.0, "bit_exact": True, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
            rows["qmm_w4a8"]["shapes"].append(row)
            log(json.dumps({"kernel": "qmm_w4a8", **row}))
            x = torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
            for name, fmt, fn, plain, w, wbytes, lib in _wo_cases(torch, dev, g, O, K):
                if fmt not in ("int4", "nvfp4"):
                    continue
                out = fn(x, *w)
                worst, err = _held(out, plain(x, *w, out_dtype=torch.float32))
                if not worst <= 1.0:
                    raise AssertionError(f"{name} {fmt} {label} N={N}: worst err/limit {worst} > 1, max abs err {err}")
                ms = timer(lambda: fn(x, *w), sz.reps)
                plain_ms = timer(lambda: plain(x, *w), 2)
                lib_ms = None
                if lib is not None:
                    call = lib()
                    lib_ms = timer(lambda: call(x), sz.reps)
                b_ms, b_by = bound(N * K * 2 + wbytes + N * O * 2, 2.0 * N * O * K, "bf16")
                row = {"shape": f"{fmt} {label} N={N} O={O} K={K}", "max_abs_err": err, "worst_err_over_limit": worst,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                       "library_ms": lib_ms}
                rows[name]["shapes"].append(row)
                log(json.dumps({"kernel": name, **row}))

    B, H, Hkv, hd, S, pos = MOE_ATTN
    q = torch.randn((B, H, pos, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, pos, hd), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    out = flash_gqa.flash_attention_gqa(q, k, v)
    ref32 = flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float())
    worst, err = _held(out, ref32)
    if not worst <= 1.0:
        raise AssertionError(f"flash_gqa rep 8: worst err/limit {worst}, max abs err {err}")
    del ref32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: flash_gqa.flash_attention_gqa(q, k, v), sz.reps)
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * H * hd * pos * (pos + 1) / 2, "bf16")
    row = {"shape": f"qwen3-30b-a3b rep 8 B={B} H={H} Hkv={Hkv} T={pos} d={hd}", "route": "tensor_core",
           "max_abs_err": err, "worst_err_over_limit": worst, "ms": ms,
           "plain_ms": timer(lambda: flash_gqa.flash_attention_gqa_plain(q, k, v), 2), "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms,
           "library_ms": timer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), sz.reps)}
    rows["flash_gqa"]["shapes"].append(row)
    log(json.dumps({"kernel": "flash_gqa", **row}))
    del q, k, v, out
    for fmt in ("int8", "bf16"):
        kc, ks, qf = _stored_rows(torch, dev, g, (B, Hkv, S, hd), fmt)
        vc, vs, _ = _stored_rows(torch, dev, g, (B, Hkv, S, hd), fmt)
        qd = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd) * qf
        kn, vn = (torch.randn((B, Hkv, 1, hd), generator=g, device=dev) for _ in range(2))
        args = (qd, kc, vc, kn, vn, torch.tensor(pos, dtype=torch.int32, device=dev), fmt, ks, vs)
        out, ref = kv_attention.kv_decode_attention(*args), kv_attention.kv_decode_attention_plain(*args)
        rel = _rel(out, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"kv_decode_attention {fmt} rep 8: rel err {rel} > 1e-5")
        ms = timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps)
        nbytes = 2 * B * Hkv * pos * _kv_row_bytes(fmt, hd) + 2 * B * Hkv * hd * 4 + 2 * qd.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * H * (pos + 1) * hd, "bf16")
        row = {"shape": f"{fmt} qwen3-30b-a3b rep 8 B={B} n_kv={Hkv} rep={H // Hkv} S={S} pos={pos}",
               "max_abs_err": float((out - ref).abs().max()), "rel_err": rel, "ms": ms,
               "plain_ms": timer(lambda: kv_attention.kv_decode_attention_plain(*args), 2), "bound_ms": b_ms,
               "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
        rows["kv_decode_attention"]["shapes"].append(row)
        log(json.dumps({"kernel": "kv_decode_attention", **row}))
        del kc, vc, ks, vs


# The shapes GPT-OSS-20B and Llama-4-Scout give the GEMMs: (model, label, O,
# K, formats, rows). Projections at the 8 x 2048 prefill (N = 16384) and a
# decode step (N = 8); experts at their prefill capacity C (GPT-OSS: 2 S k /
# E = 4096, Scout: 2048) and their decode C (2 and 1); Scout's shared expert
# takes every token. GPT-OSS's K = 2880 is 22.5 128-blocks: INT4 pads it
# to 2944 (code 0), the fp4 rows end in a half block.
FAMILY_GEMMS = (
    ("gpt-oss-20b", "q_proj", 4096, 2880, ("int4", "nvfp4", "mxfp4"), (16384, 8)),
    ("gpt-oss-20b", "k_proj", 512, 2880, ("int4", "nvfp4", "mxfp4"), (16384, 8)),
    ("gpt-oss-20b", "o_proj", 2880, 4096, ("int4", "nvfp4", "mxfp4"), (16384, 8)),
    ("gpt-oss-20b", "expert gate/up/down", 2880, 2880, ("int4", "nvfp4", "mxfp4"), (4096, 2)),
    ("llama4-scout", "q_proj/o_proj", 5120, 5120, ("nvfp4", "w4a8"), (16384, 8)),
    ("llama4-scout", "k_proj", 1024, 5120, ("nvfp4", "w4a8"), (16384, 8)),
    ("llama4-scout", "expert gate", 8192, 5120, ("nvfp4", "w4a8"), (2048, 1)),
    ("llama4-scout", "expert down", 5120, 8192, ("nvfp4", "w4a8"), (2048, 1)),
    ("llama4-scout", "shared gate", 8192, 5120, ("nvfp4", "w4a8"), (16384, 8)),
    ("llama4-scout", "shared down", 5120, 8192, ("nvfp4", "w4a8"), (16384, 8)),
)
FAMILY_GEMM_REPS = 5


def _phase_kernels_families(torch, dev, sz: Sizes, timer: Timer, rows: dict, g, table=FAMILY_GEMMS):
    """The GEMMs at `table`'s shapes (FAMILY_GEMMS, DeepSeek-V3's
    DEEPSEEK_GEMMS, DiT-XL/2's DIT_GEMMS) against their plain versions (W4A8
    bit-exact; INT4, NVFP4, MXFP4 and FP8 weight-only under `_held`), timed beside the plain
    version, with the bound and, for INT4, `torch._weight_int4pack_mm` on
    the same codes and scales (its K padded with zero columns to the 128
    multiple where K is not one: the same value); the rows join each
    kernel's `shapes`."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm, qmm_wo
    from tensorrt_model_optimizer_tpu_torch.ops.cuda.qmm import int4_a8_codes

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.int32).to(torch.uint8)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reps = FAMILY_GEMM_REPS
    for model, label, O, K, fmts, ns in table:
        Kp4, Kp64 = -(-K // 128) * 128, -(-K // 64) * 64
        nib4, nib = rand_bytes((O, Kp4 // 2)), rand_bytes((O, Kp64 // 2))
        s4 = (torch.rand((Kp4 // 128, O), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16).float()
        cases = {
            "int4": ("qmm_int4_wo", qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (nib4, s4),
                     nbytes(nib4) + 2 * s4.numel()),
            "nvfp4": ("qmm_fp4_wo", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                      (nib, (rand_bytes((O, Kp64 // 16)) % 48 + 0x20).view(torch.float8_e4m3fn),
                       torch.tensor(0.0137, dtype=torch.float32, device=dev)), None),
            "mxfp4": ("qmm_fp4_wo", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain,
                      (nib, (rand_bytes((O, Kp64 // 32)) % 9).to(torch.int8) - 8), None),
        }
        if "fp8" in fmts:  # e4m3 codes (no NaN code) under a per-tensor scale, FP8_DEFAULT_CFG's pack
            qb = rand_bytes((O, K))
            cases["fp8"] = ("qmm_byte_wo", qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain,
                            (torch.where((qb & 0x7F) == 0x7F, qb & 0x80, qb).view(torch.float8_e4m3fn),
                             torch.tensor(0.0021, dtype=torch.float32, device=dev)), None)
        for N in ns:
            for fmt in fmts:
                if fmt == "w4a8":
                    x8 = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
                    sc = (torch.rand((K // 128, O), generator=g, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
                    n_split = qmm.w4a8_decode_splits(N, K, O, sms)
                    out = qmm.w4a8_matmul(x8, nib4, sc)
                    if not torch.equal(out, qmm.w4a8_matmul_plain(x8, nib4, sc, n_split=n_split)):
                        raise AssertionError(f"w4a8 {model} {label} N={N}: not bit-exact with the plain version")
                    ms = timer(lambda: qmm.w4a8_matmul(x8, nib4, sc), reps)
                    b_ms, b_by = bound(N * K + O * K / 2 + (K // 128) * O * 2 + N * O * 4, 2.0 * N * O * K, "int8")
                    row = {"shape": f"{model} {label} N={N} O={O} K={K}", "route": "decode" if N <= 16 else "prefill",
                           "n_split": n_split, "max_abs_err": 0.0, "bit_exact": True, "ms": ms,
                           "plain_ms": timer(lambda: qmm.w4a8_matmul_plain(x8, nib4, sc), 2), "bound_ms": b_ms,
                           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
                    rows["qmm_w4a8"]["shapes"].append(row)
                    log(json.dumps({"kernel": "qmm_w4a8", **row}))
                    del x8, out
                    continue
                name, fn, plain, w, wbytes = cases[fmt]
                x = torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
                out = fn(x, *w)
                worst, err = _held(out, plain(x, *w, out_dtype=torch.float32))
                if not worst <= 1.0:
                    raise AssertionError(f"{name} {fmt} {model} {label} N={N}: worst err/limit {worst} > 1, "
                                         f"max abs err {err}")
                ms = timer(lambda: fn(x, *w), reps)
                lib_ms = None
                if fmt == "int4":
                    u = int4_a8_codes(nib4).to(torch.int32) + 8  # codes + 8, even k in the high nibble
                    wp = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
                    szp = torch.stack([s4, torch.zeros_like(s4)], dim=-1).to(torch.bfloat16).contiguous()
                    xp = torch.nn.functional.pad(x, (0, Kp4 - K))
                    lib_ms = timer(lambda: torch._weight_int4pack_mm(xp, wp, 128, szp), reps)
                    del u, wp, szp, xp
                b_ms, b_by = bound(N * K * 2 + (wbytes or nbytes(*w)) + N * O * 2, 2.0 * N * O * K, "bf16")
                row = {"shape": f"{fmt} {model} {label} N={N} O={O} K={K}", "max_abs_err": err,
                       "worst_err_over_limit": worst, "ms": ms, "plain_ms": timer(lambda: plain(x, *w), 2),
                       "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms}
                rows[name]["shapes"].append(row)
                log(json.dumps({"kernel": name, **row}))
                del x, out
        del nib4, nib, s4, cases


# The times of the CUDA-core kernels that flash and skip-softmax ran before
# their tensor-core redesign, at the shapes both were measured at (PERF.md's
# kernel table, rows 3 and 17; H100 80GB HBM3, 700.00 W), printed beside
# this run's in the phase rows as `cuda_core_ms`: constants, not re-measured.
CUDA_CORE_MS = {"flash 8B": 10.72, "skip 8B": 12.34, "skip 8B spike": 10.82, "skip anchor-ruler": 1.713,
                "skip ragged S=131": 55.00, "skip ragged S=200": 2.193}
# The largest share of flash's outputs at the anchor's prefill shape that
# may round to another bf16 than the plain version's f32 result. P split
# exactly into three bf16 terms reads 2.1e-4 there on an H100; two terms
# (~16 bits of p) read 4.4e-3, and such an ulp, carried through int8
# activation codes, gave a W4A8 token on the anchor other than the plain
# engine's. Over 2048 keys the share is ~2e-3 with P exact as well (the
# mma's own f32 accumulation, it seems: PERF.md section 7), so it is
# reported there, not held.
ULP_OFF_MAX = 1e-3
ANCHOR_FLASH = (4, 8, 4, 32, 32)  # artifacts/anchor-llama's prefill: B, H, Hkv, T, d


def _ulp_off(torch, out, ref32) -> float:
    """The share of bf16 outputs that differ from ref32 rounded to bf16."""
    return float((out != ref32.to(torch.bfloat16)).float().mean())


def _phase_kernels_flash(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """flash GQA (tensor cores) against its plain version: the 8B prefill
    shape with q contiguous and as the engine passes it (a [B, T, H, d]
    tensor seen as [B, H, T, d], read in place), a ragged T = 1000, and
    head_dim 64 and 32; SDPA causal GQA is the library call.

    bf16 out. Each element is held against the plain version's f32 result
    (bf16 inputs, f32 softmax, before the bf16 cast): rounding to bf16
    moves a value by at most half an ulp, 2^-8 of itself, and the two f32
    results differ by ~1e-6 of the row's sum of |p.v| (f32 sums in another
    order; the kernel's P is split exactly into three bf16 terms), covered
    by 1e-3 of the output's rms. The limit is per element,
    so a late row (|out| ~ 0.03) is held to ~1e-4, not to the largest
    output's scale. A value just above a power of two rounds by up to 2^-8
    of itself, so the worst err/limit of a right kernel comes near 1; the
    rms term is its headroom for the f32 gap. At the anchor's prefill shape
    at most ULP_OFF_MAX of the outputs may round to another bf16 than the
    plain version's."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, Hkv, T, d = sz.flash
    cases = [("8B", (B, H, Hkv, T, d), False), ("8B, q as the engine's [B, T, H, d] view", (B, H, Hkv, T, d), True),
             ("ragged T=1000", (B, H, Hkv, 1000, d), False), ("d=64", (B, H, Hkv, T, 64), False),
             ("d=32", (B, H, Hkv, T, 32), False), ("anchor prefill", ANCHOR_FLASH, False)]
    shapes = []
    for label, (b, h, hkv, t, dd), view in cases:
        q = torch.randn((b, t, h, dd) if view else (b, h, t, dd), generator=g, device=dev).to(torch.bfloat16)
        q = q.transpose(1, 2) if view else q
        k, v = (torch.randn((b, hkv, t, dd), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        n0 = flash_gqa.launches
        out = flash_gqa.flash_attention_gqa(q, k, v)
        torch.cuda.synchronize()
        if flash_gqa.launches != n0 + 1 or out.stride() != q.stride():
            raise AssertionError(f"flash_gqa {label}: launches {flash_gqa.launches - n0}, out strides "
                                 f"{out.stride()} for q's {q.stride()}")
        ref32 = flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float())
        diff = (out.float() - ref32).abs()
        tol = 2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt())
        worst = float((diff / tol).max())
        err = float(diff.max())
        ulp_off = _ulp_off(torch, out, ref32)
        if not worst <= 1.0:
            bad = int((diff > tol).sum())
            raise AssertionError(f"flash_gqa {label}: {bad} elements beyond 2^-8|ref| + 1e-3 rms(ref); "
                                 f"worst err/limit {worst}, max abs err {err}, "
                                 f"max |ref| {float(ref32.abs().max())}")
        if (b, h, hkv, t, dd) == ANCHOR_FLASH and not ulp_off <= ULP_OFF_MAX:
            raise AssertionError(f"flash_gqa {label}: {ulp_off} of the outputs round to another bf16 than the plain "
                                 f"version's, the limit is {ULP_OFF_MAX}")
        del ref32, diff, tol
        ms = timer(lambda: flash_gqa.flash_attention_gqa(q, k, v), sz.reps)
        plain_ms = timer(lambda: flash_gqa.flash_attention_gqa_plain(q, k, v), max(2, sz.reps // 8))
        lib_ms = timer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), sz.reps)
        b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4.0 * b * h * dd * t * (t + 1) / 2, "bf16")
        shapes.append({"shape": f"{label} B={b} H={h} Hkv={hkv} T={t} d={dd}", "route": "tensor_core",
                       "max_abs_err": err, "worst_err_over_limit": worst, "ulp_off_share": ulp_off, "ms": ms,
                       "cuda_core_ms": CUDA_CORE_MS.get(f"flash {label}"),
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                       "library_ms": lib_ms, "x_library": ms / lib_ms})
        log(json.dumps({"kernel": "flash_gqa", **shapes[-1]}))
        del q, k, v, out
    rows["flash_gqa"] = dict(shapes[0], shapes=shapes)


SKIP_KERNELS = {"tensor_core": "skip_softmax_flash_tc", "cuda_core": "skip_softmax_flash_cuda_core"}  # route -> KERNELS
SKIP_MARGIN = 1e-4  # |tile max - (running max + log threshold)|, in scaled-score units, where a keep may flip


def _phase_kernels_skip(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """skip_softmax_flash against its plain version, through both routes.
    The tensor-core route: the 8B prefill shape (BH 256, S 2048, d 128, bf16,
    causal 128-tiles) at threshold 1e-30 (only the causal tiles skipped), on
    spiked inputs at 1e-2 (most tiles skipped), at the threshold
    `calibrate_threshold` gives for a 0.4 block sparsity, and with 64-tiles
    at 1e-30. The CUDA-core route: the RULER anchor's shape (f32, d 32, S
    448, 64-tiles, BH 64 x 8 heads); ragged S = 131 (tiles of 1) and S = 200
    (tiles of 8).

    Keep maps are held equal, except tiles whose decision lies within
    SKIP_MARGIN of its limit in the plain version (the kernel's f32 dot sums
    in another order), which are counted and printed; the outputs of the q
    tiles whose keep rows agree are held per element to 2^-8 |ref| + 1e-3
    rms(ref) against the plain version's f32 result; in bf16 the share
    that rounds to another bf16 is reported. SDPA causal, timed at
    threshold 1e-30 where it computes the same function, is the library
    call."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as ssa
    from tensorrt_model_optimizer_tpu_torch.sparsity.attention_sparsity import calibrate_threshold

    sdpa = torch.nn.functional.scaled_dot_product_attention
    BH, S, d, blk = sz.skip

    def inputs(bh, s, dd, dtype, spike=False):
        q, k, v = (torch.randn((bh, s, dd), generator=g, device=dev) for _ in range(3))
        if spike:  # attention concentrated on the first 16 keys
            q[:, :, 0] = 8.0
            k[:, :16, 0] = 8.0
        return tuple(t.to(dtype) for t in (q, k, v))

    q8, k8, v8 = inputs(BH, S, d, torch.bfloat16)
    x = q8[0, :512].float()[None, :, None, :]  # as tools/bench_sparse_prefill.py: q = k = v
    calibrated = calibrate_threshold(x, x, x, 0.4)
    # (label, inputs, threshold, tile, the route it must take)
    cases = [("8B", (q8, k8, v8), 1e-30, blk, "tensor_core"),
             ("8B spike", inputs(BH, S, d, torch.bfloat16, True), 1e-2, blk, "tensor_core"),
             ("8B calibrated 0.4", (q8, k8, v8), calibrated, blk, "tensor_core"),
             ("8B 64-tiles", (q8, k8, v8), 1e-30, 64, "tensor_core"),
             ("anchor-ruler", inputs(512, 448, 32, torch.float32), 1e-2, 64, "cuda_core"),
             ("ragged S=131", inputs(32, 131, d, torch.bfloat16), 1e-2, blk, "cuda_core"),
             ("ragged S=200", inputs(32, 200, d, torch.bfloat16), 0.5, blk, "cuda_core")]
    shapes = {"tensor_core": [], "cuda_core": []}
    for label, (q, k, v), th, b, want in cases:
        bh, s, dd = q.shape
        bq, bk = ssa.tile_sizes(s, b, b)
        r0 = ssa.route_launches[want]
        out, keep = ssa.skip_softmax_flash(q, k, v, th, b, b, True)
        torch.cuda.synchronize()
        if ssa.route(q.dtype, dd, bq, bk) != want or ssa.route_launches[want] != r0 + 1:
            raise AssertionError(f"skip_softmax_flash {label}: the {want} route did not launch "
                                 f"({ssa.route_launches})")
        ref32, rkeep = ssa.skip_softmax_flash_plain(q.float(), k.float(), v.float(), th, b, b, True)
        _, margin = ssa.tile_decisions(ssa.block_max(q, k, bq, bk, True), ssa.log_threshold(th), bq, bk, True)
        flips = keep != rkeep
        far = flips & (margin.abs() > SKIP_MARGIN)
        if bool(far.any()):
            raise AssertionError(f"skip_softmax_flash {label}: {int(far.sum())} keep decisions differ from the plain "
                                 f"version away from the decision limit (margins {margin[far][:8].tolist()})")
        agree = ~flips.any(dim=-1)  # [bh, nq]: q tiles whose whole keep row agrees
        rows_ok = agree[:, :, None].expand(bh, s // bq, bq).reshape(bh, s)
        diff = (out.float() - ref32).abs()[rows_ok]
        tol = (2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt()))[rows_ok]
        worst = float((diff / tol).max()) if diff.numel() else 0.0
        err = float(diff.max()) if diff.numel() else 0.0
        if not worst <= 1.0:
            raise AssertionError(f"skip_softmax_flash {label}: worst err/limit {worst} > 1 (2^-8|ref| + 1e-3 "
                                 f"rms(ref)), max abs err {err}")
        ulp_off = _ulp_off(torch, out[rows_ok], ref32[rows_ok]) if q.dtype == torch.bfloat16 else None
        kept = float(keep.float().mean())
        ms = timer(lambda: ssa.skip_softmax_flash(q, k, v, th, b, b, True), sz.reps)
        plain_ms = timer(lambda: ssa.skip_softmax_flash_plain(q, k, v, th, b, b, True), 2)
        lib_ms = lib_rel = None
        if th == 1e-30:
            lib = lambda: sdpa(q[None], k[None], v[None], is_causal=True)[0]  # noqa: E731
            lib_rel = _rel(lib().float(), ref32)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"skip_softmax_flash {label}: SDPA is {lib_rel} of the output's scale from the "
                                     "plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
        # operations: q.k and p.v (2 x 2 d) for each score the kept tiles need:
        # in a tile the causal edge cuts, only the keys at or below each row;
        # bytes: q, k and v read, out written
        b_ms, b_by = bound(4 * q.numel() * q.element_size(), 4.0 * dd * _live_scores(torch, keep, s, bq, bk),
                           "bf16" if q.dtype == torch.bfloat16 else "f32")
        shapes[want].append({
            "shape": f"{label} BH={bh} S={s} d={dd} {str(q.dtype)[6:]} tiles={bq}x{bk} causal", "route": want,
            "threshold": th, "kept_share": kept, "keep_flips": int(flips.sum()), "q_tiles_excluded": int((~agree).sum()),
            "max_abs_err": err, "worst_err_over_limit": worst, "ulp_off_share": ulp_off, "ms": ms,
            "cuda_core_ms": CUDA_CORE_MS.get(f"skip {label}"),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
            "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "skip_softmax_flash", **shapes[want][-1]}))
        del out, keep, ref32, rkeep, margin, diff, tol
    for which, sh in shapes.items():
        rows[SKIP_KERNELS[which]] = dict(sh[0], shapes=sh)


def _live_scores(torch, keep, s: int, bq: int, bk: int) -> float:
    """The causal scores the kept tiles of `keep` [bh, s / bq, s / bk] hold:
    row r of a q tile sees the keys c <= r of each k tile."""
    rows = torch.arange(s, device=keep.device, dtype=torch.float64)
    starts = torch.arange(0, s, bk, device=keep.device, dtype=torch.float64)
    live = (rows[:, None] - starts[None, :] + 1).clamp(0, bk).reshape(s // bq, bq, -1).sum(1)  # [nq, nk]
    return float((keep.double() * live).sum())


def _stored_rows(torch, dev, g, shape, fmt):
    """Seeded random K or V rows [..., hd] in stored form: (rows, NVFP4
    block-scale bytes or None, a factor that brings q.k to a few units)."""
    if fmt == "int8":
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int32).to(torch.int8), None, 1 / 40.0
    if fmt == "nvfp4":
        *lead, hd = shape
        planes = torch.randint(0, 256, (*lead, hd // 2), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
        # e4m3 block scales 2^-3 .. 2^2 with random mantissas
        scales = (torch.randint(0, 48, (*lead, hd // 16), generator=g, device=dev, dtype=torch.int32) + 0x20).to(torch.uint8)
        return planes, scales, 1 / 4.0
    dtype = torch.bfloat16 if fmt == "bf16" else torch.float8_e4m3fn
    return (torch.randn(shape, generator=g, device=dev) * 2).to(dtype), None, 1.0


def _kv_row_bytes(fmt: str, hd: int) -> float:
    """Stored bytes of one K or V row (NVFP4: planes and block scales)."""
    return {"bf16": 2 * hd, "int8": hd, "fp8": hd, "nvfp4": hd // 2 + hd // 16}[fmt]


def _paged_pool(torch, dev, g, sz: Sizes, fmt: str, lens: list, max_pages: int):
    """A seeded page pool of the 8B shape (`sz.kv`, pages of `sz.page` rows):
    (K pages, V pages, their NVFP4 scale pages or None, q's factor, a block
    table of shuffled pages with -1 past each length, the lengths)."""
    B, n_kv, _, hd, _, _ = sz.kv
    n_pages = 1 + B * max_pages
    kp, ksp, qf = _stored_rows(torch, dev, g, (n_pages, n_kv, sz.page, hd), fmt)
    vp, vsp, _ = _stored_rows(torch, dev, g, (n_pages, n_kv, sz.page, hd), fmt)
    perm = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(torch.int32).reshape(B, max_pages)
    live = torch.arange(max_pages, device=dev)[None] * sz.page < torch.tensor(lens, device=dev)[:, None]
    table = torch.where(live, perm, torch.full_like(perm, -1))
    return kp, vp, ksp, vsp, qf, table, torch.tensor(lens, dtype=torch.int32, device=dev)


KV_FORMATS = ("int8", "bf16", "fp8", "nvfp4")
# route -> KERNELS
PAGED_PREFILL_KERNELS = {"tensor_core": "paged_attention_prefill_tc", "cuda_core": "paged_attention_prefill_cuda_core"}


def _phase_kernels_kv(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """The three KV-cache attention kernels against their plain versions at
    the 8B shapes (32 heads over 8 kv heads of 128, pages of 16 rows), in
    every stored form, and the NVFP4 decoder on every code."""
    from tensorrt_model_optimizer_tpu_torch.ops import numerics
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import kv_attention, paged_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, n_kv, rep, hd, S, pos = sz.kv
    nH, page = n_kv * rep, sz.page

    # --- the NVFP4 decoder, exactly: V rows that hold all 16 E2M1 codes under
    # every non-negative finite E4M3 scale byte (0x00 .. 0x7e; 0x7f, NaN, never
    # occurs) go through each kernel as the only live row, where softmax gives
    # it the weight 1 (the dense kernel's current token scores -1e4, and
    # exp(-1e4) is 0), so the output is the decoded row bit for bit.
    nrow = 2 * n_kv
    planes = (torch.arange(hd // 2, device=dev) % 16 * 0x11).to(torch.uint8).expand(nrow, hd // 2)
    sbytes = torch.arange(nrow * hd // 16, device=dev).reshape(nrow, hd // 16)
    sbytes = torch.where(sbytes > 0x7E, torch.zeros_like(sbytes), sbytes).to(torch.uint8)
    want = numerics.nvfp4_planes_code_load(planes, sbytes).reshape(2, n_kv, 1, hd).expand(2, n_kv, rep, hd)
    want = want.reshape(2, nH, hd)
    q = torch.zeros((2, nH, hd), device=dev)
    q[..., 0] = 1.0
    dense = lambda t, last: t.reshape(2, n_kv, 1, last).expand(2, n_kv, 4, last).contiguous()  # noqa: E731
    kn = torch.zeros((2, n_kv, 1, hd), device=dev)
    kn[..., 0] = -1e4
    pool = lambda t, last: torch.cat([torch.zeros((1, n_kv, page, last), dtype=torch.uint8, device=dev),  # noqa: E731
                                      t.reshape(2, n_kv, 1, last).expand(2, n_kv, page, last)]).contiguous()
    one = torch.ones(2, dtype=torch.int32, device=dev)
    table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
    chunk = lambda t, last: t.reshape(2, 1, n_kv, last).contiguous()  # noqa: E731
    got = {
        "kv_decode_attention": kv_attention.kv_decode_attention(
            q, dense(planes, hd // 2), dense(planes, hd // 2), kn, torch.zeros_like(kn), 1, "nvfp4",
            dense(sbytes, hd // 16), dense(sbytes, hd // 16)),
        "paged_attention_decode": paged_attention.paged_attention_decode(
            q, pool(planes, hd // 2), pool(planes, hd // 2), table, one, "nvfp4",
            pool(sbytes, hd // 16), pool(sbytes, hd // 16)),
    }
    for route, qd in (("cuda cores", torch.float32), ("tensor cores", torch.bfloat16)):
        # f32 q takes the CUDA-core route, bf16 q the tensor cores, whose bf16
        # output holds the decoded values exactly (at most 6 significant bits)
        got[f"paged_attention_prefill ({route})"] = paged_attention.paged_attention_prefill(
            q[:, None].to(qd), pool(planes, hd // 2), pool(planes, hd // 2), table, torch.zeros_like(one),
            chunk(planes, hd // 2), chunk(planes, hd // 2), "nvfp4", pool(sbytes, hd // 16), pool(sbytes, hd // 16),
            chunk(sbytes, hd // 16), chunk(sbytes, hd // 16))[:, 0].float()
    torch.cuda.synchronize()
    for name, y in got.items():
        if not torch.equal(y, want):
            bad = torch.nonzero(y != want)
            raise AssertionError(f"{name}: NVFP4 decode differs from nvfp4_planes_code_load at {len(bad)} of "
                                 f"{want.numel()} values, first (row, head, dim) {bad[0].tolist()}")
    log(json.dumps({"kernel": "kv_decode_attention, paged_attention_decode, paged_attention_prefill (both routes)",
                    "check": "NVFP4 decode: 16 E2M1 codes x 127 E4M3 scale bytes exact"}))

    # --- dense decode attention (split over the cache, then merged): f32 vs
    # torch.softmax; 1e-5 of the output's scale (f32 rounding of sums taken
    # in another order), pos a 0-d int32 tensor on the card (the grid is
    # sized from S alone), at pos 0 (the current token alone), 1, each side
    # of the first split's edge and the 8B pos. The bf16 format has a library
    # call: SDPA over the valid rows and the current token, concatenated
    # outside the timed call; it takes q, the current token and the output in
    # bf16, so it is held to 1e-2 of the output's scale.
    shapes = []
    for fmt in KV_FORMATS:
        kc, ks, qf = _stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        vc, vs, _ = _stored_rows(torch, dev, g, (B, n_kv, S, hd), fmt)
        q = torch.randn((B, nH, hd), generator=g, device=dev) / math.sqrt(hd) * qf
        kn, vn = (torch.randn((B, n_kv, 1, hd), generator=g, device=dev) for _ in range(2))
        edges = {}
        for p_ in (0, 1, 255, 256, 257):
            e_args = (q, kc, vc, kn, vn, torch.tensor(p_, dtype=torch.int32, device=dev), fmt, ks, vs)
            edges[p_] = _rel(kv_attention.kv_decode_attention(*e_args), kv_attention.kv_decode_attention_plain(*e_args))
            if not edges[p_] <= 1e-5:
                raise AssertionError(f"kv_decode_attention {fmt} pos {p_}: rel err {edges[p_]} > 1e-5")
        args = (q, kc, vc, kn, vn, torch.tensor(pos, dtype=torch.int32, device=dev), fmt, ks, vs)
        out = kv_attention.kv_decode_attention(*args)
        ref = kv_attention.kv_decode_attention_plain(*args)
        rel = _rel(out, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"kv_decode_attention {fmt}: rel err {rel} > 1e-5")
        ms = timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps)
        plain_ms = timer(lambda: kv_attention.kv_decode_attention_plain(*args), max(2, sz.reps // 4))
        lib_ms = lib_rel = None
        if fmt == "bf16":
            qb = q.to(torch.bfloat16)[:, :, None]
            kk = torch.cat([kc[:, :, :pos], kn.to(torch.bfloat16)], dim=2)
            vv = torch.cat([vc[:, :, :pos], vn.to(torch.bfloat16)], dim=2)
            lib = lambda: sdpa(qb, kk, vv, scale=1.0, enable_gqa=True)  # noqa: E731
            lib_rel = _rel(lib()[:, :, 0].float(), ref)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"kv_decode_attention bf16: SDPA is {lib_rel} of the output's scale from the "
                                     "plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
        nbytes = 2 * B * n_kv * pos * _kv_row_bytes(fmt, hd) + 2 * B * n_kv * hd * 4 + 2 * q.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * nH * (pos + 1) * hd, "bf16")
        shapes.append({"shape": f"{fmt} B={B} n_kv={n_kv} rep={rep} S={S} pos={pos}",
                       "splits": kv_attention.n_splits(S), "max_abs_err": float((out - ref).abs().max()),
                       "rel_err": rel, "rel_err_at_pos": edges, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
                       "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "kv_decode_attention", **shapes[-1]}))
        del kc, vc, ks, vs
    rows["kv_decode_attention"] = dict(shapes[0], shapes=shapes)

    # --- the paged kernels: bf16 queries and outputs as the engine gives and
    # takes them, held per element against the plain version's f32 result
    # (`_held`: the bf16 rounding of the output plus the f32 sums' order).
    # Pages come from a shuffled pool; table entries past a sequence's live
    # pages are -1. The bf16 format's library call is SDPA over K/V gathered
    # outside the timed call, with the lengths as a mask; it rounds its
    # probabilities to bf16, so it is held to 1e-2 of the output's scale (rows
    # of a sequence with no live row apart: SDPA gives NaN there, the kernels 0).
    def gathered(pages, table):
        return pages[table.clamp_min(0).long()].permute(0, 2, 1, 3, 4).reshape(B, n_kv, -1, hd)

    # The table spans 2080 rows (130 pages): 9 splits of 256 rows, the last
    # one past every length but in "edges", which ends on the table's last
    # row and puts lengths on each side of the first splits' edges.
    shapes = []
    paged_lens = (("uniform", [2048] * B), ("ragged", [2048, 1153, 1024, 513, 17, 16, 1, 0][:B]),
                  ("edges", [0, 1, 255, 256, 257, 511, 513, 2080][:B]))
    for fmt in KV_FORMATS:
        for what, lens in paged_lens:
            kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, sz, fmt, lens, 2048 // page + 2)
            q = (torch.randn((B, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
            kind = "nvfp4" if fmt == "nvfp4" else "raw"
            args = (q, kp, vp, table, tl, kind, ksp, vsp)
            out = paged_attention.paged_attention_decode(*args)
            ref32 = paged_attention.paged_attention_decode_plain(*args, out_dtype=torch.float32)
            worst, err = _held(out, ref32)
            if not worst <= 1.0:
                raise AssertionError(f"paged_attention_decode {fmt} {what}: worst err/limit {worst} > 1 "
                                     f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
            _same_again(torch, f"paged_attention_decode {fmt} {what}", out,
                        paged_attention.paged_attention_decode(*args))
            ms = timer(lambda: paged_attention.paged_attention_decode(*args), sz.reps)
            plain_ms = timer(lambda: paged_attention.paged_attention_decode_plain(*args), max(2, sz.reps // 4))
            lib_ms = lib_rel = None
            if fmt == "bf16":
                kk, vv = gathered(kp, table), gathered(vp, table)
                mask = (torch.arange(kk.shape[2], device=dev)[None] < tl[:, None])[:, None, None, :]
                lib = lambda: sdpa(q[:, :, None], kk, vv, attn_mask=mask, enable_gqa=True)  # noqa: E731
                some = tl > 0
                lib_rel = _rel(lib()[:, :, 0].float()[some], ref32[some])
                if not lib_rel <= 1e-2:
                    raise AssertionError(f"paged_attention_decode bf16 {what}: SDPA is {lib_rel} of the output's "
                                         "scale from the plain version: not the same function")
                lib_ms = timer(lib, sz.reps)
                del kk, vv
            nbytes = 2 * n_kv * sum(lens) * _kv_row_bytes(fmt, hd) + 2 * q.numel() * 2 + table.numel() * 4
            b_ms, b_by = bound(nbytes, 4.0 * nH * sum(lens) * hd, "bf16")
            shapes.append({"shape": f"{fmt} {what} B={B} n_kv={n_kv} rep={rep} page={page} lens={lens}",
                           "splits": paged_attention.n_splits(table.shape[1], page), "max_abs_err": err,
                           "worst_err_over_limit": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms,
                           "x_library": None if lib_ms is None else ms / lib_ms, "library_rel_err": lib_rel})
            log(json.dumps({"kernel": "paged_attention_decode", **shapes[-1]}))
            del kp, vp, ksp, vsp, ref32
    rows["paged_attention_decode"] = dict(shapes[0], shapes=shapes)

    # paged prefill through both routes. The tensor cores (bf16 q, the engine's
    # activations): every format at the chunk's T = 64 and at T = 5 (a q tile
    # mostly padding), held per element by `_held`, with the share of bf16
    # outputs that round to another bf16 than the plain version's f32 result
    # reported. The CUDA cores (f32 q, the anchor's f32 engine): every format
    # at T = 64, f32 out, held to 1e-5 of the output's scale.
    shapes = {"tensor_core": [], "cuda_core": []}
    full_ctx, short_ctx = [1024, 960, 256, 70, 64, 1, 0, 0][:B], [1024, 37, 256, 70, 64, 1, 0, 0][:B]
    cases = [("tensor_core", fmt, sz.chunk, full_ctx) for fmt in KV_FORMATS]
    cases += [("tensor_core", fmt, 5, short_ctx) for fmt in KV_FORMATS]  # T not a multiple of 8
    cases += [("cuda_core", fmt, sz.chunk, full_ctx) for fmt in KV_FORMATS]
    for want, fmt, T, ctx in cases:
        kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, sz, fmt, ctx, 1024 // page + 2)
        ck, cks, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
        cv, cvs, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), fmt)
        qdt = torch.bfloat16 if want == "tensor_core" else torch.float32
        q = (torch.randn((B, T, nH, hd), generator=g, device=dev) * qf).to(qdt)
        kind = "nvfp4" if fmt == "nvfp4" else "raw"
        args = (q, kp, vp, table, tl, ck, cv, kind, ksp, vsp, cks, cvs)
        n0 = paged_attention.prefill_route_launches[want]
        out = paged_attention.paged_attention_prefill(*args)
        torch.cuda.synchronize()
        if paged_attention.prefill_route(q.dtype, hd, rep) != want or \
                paged_attention.prefill_route_launches[want] != n0 + 1:
            raise AssertionError(f"paged_attention_prefill {fmt} T={T}: the {want} route did not launch "
                                 f"({paged_attention.prefill_route_launches})")
        ref32 = paged_attention.paged_attention_prefill_plain(*args, out_dtype=torch.float32)
        ulp_off = None
        if want == "tensor_core":
            worst, err = _held(out, ref32)
            ulp_off = _ulp_off(torch, out, ref32)
            if not worst <= 1.0:
                raise AssertionError(f"paged_attention_prefill {fmt} T={T}: worst err/limit {worst} > 1 "
                                     f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
        else:
            worst, err = _rel(out, ref32), float((out - ref32).abs().max())
            if not worst <= 1e-5:
                raise AssertionError(f"paged_attention_prefill f32 {fmt} T={T}: rel err {worst} > 1e-5")
        ms = timer(lambda: paged_attention.paged_attention_prefill(*args), sz.reps)
        plain_ms = timer(lambda: paged_attention.paged_attention_prefill_plain(*args), max(2, sz.reps // 4))
        lib_ms = lib_rel = None
        if fmt == "bf16" and want == "tensor_core" and T == sz.chunk:
            kk = torch.cat([gathered(kp, table), ck.transpose(1, 2)], dim=2)
            vv = torch.cat([gathered(vp, table), cv.transpose(1, 2)], dim=2)
            Sc = kk.shape[2] - T
            t = torch.arange(T, device=dev)
            mask = torch.cat([(torch.arange(Sc, device=dev)[None] < tl[:, None])[:, None, :].expand(B, T, Sc),
                              (t[None, :] <= t[:, None])[None].expand(B, T, T)], dim=-1)[:, None]
            lib = lambda: sdpa(q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)  # noqa: E731
            lib_rel = _rel(lib().transpose(1, 2).float(), ref32)
            if not lib_rel <= 1e-2:
                raise AssertionError(f"paged_attention_prefill bf16: SDPA is {lib_rel} of the output's scale from "
                                     "the plain version: not the same function")
            lib_ms = timer(lib, sz.reps)
            del kk, vv, mask
        rows_read = sum(ctx) + B * T
        nbytes = 2 * n_kv * rows_read * _kv_row_bytes(fmt, hd) + 2 * q.numel() * q.element_size() + table.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * nH * T * hd * sum(c + T for c in ctx), "bf16" if want == "tensor_core" else "f32")
        shapes[want].append({
            "shape": f"{fmt} B={B} T={T} n_kv={n_kv} rep={rep} page={page} ctx={ctx} q {str(q.dtype)[6:]}",
            "route": want, "max_abs_err": err, "worst_err_over_limit" if want == "tensor_core" else "rel_err": worst,
            "ulp_off_share": ulp_off, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "library_ms": lib_ms, "x_library": None if lib_ms is None else ms / lib_ms,
            "library_rel_err": lib_rel})
        log(json.dumps({"kernel": "paged_attention_prefill", **shapes[want][-1]}))
        del kp, vp, ksp, vsp, ref32
    for which, sh in shapes.items():
        rows[PAGED_PREFILL_KERNELS[which]] = dict(sh[0], shapes=sh)


def _held(out, ref32) -> tuple[float, float]:
    """A bf16 kernel output against its plain version's f32 result (before
    the bf16 cast), per element: |out - ref| <= 2^-8 |ref| + 1e-3 rms(ref).
    Rounding to bf16 moves a value by at most 2^-8 of itself; the rms term
    covers the f32 sums taken in another order (the tensor cores' against
    torch.matmul's), about 1e-6 of the row's sum of |x w|. Returns (worst
    err/limit, max abs err); a right kernel's worst ratio comes near 1."""
    diff = (out.float() - ref32).abs()
    tol = 2.0 ** -8 * ref32.abs() + 1e-3 * float(ref32.square().mean().sqrt())
    return float((diff / tol).max()), float(diff.max())


def _same_again(torch, what: str, first, again) -> None:
    """A second call on the same inputs must give the first call's bits: the
    split kernels add their partials in a fixed order, and the weight-only
    GEMMs' fix-up leaves its arrival counters at 0 for the next call."""
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f"{what}: a second call on the same inputs differs from the first at "
                             f"{int((first != again).sum())} of {first.numel()} outputs")


def _wo_cases(torch, dev, g, O: int, K: int):
    """(kernel name, label, wrapper, plain, weight arrays, weight bytes,
    library call) for each weight-only format at one projection shape, from
    seeded random codes and scales. The library call is `x -> y` through the
    one PyTorch function that computes the same GEMM from the same codes and
    scales (repacked to its layout outside the timed call), or None: PyTorch
    has a bf16 x int4 group-wise call and a bf16 x int8 per-channel call, and
    none that multiplies bf16 activations by NVFP4, MXFP4 or e4m3 weights
    (`_scaled_mm` wants both operands in fp8). It is timed and used nowhere
    in the port."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo
    from tensorrt_model_optimizer_tpu_torch.ops.cuda.qmm import int4_a8_codes

    def rand_bytes(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.int32).to(torch.uint8)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    nib = rand_bytes((O, K // 2))
    s4 = (torch.rand((K // 128, O), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16).float()

    def lib_int4(scales, group):
        # codes + 8 as unsigned nibbles, even k in the high nibble; the call
        # computes (u - 8) * scale + zero with [K/group, O, 2] bf16 scale / zero
        def make():
            u = int4_a8_codes(nib).to(torch.int32) + 8
            w = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
            sz = torch.stack([scales, torch.zeros_like(scales)], dim=-1).to(torch.bfloat16).contiguous()
            return lambda x: torch._weight_int4pack_mm(x, w, group, sz)
        return make

    # the block scales are bf16 values (the default layout rounds them so), held
    # in the kernel's f32 array: the function must move 2 bytes of each
    yield ("qmm_int4_wo", "int4", qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (nib, s4),
           nbytes(nib) + 2 * s4.numel(), lib_int4(s4, 128))
    # NF4_WEIGHT_ONLY_CFG's 64-blocks (int4 codes, f32 block scales)
    s64 = (torch.rand((K // 64, O), generator=g, device=dev) * 0.02 + 0.005).to(torch.bfloat16).float()
    yield ("qmm_int4_wo", "int4 b64", qmm_wo.int4_wo_matmul, qmm_wo.int4_wo_matmul_plain, (nib, s64),
           nbytes(nib) + 2 * s64.numel(), lib_int4(s64, 64))
    # e4m3 block scales 2^-3 .. 2^2 with random mantissas; exponents -8 .. 0
    s_nv = (rand_bytes((O, K // 16)) % 48 + 0x20).view(torch.float8_e4m3fn)
    gs = torch.tensor(0.0137, dtype=torch.float32, device=dev)
    yield ("qmm_fp4_wo", "nvfp4", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain, (nib, s_nv, gs),
           nbytes(nib, s_nv, gs), None)
    s_mx = (rand_bytes((O, K // 32)) % 9).to(torch.int8) - 8
    yield "qmm_fp4_wo", "mxfp4", qmm_wo.fp4_wo_matmul, qmm_wo.fp4_wo_matmul_plain, (nib, s_mx), nbytes(nib, s_mx), None
    q8 = rand_bytes((O, K)).view(torch.int8)
    sc8 = (torch.rand((O, 1), generator=g, device=dev) * 0.01 + 0.001).to(torch.bfloat16).float()

    def lib_int8():
        sc = sc8.reshape(-1).to(torch.bfloat16)  # exact: sc8 holds bf16 values
        return lambda x: torch._weight_int8pack_mm(x, q8, sc)

    yield ("qmm_byte_wo", "int8", qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain, (q8, sc8),
           nbytes(q8, sc8), lib_int8)
    qb = rand_bytes((O, K))
    qf8 = torch.where((qb & 0x7F) == 0x7F, qb & 0x80, qb).view(torch.float8_e4m3fn)  # no NaN codes
    scf = torch.tensor(0.0021, dtype=torch.float32, device=dev)
    yield "qmm_byte_wo", "fp8", qmm_wo.byte_wo_matmul, qmm_wo.byte_wo_matmul_plain, (qf8, scf), nbytes(qf8, scf), None


def _phase_kernels_wo(torch, dev, sz: Sizes, timer: Timer, rows: dict, g):
    """The three weight-only GEMMs against their plain versions at the 8B
    shapes, and the e4m3 decode of the byte kernel on every code."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm, qmm_wo

    # every e4m3 code through the kernel's decoder, exactly: y = I . q^T
    # with one code per k, through the prefill tiles (N = 256) and the
    # decode tiles (16 rows of I at a time); the two NaN codes apart
    codes = torch.arange(256, device=dev, dtype=torch.int32).to(torch.uint8)
    finite = (codes & 0x7F) != 0x7F
    q = torch.where(finite, codes, codes & 0x80).view(torch.float8_e4m3fn).expand(16, 256).contiguous()
    want = q[0].float()
    one = torch.ones((), dtype=torch.float32, device=dev)
    eye = torch.eye(256, dtype=torch.bfloat16, device=dev)
    got = {"prefill tiles": qmm_wo.byte_wo_matmul(eye, q, one)[:, 0].float(),
           "decode tiles": torch.cat([qmm_wo.byte_wo_matmul(eye[i:i + 16], q, one)[:, 0].float()
                                      for i in range(0, 256, 16)])}
    for what, y in got.items():
        if not torch.equal(y, want):
            raise AssertionError(f"qmm_byte_wo ({what}): e4m3 decode differs from torch at codes "
                                 f"{torch.nonzero(y != want).flatten().tolist()[:16]}")
    nan = torch.full((16, 16), 0x7F, dtype=torch.uint8, device=dev).view(torch.float8_e4m3fn)
    if not bool(torch.isnan(qmm_wo.byte_wo_matmul(eye[:16, :16].contiguous(), nan, one).float()).all()):
        raise AssertionError("qmm_byte_wo: the e4m3 NaN code does not decode to NaN")
    log(json.dumps({"kernel": "qmm_byte_wo", "check": "e4m3 decode: 254 finite codes exact, NaN code NaN"}))

    # every E2M1 code under every scale through the fp4 kernel's decoder,
    # exactly: row o of the weight holds codes 0..15 in k 0..15 and again in
    # k 16..31 under scale o (every non-NaN e4m3 byte; MXFP4 exponents -126
    # .. 125, the stored range's finite products: -126 makes 0.5 x 2^-126 a
    # bf16 subnormal, and above 125 an inf weight would make the zero terms
    # NaN), and y = I . w^T picks them,
    # through the decode route (16 rows of I) and the prefill tiles (32)
    k_codes = torch.arange(32, device=dev, dtype=torch.int32) % 16
    row = (k_codes[0::2] | k_codes[1::2] << 4).to(torch.uint8)
    eye = torch.eye(32, 64, dtype=torch.bfloat16, device=dev)
    e4m3 = torch.arange(256, device=dev, dtype=torch.int32)
    e4m3 = e4m3[(e4m3 & 0x7F) != 0x7F].to(torch.uint8)
    scale_sets = {"nvfp4": e4m3.view(torch.float8_e4m3fn)[:, None].expand(-1, 4),
                  "mxfp4": torch.arange(-126, 126, device=dev, dtype=torch.int32).to(torch.int8)[:, None].expand(-1, 2)}
    for fmt, sc in scale_sets.items():
        sc = sc.contiguous()
        packed = torch.nn.functional.pad(row, (0, 16)).expand(sc.shape[0], 32).contiguous()
        w = qmm_wo.fp4_rows_values(packed) * torch.repeat_interleave(qmm_wo.fp4_rows_scales(sc), 64 // sc.shape[1], 1)
        for what, n in (("decode route", 16), ("prefill tiles", 32)):
            y = qmm_wo.fp4_wo_matmul(eye[:n].contiguous(), packed, sc)
            want = w[:, :n].t().to(torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                bad = torch.nonzero(y != want)
                raise AssertionError(f"qmm_fp4_wo {fmt} ({what}): E2M1 x scale decode differs at {len(bad)} of "
                                     f"{want.numel()} (k, scale row) pairs, first {bad[0].tolist()}")
    log(json.dumps({"kernel": "qmm_fp4_wo", "check": "E2M1 decode: 16 codes x 254 e4m3 scales (NVFP4) and x 252 "
                    "exponents -126 .. 125 (MXFP4, bf16 subnormal products at -126) exact, decode route and prefill tiles"}))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def splits(N, O, K):  # the decode route's split over K (every format's rows pad K to 128 or less)
        return qmm.decode_splits(O, -(-K // 128) * 128, N, sms) if N <= 16 else None

    shapes: dict = {name: [] for name in qmm_wo.launches}
    for O, K, label in sz.qmm_shapes:
        for N in sz.qmm_rows:
            x = torch.randn((N, K), generator=g, device=dev).to(torch.bfloat16)
            for name, fmt, fn, plain, w, wbytes, lib in _wo_cases(torch, dev, g, O, K):
                out = fn(x, *w)
                torch.cuda.synchronize()
                ref32 = plain(x, *w, out_dtype=torch.float32)
                worst, err = _held(out, ref32)
                if not worst <= 1.0:
                    raise AssertionError(f"{name} {fmt} {label} N={N}: worst err/limit {worst} > 1 "
                                         f"(2^-8|ref| + 1e-3 rms(ref)), max abs err {err}")
                _same_again(torch, f"{name} {fmt} {label} N={N}", out, fn(x, *w))
                ms = timer(lambda: fn(x, *w), sz.reps)
                plain_ms = timer(lambda: plain(x, *w), 2)
                lib_ms = lib_rel = None
                if lib is not None:
                    # the library rounds (u - 8) * s to bf16 per weight, so it
                    # is held only as far as shows it is the same function: 1e-2
                    # of the output's scale (a wrong nibble order reads ~1)
                    call = lib()
                    lib_rel = _rel(call(x), ref32)
                    if not lib_rel <= 1e-2:
                        raise AssertionError(f"{name} {fmt} {label} N={N}: the library call is {lib_rel} of the "
                                             f"output's scale from the plain version: not the same function")
                    lib_ms = timer(lambda: call(x), sz.reps if N <= 16 or fmt.startswith("int4") else 2)
                    del call
                del ref32
                b_ms, b_by = bound(N * K * 2 + wbytes + N * O * 2, 2.0 * N * O * K, "bf16")
                shapes[name].append({"shape": f"{fmt} {label} N={N} O={O} K={K}", "max_abs_err": err,
                                     "worst_err_over_limit": worst, "splits": splits(N, O, K), "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "bound_share": b_ms / ms, "library_ms": lib_ms,
                                     "x_library": None if lib_ms is None else ms / lib_ms,
                                     "library_rel_err": lib_rel})
                log(json.dumps({"kernel": name, **shapes[name][-1]}))
                del out, w
            del x
    for name, sh in shapes.items():
        rows[name] = dict(sh[0], shapes=sh)


def _engine(torch, cm, max_seq: int, dev, plain: tuple = (), kv="int8", **fields):
    """The kernel-attention engine unless `fields` sets kv_attention_kernel=
    False (the einsum engine); `kv` "int8", "nvfp4" or None (the model's
    dtype, or packed NVFP4 where the preset quantizes the k_bmm site so);
    `fields` are further EngineConfig fields (layouts, paged_attention_kernel,
    attn_sparsity)."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import Engine, EngineConfig

    fields = {"kv_attention_kernel": True, **fields}
    return Engine(cm, EngineConfig(max_seq_len=max_seq, kv_dtype=torch.int8 if kv == "int8" else kv,
                                   plain_ops=plain, **fields), device=dev)


@dataclasses.dataclass(frozen=True)
class Path:
    """One served path of the engine: a PTQ config, the engine's layout
    fields, the depth of its full-width run, and its GEMM kernel."""

    label: str
    preset: str          # preset name; "" = weight-only INT8 (INT8_DEFAULT_CFG without input quantizers)
    gemm: str            # the path's GEMM kernel (a key of KERNELS)
    depth: int = 8       # layers of the full-width run (the model has 32: FULL_DEPTH)
    layouts: tuple = ()  # EngineConfig layout fields, as (name, value) pairs
    calib: bool = False  # the preset has static input quantizers: calibrate on one batch

    def quant_cfg(self):
        from tensorrt_model_optimizer_tpu_torch.quant import config

        if self.preset:
            return config.get_preset(self.preset)
        return config.INT8_DEFAULT_CFG.with_rules({"*input_quantizer": {"enable": False}})


# W4A8, INT4 and NVFP4 at FULL_DEPTH; the formats that share a kernel with
# them (MXFP4, and NVFP4 with its activation quantizers: dynamic block scales
# under a calibrated global amax, fake-quantized before the GEMM) or that
# move twice the weight bytes (INT8, FP8) on 4 layers, which launches every
# kernel at every full-width shape all the same. The anchor runs every path
# at its own depth (6 layers).
FULL_DEPTH = Path.depth
FULL_PATHS = (
    Path("w4a8", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", layouts=(("int4_layout", "a8"),)),
    Path("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    Path("nvfp4", "NVFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    Path("mxfp4", "MXFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo", depth=4),
    Path("int8", "", "qmm_byte_wo", depth=4),
    Path("fp8", "FP8_DEFAULT_CFG", "qmm_byte_wo", depth=4, calib=True),
    Path("nvfp4_w4a4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo", depth=4, calib=True),
)

# kernel name (KERNELS) -> the engine's `plain_ops` name
PLAIN_NAME = {"qmm_w4a8": "w4a8", "kv_decode_attention": "kv_attention", "flash_gqa": "flash",
              "qmm_int4_wo": "int4_wo", "qmm_fp4_wo": "fp4_wo", "qmm_byte_wo": "byte_wo",
              "paged_attention_decode": "paged_decode", "paged_attention_prefill_tc": "paged_prefill",
              "paged_attention_prefill_cuda_core": "paged_prefill",
              "skip_softmax_flash_tc": "skip_softmax", "skip_softmax_flash_cuda_core": "skip_softmax"}
PAGED_PLAIN = ("paged_decode", "paged_prefill")


def _counts(reset: bool = False) -> dict:
    """Launch counts of every kernel's wrapper; `reset` sets them to 0."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, paged_attention, qmm, qmm_wo
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention

    if reset:
        qmm.launches = kv_attention.launches = flash_gqa.launches = sparse_attention.launches = 0
        for counts in (qmm_wo.launches, paged_attention.launches, paged_attention.prefill_route_launches,
                       sparse_attention.route_launches):
            for k in counts:
                counts[k] = 0
    return {"qmm_w4a8": qmm.launches, "kv_decode_attention": kv_attention.launches,
            "flash_gqa": flash_gqa.launches, **qmm_wo.launches, **paged_attention.launches,
            **{PAGED_PREFILL_KERNELS[r]: n for r, n in paged_attention.prefill_route_launches.items()},
            **{SKIP_KERNELS[r]: n for r, n in sparse_attention.route_launches.items()}}


def _compressed(torch, path: Path, cfg, params, dev, seed: int):
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq

    batches = None
    if path.calib:
        g = torch.Generator(device=dev).manual_seed(seed)
        batches = [torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)]
    return compress.compress(ptq.quantize(cfg, params, path.quant_cfg(), batches, device=dev))


def _anchor_projections(torch, dev, path: Path, cm, g) -> float:
    """This path's GEMM kernel against its plain version at every projection
    shape of the checkpoint (hd 32, the ragged K = 704 of down_proj), decode
    and prefill rows, on random activations; the limit of `_held`. Returns
    the worst err/limit."""
    from tensorrt_model_optimizer_tpu_torch.models.llama import slice_state
    from tensorrt_model_optimizer_tpu_torch.quant.compress import convert_packed_layouts, layer_arrays
    from tensorrt_model_optimizer_tpu_torch.serve import engine

    layouts = dict(path.layouts)
    served = convert_packed_layouts(cm, nvfp4=layouts.get("nvfp4_layout", "word2"),
                                    int4=layouts.get("int4_layout", "bd2"), mxfp4=layouts.get("nvfp4_layout", "word2"))
    worst = 0.0
    for name, kind in served.kinds.items():
        arrays = layer_arrays(served.params["layers"][name], 0)
        ist = slice_state(served.qstate.get(name, {}).get("input"), 0)
        K = arrays.get("in_features") or arrays["q"].shape[-1]
        for n in (4, 128):
            x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
            if kind == "int4a8":
                x8 = torch.clamp(torch.round(x.float() * 40), -127, 127).to(torch.int8)
                args = (x8, arrays["packed"], arrays["scales"])
                out, ref = engine.qmm.w4a8_matmul(*args), engine.qmm.w4a8_matmul_plain(*args)
                ratio = 0.0 if torch.equal(out, ref) else float("inf")
            else:
                def run(ops, **kw):
                    return engine._qlinear(x, name, kind, arrays, served, ist,
                                           {k: (lambda *a, f=f: f(*a, **kw)) for k, f in ops.items()})
                out = run(engine._ops(()))
                ref = run(engine._ops(engine.PLAIN_ALL), out_dtype=torch.float32)
                ratio, _ = _held(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"anchor {path.label}: {name} ({kind}) N={n} K={K}: kernel against plain "
                                     f"version, worst err/limit {ratio}")
            worst = max(worst, ratio)
    return worst


def phase_anchor(torch, dev, sz: Sizes) -> dict:
    """The trained checkpoint through every path, kernels against plain
    versions: first each projection's GEMM alone at the checkpoint's shapes,
    then 4 prompts x 32 tokens and 16 greedy steps end to end.

    End to end the kernel engine picks each token and every engine is fed
    it, so all stay on one sequence and their logits are compared at every
    step. Kernel and plain GEMM round the same f32 sums, taken in another
    order, to bf16, so isolated outputs land one ulp apart; the int8 KV
    cache turns some of those into a flipped code (1/127 of the cache's
    range), which the layers carry on. How far that moves the logits is the
    model's property (at some positions of the anchor's data several tokens
    are about equally likely, and bf16 rounding alone moves the logits by
    much of their scale there), so the yardstick is measured, not assumed: a
    third engine runs the plain versions on f32 activations. Each engine's
    distance from it is taken per prompt and step (largest logit difference
    as a share of the f32 logits' largest magnitude); the median of the
    kernel engine's 64 distances may be at most twice the median of the plain
    bf16 engine's. That catches what the projection check cannot: a scale,
    a layer or a layout wired wrongly into the engine. The kernel engine is
    also held against the plain bf16 engine directly, activation quantizers
    on: the median of their 64 distances may be at most 1e-2 of the logits'
    scale (two bf16 ulps of the largest logit, and twice the largest median a
    right kernel reads here), and wherever their argmax differs, the kernel's
    token must lie within 1e-2 of the scale of the plain engine's best
    logit: a near tie, not another answer. W4A8, whose GEMM is bit-exact with
    its plain version, is held to equal tokens in free-running generation
    as before. Flash splits P exactly into three bf16 terms, so at this
    prefill's shape its outputs round like the plain version's up to f32
    summation order (the kernels phase holds the share an ulp apart to
    ULP_OFF_MAX): with two terms, an H100 run read an ulp carried through
    int8 codes into a W4A8 token that differed at a plain-logit margin of
    0.069.
    Returns the launch counts of the two CUDA-core routes it alone takes:
    skip-softmax's in the RULER curve, the paged prefill's in the f32 serve
    runs."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, device=dev)
    for path in FULL_PATHS:
        cm = _compressed(torch, path, cfg, params, dev, seed=3)
        layouts = dict(path.layouts)
        worst_proj = _anchor_projections(torch, dev, path, cm, g)
        cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
        engines = (_engine(torch, cm, 64, dev, **layouts), _engine(torch, cm, 64, dev, PLAIN_ALL, **layouts),
                   _engine(torch, cm32, 64, dev, PLAIN_ALL, **layouts))
        _counts(reset=True)
        steps = _lockstep(torch, engines, prompts, 16)
        launched = _counts()[path.gemm]
        gaps_kernel = [g for logits, _, truth in steps for g in _gaps(logits, truth)[0]]
        gaps_plain = [g for _, ref, truth in steps for g in _gaps(ref, truth)[0]]
        gap_kernel, gap_plain = statistics.median(gaps_kernel), statistics.median(gaps_plain)
        _hold_to_plain(torch, f"anchor {path.label}", engines[0], engines[1], prompts, steps, path.gemm == "qmm_w4a8",
                       {"phase": "anchor", "path": path.label, "prompts": list(prompts.shape), "new_tokens": 16,
                        "projections_worst_err_over_limit": worst_proj, "median_logits_gap_kernel_vs_f32": gap_kernel,
                        "median_logits_gap_plain_vs_f32": gap_plain, "worst_logits_gap_kernel_vs_f32": max(gaps_kernel),
                        "worst_logits_gap_plain_vs_f32": max(gaps_plain), "gemm_launches": launched})
        if not gap_kernel <= 2 * gap_plain:
            raise AssertionError(f"anchor {path.label}: the kernel engine's logits lie {gap_kernel} of their scale "
                                 f"(median) from the f32 plain engine's, the bf16 plain engine's {gap_plain}")
        if launched <= 0:
            raise AssertionError(f"anchor {path.label}: {path.gemm} never launched")
    f32_prefills = sum(_anchor_paged(torch, dev, cfg, params, path, kv) for path, kv in PAGED_PATHS)
    _anchor_einsum(torch, dev, cfg, params)
    return {**_anchor_ruler(torch, dev), "paged_attention_prefill_cuda_core": f32_prefills}


def _anchor_einsum(torch, dev, cfg, params) -> None:
    """The einsum engine (kv_attention_kernel=False) on the trained
    checkpoint, INT4 weights, int8 and packed NVFP4 caches: 4 prompts of 256
    tokens, dense prefill and sparse prefill (64-tiles, threshold 1e-2),
    then 8 greedy decode steps in lock step on the kernel engine's tokens,
    the kernel engine against the all-plain one.

    In bf16 the median logits gap is held to 1e-2 of the scale, and the
    dense prefill's argmax flips to a plain-logit margin <= 1e-2, as the
    other anchor paths. The sparse prefill's attention rounds its output to
    bf16 one ulp apart now and then, as flash does, and this checkpoint
    moves near-tied tokens by much of the logits' scale on that (an H100 run
    read a flip at a plain-logit margin of 0.028): there the flips are reported,
    and held on f32 activations, where the GEMMs run their plain versions
    in both engines and the skip-softmax kernel is the only difference:
    median gap <= 1e-3, every flip at a margin <= 1e-2. The keep fractions
    agree within 1e-3 (the projections' outputs may move a tile max across
    its limit); one skip-softmax launch a layer."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cm = _compressed(torch, FULL_PATHS[1], cfg, params, dev, seed=3)
    cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
    g = torch.Generator(device=dev).manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=dev)
    L = cfg.num_hidden_layers
    gemms_plain = tuple(n for n in PLAIN_ALL if n != "skip_softmax")

    def lockstep(ek, ep):
        ck, cp = ek.init_cache(4), ep.init_cache(4)
        _counts(reset=True)
        lk = ek.prefill(prompts, ck)
        launched = _counts()
        lp = ep.prefill(prompts, cp)
        gaps, flips = _gaps(lk, lp)
        tok = lk.argmax(dim=-1).to(torch.int32)[:, None]
        for _ in range(8):
            lk, lp = ek._model_step(tok, ck), ep._model_step(tok, cp)
            gp, fl = _gaps(lk, lp)
            gaps, flips = gaps + gp, flips + fl
            tok = lk.argmax(dim=-1).to(torch.int32)[:, None]
        keep = None if ek.last_prefill_keep_frac is None else [ek.last_prefill_keep_frac.tolist(),
                                                               ep.last_prefill_keep_frac.tolist()]
        return statistics.median(gaps), max(gaps), flips, keep, launched, ck["k"].shape[-1]

    for kv in ("int8", "nvfp4"):
        for th in (None, 1e-2):
            fields = dict(kv=kv, kv_attention_kernel=False, attn_sparsity=th, attn_sparsity_blocks=(64, 64))
            med, worst, flips, keep, launched, row_bytes = lockstep(
                _engine(torch, cm, 272, dev, **fields), _engine(torch, cm, 272, dev, PLAIN_ALL, **fields))
            row = {"phase": "anchor", "path": f"einsum engine, int4, {kv} cache, "
                   + ("dense prefill" if th is None else f"sparse prefill {th}"), "cache_row_bytes": row_bytes,
                   "prompts": [4, 256], "median_logits_gap_kernel_vs_plain": med,
                   "worst_logits_gap_kernel_vs_plain": worst, "argmax_flips_vs_plain": flips,
                   "keep_frac_kernel_plain": keep, "prefill_launches": {k: v for k, v in launched.items() if v}}
            keeps = [keep]
            if th is not None:  # f32 activations: the skip-softmax kernel is the only difference
                med32, worst32, flips32, keep32, launched32, _ = lockstep(
                    _engine(torch, cm32, 272, dev, gemms_plain, **fields),
                    _engine(torch, cm32, 272, dev, PLAIN_ALL, **fields))
                row.update(f32_median_logits_gap_kernel_vs_plain=med32, f32_worst_logits_gap=worst32,
                           f32_argmax_flips_vs_plain=flips32, f32_keep_frac_kernel_plain=keep32)
                keeps.append(keep32)
                if not (med32 <= 1e-3 and all(m <= 1e-2 for m in flips32)
                        and launched32["skip_softmax_flash_cuda_core"] == L and not launched32["skip_softmax_flash_tc"]):
                    raise AssertionError(f"anchor einsum {kv} {th} f32: median gap {med32}, flips {flips32}, "
                                         f"launches {launched32}")
            log(json.dumps(row))
            if not med <= 1e-2 or (th is None and any(not m <= 1e-2 for m in flips)):
                raise AssertionError(f"anchor einsum {kv} {th}: median gap {med}, flips {flips}")
            if not (launched["qmm_int4_wo"] and launched["skip_softmax_flash_tc"] == (0 if th is None else L)
                    and not launched["skip_softmax_flash_cuda_core"]):
                raise AssertionError(f"anchor einsum {kv} {th}: prefill launches {launched}")
            for kp in keeps:
                if kp and max(abs(a - b) for a, b in zip(*kp)) > 1e-3:
                    raise AssertionError(f"anchor einsum {kv} {th}: keep fractions kernel / plain {kp}")


RULER = dict(thresholds=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1), n=64, ctx_tokens=448, blocks=(64, 64),
             max_acc_drop=0.02, min_dense_acc=0.8, max_dppl=0.05)  # tools/ruler_curve.py's settings


def _anchor_ruler(torch, dev) -> dict:
    """The RULER threshold curve on `artifacts/anchor-ruler` (f32, as
    tools/ruler_curve.py loads it) at that tool's settings, through the
    skip-softmax kernel and through its plain version: rows held to agree
    (keep fractions within 1e-3, accuracies within 1/64), and printed beside
    `artifacts/ruler_curve.json`, which the JAX package made (accuracy, not
    speed). The curve runs on f32 activations, so through the CUDA-core
    route alone; returns its launch count of that route."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.quant.compress import compress_bf16
    from tensorrt_model_optimizer_tpu_torch.serve.engine import EngineConfig
    from tensorrt_model_optimizer_tpu_torch.sparsity import ruler
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    lang = synthlang.SynthLang(0)
    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR_RULER, dtype=torch.float32, device=dev)
    cm = compress_bf16(cfg, params)
    ev = list(lang.eval_batches(2, 8, RULER["ctx_tokens"], seed=991))
    out = {}
    for which, plain in (("kernel", ()), ("plain", ("skip_softmax",))):
        _counts(reset=True)
        t0 = time.perf_counter()
        th, rows = ruler.calibrate_threshold_ruler(cm, EngineConfig(max_seq_len=RULER["ctx_tokens"] + 16,
                                                                    plain_ops=plain),
                                                   lang, ppl_batches=ev, device=dev, **RULER)
        n = _counts()
        out[which] = dict(threshold=th, rows=rows, seconds=time.perf_counter() - t0,
                          launches=n["skip_softmax_flash_cuda_core"], tc_launches=n["skip_softmax_flash_tc"])
    with open(RULER_CURVE) as f:
        artifact = json.load(f)
    jax_rows = artifact["curve"]
    keys = ("threshold", "keep_frac", "acc_override", "acc_multikey", "acc_memory", "dppl")
    table = [{"kernel": {k: rk.get(k) for k in keys}, "plain": {k: rp.get(k) for k in keys},
              "jax_artifact": {k: rj.get(k) for k in keys}}
             for rk, rp, rj in zip(out["kernel"]["rows"], out["plain"]["rows"], jax_rows)]
    log(json.dumps({"phase": "anchor", "path": "RULER curve, anchor-ruler", **{k: v for k, v in RULER.items()},
                    "calibrated_threshold": {w: o["threshold"] for w, o in out.items()},
                    "jax_artifact_threshold": artifact["calibrated_threshold"], "seconds": {w: o["seconds"] for w, o in out.items()},
                    "skip_softmax_launches": out["kernel"]["launches"], "rows": table}))
    for row in table[1:]:
        a, b = row["kernel"], row["plain"]
        if abs(a["keep_frac"] - b["keep_frac"]) > 1e-3 or any(
                abs(a[f"acc_{k}"] - b[f"acc_{k}"]) > 1 / 64 + 1e-9 for k in ("override", "multikey", "memory")):
            raise AssertionError(f"anchor RULER: kernel and plain rows disagree at threshold {a['threshold']}: {row}")
    if not out["kernel"]["launches"] or out["kernel"]["tc_launches"]:
        raise AssertionError(f"anchor RULER: the f32 curve must run the CUDA-core route alone: {out['kernel']}")
    return {"skip_softmax_flash_cuda_core": out["kernel"]["launches"]}


PAGED_ANCHOR = dict(n_pages=64, page_size=8, max_slots=2, max_pages_per_seq=16)
PAGED_PATHS = (  # (path, EngineConfig.kv_dtype): int8 pages, and the packed NVFP4 pool NVFP4_KV_CFG selects
    (Path("int4 + int8 pages", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"), "int8"),
    (Path("nvfp4_kv (packed NVFP4 pages)", "NVFP4_KV_CFG", "qmm_fp4_wo", depth=4, calib=True), None),
)


def _gaps(logits, ref) -> tuple[list, list]:
    """Per row: the largest logit difference as a share of the reference's
    largest magnitude; and, where the argmax differs, how far below its best
    logit the reference holds the other's token (as a share of that scale)."""
    scale = ref.abs().max(dim=-1).values
    gaps = ((logits - ref).abs().max(dim=-1).values / scale).tolist()
    tok = logits.argmax(dim=-1)
    margin = (ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]) / scale
    return gaps, [float(m) for m in margin[tok != ref.argmax(dim=-1)]]


def _lockstep(torch, engines, prompts, steps: int) -> list:
    """The engines in lock step on the first one's greedy tokens: the
    prompts' prefill, then steps - 1 decode steps, every engine fed the
    token the first one picked. Returns each step's logits, a tuple of one
    [B, V] tensor an engine."""
    caches = [e.init_cache(prompts.shape[0]) for e in engines]
    out = [tuple(e.prefill(prompts, c) for e, c in zip(engines, caches))]
    for _ in range(steps - 1):
        tok = torch.argmax(out[-1][0], dim=-1).to(torch.int32)[:, None]
        out.append(tuple(e._model_step(tok, c) for e, c in zip(engines, caches)))
    return out


def _hold_to_plain(torch, label: str, kernel, plain, prompts, steps: list, exact: bool, row: dict) -> None:
    """The anchors' rule for a kernel engine against the all-plain one,
    over `_lockstep`'s logits (the kernel engine's first, the plain one's
    second): the median logits gap at most 1e-2 of their scale (two bf16
    ulps of the largest logit), every argmax flip at a plain-logit margin
    <= 1e-2 (a near tie, not another answer), and, where the GEMM is
    bit-exact with its plain version (`exact`: W4A8), free-running greedy
    tokens equal. Logs `row` with the readings before it raises."""
    gaps, flips = [], []
    for step, (lk, lp, *_) in enumerate(steps):
        gp, fl = _gaps(lk, lp)
        gaps += gp
        flips += [(step, m) for m in fl]
    free = kernel.generate(prompts, len(steps))
    same = bool(torch.equal(free, plain.generate(prompts, len(steps))))
    median = statistics.median(gaps)
    log(json.dumps({**row, "median_logits_gap_kernel_vs_plain": median, "worst_logits_gap_kernel_vs_plain": max(gaps),
                    "argmax_flips_vs_plain": flips, "free_running_tokens_equal_plain": same,
                    "tokens_row0": free[0].tolist()}))
    if not median <= 1e-2:
        raise AssertionError(f"{label}: the kernel engine's logits lie {median} of their scale (median) from the "
                             "plain engine's, the limit is 1e-2")
    far = [(step, m) for step, m in flips if not m <= 1e-2]
    if far:
        raise AssertionError(f"{label}: the kernel engine's token differs from the plain engine's away from a near "
                             f"tie (step, plain-logit margin as a share of the scale): {far}")
    if exact and not same:
        raise AssertionError(f"{label}: kernel-path tokens differ from plain")


def _dense_margins(torch, eng, prompt, served: list) -> list:
    """The dense-cache engine fed a request's served tokens: at every step,
    how far below its best logit it holds the served token (a share of the
    logits' scale; 0 where it is the engine's own greedy token)."""
    cache = eng.init_cache(1)
    logits = eng.prefill(prompt[None], cache)
    margins = []
    for t in served:
        margins.append(float((logits.max() - logits[0, t]) / logits.abs().max()))
        logits = eng._model_step(torch.tensor([[t]], dtype=torch.int32, device=prompt.device), cache)
    return margins


def _anchor_paged(torch, dev, cfg, params, path: Path, kv) -> None:
    """`Engine.serve` on the trained checkpoint over pages of 8 rows and 2
    slots, kernel engine against plain versions.

    In lock step: two engines (the paged and the dense decode attention on
    their kernels, or on their plain versions) fill the same slots. Slot 0
    prefills 40 tokens densely; slot 1 shares slot 0's two full prefix pages
    and streams its 72-token tail through `prefill_chunked` (one chunk of 64
    through the prefill kernel, 8 single tokens through the decode kernel);
    then 12 decode steps run both slots on the kernel engine's tokens. The
    logits are held as the weight-only GEMMs are above: kernel and plain
    version round the same f32 sums to bf16 one ulp apart now and then, the
    quantized pages turn some of those into a flipped code, so the median gap
    may be at most 1e-2 of the logits' scale and every argmax flip must lie at
    a plain-logit margin <= 1e-2.

    Then `serve` itself, with the prefix cache, unroll 1 and 4: 4 requests of
    unequal length behind a 16-token prefix. Request 0 outlives the others and
    keeps the prefix pages published, so requests 2 and 3 share them and
    prefill only their tails (72 tokens: through the prefill kernel). Every
    output has its length, the pool is whole again at the end, both prefill
    routes were taken and both paged kernels launched.

    Against `Engine.generate`: the dense-cache engine is fed each request's
    served tokens, and how far below its own best logit it holds each of them
    is the margin. In bf16 the margins are reported, not held: the paged path
    rounds q and the context to bf16 where the dense path keeps f32, and on
    this checkpoint bf16 rounding alone moves near-tied positions by much of
    the logits' scale. They are held on f32 activations, where the two paths
    differ only by f32 rounding and the codes it flips: a third engine runs
    the GEMMs and flash on their plain versions in f32 and the three KV
    attention kernels as kernels, and every token it serves must lie within
    1e-2 of the logits' scale of what it gives over its dense cache."""
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request

    cm = _compressed(torch, path, cfg, params, dev, seed=3)
    ek = _engine(torch, cm, 128, dev, kv=kv, paged_attention_kernel=True)
    ep = _engine(torch, cm, 128, dev, PAGED_PLAIN + ("kv_attention",), kv=kv, paged_attention_kernel=True)
    g = torch.Generator(device=dev).manual_seed(5)
    shared = torch.randint(0, cfg.vocab_size, (16,), generator=g, device=dev)
    prompts = [torch.cat([shared, torch.randint(0, cfg.vocab_size, (n,), generator=g, device=dev)])
               for n in (24, 40, 72, 9)]

    _counts(reset=True)
    table = torch.full((2, 16), -1, dtype=torch.int32, device=dev)
    table[0, :8] = torch.arange(1, 9)
    table[1, :2] = table[0, :2]
    table[1, 2:14] = torch.arange(20, 32)
    caches = [e.init_paged_cache(**PAGED_ANCHOR) for e in (ek, ep)]
    pairs = []
    for c in caches:
        c.block_table = table.clone()
    pairs.append([e.prefill_into_slot(c, 0, prompts[0][None]) for e, c in zip((ek, ep), caches)])
    for c in caches:
        c.seq_lens[1] = 16
    pairs.append([e.prefill_chunked(c, 1, prompts[2][None, 16:])[None] for e, c in zip((ek, ep), caches)])
    tok = torch.stack([pairs[0][0][0].argmax(), pairs[1][0][0].argmax()]).to(torch.int32)[:, None]
    active = torch.ones(2, dtype=torch.bool, device=dev)
    for _ in range(12):
        pairs.append([e.paged_step(tok, c, active) for e, c in zip((ek, ep), caches)])
        tok = pairs[-1][0].argmax(dim=-1).to(torch.int32)[:, None]
    gaps, flips = [], []
    for logits, ref in pairs:
        gp, fl = _gaps(logits, ref)
        gaps += gp
        flips += fl
    lock = _counts()
    packed = caches[0].packed_nvfp4
    if packed != (ek.ecfg.kv_dtype == "nvfp4"):
        raise AssertionError(f"anchor paged {path.label}: kv_dtype {ek.ecfg.kv_dtype!r}, packed pool {packed}")

    def requests():
        return [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (24, 6, 8, 8)))]

    cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
    e32 = _engine(torch, cm32, 128, dev, ("w4a8", "flash", "int4_wo", "fp4_wo", "byte_wo"), kv=kv,
                  paged_attention_kernel=True)
    served, f32_prefills = {}, 0
    for unroll in (1, 4):
        _counts(reset=True)
        reqs = requests()
        outs, m = ek.serve(reqs, prefix_cache=True, unroll=unroll, collect_metrics=True, **PAGED_ANCHOR)
        n = _counts()
        margins = [_dense_margins(torch, ek, p, outs[i]) for i, p in enumerate(prompts)]
        _counts(reset=True)
        outs32 = e32.serve(requests(), prefix_cache=True, unroll=unroll, **PAGED_ANCHOR)
        f32_prefills += _counts()["paged_attention_prefill_cuda_core"]
        margins32 = [_dense_margins(torch, e32, p, outs32[i]) for i, p in enumerate(prompts)]
        served[unroll] = dict(outs=outs, metrics=m, launches=n, margins=margins, margins32=margins32)
        if [len(outs[r.rid]) for r in reqs] != [r.max_new_tokens for r in reqs]:
            raise AssertionError(f"anchor paged {path.label}: output lengths {[len(v) for v in outs.values()]}")
        if not (m["dense_prefills"] and m["chunked_prefills"] and m["free_pages"] == PAGED_ANCHOR["n_pages"] - 1):
            raise AssertionError(f"anchor paged {path.label} unroll {unroll}: prefill routes or free pages: {m}")
        if not (n["paged_attention_decode"] and n["paged_attention_prefill"]):
            raise AssertionError(f"anchor paged {path.label} unroll {unroll}: paged kernels not launched: {n}")
    worst = max(max(mg) for sv in served.values() for mg in sv["margins32"])
    log(json.dumps({
        "phase": "anchor", "path": f"serve: {path.label}", "packed_nvfp4_pages": bool(packed),
        "lockstep_rows": len(gaps), "median_logits_gap_kernel_vs_plain": statistics.median(gaps),
        "worst_logits_gap_kernel_vs_plain": max(gaps), "argmax_flips_vs_plain": flips, "lockstep_launches": lock,
        "serve": {u: {"metrics": sv["metrics"], "launches": {k: v for k, v in sv["launches"].items() if v},
                      "tokens_off_the_dense_engines_greedy": sum(m > 0 for mg in sv["margins"] for m in mg),
                      "worst_margin": max(max(mg) for mg in sv["margins"]),
                      "f32_tokens_off_the_dense_engines_greedy": sum(m > 0 for mg in sv["margins32"] for m in mg),
                      "f32_worst_margin": max(max(mg) for mg in sv["margins32"])} for u, sv in served.items()},
        "unroll_4_tokens_equal_unroll_1": served[4]["outs"] == served[1]["outs"],
        "tokens_request0": served[1]["outs"][0]}))
    if not statistics.median(gaps) <= 1e-2:
        raise AssertionError(f"anchor paged {path.label}: kernel engine's logits lie {statistics.median(gaps)} of "
                             "their scale (median) from the plain engine's, the limit is 1e-2")
    if any(not m <= 1e-2 for m in flips):
        raise AssertionError(f"anchor paged {path.label}: argmax differs from the plain engine's away from a near "
                             f"tie (plain-logit margins {flips})")
    if not worst <= 1e-2:
        raise AssertionError(f"anchor paged {path.label}: on f32 activations a served token lies {worst} of the "
                             "logits' scale below the dense-cache engine's best")
    return f32_prefills


def _profile(torch, label: str, fn, calls: int, wall_ms_unprofiled: float) -> dict:
    """Device time by kernel over `calls` calls of the served path, and the
    device's idle share against the same calls' wall time measured without
    the profiler (its own host cost would inflate the idle share). Logs the
    row and returns it. Unless the run asks for `profile` (PROFILING), runs
    nothing and returns the row's device fields as None: the profiler's host
    cost, seconds a call, does not fit the default run's time."""
    if not PROFILING:
        return {"per_call_device_busy_ms": None, "per_call_kernel_launches": None, "device_idle_share": None,
                "top": [], "host_top": []}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3 / calls, e.count // calls)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.key.startswith("Command Buffer")),
                       key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    # where the host spends its time (with the profiler on, so inflated: a ranking, not a cost)
    by_op = sorted(((e.key, e.self_cpu_time_total / 1e3 / calls, e.count // calls) for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    row = {"phase": "profile", "what": label, "per_call_device_busy_ms": busy_ms,
           "per_call_kernel_launches": sum(n for _, _, n in by_kernel),
           "per_call_wall_ms_unprofiled": wall_ms_unprofiled,
           "device_idle_share": 1.0 - busy_ms / wall_ms_unprofiled,
           "top": [{"kernel": k[:70], "ms": ms, "count": n} for k, ms, n in by_kernel[:10]],
           "host_top": [{"op": k[:40], "self_cpu_ms": ms, "count": n} for k, ms, n in by_op[:8]]}
    log(json.dumps(row))
    return row


def _eager_step(torch, eng, tok, cache):
    """One greedy decode step launched kernel by kernel from the host (no
    graph): (next token [B, 1] int32, logits [B, V])."""
    logits = eng._model_step(tok, cache)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits


def _clone_cache(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def _same_cache(torch, a: dict, b: dict) -> bool:
    """Bit equality of two dense caches (one-byte forms compared as bytes)."""
    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t
    return set(a) == set(b) and all(torch.equal(bits(a[k]), bits(b[k])) for k in a)


GRAPH_UNROLLS = (1, 8)  # decode_step(unroll=...) as timed beside the eager step; 8 is bench.py's BENCH_UNROLL
GRAPH_CHECK_STEPS = 2 * max(GRAPH_UNROLLS)  # the fewest eager steps `_graphed_decode` holds a replay of each unroll to


def _graphed_decode(torch, eng, label: str, tok0, start: dict, eager_toks: list, eager_cache: dict,
                    eager_ms: float, profile_unrolls: bool = True, profile_eager: bool = True) -> dict:
    """The fused decode step against the eager one, from the cache state the
    eager loop started from: `decode_step(unroll=u)` for u in GRAPH_UNROLLS
    over the same len(eager_toks) steps, one CUDA-graph replay a call after
    the first (the capture). Raises unless the tokens it returns and the cache
    it leaves equal the eager loop's bit for bit. Each unroll's wall is read
    twice: with a sync after each call, and over the same number of calls
    back to back with one sync at the end (the host queues the next replay
    while the card runs one); where the check took one call (the capture),
    one more synced call gives the wall. Then the eager step and each
    unroll (unless `profile_unrolls` is False) under the profiler: device
    time, idle share and kernels a token step, beside the host launches a
    token step (eager: every kernel; a replay: the token's copy-in, the
    replay and the output's copy); `profile_eager=False` leaves the eager
    step's profile out (its device fields None). Raises unless every unroll
    gets at least two calls (GRAPH_CHECK_STEPS): the first call's tokens come
    from the warm-up run that precedes the capture, so only a later call
    holds a replay to the eager steps."""
    sync = torch.cuda.synchronize
    steps = len(eager_toks)
    short = [u for u in GRAPH_UNROLLS if steps // u < 2]
    if short:
        raise ValueError(f"{label}: {steps} eager steps leave unroll {short} no replay after its capture to hold")
    out = {"eager": {"wall_ms_per_token_step": eager_ms, "device_ms_per_token_step": None,
                     "device_idle_share": None, "kernels_per_token_step": None}}
    if profile_eager and PROFILING:
        c = _clone_cache(start)
        prof = _profile(torch, f"{label} decode step, eager",
                        lambda: [_eager_step(torch, eng, tok0, c) for _ in range(2)], 2, eager_ms)
        del c
        kernels = prof["per_call_kernel_launches"]
        out["eager"].update(device_ms_per_token_step=prof["per_call_device_busy_ms"],
                            device_idle_share=prof["device_idle_share"], kernels_per_token_step=kernels,
                            host_launches_per_token_step=kernels)
    for u in GRAPH_UNROLLS:
        cache, tok, walls, got = _clone_cache(start), tok0, [], []
        for _ in range(steps // u):
            t0 = time.perf_counter()
            tok, cache2 = eng.decode_step(tok, cache, unroll=u)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            got.append(tok)
        want = torch.cat(eager_toks, dim=1)[:, u - 1::u]
        if cache2 is not cache or not torch.equal(torch.cat(got, dim=1), want):
            raise AssertionError(f"{label}: decode_step(unroll={u}) tokens differ from the eager steps'")
        if not _same_cache(torch, cache, eager_cache):
            raise AssertionError(f"{label}: decode_step(unroll={u}) left another cache than the eager steps")
        wall = statistics.median(walls[1:]) / u
        ev = []
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            tok, _ = eng.decode_step(tok, cache, unroll=u)
            e.record()
            ev.append((s, e))
        sync()
        t0 = time.perf_counter()  # the same calls back to back, one sync at the end
        for _ in range(steps // u):
            tok, _ = eng.decode_step(tok, cache, unroll=u)
        sync()
        pipelined = (time.perf_counter() - t0) * 1e3 / (steps // u * u)
        out[f"unroll {u}"] = {
            "capture_call_ms": walls[0], "wall_ms_per_token_step": wall,
            "pipelined_wall_ms_per_token_step": pipelined,
            "event_ms_per_token_step": statistics.median(s.elapsed_time(e) for s, e in ev) / u,
            "host_launches_per_token_step": 3 / u, "tokens_equal_eager": True, "cache_equal_eager": True}
        if profile_unrolls and PROFILING:
            calls = 2 if u == 1 else 1
            prof = _profile(torch, f"{label} decode step, graph unroll {u}",
                            lambda: [eng.decode_step(tok, cache, unroll=u) for _ in range(calls)], calls, wall * u)
            out[f"unroll {u}"].update(device_ms_per_token_step=prof["per_call_device_busy_ms"] / u,
                                      device_idle_share=prof["device_idle_share"],
                                      kernels_per_token_step=prof["per_call_kernel_launches"] / u)
        del cache
    log(json.dumps({"phase": "full_graphs", "path": label, "steps": steps, **out}))
    return out


def phase_full(torch, dev, sz: Sizes, profile: bool = False) -> dict:
    """Every path of FULL_PATHS at full width; returns each kernel's launch
    count in the run of the first path that has it."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "full", "model": "llama3_8b", "init_params_s": time.perf_counter() - t0}))
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    launches: dict = {}
    for path in FULL_PATHS:
        for name, n in _full_path(torch, dev, sz, path, cfg, params, prompt, profile).items():
            if n > 0:
                launches.setdefault(name, n)
        torch.cuda.empty_cache()
    _full_nvfp4_kv(torch, dev, sz, cfg, params, profile)
    return launches


def _full_path(torch, dev, sz: Sizes, path: Path, cfg, params, prompt, profile: bool) -> dict:
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    sync = torch.cuda.synchronize
    layouts = dict(path.layouts)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_hidden_layers=path.depth)
    sub = {**params, "layers": {k: v[:path.depth] for k, v in params["layers"].items()}}
    eng = _engine(torch, _compressed(torch, path, cfg, sub, dev, seed=4), sz.max_seq, dev, **layouts)
    torch.cuda.empty_cache()
    sync()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    _counts(reset=True)
    cache = eng.init_cache(sz.batch)
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _counts()
    tok0 = tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    start = _clone_cache(cache)
    step_ms, toks = [], []
    for _ in range(sz.decode_steps):
        t0 = time.perf_counter()
        tok, step_logits = _eager_step(torch, eng, tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs = _graphed_decode(torch, eng, f"full {path.label}", tok0, start, toks, cache, statistics.median(step_ms))
    launches = _counts()
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    eng.release_graphs()
    del cache, start

    log(json.dumps({"phase": "full", "path": path.label, "model": "llama3_8b", "kinds": sorted(set(eng.cm.kinds.values())),
                    "layers": path.depth, "batch": sz.batch, "prompt": sz.prompt,
                    "decode_steps": sz.decode_steps, "setup_s": setup_s, "ttft_ms": ttft_ms,
                    "decode_ms_per_step_median": statistics.median(step_ms),
                    "decode_ms_per_step_mean": statistics.mean(step_ms),
                    "decode_tok_per_s": sz.batch * 1e3 / statistics.median(step_ms),
                    "peak_mem_gb": peak_gb, "launches": launches, "prefill_launches": prefill_launches,
                    "logits_finite": finite, "packed_weight_gb": eng.cm.packed_bytes / 1e9,
                    "graph_wall_ms_per_token_step": {k: v["wall_ms_per_token_step"] for k, v in graphs.items()}}))
    if not finite:
        raise AssertionError(f"full {path.label}: non-finite logits")
    want = {path.gemm, "kv_decode_attention", "flash_gqa"}
    if {k for k, n in launches.items() if n > 0} != want:
        raise AssertionError(f"full {path.label}: launched {launches}, the path's kernels are {sorted(want)}")
    if prefill_launches["flash_gqa"] != path.depth:
        raise AssertionError(f"full {path.label}: the prefill launched flash {prefill_launches['flash_gqa']} times "
                             f"over {path.depth} layers")
    if profile and path.depth == FULL_DEPTH:
        _profile(torch, f"{path.label} prefill", lambda: eng.prefill(prompt, eng.init_cache(sz.batch)), 1, ttft_ms)
        pc = eng.init_cache(sz.batch)
        eng.prefill(prompt, pc)
        t = torch.zeros((sz.batch, 1), dtype=torch.int32, device=dev)
        _profile(torch, f"{path.label} decode step", lambda: [eng._model_step(t, pc) for _ in range(4)], 4,
                 statistics.median(step_ms))
        del pc

    # The prefill logits against the same engine with this path's GEMM on
    # its plain version, at depths 1 and 2 (the plain versions are slow; W4A8
    # at 1, 2, 4 and 8, all FULL_DEPTH layers). The logits are bf16 values,
    # so one ulp is 2^-8 (0.4%) of the largest. Held to 5e-2 of the logits' scale at
    # depth 2, for every path:
    # - The weight-only GEMMs write bf16; kernel and plain version round the
    #   same f32 sum, taken in another order, so a few outputs in a thousand
    #   land one bf16 ulp apart. Each layer re-quantizes k and v to int8
    #   codes, where such an ulp can move a code across a rounding boundary
    #   (a step of 1/127 of the range), and random (untrained) layers
    #   amplify each flipped code with depth.
    # - W4A8 is bit-exact with its plain version, so its engine is held
    #   against the all-plain one, and an engine that runs only flash on its
    #   plain version must equal the all-plain one exactly: that shows the
    #   whole gap comes from flash, whose outputs may round one bf16 ulp
    #   apart and flip codes of the per-token int8 activations the same way.
    # - A path whose preset fake-quantizes the activations (FP8_DEFAULT_CFG:
    #   e4m3, a step of up to 2^-3 of the value; NVFP4_DEFAULT_CFG: e2m1, a
    #   step of up to a third of the value) is held with those input
    #   quantizers switched off, which is the check of its GEMM; the reading
    #   with them on is reported beside it, not held: there one flipped
    #   activation code moves a value by 12.5% or more.
    w4a8 = path.gemm == "qmm_w4a8"
    for depth in ((1, 2, 4, 8) if w4a8 else (1, 2)):
        subcm = _truncate(eng.cm, depth)
        plain_gemm = PLAIN_ALL if w4a8 else (PLAIN_NAME[path.gemm],)

        def run(plain, cm=subcm):
            return _engine(torch, cm, sz.max_seq, dev, plain, **layouts).prefill(prompt, _cache(eng, depth, sz))

        row = {"phase": "full_vs_plain", "path": path.label, "depth": depth}
        if path.calib:
            row["with_input_quantizers_rel_err"] = _rel(run(()), run(plain_gemm))
            subcm = _without_input_quantizers(subcm)
        out, ref = run((), subcm), run(plain_gemm, subcm)
        rel = _rel(out, ref)
        row.update(prefill_logits_rel_err=rel,
                   argmax_agree=float((out.argmax(-1) == ref.argmax(-1)).float().mean()))
        if w4a8:
            flash_plain = run(("flash",))
            row.update(flash_plain_equals_plain=bool(torch.equal(flash_plain, ref)),
                       flash_plain_rel_err=_rel(flash_plain, ref))
            del flash_plain
        log(json.dumps(row))
        if w4a8 and not row["flash_plain_equals_plain"]:
            raise AssertionError(f"full w4a8: depth {depth}: with only flash plain, the logits differ from plain")
        if depth == 2 and not rel <= 5e-2:
            raise AssertionError(f"full {path.label}: depth-2 prefill logits rel err {rel} vs plain > 5e-2")
        del out, ref, subcm
    if path.label == "int4":
        # the INT4 model again, served through `Engine.serve` over int8 pages
        # (all layers), and by the einsum engine with dense and sparse prefill
        # (FULL_EINSUM_DEPTH layers)
        for name, n in _full_paged(torch, dev, sz, eng.cm, PAGED_PATHS[0][0].label, "int8", PagedRun(), profile).items():
            launches[name] = launches[name] or n
        for name, n in _full_einsum(torch, dev, sz, _truncate(eng.cm, FULL_EINSUM_DEPTH), prompt, profile).items():
            launches[name] = launches[name] or n
    return launches


def _recording(op, keeps: list):
    """The kernel engine's skip-softmax op, also appending each call's (one a
    layer) keep map [bh, nq, nk]."""
    def call(q, k, v, th, block_q, block_k, causal):
        out, keep = op(q, k, v, th, block_q, block_k, causal)
        keeps.append(keep)
        return out, keep

    return call


def _pinned_plain(torch, keeps: list, decided: list):
    """The plain engine's skip-softmax op at depth 2: the plain version's
    arithmetic (f32 scores, softmax over the kept entries, the result in the
    input dtype) on the keep map the kernel engine took in the same layer,
    `keeps[i]` at the i-th call. It appends the decisions the plain version
    takes on its own inputs, with each tile's scaled max and margin from its
    limit."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention as ssa

    def call(q, k, v, th, block_q, block_k, causal):
        keep = keeps[len(decided)]
        BH, S, d = q.shape
        bq, bk = ssa.tile_sizes(S, block_q, block_k)
        bm = ssa.block_max(q, k, bq, bk, causal)
        own, margin = ssa.tile_decisions(bm, ssa.log_threshold(th), bq, bk, causal)
        decided.append((own, bm, margin))
        scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32, device=q.device)
        above = torch.arange(S, device=q.device)[None, :] > torch.arange(S, device=q.device)[:, None]
        out = torch.empty_like(q)
        for b in range(0, BH, 16):
            s = torch.einsum("bqd,bkd->bqk", q[b:b + 16].float(), k[b:b + 16].float()) * scale
            kf = keep[b:b + 16, :, None, :, None].bool().expand(-1, S // bq, bq, S // bk, bk).reshape(s.shape)
            s = torch.where(kf & ~above if causal else kf, s, torch.full_like(s, -1e30))
            pr = torch.softmax(s, dim=-1)
            pr = torch.where(s > -1e29, pr, torch.zeros_like(pr))
            out[b:b + 16] = torch.einsum("bqk,bkd->bqd", pr, v[b:b + 16].float()).to(q.dtype)
        return out, keep

    return call


APART_MARGIN_MAX = 2.0 ** -5  # of the tile max: how near its limit a tile decided apart must lie


def _decided_apart(keeps: list, decided: list, exact: bool) -> dict:
    """Tiles the kernel engine decided otherwise than the plain version does
    on the plain engine's own inputs, per layer. From layer 2 on (and in
    layer 1 through the GEMM) the two engines' inputs differ by bf16 ulps, so
    a tile whose max lies that close to its limit (log 0.98 = -0.02 below
    the running max at the calibrated threshold: many on random weights)
    may be decided apart; each must lie within APART_MARGIN_MAX of its tile
    max from the limit. `exact` (threshold 1e-30, every causal tile kept):
    none may."""
    counts, apart_margins = [], []
    for layer, (keep, (own, bm, margin)) in enumerate(zip(keeps, decided)):
        apart = keep.bool() != own
        counts.append(int(apart.sum()))
        apart_margins += [(layer, m, t) for m, t in zip(margin[apart].tolist(), bm[apart].tolist())]
    facts = {"tiles_apart_per_layer": counts, "apart_margin_over_tile_max_max":
             max((abs(m) / max(abs(t), 1e-30) for _, m, t in apart_margins), default=0.0),
             "apart_margins": apart_margins[:8]}
    if exact and sum(counts):
        raise AssertionError(f"full einsum: depth-2 keep maps at threshold 1e-30 differ: {facts}")
    far = [m for m in apart_margins if not abs(m[1]) <= APART_MARGIN_MAX * abs(m[2])]
    if far:
        raise AssertionError(f"full einsum: depth-2 tiles decided apart away from their limit (layer, margin, tile "
                             f"max): {far[:8]} ({facts})")
    return facts


# the einsum engine's full-width run: 8 of the 8B's 32 layers (the default
# run's time)
FULL_EINSUM_DEPTH = 8


def _full_einsum(torch, dev, sz: Sizes, cm, prompt, profile: bool) -> dict:
    """The einsum engine (kv_attention_kernel=False) on the INT4 model at full
    width (the layers of `cm`), int8 cache of prompt + decode rows: batch 8 x 2048
    prefill dense, sparse at the threshold `calibrate_threshold` gives for a
    0.4 block sparsity on the prompt's embeddings (as
    tools/bench_sparse_prefill.py does) and at 0.999999; each layer's keep
    fraction, the logits against dense, 32 greedy decode steps on the einsum
    cache, peak memory and launches. At depth 2 the kernel engine is held
    against the plain one (the GEMM and the skip-softmax kernel on their plain
    versions): logits within 5e-2 of their scale, as the other paths, dense
    and sparse at 1e-30 and at the calibrated threshold. Sparse, the plain
    engine's skip-softmax takes the kernel engine's keep map of each layer
    (`_pinned_plain`), so both compute one function, and the kernel's
    decisions are held against the plain version's on the plain engine's
    inputs (`_decided_apart`)."""
    from tensorrt_model_optimizer_tpu_torch.sparsity.attention_sparsity import calibrate_threshold

    sync = torch.cuda.synchronize
    L = cm.model_cfg.num_hidden_layers
    max_seq = sz.prompt + sz.decode_steps
    x = cm.params["embed_tokens"][prompt[:1, :512]].float()[:, :, None, :]
    calibrated = calibrate_threshold(x, x, x, 0.4)
    del x
    runs, launches, dense_logits = [], {}, None
    for th in (None, calibrated, 0.999999):
        eng = _engine(torch, cm, max_seq, dev, kv_attention_kernel=False, attn_sparsity=th)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = eng.init_cache(sz.batch)
        _counts(reset=True)
        sync()
        t0 = time.perf_counter()
        logits = eng.prefill(prompt, cache)
        sync()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        n = _counts()
        for name, c in n.items():
            if c:
                launches.setdefault(name, c)
        row = {"phase": "full", "path": "einsum engine, int4, int8 cache",
               "prefill": "dense" if th is None else "sparse", "threshold": th, "layers": L, "batch": sz.batch,
               "prompt": sz.prompt, "ttft_ms": ttft_ms, "prefill_launches": {k: v for k, v in n.items() if v},
               "logits_finite": bool(torch.isfinite(logits).all())}
        if th is None:
            dense_logits = logits
            tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            step_ms = []
            for _ in range(sz.decode_steps):
                t0 = time.perf_counter()
                tok, step_logits = _eager_step(torch, eng, tok, cache)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            row.update(decode_steps=sz.decode_steps, decode_ms_per_step_median=statistics.median(step_ms),
                       decode_steps_finite=bool(torch.isfinite(step_logits).all()))
        else:
            a, b = logits.double().flatten(), dense_logits.double().flatten()
            row.update(keep_frac_per_layer=eng.last_prefill_keep_frac.tolist(),
                       logits_corr_vs_dense=float(torch.corrcoef(torch.stack([a, b]))[0, 1]),
                       logits_largest_gap_vs_dense=_rel(logits, dense_logits),
                       argmax_agree_vs_dense=float((logits.argmax(-1) == dense_logits.argmax(-1)).float().mean()))
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(json.dumps(row))
        runs.append(row)
        if not (row["logits_finite"] and row.get("decode_steps_finite", True)):
            raise AssertionError(f"full einsum {th}: non-finite logits")
        if (n["skip_softmax_flash_tc"] != (0 if th is None else L) or n["skip_softmax_flash_cuda_core"]
                or not n["qmm_int4_wo"]):
            raise AssertionError(f"full einsum {th}: prefill launches {n}")
        if profile:
            _profile(torch, f"einsum {'dense' if th is None else 'sparse'} prefill {th}",
                     lambda e=eng: e.prefill(prompt, e.init_cache(sz.batch)), 1, ttft_ms)
            if th is None:
                pc = eng.init_cache(sz.batch)
                eng.prefill(prompt, pc)
                _profile(torch, "einsum decode step", lambda e=eng: [e._model_step(tok, pc) for _ in range(2)],
                         2, statistics.median(step_ms))
                del pc
        del eng, cache, logits

    # depth 2: kernel engine against its plain versions, dense and sparse
    # prefill; sparse, the kernel engine's keep maps pin the plain engine's
    sub = _truncate(cm, 2)
    for th in (None, 1e-30, calibrated):
        fields = dict(kv_attention_kernel=False, attn_sparsity=th)
        out = _engine(torch, sub, max_seq, dev, **fields)
        ref = _engine(torch, sub, max_seq, dev, ("int4_wo", "skip_softmax"), **fields)
        keeps, decided = [], []
        if th is not None:
            out._ops["skip_softmax"] = _recording(out._ops["skip_softmax"], keeps)
            ref._ops["skip_softmax"] = _pinned_plain(torch, keeps, decided)
        lo = out.prefill(prompt, out.init_cache(sz.batch))
        lr = ref.prefill(prompt, ref.init_cache(sz.batch))
        rel = _rel(lo, lr)
        row = {"phase": "full_vs_plain", "path": "einsum engine, int4, int8 cache", "depth": 2, "threshold": th,
               "prefill_logits_rel_err": rel, "argmax_agree": float((lo.argmax(-1) == lr.argmax(-1)).float().mean())}
        if th is not None:
            row.update(_decided_apart(keeps, decided, exact=th == 1e-30))
        log(json.dumps(row))
        if not rel <= 5e-2:
            raise AssertionError(f"full einsum: depth-2 prefill logits rel err {rel} vs plain > 5e-2 (threshold {th})")
        del out, ref, lo, lr, keeps, decided
    return launches


@dataclasses.dataclass(frozen=True)
class PagedRun:
    """A request list for `Engine.serve` and its pool: `requests` prompts of
    `prompt` tokens that share their first `shared`; `new_tokens` each, but
    `short_new` for requests 1 .. `short`: those retire early, and the
    requests admitted into their slots find request 0's prefix pages still
    published, share them and prefill only their tails (`prefill_chunked`).
    With equal lengths all slots retire in one step, the prefix pages are
    freed before the next admissions, and no request ever shares a page."""

    requests: int = 12
    prompt: int = 1024
    shared: int = 256
    new_tokens: int = 32
    short: int = 4
    short_new: int = 16
    slots: int = 8
    unroll: int = 4

    def geometry(self, page: int) -> dict:
        need = (self.prompt + self.new_tokens) // page + 2
        return dict(n_pages=self.slots * need + 8, page_size=page, max_slots=self.slots, max_pages_per_seq=need + 1)

    def make(self, torch, dev, vocab: int, seed: int):
        from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request

        g = torch.Generator(device=dev).manual_seed(seed)
        shared = torch.randint(0, vocab, (self.shared,), generator=g, device=dev)
        prompts = [torch.cat([shared, torch.randint(0, vocab, (self.prompt - self.shared,), generator=g, device=dev)])
                   for _ in range(self.requests)]
        new = [self.short_new if 1 <= i <= self.short else self.new_tokens for i in range(self.requests)]
        return prompts, lambda: [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                                 for i, (p, n) in enumerate(zip(prompts, new))]


def _scheduler_replay(reqs, geom: dict, unroll: int) -> dict:
    """What the scheduler's bookkeeping alone gives for a request list: the
    loop of `Engine.serve` with made-up tokens and no model (no request has an
    EOS token, so the tokens' values decide nothing)."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch.serve.paged_cache import init_paged
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Scheduler

    sched = Scheduler(geom["max_slots"], geom["n_pages"], geom["page_size"], geom["max_pages_per_seq"],
                      prefix_cache=True)
    cache = init_paged(0, geom["n_pages"], geom["page_size"], 1, 16, geom["max_slots"], geom["max_pages_per_seq"])
    for r in reqs:
        sched.submit(r)
    out = dict(dense_prefills=0, chunked_prefills=0, decode_dispatches=0)
    while sched.has_work:
        cache, admissions = sched.admit(cache)
        for slot, req in admissions:
            out["chunked_prefills" if int(cache.seq_lens[slot]) > 0 else "dense_prefills"] += 1
            sched.register_prefix(slot)
            req.output.append(0)
            req.done = len(req.output) >= req.max_new_tokens
        if sched.active_mask().any():
            sched.record_token_block(np.zeros((geom["max_slots"], unroll), np.int64))
            out["decode_dispatches"] += 1
        sched.retire(cache)
    return dict(out, free_pages=len(sched.free_pages))


def _paged_probe(torch, eng, geom: dict, prompts: list, shared: int, tok=None):
    """Fill one slot per prompt by hand: all but the last prefill densely
    (`prefill_into_slot`); the last shares slot 0's `shared` prefix rows and
    streams its tail through `prefill_chunked`; then one decode step over all
    slots. Returns the pool, [slot 0's prefill logits, the chunked prefill's
    logits, the decode step's logits], and the step's tokens and mask."""
    dev, n, per = prompts[0].device, len(prompts), geom["max_pages_per_seq"] - 1
    cache = eng.init_paged_cache(**geom)
    table = torch.full((geom["max_slots"], per + 1), -1, dtype=torch.int32, device=dev)
    table[:n, :per] = (1 + torch.arange(n * per, device=dev)).reshape(n, per)
    table[n - 1, :shared // geom["page_size"]] = table[0, :shared // geom["page_size"]]
    cache.block_table = table
    logits = [eng.prefill_into_slot(cache, b, p[None]) for b, p in enumerate(prompts[:-1])][:1]
    cache.seq_lens[n - 1] = shared
    logits.append(eng.prefill_chunked(cache, n - 1, prompts[-1][None, shared:])[None])
    active = torch.zeros(geom["max_slots"], dtype=torch.bool, device=dev)
    active[:n] = True
    if tok is None:
        tok = torch.zeros((geom["max_slots"], 1), dtype=torch.int32, device=dev)
        tok[0], tok[n - 1] = logits[0][0].argmax(), logits[1][0].argmax()
    logits.append(eng.paged_step(tok, cache, active))
    return cache, logits, tok, active


def _full_paged(torch, dev, sz: Sizes, cm, label: str, kv, run: PagedRun, profile: bool,
                act_quantizers: bool = False) -> dict:
    """`Engine.serve` at full width over the paged pool: the request list of
    `run` through the kernel engine, its metrics held against the scheduler's
    own bookkeeping; then the paths of the run by hand (`_paged_probe`), at
    full depth for finite logits and step times, and on the first 2 layers
    against the engine that runs the paged kernels' plain versions."""
    sync = torch.cuda.synchronize
    cfg = cm.model_cfg
    geom = run.geometry(sz.page)
    max_seq = run.prompt + run.new_tokens + 16
    fields = dict(kv=kv, paged_attention_kernel=True)
    eng = _engine(torch, cm, max_seq, dev, **fields)
    prompts, requests = run.make(torch, dev, cfg.vocab_size, seed=6)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    reqs = requests()
    outs, m = eng.serve(reqs, prefix_cache=True, unroll=run.unroll, collect_metrics=True, **geom)
    sync()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eng.release_graphs()
    # the same requests with every decode step launched eagerly: the graphed
    # serve (one replay per unroll block) must serve the same tokens
    eager = _engine(torch, cm, max_seq, dev, **fields)
    eager._eager = True
    outs_eager, m_eager = eager.serve(requests(), prefix_cache=True, unroll=run.unroll, collect_metrics=True, **geom)
    sync()
    del eager
    if outs != outs_eager:
        raise AssertionError(f"full serve {label}: the graphed serve's tokens differ from the eager serve's")
    want = _scheduler_replay(requests(), geom, run.unroll)
    lengths_ok = all(len(outs[r.rid]) == r.max_new_tokens for r in reqs)
    tokens_ok = all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)

    # the run's paths by hand, every slot filled as in the run's first wave
    cache, logits, tok, active = _paged_probe(torch, eng, geom, prompts[:run.slots], run.shared)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    chunk_toks = torch.zeros((run.slots, sz.chunk), dtype=torch.int64, device=dev)
    idle = ~active  # a chunk step as `prefill_chunked` runs it: all slots computed, none of the live ones writes
    dense = eng.init_cache(run.slots, max_seq)
    eng.prefill(torch.stack(prompts[:run.slots]), dense)

    def dense_step():  # the dense-cache step over the same rows, for what the paged step adds
        dense["pos"].fill_(run.prompt)
        eng._model_step(tok, dense)

    # the host's cost of a step depends on what the process ran before it, so
    # the decode step is read before and after the chunk steps
    steps = {"decode step": lambda: eng.paged_step(tok, cache, idle), "dense decode step": dense_step,
             "chunk step": lambda: eng.paged_step(chunk_toks, cache, idle),
             "decode step after chunk steps": lambda: eng.paged_step(tok, cache, idle)}
    wall = {}
    for what, fn in steps.items():
        fn()
        sync()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        wall[what] = statistics.median(times)
    del dense
    log(json.dumps({"phase": "full", "path": f"serve: {label}", "model": "llama3_8b", "layers": cfg.num_hidden_layers,
                    "kv_dtype": str(eng.ecfg.kv_dtype), "packed_nvfp4_pages": cache.packed_nvfp4,
                    "requests": run.requests, "prompt": run.prompt, "shared_prefix": run.shared,
                    "new_tokens": [r.max_new_tokens for r in reqs], **geom, "prefix_cache": True,
                    "metrics": m, "metrics_eager_steps": m_eager, "served_tokens_equal_eager": True,
                    "scheduler_replay": want, "launches": {k: v for k, v in launches.items() if v},
                    "peak_mem_gb": peak_gb, "output_lengths_ok": lengths_ok, "tokens_in_vocab": tokens_ok,
                    "probe_logits_finite": finite, "step_wall_ms": wall,
                    "page_pool_gb": sum(t.numel() * t.element_size() for t in (
                        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales) if t is not None) / 1e9}))
    if not (lengths_ok and tokens_ok and finite):
        raise AssertionError(f"full serve {label}: output lengths, token range or finite logits failed")
    if not (m["dense_prefills"] and m["chunked_prefills"]):
        raise AssertionError(f"full serve {label}: a prefill route was never taken: {m}")
    if {k: m[k] for k in want} != want:
        raise AssertionError(f"full serve {label}: the run's metrics {m} differ from the scheduler's bookkeeping {want}")
    if not (launches["paged_attention_decode"] and launches["paged_attention_prefill"] and launches["flash_gqa"]):
        raise AssertionError(f"full serve {label}: kernels of the path never launched: {launches}")
    if launches["paged_attention_prefill_tc"] != launches["paged_attention_prefill"]:
        raise AssertionError(f"full serve {label}: {launches['paged_attention_prefill_cuda_core']} of its "
                             f"{launches['paged_attention_prefill']} chunk prefills left the tensor-core route")
    if cache.packed_nvfp4 != (eng.ecfg.kv_dtype == "nvfp4"):
        raise AssertionError(f"full serve {label}: kv_dtype {eng.ecfg.kv_dtype!r}, packed pool {cache.packed_nvfp4}")
    if profile:
        for what in ("chunk step", "decode step"):
            _profile(torch, f"serve: {label} paged {what}", lambda fn=steps[what]: [fn() for _ in range(2)], 2,
                     wall[what])
    del cache, logits

    # First 2 layers, kernel engine against the engine with the two paged
    # kernels on their plain versions: slot 0's dense prefill (the same
    # kernels in both, so equal), the chunked prefill over shared prefix
    # pages (the prefill kernel, and the decode kernel for the tail's
    # remainder) and a decode step (the decode kernel), each held to the 5e-2
    # of the logits' scale that the dense paths above are held to: kernel and
    # plain version round the same f32 result to bf16, an ulp apart now and
    # then, and quantized pages and random layers amplify that. A preset that
    # fake-quantizes the activations (`act_quantizers`: NVFP4_KV_CFG's e2m1
    # input quantizers, a step of up to a third of a value, the first of them
    # on the attention's own output) is held with those quantizers off, as the
    # dense paths above are; the reading with them on is reported beside it.
    def depth2(sub):
        _, got, tok2, _ = _paged_probe(torch, _engine(torch, sub, max_seq, dev, **fields), geom, prompts[:2],
                                       run.shared)
        _, ref, _, _ = _paged_probe(torch, _engine(torch, sub, max_seq, dev, PAGED_PLAIN, **fields), geom,
                                    prompts[:2], run.shared, tok2)
        return {what: _rel(a, b) for what, a, b in zip(("dense_prefill", "chunked_prefill", "decode_step"), got, ref)}

    sub = _truncate(cm, 2)
    row = {"phase": "full_vs_plain", "path": f"serve: {label}", "depth": 2}
    if act_quantizers:
        row["with_input_quantizers"] = depth2(sub)
        sub = _without_input_quantizers(sub)
    rels = depth2(sub)
    log(json.dumps({**row, **rels}))
    if not all(r <= 5e-2 for r in rels.values()):
        raise AssertionError(f"full serve {label}: depth-2 logits rel err vs the plain paged versions {rels} > 5e-2")
    return launches


def _full_nvfp4_kv(torch, dev, sz: Sizes, cfg, params, profile: bool) -> None:
    """NVFP4_KV_CFG on the first 4 layers at full width: a shorter paged run
    over the packed NVFP4 pool, and generation over the dense NVFP4 KV cache
    at batch 8 x 2048 (the `nvfp4` format of all three attention kernels)."""
    path = PAGED_PATHS[1][0]
    cfg = dataclasses.replace(cfg, num_hidden_layers=path.depth)
    sub = {**params, "layers": {k: v[:path.depth] for k, v in params["layers"].items()}}
    cm = _compressed(torch, path, cfg, sub, dev, seed=4)
    _full_paged(torch, dev, sz, cm, path.label, None,
                PagedRun(requests=6, prompt=512, shared=256, new_tokens=16, short=2, short_new=8, slots=4), profile,
                act_quantizers=True)
    eng = _engine(torch, cm, sz.max_seq, dev, kv=None)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    _counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    cache = eng.init_cache(sz.batch)
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
    step_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        tok, step_logits = _eager_step(torch, eng, tok, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    dense = _counts()
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    log(json.dumps({"phase": "full", "path": "dense NVFP4 KV cache (NVFP4_KV_CFG)", "layers": path.depth,
                    "batch": sz.batch, "prompt": sz.prompt, "decode_steps": 8, "kv_dtype": str(eng.ecfg.kv_dtype),
                    "cache_bytes_per_row": cache["k"].shape[-1] + cache["ks"].shape[-1], "ttft_ms": ttft_ms,
                    "decode_ms_per_step_median": statistics.median(step_ms),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: v for k, v in dense.items() if v}, "logits_finite": finite}))
    if not (finite and eng.ecfg.kv_dtype == "nvfp4" and dense["kv_decode_attention"] == 8 * path.depth):
        raise AssertionError(f"full dense NVFP4 KV: finite {finite}, kv_dtype {eng.ecfg.kv_dtype}, launches {dense}")


def _truncate(cm, depth: int):
    """The first `depth` layers of a compressed model (views, no copies)."""
    layers = {k: ({n: (a[:depth] if hasattr(a, "shape") else a) for n, a in v.items()}
                  if isinstance(v, dict) else v[:depth]) for k, v in cm.params["layers"].items()}
    return dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, num_hidden_layers=depth),
                               params={**cm.params, "layers": layers})


def _without_input_quantizers(cm):
    """The same compressed model with every `.input` site disabled."""
    from tensorrt_model_optimizer_tpu_torch.models.llama import QuantLayout
    from tensorrt_model_optimizer_tpu_torch.quant.quantizer import DISABLED

    sites = tuple((k, DISABLED if k.endswith(".input") else v) for k, v in cm.layout.sites)
    return dataclasses.replace(cm, layout=QuantLayout(sites=sites))


def _cache(eng, depth: int, sz: Sizes) -> dict:
    c = eng.init_cache(sz.batch)
    return {"k": c["k"][:depth], "v": c["v"][:depth], "pos": c["pos"]}


# The deploy loop at full width: the headline W4A8 configuration (INT4 weights
# served as W4A8, int8 KV, kernel attention) and NVFP4 weight-only, on the
# first 4 layers (every tensor shape of the 32-layer model; ~2.6 GB written
# and read in each run against ~5.6 GB at 32)
DEPLOY_PATHS = (FULL_PATHS[0], FULL_PATHS[2])
DEPLOY_DEPTH = 4
DEPLOY_SHARD_BYTES = 1 << 30
DEPLOY_GAP_MAX = 1e-2  # median logits gap, loaded against in-memory engine, as a share of the logits' scale


def _int4_codes(torch, packed):
    """Plane-packed int4 [L, O/2, K] -> signed codes [L, O, K]."""
    c = torch.cat([packed & 0xF, (packed >> 4) & 0xF], dim=-2).to(torch.int16)
    return torch.where(c >= 8, c - 16, c)


def _deploy_packs(torch, cm, loaded) -> dict:
    """The loaded canonical packs against `compress`'s, per projection
    array: "equal", or the named difference. A scale the export computes
    another way than `compress` may lie one f32 ulp apart, and then a value
    on a rounding tie under one of the two scales quantizes one step apart:
    INT4's block scale is amax * f32(1/7) in the export (XLA's rewrite of
    the reference's amax / 7) where `compress` divides (on the CPU; a CUDA
    division by a scalar multiplies by its reciprocal too); NVFP4's global
    scale is amax / 2688 taken in f64 on the host in the export, in f32 by
    `compress` (on the card: times f32(1/2688)), and a moved global scale
    can move the layer's E4M3 block scales and codes. The embeddings, norms
    and lm_head went through fp16 (the checkpoint's storage). Raises on any
    other difference."""
    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t

    out = {}
    for name, arrays in cm.params["layers"].items():
        if not isinstance(arrays, dict):
            continue
        got_arrays = loaded.params["layers"][name]
        if cm.kinds[name] == "int4":
            s_want = torch.cat([arrays["scale_lo"], arrays["scale_hi"]], dim=-2)
            s_got = torch.cat([got_arrays["scale_lo"], got_arrays["scale_hi"]], dim=-2)
            moved = s_got != s_want
            if not torch.equal(torch.nextafter(s_want, s_got), s_got):
                raise AssertionError(f"deploy: loaded {name} INT4 scales differ by more than one f32 ulp")
            c_want, c_got = _int4_codes(torch, arrays["packed"]), _int4_codes(torch, got_arrays["packed"])
            step = (c_got - c_want).abs()
            block = moved.repeat_interleave(c_want.shape[-1] // moved.shape[-1], dim=-1)
            if int(step.max()) > 1 or bool((step.bool() & ~block).any()):
                raise AssertionError(f"deploy: loaded {name} INT4 codes differ outside the blocks whose scale moved")
            out[name] = {"scales_one_ulp_apart": int(moved.sum()), "scales": moved.numel(),
                         "codes_one_step_apart": int(step.bool().sum()), "codes": step.numel()}
            continue
        if cm.kinds[name] == "nvfp4":
            g_want, g_got = arrays["global_scale"], got_arrays["global_scale"]
            if not torch.equal(torch.nextafter(g_want, g_got), g_got):
                raise AssertionError(f"deploy: loaded {name} NVFP4 global scales differ by more than one f32 ulp")
            moved = g_got != g_want  # [L]
            row = {"global_scales_one_ulp_apart": int(moved.sum()), "layers": moved.numel()}
            for k in ("packed", "scale_lo", "scale_hi"):
                diff = bits(got_arrays[k]) != bits(arrays[k])
                if bool(diff[~moved].any()):
                    raise AssertionError(f"deploy: loaded {name}.{k} differs in a layer whose global scale is equal")
                row[f"{k}_bytes_apart"] = int(diff.sum())
            out[name] = row if bool(moved.any()) else "equal"
            continue
        for k, want in arrays.items():
            if not torch.equal(bits(got_arrays[k]).reshape(want.shape), bits(want)):
                raise AssertionError(f"deploy: loaded {name}.{k} differs from compress's")
            out[f"{name}.{k}"] = "equal"
    for name in ("embed_tokens", "norm", "lm_head"):
        a, b = loaded.params[name].float(), cm.params[name].float()
        out[name] = {"fp16_storage_elements_changed": int((a != b).sum()),
                     "max_rel": float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())}
    return out


def _packs_equal(packs: dict) -> bool:
    """`_deploy_packs`'s reading: every projection array equal (an INT4
    site with no scale moved has no code moved either)."""
    return all(v == "equal" or (isinstance(v, dict) and v.get("scales_one_ulp_apart") == 0)
               for k, v in packs.items() if k not in ("embed_tokens", "norm", "lm_head"))


def _as_exported(torch, qm, cm, loaded):
    """`compress`'s output as the checkpoint stores it, made without the
    export's packers or the loader: (model, model with only (2)). (1) Every
    layer whose scales the export moved (`_deploy_packs`: INT4 block scales
    and NVFP4 global scales an f32 ulp apart) packed again by
    `compress.compress_weight` under the loaded scales; (2) the unpacked
    tensors (embeddings, norms, lm_head) rounded through fp16 as the export
    stores them (bf16 -> f32 -> fp16, the reference's `to_np16`)."""
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress

    def fp16(t):
        return t.float().to(torch.float16).to(t.dtype)

    def rounded(tree):
        return {k: fp16(v) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    fp16_only = dataclasses.replace(cm, params={**rounded(cm.params), "layers": rounded(cm.params["layers"])})
    layers = dict(fp16_only.params["layers"])
    for name, kind in cm.kinds.items():
        if kind not in ("int4", "nvfp4"):
            continue
        want, got = cm.params["layers"][name], loaded.params["layers"][name]
        if kind == "int4":
            scales = torch.cat([got["scale_lo"], got["scale_hi"]], dim=-2)
            moved = (scales != torch.cat([want["scale_lo"], want["scale_hi"]], dim=-2)).flatten(1).any(1)
        else:
            scales = got["global_scale"]
            moved = scales != want["global_scale"]
        if not bool(moved.any()):
            continue
        per_layer = [compress.layer_arrays(want, i) for i in range(moved.numel())]
        wcfg, st = qm.layout.get(f"{name}.weight"), qm.qstate.get(name, {}).get("weight")
        for i in moved.nonzero().flatten().tolist():
            per_layer[i] = compress.compress_weight(qm.params["layers"][name][i], wcfg, llama.slice_state(st, i),
                                                    scales=scales[i])[1]
        layers[name] = compress._stack_arrays(per_layer)
    if all(layers[k] is v for k, v in fp16_only.params["layers"].items()):
        return fp16_only, fp16_only
    return dataclasses.replace(fp16_only, params={**fp16_only.params, "layers": layers}), fp16_only


def phase_deploy(torch, dev, sz: Sizes) -> dict:
    """Quantize -> export (sharded, into a temporary directory removed when
    the path is done) -> `load_quantized_checkpoint` -> engine -> 8 x 2048
    prefill and 32 steps through `decode_step(unroll=8)`, for each path of
    DEPLOY_PATHS at full width and DEPLOY_DEPTH layers. Raises unless the
    loaded packs equal `compress`'s (or differ as named), the loaded model
    equals byte for byte `compress`'s output as the checkpoint stores it
    (`_as_exported`: moved scales, fp16 storage), and the loaded engine's
    logits lie within DEPLOY_GAP_MAX (median) of two in-memory engines':
    the engine over the export's own tensors (the same conversion, no disk:
    the round trip) and the engine over `_as_exported`'s model. Reported:
    the gap to `compress`'s own output, and its controls: the fp16 storage
    alone, under the int8 KV cache and under bf16 KV (the int8 cache at its
    uncalibrated amax, 448, a step of 3.5, turns the small changes of bf16
    activations into changed codes; W4A8's int8 activations absorb most).
    Returns the launch counts of its runs."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve import loader

    sync = torch.cuda.synchronize
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_hidden_layers=DEPLOY_DEPTH)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    launches: dict = {}
    for path in DEPLOY_PATHS:
        layouts = dict(path.layouts)
        qm = ptq.quantize(cfg, params, path.quant_cfg(), None, device=dev)
        cm = compress.compress(qm)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as d:
            sync()
            t0 = time.perf_counter()
            qc = hf_export.export_hf_checkpoint(qm, d, max_shard_bytes=DEPLOY_SHARD_BYTES)
            export_s = time.perf_counter() - t0
            files = sorted(os.listdir(d))
            disk_gb = sum(os.path.getsize(os.path.join(d, f)) for f in files) / 1e9
            with open(os.path.join(d, "config.json")) as f:
                hf_cfg = json.load(f)
            t0 = time.perf_counter()
            loaded = loader.load_quantized_checkpoint(d, device=dev)
            sync()
            load_s = time.perf_counter() - t0
        packs = _deploy_packs(torch, cm, loaded)
        packs_equal = _packs_equal(packs)
        streamed = loader.compressed_from_export(hf_cfg, qc["quantization"],
                                                 dict(hf_export._iter_export_tensors(qm)), dev)
        as_exported, fp16_only = _as_exported(torch, qm, cm, loaded)
        repacked = _deploy_packs(torch, as_exported, loaded)
        if not _packs_equal(repacked) or any(repacked[k]["fp16_storage_elements_changed"]
                                             for k in ("embed_tokens", "norm", "lm_head")):
            raise AssertionError(f"deploy {path.label}: the loaded model differs from compress's as the "
                                 f"checkpoint stores it: {repacked}")
        del qm
        dep = _engine(torch, loaded, sz.max_seq, dev, **layouts)
        _counts(reset=True)
        sync()
        t0 = time.perf_counter()
        cache = dep.init_cache(sz.batch)
        logits = dep.prefill(prompt, cache)
        sync()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        tok, walls = torch.argmax(logits, dim=-1).to(torch.int32)[:, None], []
        for _ in range(sz.decode_steps // 8):
            t0 = time.perf_counter()
            tok, cache = dep.decode_step(tok, cache, unroll=8)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        for name, n in _counts().items():
            launches[name] = launches.get(name, 0) + n

        def served(model, kv="int8"):  # prefill logits and the last of 32 greedy tokens
            mem = _engine(torch, model, sz.max_seq, dev, kv=kv, **layouts)
            mcache = mem.init_cache(sz.batch)
            ref = mem.prefill(prompt, mcache)
            mtok = torch.argmax(ref, dim=-1).to(torch.int32)[:, None]
            for _ in range(sz.decode_steps // 8):
                mtok, mcache = mem.decode_step(mtok, mcache, unroll=8)
            return ref, mtok

        def vs(a, b):
            gaps, flips = _gaps(a[0], b[0])
            return {"median_logits_gap": statistics.median(gaps), "worst_logits_gap": max(gaps),
                    "argmax_flip_margins": flips, "logits_equal": bool(torch.equal(a[0], b[0])),
                    "last_tokens_equal": bool(torch.equal(a[1], b[1]))}

        held_refs = ("in_memory_export", "compress_as_exported")
        out, comp = (logits, tok), served(cm)
        held = {"in_memory_export": vs(out, served(streamed)), "compress_as_exported": vs(out, served(as_exported)),
                "in_memory_compress": vs(out, comp), "control_fp16_storage_only": vs(served(fp16_only), comp),
                "control_fp16_storage_only_bf16_kv": vs(served(fp16_only, None), served(cm, None))}
        row = {"phase": "deploy", "path": path.label, "model": "llama3_8b", "layers": DEPLOY_DEPTH,
               "quant_algo": qc["quantization"]["quant_algo"], "kinds_served": sorted(set(dep.cm.kinds.values())),
               "files": files, "disk_gb": disk_gb, "export_s": export_s, "load_s": load_s,
               "batch": sz.batch, "prompt": sz.prompt, "ttft_ms": ttft_ms, "decode_steps": sz.decode_steps,
               "unroll": 8, "wall_ms_per_token_step": statistics.median(walls[1:]) / 8,
               "capture_call_ms": walls[0], "serve_s": (ttft_ms + sum(walls)) / 1e3,
               "vs": held, "logits_finite": bool(torch.isfinite(logits).all()), "packs_vs_compress": packs,
               "packs_equal": packs_equal}
        log(json.dumps(row))
        for what in held_refs:
            gap = held[what]["median_logits_gap"]
            if not row["logits_finite"] or not gap <= DEPLOY_GAP_MAX:
                raise AssertionError(f"deploy {path.label}: the loaded engine's logits lie {gap} (median) of their "
                                     f"scale from the {what} engine's, the limit is {DEPLOY_GAP_MAX}")
        if len([f for f in files if f.startswith("model-")]) < 2 or "model.safetensors.index.json" not in files:
            raise AssertionError(f"deploy {path.label}: the sharded export wrote {files}")
        del dep, cache, loaded, cm, streamed, as_exported, fp16_only
        torch.cuda.empty_cache()
    return launches


# The calibration algorithms at full width: each preset this slice unlocks,
# calibrated on the card on 4 seeded batches of [2, 512] tokens, compressed
# and served by the kernel engine. INT4_AWQ_CFG (the headline) and its
# max-calibrated counterpart on 8 layers, every other preset on the first 2
# (the default run's time; CALIB_PLAIN_DEPTH's hold takes all 2).
@dataclasses.dataclass(frozen=True)
class CalibPath:
    label: str
    preset: str
    depth: int = 2
    layouts: tuple = ()    # EngineConfig layout fields
    kv: object = "int8"    # "int8", or "fp8" where the preset quantizes the KV cache to fp8
    max_counterpart: str = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"  # the max-calibrated preset its error is read beside
    deploy: bool = False   # export -> load -> serve at DEPLOY_DEPTH


CALIB_PATHS = (
    CalibPath("int4_max", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", depth=8),
    CalibPath("int4_awq", "INT4_AWQ_CFG", depth=8, deploy=True),
    CalibPath("w8a8_smoothquant", "INT8_SMOOTHQUANT_CFG", max_counterpart="INT8_DEFAULT_CFG", deploy=True),
    CalibPath("int4_gptq", "INT4_GPTQ_CFG"),
    CalibPath("int4_local_hessian", "INT4_LOCAL_HESSIAN_CFG"),
    CalibPath("int4_svdquant", "INT4_SVDQUANT_CFG"),
    CalibPath("nvfp4_svdquant", "NVFP4_SVDQUANT_CFG", max_counterpart="NVFP4_DEFAULT_CFG", deploy=True),
    CalibPath("w4a8_awq", "W4A8_AWQ_BETA_CFG", layouts=(("int4_layout", "a8"),), deploy=True),
    CalibPath("nvfp4_awq_lite", "NVFP4_AWQ_LITE_CFG", max_counterpart="NVFP4_DEFAULT_CFG"),
    CalibPath("nvfp4_act_headroom", "NVFP4_ACT_HEADROOM_CFG", max_counterpart="NVFP4_DEFAULT_CFG"),
    CalibPath("fp8_kv_affine", "FP8_KV_AFFINE_CFG", kv="fp8", max_counterpart="FP8_KV_CFG"),
    CalibPath("int4_awq_kv_fp8", "INT4_AWQ_KV_FP8_CFG", kv="fp8"),
)
CALIB_BATCHES = (4, 2, 512)  # seeded token batches: count, B, T
CALIB_KERNELS = ("qmm_int4_wo", "qmm_fp4_wo", "qmm_w4a8", "qmm_byte_wo", "flash_gqa", "kv_decode_attention")
# kernel engine against the all-plain engine: the prefill logits' relative
# error at CALIB_PLAIN_DEPTH layers, input quantizers off, as `_full_path`
# holds each path (the bf16 GEMMs' one-ulp differences flip int8 KV and
# activation codes, which random layers amplify with depth)
CALIB_PLAIN_REL_MAX = 5e-2
CALIB_PLAIN_DEPTH = 2
ENGINE_VS_FAKE_QUANT_MAX = 0.1  # anchor: the engine against the calibrated fake-quant forward, median gap
# W8A8's static per-tensor int8 activations turn the engine's and the
# fake-quant forward's bf16 rounding into other codes, and deeper layers
# carry them on: over the anchor's 6 layers JAX's own engine lies 0.090
# (SmoothQuant) from JAX's fake-quant forward on the CPU, the port's as far
# (tests/test_torch_w8a8_anchor.py); W8A8 is held to twice that
ANCHOR_W8A8_DEPTH = 6
W8A8_VS_FAKE_QUANT_MAX = 0.2
CARD_CPU_FROB_MAX = 1e-3  # anchor: card against CPU calibration, relative Frobenius error of each tensor
CARD_CPU_APART_MAX = 1e-2  # anchor: share of a tensor's elements apart beyond the elementwise rule


def _kv_of(torch, path: CalibPath):
    return torch.float8_e4m3fn if path.kv == "fp8" else "int8"


def _calib_serve(torch, dev, sz: Sizes, path: CalibPath, cm, prompt) -> dict:
    """The kernel engine over `cm`: 8 x 2048 prefill (TTFT), then 32 steps
    through decode_step(unroll=8) (wall per token step); the launch counts of
    that run; then the same steps launched eagerly from the prefilled cache
    (tokens and cache must be equal bit for bit); then the prefill logits of
    the model's first CALIB_PLAIN_DEPTH layers against the all-plain
    engine's, with the input quantizers off where the preset has them
    (relative error <= CALIB_PLAIN_REL_MAX; with them on, the median gap and
    flip margins, printed), and at a 4-layer path's full depth (printed).
    Returns (the row, the prefill logits, the failures)."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    sync = torch.cuda.synchronize
    layouts, kv = dict(path.layouts), _kv_of(torch, path)
    eng = _engine(torch, cm, sz.max_seq, dev, kv=kv, **layouts)
    cache = eng.init_cache(sz.batch)
    _counts(reset=True)
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    start = _clone_cache(cache)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    tok, walls, got = tok0, [], []
    for _ in range(sz.decode_steps // 8):
        t0 = time.perf_counter()
        tok, cache = eng.decode_step(tok, cache, unroll=8)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        got.append(tok)
    launches = _counts()
    eager, t = [], tok0
    for _ in range(sz.decode_steps):
        t, _ = _eager_step(torch, eng, t, start)
        eager.append(t)
    failures = []
    equal = torch.equal(torch.cat(got, dim=1), torch.cat(eager, dim=1)[:, 7::8]) and _same_cache(torch, cache, start)
    if not equal:
        failures.append(f"calib {path.label}: the graphed decode steps differ from the eager ones")
    kinds = sorted(set(eng.cm.kinds.values()))
    eng.release_graphs()
    del eng, cache, start

    def vs_plain(depth, model):
        sub = _truncate(model, depth) if depth != path.depth else model
        out = _engine(torch, sub, sz.max_seq, dev, kv=kv, **layouts)
        out = out.prefill(prompt, out.init_cache(sz.batch)) if depth != path.depth or model is not cm else logits
        ref = _engine(torch, sub, sz.max_seq, dev, PLAIN_ALL, kv=kv, **layouts)
        ref = ref.prefill(prompt, ref.init_cache(sz.batch))
        gaps, flips = _gaps(out, ref)
        return {"prefill_logits_rel_err": _rel(out, ref), "median_logits_gap": statistics.median(gaps),
                "worst_logits_gap": max(gaps), "argmax_flip_margins": flips}

    depth = min(CALIB_PLAIN_DEPTH, path.depth)
    acts = any(c.enable for k, c in cm.layout.sites if k.endswith(".input"))
    held = vs_plain(depth, _without_input_quantizers(cm) if acts else cm)
    readings = {f"depth {depth}" + (", input quantizers off" if acts else ""): held}
    if acts:
        readings[f"depth {depth}"] = vs_plain(depth, cm)
    if path.depth <= 4:  # the 32-layer plain prefill takes ~20 s
        readings[f"depth {path.depth}"] = vs_plain(path.depth, cm)
    row = {"ttft_ms": ttft_ms, "wall_ms_per_token_step": statistics.median(walls[1:]) / 8,
           "capture_call_ms": walls[0], "graph_tokens_equal_eager": equal, "vs_plain": readings,
           "kinds_served": kinds, "launches": launches, "logits_finite": bool(torch.isfinite(logits).all())}
    if not row["logits_finite"] or not held["prefill_logits_rel_err"] <= CALIB_PLAIN_REL_MAX:
        failures.append(f"calib {path.label}: the kernel engine against the plain one: {readings}")
    return row, logits, failures


def _rel_frob(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _held_card_cpu(torch, label: str, card, cpu) -> dict:
    """Card against CPU calibration of one f32 model: the algorithm a search
    picked equal; every state tensor (amax, pre_quant_scale, affine bias),
    folded or residual weight and adapter product B @ A within
    CARD_CPU_FROB_MAX (relative Frobenius), and the share of its elements
    more than 1e-5 of the tensor's largest magnitude apart at most
    CARD_CPU_APART_MAX: a search's choice at a near tie (the card's and the
    CPU's f32 sums differ in order) moves a few rows or blocks, a GPTQ code
    at a rounding tie the columns after it. Returns the worst figures;
    raises beyond."""
    from tensorrt_model_optimizer_tpu_torch.quant.quantizer import QuantizerState

    if card.quant_cfg.algorithm != cpu.quant_cfg.algorithm:
        raise AssertionError(f"calib card/cpu {label}: picked {card.quant_cfg.algorithm} on the card, "
                             f"{cpu.quant_cfg.algorithm} on the CPU")
    pairs = []

    def walk(name, a, b):
        if a is None:
            return
        if isinstance(a, dict):
            for k in a:
                walk(f"{name}.{k}", a[k], b[k])
        elif isinstance(a, tuple):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(f"{name}[{i}]", x, y)
        elif isinstance(a, QuantizerState):
            for f in ("amax", "pre_quant_scale", "bias"):
                walk(f"{name}.{f}", getattr(a, f), getattr(b, f))
        else:
            pairs.append((name, a.cpu(), b))

    walk("qstate", card.qstate, cpu.qstate)
    for name in card.params["layers"]:
        walk(f"layers.{name}", card.params["layers"][name], cpu.params["layers"][name])
    for name, ad in (card.adapters or {}).items():
        pairs.append((f"adapters.{name}.B@A", torch.bmm(ad["B"].float(), ad["A"].float()).cpu(),
                      torch.bmm(cpu.adapters[name]["B"].float(), cpu.adapters[name]["A"].float())))
    worst_frob, worst_apart, apart_total, beyond = 0.0, 0.0, 0, []
    for name, a, b in pairs:
        frob = _rel_frob(a, b)
        apart = (a.float() - b.float()).abs() > 1e-5 * b.float().abs().max().clamp_min(1e-30)
        share = float(apart.float().mean())
        worst_frob, worst_apart = max(worst_frob, frob), max(worst_apart, share)
        apart_total += int(apart.sum())
        if not frob <= CARD_CPU_FROB_MAX or not share <= CARD_CPU_APART_MAX:
            idx = apart.flatten().nonzero()[:4, 0]
            beyond.append({"tensor": name, "rel_frobenius": frob, "share_apart": share,
                           "card": a.flatten()[idx].tolist(), "cpu": b.flatten()[idx].tolist()})
    out = {"tensors": len(pairs), "worst_rel_frobenius": worst_frob, "worst_share_apart": worst_apart,
           "elements_apart": apart_total, "beyond": beyond}
    if beyond:
        log(json.dumps({"phase": "calib_anchor_card_cpu_apart", "algorithm": label, **out}))
        raise AssertionError(f"calib card/cpu {label}: {len(beyond)} tensors beyond the rule, first "
                             f"{beyond[0]['tensor']}")
    return out


# card against CPU: the calibration modules on the same captured inputs
TIE_REL = 1e-5        # a choice may differ only where the CPU's losses for the two candidates lie this close
SCALE_ULP = 4         # f32 scales from the same choice: within this many ulp
GPTQ_OUT_ERR_REL = 1e-2   # GPTQ: the output error ||X (Wq - W)^T||^2 within this share of the CPU's
GPTQ_APART_MAX = 1e-2     # GPTQ: the share of weights more than 1e-3 of the largest apart (a code at a tie cascades)
SVD_REL = 1e-4        # SVDQuant: B @ A and the residual, relative to the weight, or SVD_GAP_ULPS f32 ulps of
SVD_GAP_ULPS = 16     # sigma_1 / (sigma_r - sigma_r+1) where the rank-r subspace is that ill-defined (Davis-Kahan)


def card_cpu_calib_modules(torch, dev, cfg, params, batches) -> dict:
    """Every calibration module on the CPU and on the card (`dev`) over the
    same inputs: f32 weights `params` and the captures of `batches`, taken
    once on the CPU. The parity rules of tests/test_torch_calib_math.py,
    with the CPU in JAX's place: a search's choices (AWQ-lite alphas with
    the INT4, W4A8 and NVFP4 weight quantizers, SmoothQuant auto's
    candidates, AWQ-clip, local-Hessian and MSE ratios) equal wherever the
    CPU's losses for the two candidates differ by more than TIE_REL, the
    scales of an equal choice within SCALE_ULP; GPTQ's output error within
    GPTQ_OUT_ERR_REL and at most GPTQ_APART_MAX of its weights apart;
    SVDQuant within SVD_REL, or where the rank-16 subspace is ill-defined
    (close singular values at the cut) within SVD_GAP_ULPS f32 ulps times
    sigma_1 / (sigma_16 - sigma_17), how far two correct SVDs may rotate it;
    histogram counts and amaxes equal. AWQ clip
    skips a K that is no whole number of blocks (JAX raises there). Returns
    the counts; raises beyond the rules."""
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.ops import numerics
    from tensorrt_model_optimizer_tpu_torch.quant import config, ptq
    from tensorrt_model_optimizer_tpu_torch.quant.calib import awq, gptq, histogram, mse, smoothquant, svdquant

    layout = llama.build_layout(cfg, config.INT4_BLOCKWISE_WEIGHT_ONLY_CFG)
    absmean, amax, samples = ptq._capture_stats(cfg, params, layout, llama.init_quant_state(cfg, layout, "cpu"),
                                                batches, 128)
    st = {"choices": 0, "choices_apart": 0, "worst_tie_gap": 0.0, "worst_scale_ulp": 0.0,
          "gptq_worst_out_err_rel": 0.0, "gptq_worst_share_apart": 0.0, "svd_worst_rel": 0.0}
    failures = []

    def on(t):
        return t.to(dev)

    def choices(what, lc, lg):
        """The argmins of the CPU's and the card's losses [n, ...]; where
        they differ, the CPU's losses for the two must be a tie."""
        ic, ig = lc.argmin(0), lg.cpu().argmin(0)
        apart = ic != ig
        st["choices"] += ic.numel()
        if bool(apart.any()):
            a, b = lc.gather(0, ic[None])[0][apart], lc.gather(0, ig[None])[0][apart]
            gap = float(((b - a).abs() / a.abs().clamp_min(1e-30)).max())
            st["choices_apart"] += int(apart.sum())
            st["worst_tie_gap"] = max(st["worst_tie_gap"], gap)
            if gap > TIE_REL:
                failures.append(f"{what}: {int(apart.sum())} choices apart, CPU losses {gap} apart")
        return apart

    def ulps(what, a, b):
        a, b = a.cpu().double(), b.double()
        u = float(((a - b).abs() / (b.abs() * 2.0 ** -23).clamp_min(1e-45)).max()) if a.numel() else 0.0
        st["worst_scale_ulp"] = max(st["worst_scale_ulp"], u)
        if u > SCALE_ULP:
            failures.append(f"{what}: scales {u} ulp apart")

    wq = {"int4": config.INT4_PER_BLOCK_128, "w4a8": config.W4A8_SEQUENTIAL, "nvfp4": config.NVFP4_BLOCK16}
    for key, members in ptq.CAPTURE_GROUPS.items():
        for i in range(cfg.num_hidden_layers):
            x, ws, am = samples[key][i], [params["layers"][m][i] for m in members], absmean[key][i]
            base = torch.clamp_min(am.float(), 1e-8)
            for name, c in wq.items():  # AWQ lite
                fns = ptq._weight_qfns([c] * len(ws))
                alphas, lc = awq.awq_lite_losses(x, ws, fns, am)
                _, lg = awq.awq_lite_losses(on(x), [on(w) for w in ws], fns, on(am))
                if not bool(choices(f"awq_lite {name} {key}[{i}]", lc, lg).any()):
                    a = alphas[lc.argmin(0)]
                    ulps(f"awq_lite {name} {key}[{i}]", awq._normalize_scale(torch.pow(on(base), on(a))),
                         awq._normalize_scale(torch.pow(base, a)))
            fns = [lambda w, f=f: f(w[0])[None] for f in ptq._weight_qfns([config.INT8_PER_CHANNEL] * len(ws))]
            sc, lc = smoothquant.smoothquant_auto_losses(x[None], amax[key][i][None], [w[None] for w in ws], fns)
            sg, lg = smoothquant.smoothquant_auto_losses(on(x)[None], on(amax[key][i])[None],
                                                         [on(w)[None] for w in ws], fns)
            if not bool(choices(f"smoothquant_auto {key}[{i}]", lc, lg).any()):
                j = int(lc.argmin(0))
                ulps(f"smoothquant_auto {key}[{i}]", sg[j], sc[j])
            for m, w in zip(members, ws):
                bsz = min(128, w.shape[-1])

                def q4(wx, full):
                    return numerics.fake_quant_int(wx, full, 4)

                amax0 = torch.amax(torch.abs(torch.nn.functional.pad(w, (0, -w.shape[-1] % bsz))).reshape(
                    w.shape[0], -1, bsz), dim=-1)
                _, lc = mse.local_hessian_losses(x, w, amax0, q4, bsz)
                _, lg = mse.local_hessian_losses(on(x), on(w), on(amax0), q4, bsz)
                choices(f"local_hessian {m}[{i}]", lc, lg)
                if w.shape[-1] % bsz == 0:
                    _, _, lc = awq.awq_clip_losses(x, w, bsz, q4)
                    _, _, lg = awq.awq_clip_losses(on(x), on(w), bsz, q4)
                    choices(f"awq_clip {m}[{i}]", lc, lg)
                    expand = (lambda a, shape=tuple(w.shape): numerics.expand_block_scale(a, shape, ((-1, bsz),)))
                    _, lc = mse.mse_amax_losses(w, amax0, q4, expand)
                    _, lg = mse.mse_amax_losses(on(w), on(amax0), q4, expand)
                    choices(f"mse {m}[{i}]", lc, lg)
                A, B, r = svdquant.svd_split(w, 16)
                Ag, Bg, rg = svdquant.svd_split(on(w), 16)
                rel = max(float(((Bg @ Ag).cpu() - B @ A).norm() / w.norm()), float((rg.cpu() - r).norm() / w.norm()))
                sv = torch.linalg.svdvals(w.double())
                bound = max(SVD_REL, SVD_GAP_ULPS * 2.0 ** -23 * float(sv[0] / (sv[15] - sv[16])))
                st["svd_worst_rel"] = max(st["svd_worst_rel"], rel)
                st["svd_worst_share_of_bound"] = max(st.get("svd_worst_share_of_bound", 0.0), rel / bound)
                if rel > bound:
                    failures.append(f"svdquant {m}[{i}]: {rel} of the weight apart, the bound {bound}")
            wcat = torch.cat(ws)  # the group's weights share the Hessian, as ptq runs them
            wc = gptq.gptq_calibrate_weight(wcat, x, config.INT4_PER_BLOCK_128)
            wg = gptq.gptq_calibrate_weight(on(wcat), on(x), config.INT4_PER_BLOCK_128).cpu()

            def out_err(wq_):  # ||X (Wq - W)^T||^2
                return float(((x.double() @ (wq_ - wcat).double().t()) ** 2).sum())

            err_rel = abs(out_err(wg) - out_err(wc)) / out_err(wc)
            share = float(((wg - wc).abs() > 1e-3 * wc.abs().max()).float().mean())
            st["gptq_worst_out_err_rel"] = max(st["gptq_worst_out_err_rel"], err_rel)
            st["gptq_worst_share_apart"] = max(st["gptq_worst_share_apart"], share)
            if err_rel > GPTQ_OUT_ERR_REL or share > GPTQ_APART_MAX:
                failures.append(f"gptq {key}[{i}]: output error {err_rel} apart, {share} of the weights")
    x = samples["down_in"]
    hc = histogram.collect_histogram(x, histogram.init_histogram(torch.amax(torch.abs(x))))
    hg = histogram.collect_histogram(on(x), histogram.init_histogram(on(torch.amax(torch.abs(x)))))
    if not torch.equal(hg.counts.cpu(), hc.counts) or any(
            not torch.equal(histogram.compute_amax(hg, m).cpu(), histogram.compute_amax(hc, m))
            for m in ("percentile", "mse", "entropy")):
        failures.append("histogram: counts or amaxes apart")
    if failures:
        raise AssertionError(f"calib card/cpu: {len(failures)} beyond the rules: " + "; ".join(failures[:8]))
    return st


# the presets served on artifacts/anchor-llama against their own fake-quant
# forward: (algorithm, preset, its max-calibrated counterpart)
ANCHOR_CALIB = (
    ("smoothquant_auto", "INT8_SMOOTHQUANT_CFG", "INT8_DEFAULT_CFG"),  # served W8A8 (ANCHOR_W8A8_DEPTH)
    ("awq_lite", "INT4_AWQ_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"),
    ("awq_lite_w4a8", "W4A8_AWQ_BETA_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"),
    ("gptq", "INT4_GPTQ_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"),
    ("local_hessian", "INT4_LOCAL_HESSIAN_CFG", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"),
    ("svdquant", "NVFP4_SVDQUANT_CFG", "NVFP4_DEFAULT_CFG"),
    ("nvfp4_act_headroom", "NVFP4_ACT_HEADROOM_CFG", "NVFP4_DEFAULT_CFG"),
    ("fp8_kv_affine", "FP8_KV_AFFINE_CFG", "FP8_KV_CFG"),
)
# the algorithms without a search, held card against CPU through ptq.quantize
ANCHOR_CARD_CPU_PTQ = ("NVFP4_ACT_HEADROOM_CFG", "FP8_KV_AFFINE_CFG")


def _a8_fake_quant(qm):
    """`qm` with every enabled input site as the W4A8 engine quantizes it:
    per-token dynamic int8 (the pre_quant_scale stays in the state)."""
    from tensorrt_model_optimizer_tpu_torch.models.llama import QuantLayout
    from tensorrt_model_optimizer_tpu_torch.quant.config import INT8_PER_TOKEN_DYNAMIC

    sites = tuple((k, INT8_PER_TOKEN_DYNAMIC if k.endswith(".input") and k != "lm_head.input" else v)
                  for k, v in qm.layout.sites)
    return dataclasses.replace(qm, layout=QuantLayout(sites=sites))


def _calib_anchor(torch, dev) -> list:
    """On artifacts/anchor-llama: every calibration module on the card and
    on the CPU over the same f32 captures (`card_cpu_calib_modules`; in bf16
    the two devices' forwards round the activations an ulp apart, and every
    statistic after them), and the search-free algorithms through
    `ptq.quantize` in f32 (`_held_card_cpu`); then each preset of
    ANCHOR_CALIB calibrated on the card in bf16 and served by the kernel
    engine against its own fake-quant forward (the KV cache as the preset
    quantizes it; W4A8 against int8 per-token input sites): the median
    logits gap at most ENGINE_VS_FAKE_QUANT_MAX, which holds the engine's use
    of the calibrated state (pre_quant_scale, adapters, W8A8 scales) to the
    forward that calibrated it; and each model's fake-quant logits error
    against the unquantized model beside max calibration's (printed)."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, config, ptq

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    cpu32 = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")[1]
    g = torch.Generator(device=dev).manual_seed(6)
    batches = [torch.randint(0, cfg.vocab_size, (2, 128), generator=g, device=dev) for _ in range(4)]
    t0 = time.perf_counter()
    modules = card_cpu_calib_modules(torch, dev, cfg32, cpu32, [b.cpu() for b in batches])
    log(json.dumps({"phase": "calib_anchor_modules", "seconds": time.perf_counter() - t0, **modules}))
    for preset in ANCHOR_CARD_CPU_PTQ:
        card = ptq.quantize(cfg32, {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                                        {n: a.to(dev) for n, a in v.items()}) for k, v in cpu32.items()},
                            preset, batches, device=dev)
        cpu = ptq.quantize(cfg32, cpu32, preset, [b.cpu() for b in batches], device="cpu")
        log(json.dumps({"phase": "calib_anchor_ptq", "preset": preset, **_held_card_cpu(torch, preset, card, cpu)}))
        del card, cpu
    rows = []
    for label, preset, counterpart in ANCHOR_CALIB:
        qcfg = config.get_preset(preset)
        t0 = time.perf_counter()
        card = ptq.quantize(cfg, params, qcfg, batches, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device=dev)
        a8 = preset.startswith("W4A8")
        kv = torch.float8_e4m3fn if qcfg.resolve("model.layers.0.self_attn.k_bmm_quantizer").enable else None
        held_qm = card
        if qcfg.resolve("model.layers.0.mlp.up_proj.input_quantizer").num_bits == 8 and \
                qcfg.resolve("model.layers.0.mlp.up_proj.weight_quantizer").num_bits == 8:
            held_qm = _truncated_qm(card, ANCHOR_W8A8_DEPTH)
        eng = _engine(torch, compress.compress(held_qm), 128, dev, kv=kv, **({"int4_layout": "a8"} if a8 else {}))
        served = eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
        fq = (_a8_fake_quant(held_qm) if a8 else held_qm).forward(prompt)[0][:, -1]
        gap = statistics.median(_gaps(served, fq)[0])
        ref = llama.forward(cfg, params, prompt)[0][:, -1]
        mx = ptq.quantize(cfg, params, counterpart, batches, device=dev)
        row = {"phase": "calib_anchor", "algorithm": label, "preset": preset, "card_s": card_s,
               "engine_layers": held_qm.model_cfg.num_hidden_layers, "engine_vs_fake_quant_median_gap": gap,
               "fake_quant_rel_err_vs_unquantized": _rel_frob(card.forward(prompt)[0][:, -1], ref),
               "max_calibrated_rel_err_vs_unquantized": _rel_frob(mx.forward(prompt)[0][:, -1], ref)}
        log(json.dumps(row))
        rows.append(row)
        limit = W8A8_VS_FAKE_QUANT_MAX if held_qm is not card else ENGINE_VS_FAKE_QUANT_MAX
        if not gap <= limit:
            raise AssertionError(f"calib anchor {label}: the engine lies {gap} (median) from the calibrated "
                                 f"fake-quant forward, the limit is {limit}")
        del card, mx, eng
    return rows


def _truncated_qm(qm, depth: int):
    """The first `depth` layers of a QuantizedModel (views): the layers'
    weights, their stacked states and adapters."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if isinstance(tree, llama.QuantizerState):
            return llama._map_state(lambda a: a[:depth], tree)
        return tree[:depth]

    qstate = {k: (v if k.startswith(llama.GLOBAL_SITES) else cut(v)) for k, v in qm.qstate.items()}
    return dataclasses.replace(qm, model_cfg=dataclasses.replace(qm.model_cfg, num_hidden_layers=depth),
                               params={**qm.params, "layers": cut(qm.params["layers"])}, qstate=qstate,
                               adapters=None if qm.adapters is None else cut(qm.adapters))


def _calib_deploy(torch, dev, sz: Sizes, path: CalibPath, qm, prompt) -> tuple:
    """export (1 GiB shards, a temporary directory) -> load -> serve at
    DEPLOY_DEPTH (or the path's depth where it is less): the loaded engine's prefill logits (256 tokens) against
    the engine over the export's own tensors held in memory (the same
    conversion, no disk; median gap <= DEPLOY_GAP_MAX), and against the
    engine over `compress`'s model (printed: the checkpoint's fp16 storage
    and its scales moved an ulp, `phase_deploy`, are between them). Returns
    (the row, the failures)."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.quant import compress
    from tensorrt_model_optimizer_tpu_torch.serve import loader

    depth = min(DEPLOY_DEPTH, qm.model_cfg.num_hidden_layers)
    qm = _truncated_qm(qm, depth) if qm.model_cfg.num_hidden_layers != depth else qm
    layouts, kv = dict(path.layouts), _kv_of(torch, path)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_calib_deploy_") as d:
        t0 = time.perf_counter()
        qc = hf_export.export_hf_checkpoint(qm, d, max_shard_bytes=DEPLOY_SHARD_BYTES)
        export_s = time.perf_counter() - t0
        with open(os.path.join(d, "config.json")) as f:
            hf_cfg = json.load(f)
        t0 = time.perf_counter()
        loaded = loader.load_quantized_checkpoint(d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    p = prompt[:, :256]

    def served(cm):
        eng = _engine(torch, cm, 512, dev, kv=kv, **layouts)
        return eng.prefill(p, eng.init_cache(p.shape[0]))

    def vs(a, b):
        gaps, flips = _gaps(a, b)
        return {"median_logits_gap": statistics.median(gaps), "worst_logits_gap": max(gaps),
                "argmax_flip_margins": flips}

    out = served(loaded)
    held = vs(out, served(loader.compressed_from_export(hf_cfg, qc["quantization"],
                                                        dict(hf_export._iter_export_tensors(qm)), dev)))
    row = {"quant_algo": qc["quantization"]["quant_algo"], "lora_rank": qc["quantization"].get("lora_rank"),
           "adapters_loaded": loaded.adapters is not None, "export_s": export_s, "load_s": load_s,
           "layers": depth, "loaded_vs_in_memory_export": held,
           "loaded_vs_compress": vs(out, served(compress.compress(qm)))}
    failed = [] if held["median_logits_gap"] <= DEPLOY_GAP_MAX and row["adapters_loaded"] == (qm.adapters is not None) \
        else [f"calib deploy {path.label}: {row}"]
    return row, failed


def phase_calib(torch, dev, sz: Sizes) -> dict:
    """Every path of CALIB_PATHS at full width (seeded random bf16 weights,
    32 layers made once, each path on its first `depth`): calibrate on the
    card (seconds, peak memory), compress, serve (`_calib_serve`), the
    prefill logits' error against the unquantized engine beside the
    max-calibrated counterpart's (informational: the weights are random);
    the deploy paths export, load and serve at DEPLOY_DEPTH. Then
    `_calib_anchor`. Returns the launch counts of the served runs."""
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, config, ptq

    sync = torch.cuda.synchronize
    cfg32 = llama.LlamaConfig.llama3_8b()
    params32 = llama.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg32.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    n, b, t = CALIB_BATCHES
    gb = torch.Generator(device=dev).manual_seed(4)
    batches = [torch.randint(0, cfg32.vocab_size, (b, t), generator=gb, device=dev) for _ in range(n)]
    launches: dict = {}
    refs: dict = {}
    max_err: dict = {}
    failures: list = []
    for path in CALIB_PATHS:
        cfg = dataclasses.replace(cfg32, num_hidden_layers=path.depth)
        params = {**params32, "layers": {k: v[:path.depth] for k, v in params32["layers"].items()}}
        if path.depth not in refs:  # the unquantized engine's prefill logits at this depth
            ref_eng = _engine(torch, compress.compress_bf16(cfg, params), sz.max_seq, dev, kv=None)
            refs[path.depth] = ref_eng.prefill(prompt, ref_eng.init_cache(sz.batch))
            del ref_eng
        torch.cuda.empty_cache()
        sync()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qm = ptq.quantize(cfg, params, path.preset, batches, device=dev)
        sync()
        calib_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cm = compress.compress(qm)
        row, logits, failed = _calib_serve(torch, dev, sz, path, cm, prompt)
        failures += failed
        for k, v in row.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        err = _rel_frob(logits, refs[path.depth])
        key = (path.depth, path.max_counterpart, path.kv, path.layouts)
        if path.preset == path.max_counterpart:
            max_err[key] = err
        if key not in max_err:
            mcm = compress.compress(ptq.quantize(cfg, params, path.max_counterpart, batches, device=dev))
            me = _engine(torch, mcm, sz.max_seq, dev, kv=_kv_of(torch, path), **dict(path.layouts))
            max_err[key] = _rel_frob(me.prefill(prompt, me.init_cache(sz.batch)), refs[path.depth])
            del mcm, me
        out = {"phase": "calib", "path": path.label, "preset": path.preset, "model": "llama3_8b",
               "layers": path.depth, "calib_batches": list(CALIB_BATCHES), "calib_s": calib_s,
               "calib_peak_gb": peak / 1e9, "resident_before_gb": resident / 1e9,
               "algorithm": qm.quant_cfg.algorithm, "batch": sz.batch, "prompt": sz.prompt,
               "decode_steps": sz.decode_steps, "unroll": 8, **row,
               "prefill_logits_rel_err_vs_unquantized": err,
               "max_counterpart": path.max_counterpart, "max_counterpart_rel_err": max_err[key]}
        if path.deploy:
            out["deploy"], failed = _calib_deploy(torch, dev, sz, path, qm, prompt)
            failures += failed
        log(json.dumps(out))
        del qm, cm, logits
    del params32, refs
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "calib_launches", **launches}))
    _calib_anchor(torch, dev)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# The accuracy harness (`utils/evaluate.py`, `utils/mmlu.py`), the last
# formats (NF4 on the INT4 kernel at 64-blocks, MXFP6 and MXFP8 as bf16
# grid values, the int4x and int8a8 layouts), layerwise calibration and the
# PTQ entry point (`examples/hf_ptq_torch.py`).
ACCURACY_RECORD = os.path.join(HERE, "artifacts", "accuracy_table.json")  # JAX's record, read as data
ACC_BF16_REL = 1e-3  # the unquantized anchor's ppl against JAX's record, relative
# JAX's per-preset pinned Δppl budgets (`tests/test_accuracy_anchor.py`
# _MEASURED_DPPL, copied as data): each preset's Δppl must stay under
# round(max(3 x measured, 0) + 0.01, 4)
MEASURED_DPPL = {
    "FP8_2D_BLOCKWISE_WEIGHT_ONLY_CFG": -0.0002, "FP8_DEFAULT_CFG": 0.0012,
    "FP8_KV_AFFINE_CFG": 0.0010, "FP8_KV_CFG": 0.0013,
    "FP8_PER_CHANNEL_PER_TOKEN_CFG": 0.0001, "INT4_AWQ_CFG": -0.0001,
    "INT4_AWQ_KV_FP8_CFG": 0.0001, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG": -0.0002,
    "INT4_GPTQ_CFG": 0.0000, "INT4_LOCAL_HESSIAN_CFG": -0.0008,
    "INT4_SVDQUANT_CFG": 0.0002, "INT8_DEFAULT_CFG": 0.0006,
    "INT8_SMOOTHQUANT_CFG": 0.1090, "MXFP4_DEFAULT_CFG": 0.0337,
    "MXFP4_WEIGHT_ONLY_CFG": 0.0014, "MXFP6_DEFAULT_CFG": 0.0000,
    "MXFP8_DEFAULT_CFG": 0.0002, "NF4_WEIGHT_ONLY_CFG": -0.0003,
    "NVFP4_ACT_HEADROOM_CFG": 0.0038, "NVFP4_AWQ_LITE_CFG": 0.0081,
    "NVFP4_DEFAULT_CFG": 0.0069, "NVFP4_KV_CFG": 0.0102,
    "NVFP4_SVDQUANT_CFG": 0.0053, "NVFP4_WEIGHT_ONLY_CFG": 0.0009,
    "W4A8_AWQ_BETA_CFG": 0.0008,
}
ACC_MMLU = ("INT4_AWQ_CFG",)  # answered beside the unquantized model, card against CPU
ACC_MMLU_N = 24               # questions a subject (5 subjects: 120)
MMLU_MARGIN = 1e-4            # a choice may differ only where the CPU's top-two logits lie this close
# the new formats and layouts served on the anchor against their fake-quant
# forward (ENGINE_VS_FAKE_QUANT_MAX): (label, preset, engine layout fields)
ACC_ANCHOR_SERVED = (
    ("nf4", "NF4_WEIGHT_ONLY_CFG", ()),
    ("mxfp6", "MXFP6_DEFAULT_CFG", ()),
    ("mxfp8", "MXFP8_DEFAULT_CFG", ()),
    ("int4x", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", (("int4_layout", "xla"),)),
    ("int8a8", "NVFP4_WEIGHT_ONLY_CFG", (("nvfp4_layout", "i8"),)),
)
# full width: served as `_calib_serve` serves CALIB_PATHS (NF4 on the INT4
# kernel at 64-blocks also on 8 layers)
ACC_PATHS = (
    CalibPath("nf4_8", "NF4_WEIGHT_ONLY_CFG", depth=8),
    CalibPath("nf4", "NF4_WEIGHT_ONLY_CFG"),
    CalibPath("mxfp6", "MXFP6_DEFAULT_CFG"),
    CalibPath("mxfp8", "MXFP8_DEFAULT_CFG"),
    CalibPath("int4x", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", layouts=(("int4_layout", "xla"),)),
    CalibPath("int8a8", "NVFP4_WEIGHT_ONLY_CFG", layouts=(("nvfp4_layout", "i8"),)),
)
ACC_EVAL_TOKENS = (2, 2, 1024)      # full-width perplexity / KL: batches, B, T
ACC_LAYERWISE_PRESET = "FP8_DEFAULT_CFG"  # max calibration of weights and static inputs
# the calib phase's one-shot max INT4 calibration at 32 layers, 16.2 GB of
# weights resident (H100 80GB HBM3, 700.00 W; PERF.md §5): printed beside
# the layerwise peak
ONE_SHOT_INT4_MAX_PEAK_GB = 17.71
ACC_CLI_TOKENS = 16                 # tokens the CLI's models serve
ACCURACY_KERNELS = ("qmm_w4a8", "qmm_int4_wo", "qmm_fp4_wo", "flash_gqa", "kv_decode_attention")


def _pin(measured: float) -> float:
    return round(max(3.0 * measured, 0.0) + 0.01, 4)


def _mmlu_rows(torch, fwd, data_dir):
    from tensorrt_model_optimizer_tpu_torch.utils import mmlu, synthlang

    return mmlu.mmlu_eval(fwd, synthlang.encode, synthlang.ANSWER_TOKEN_IDS, data_dir, k_shot=3,
                          max_questions_per_subject=ACC_MMLU_N, batch=8)


def _accuracy_anchor(torch, dev) -> list:
    """(a) artifacts/anchor-llama in f32 on the card: the unquantized ppl
    against JAX's record; every preset's Δppl under JAX's pinned budget;
    MMLU choices of the unquantized and ACC_MMLU models, card against CPU;
    the new formats and layouts served against their fake-quant forward.
    Returns the failures."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, config, ptq
    from tensorrt_model_optimizer_tpu_torch.utils import evaluate, synthlang

    import numpy as np

    failures = []
    with open(ACCURACY_RECORD) as f:
        record = json.load(f)
    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    cpu_params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")[1]
    lang = synthlang.SynthLang(0)
    full_eval = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 256, seed=999)]
    ev = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(2, 8, 256, seed=999)]
    calib_np = lang.eval_batches(4, 4, 256, seed=555)
    calib = [torch.from_numpy(b).to(dev) for b in calib_np]
    t0 = time.perf_counter()
    ppl = evaluate.perplexity(cfg, params, full_eval)
    rel = abs(ppl - record["bf16"]["ppl"]) / record["bf16"]["ppl"]
    log(json.dumps({"phase": "accuracy_anchor_ppl", "ppl": ppl, "jax_record": record["bf16"]["ppl"], "rel": rel,
                    "seconds": time.perf_counter() - t0}))
    if not rel <= ACC_BF16_REL:
        failures.append(f"accuracy: the anchor's ppl {ppl} is {rel} from JAX's record {record['bf16']['ppl']}")
    base = evaluate.perplexity(cfg, params, ev)
    rows = []
    for name in config.PRESETS:
        t0 = time.perf_counter()
        qm = ptq.quantize(cfg, params, name, calib, device=dev)
        calib_s = time.perf_counter() - t0
        q = evaluate.perplexity(cfg, qm.params, ev, layout=qm.layout, qstate=qm.qstate, adapters=qm.adapters)
        kl = evaluate.logit_divergence(cfg, qm.params, ev[:1], qm.layout, qm.qstate)
        row = {"preset": name, "ppl": q, "d_ppl": q - base, "pin": _pin(MEASURED_DPPL[name]),
               "jax_record_d_ppl": record["presets"].get(name, {}).get("d_ppl"), "kl_one_batch": kl,
               "calib_s": calib_s}
        rows.append(row)
        if not row["d_ppl"] < row["pin"]:
            failures.append(f"accuracy: {name} d_ppl {row['d_ppl']} over JAX's pin {row['pin']}")
        del qm
    log(json.dumps({"phase": "accuracy_anchor_presets", "base_ppl": base, "rows": rows}))

    data_dir = lang.write_mmlu_data(tempfile.mkdtemp(prefix="chip_smoke_mmlu_"), n_test=ACC_MMLU_N)
    cpu_calib = [torch.from_numpy(b) for b in calib_np]
    for name in (None,) + ACC_MMLU:
        card_m = ptq.quantize(cfg, params, name, calib, device=dev) if name else None
        cpu_m = ptq.quantize(cfg, cpu_params, name, cpu_calib, device="cpu") if name else None

        def fwd(m, p, d):
            return lambda t: (m.forward(torch.from_numpy(t).to(d))[0] if m else
                              llama.forward(cfg, p, torch.from_numpy(t).to(d))[0])

        t0 = time.perf_counter()
        card = _mmlu_rows(torch, fwd(card_m, params, dev), data_dir)
        card_s = time.perf_counter() - t0
        cpu = _mmlu_rows(torch, fwd(cpu_m, cpu_params, "cpu"), data_dir)
        top2 = np.sort(cpu["logits"], axis=-1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) < MMLU_MARGIN
        apart = [i for i, (a, b) in enumerate(zip(card["choices"], cpu["choices"])) if a != b]
        row = {"phase": "accuracy_anchor_mmlu", "model": name or "unquantized", "n": card["n"],
               "accuracy_card": card["accuracy"], "accuracy_cpu": cpu["accuracy"], "card_s": card_s,
               "choices_apart": len(apart), "cpu_margin_under_limit": int(near.sum()),
               "apart_outside_margin": [i for i in apart if not near[i]]}
        log(json.dumps(row))
        if row["apart_outside_margin"]:
            failures.append(f"accuracy: MMLU choices of {row['model']} differ card against CPU at "
                            f"{row['apart_outside_margin']}")
        del card_m, cpu_m

    ab = hf_loader.load_hf_checkpoint(ANCHOR, device=dev)  # bf16, as the engines serve it
    g = torch.Generator(device=dev).manual_seed(6)
    batches = [torch.randint(0, cfg.vocab_size, (2, 128), generator=g, device=dev) for _ in range(4)]
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device=dev)
    for label, preset, layouts in ACC_ANCHOR_SERVED:
        qm = ptq.quantize(ab[0], ab[1], preset, batches, device=dev)
        eng = _engine(torch, compress.compress(qm), 128, dev, kv=None, **dict(layouts))
        served = eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
        gap = statistics.median(_gaps(served, qm.forward(prompt)[0][:, -1])[0])
        log(json.dumps({"phase": "accuracy_anchor_served", "path": label, "preset": preset,
                        "kinds_served": sorted(set(eng.cm.kinds.values())), "engine_vs_fake_quant_median_gap": gap}))
        if not gap <= ENGINE_VS_FAKE_QUANT_MAX:
            failures.append(f"accuracy: the {label} engine lies {gap} (median) from its fake-quant forward, the "
                            f"limit is {ENGINE_VS_FAKE_QUANT_MAX}")
        del qm, eng
    return failures


def _accuracy_full(torch, dev, sz: Sizes) -> tuple:
    """(b) Llama-3.1-8B shapes, seeded random weights: ACC_PATHS calibrated
    and served (`_calib_serve`: TTFT, the graphed steps, kernel against
    plain), with peak memory; perplexity and KL at full width; layerwise
    calibration of 32 layers brought to the card one at a time, its amax
    against the one-shot calibration's on 4 layers. Returns (launch counts,
    failures)."""
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, config, layerwise, ptq
    from tensorrt_model_optimizer_tpu_torch.utils import evaluate

    sync = torch.cuda.synchronize
    cfg32 = llama.LlamaConfig.llama3_8b()
    params32 = llama.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg32.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    n, b, t = CALIB_BATCHES
    gb = torch.Generator(device=dev).manual_seed(4)
    batches = [torch.randint(0, cfg32.vocab_size, (b, t), generator=gb, device=dev) for _ in range(n)]
    launches, failures = {}, []
    for path in ACC_PATHS:
        cfg = dataclasses.replace(cfg32, num_hidden_layers=path.depth)
        params = {**params32, "layers": {k: v[:path.depth] for k, v in params32["layers"].items()}}
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qm = ptq.quantize(cfg, params, path.preset, batches, device=dev)
        sync()
        calib_s = time.perf_counter() - t0
        cm = compress.compress(qm)
        del qm
        row, logits, failed = _calib_serve(torch, dev, sz, path, cm, prompt)
        failures += failed
        for k, v in row.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        log(json.dumps({"phase": "accuracy_full", "path": path.label, "preset": path.preset, "model": "llama3_8b",
                        "layers": path.depth, "calib_s": calib_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "batch": sz.batch, "prompt": sz.prompt, "decode_steps": sz.decode_steps, "unroll": 8, **row}))
        del cm, logits
    del params  # views of the 32 layers
    torch.cuda.empty_cache()

    # perplexity and KL at full width (the values mean nothing on random weights)
    nb, bb, tt = ACC_EVAL_TOKENS
    toks = [torch.randint(0, cfg32.vocab_size, (bb, tt), generator=g, device=dev) for _ in range(nb)]
    qm = ptq.quantize(cfg32, params32, "NF4_WEIGHT_ONLY_CFG", None, device=dev)
    for what, fn in (("perplexity", lambda: evaluate.perplexity(cfg32, qm.params, toks, qm.layout, qm.qstate)),
                     ("logit_divergence", lambda: evaluate.logit_divergence(cfg32, qm.params, toks, qm.layout,
                                                                            qm.qstate))):
        torch.cuda.empty_cache()
        sync()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = fn()
        sync()
        log(json.dumps({"phase": "accuracy_full_eval", "function": what, "preset": "NF4_WEIGHT_ONLY_CFG",
                        "layers": 32, "tokens": list(ACC_EVAL_TOKENS), "value": value,
                        "seconds": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "resident_gb": resident / 1e9}))
        if not math.isfinite(value):
            failures.append(f"accuracy: full-width {what} is {value}")
    del qm

    # layerwise: its amax equal to the one-shot max calibration's on 4 layers
    qcfg = config.get_preset(ACC_LAYERWISE_PRESET)
    cfg4 = dataclasses.replace(cfg32, num_hidden_layers=4)
    p4 = {**params32, "layers": {k: v[:4] for k, v in params32["layers"].items()}}
    one_shot = ptq.quantize(cfg4, p4, qcfg, batches, device=dev).qstate
    lw4 = layerwise.layerwise_calibrate(cfg4, p4, llama.build_layout(cfg4, qcfg), batches)
    apart = [f"{k}.{w}" for k, sub in lw4.items() if isinstance(sub, dict)
             for w, st in sub.items() if not torch.equal(st.amax, one_shot[k][w].amax)]
    apart += [k for k, st in lw4.items() if not isinstance(st, dict) and not torch.equal(st.amax, one_shot[k].amax)]
    del one_shot, lw4, p4
    # 32 layers from host memory, one brought to the card at a time
    host = {k: v.to("cpu").pin_memory() for k, v in params32["layers"].items()}
    lw_params = {k: v for k, v in params32.items() if k != "layers"}
    del params32
    torch.cuda.empty_cache()
    lw_params["layer_loader"] = lambda i: {k: v[i].to(dev, non_blocking=True) for k, v in host.items()}
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lw = layerwise.layerwise_calibrate(cfg32, lw_params, llama.build_layout(cfg32, qcfg), batches)
    sync()
    row = {"phase": "accuracy_layerwise", "preset": ACC_LAYERWISE_PRESET, "layers": 32,
           "calib_batches": list(CALIB_BATCHES), "seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "resident_before_gb": resident / 1e9,
           "one_shot_int4_max_peak_gb": ONE_SHOT_INT4_MAX_PEAK_GB, "amax_sites_apart_from_one_shot_4_layers": apart,
           "amax_finite": all(bool(torch.isfinite(st.amax).all()) for sub in lw.values()
                              for st in (sub.values() if isinstance(sub, dict) else (sub,)))}
    log(json.dumps(row))
    if apart or not row["amax_finite"]:
        failures.append(f"accuracy: layerwise calibration: {row}")
    del lw, host, lw_params
    torch.cuda.empty_cache()
    return launches, failures


def _accuracy_cli(torch, dev) -> tuple:
    """(c) examples/hf_ptq_torch.py on artifacts/anchor-llama: nvfp4_ptq.yaml
    exported into a temporary directory, loaded, held against its `compress`
    model as the checkpoint stores it (as `phase_deploy` holds), served for
    ACC_CLI_TOKENS tokens; w4a8_awq.yaml with --export_path raises as JAX's
    does (INT4 export at the anchor's ragged K = 704, ROADMAP queue 3), and
    its in-memory model serves under int4_layout="a8" against its fake-quant
    forward. Returns (launch counts, failures)."""
    import importlib.util
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.quant import compress
    from tensorrt_model_optimizer_tpu_torch.serve import loader

    spec = importlib.util.spec_from_file_location("hf_ptq_torch", os.path.join(HERE, "examples", "hf_ptq_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    failures, launches = [], {}
    g = torch.Generator(device=dev).manual_seed(8)
    prompt = torch.randint(0, 512, (2, 32), generator=g, device=dev)

    def serve(cm, **layouts):
        _counts(reset=True)
        eng = _engine(torch, cm, 128, dev, **layouts)
        toks = eng.generate_host(prompt, ACC_CLI_TOKENS)
        for k, v in _counts().items():
            launches[k] = launches.get(k, 0) + v
        return toks

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        t0 = time.perf_counter()
        out = cli.main(["--model", ANCHOR, "--recipe", "nvfp4_ptq.yaml", "--export_path", d, "--device", dev.type])
        cli_s = time.perf_counter() - t0
        qm = out.pop("model")
        cm = compress.compress(qm)
        loaded = loader.load_quantized_checkpoint(d, device=dev)
        as_exported, _ = _as_exported(torch, qm, cm, loaded)
        repacked = _deploy_packs(torch, as_exported, loaded)
    equal = _packs_equal(repacked) and not any(repacked[k]["fp16_storage_elements_changed"]
                                               for k in ("embed_tokens", "norm", "lm_head"))
    toks = serve(loaded)
    log(json.dumps({"phase": "accuracy_cli", "recipe": "nvfp4_ptq.yaml", **out, "cli_s": cli_s,
                    "loaded_equals_compress_as_stored": equal, "served_tokens": list(toks.shape)}))
    if not equal or toks.shape != (2, ACC_CLI_TOKENS):
        failures.append(f"accuracy: the CLI's nvfp4_ptq checkpoint loads as {repacked}")
    refused = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        try:
            cli.main(["--model", ANCHOR, "--recipe", "w4a8_awq.yaml", "--export_path", d, "--device", dev.type])
            failures.append("accuracy: the CLI exported W4A8 at the anchor's K = 704, which JAX's export refuses")
        except ValueError as e:
            refused = str(e)
    out = cli.main(["--model", ANCHOR, "--recipe", "w4a8_awq.yaml", "--device", dev.type])
    qm = out.pop("model")
    toks = serve(compress.compress(qm), int4_layout="a8")
    eng = _engine(torch, compress.compress(qm), 128, dev, kv=None, int4_layout="a8")
    served = eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
    gap = statistics.median(_gaps(served, _a8_fake_quant(qm).forward(prompt)[0][:, -1])[0])
    log(json.dumps({"phase": "accuracy_cli", "recipe": "w4a8_awq.yaml", **out, "export_refused": refused,
                    "served_tokens": list(toks.shape), "engine_vs_fake_quant_median_gap": gap}))
    if not gap <= ENGINE_VS_FAKE_QUANT_MAX:
        failures.append(f"accuracy: the CLI's W4A8 model serves {gap} (median) from its fake-quant forward")
    return launches, failures


def phase_accuracy(torch, dev, sz: Sizes) -> dict:
    """(a) `_accuracy_anchor`, (b) `_accuracy_full`, (c) `_accuracy_cli`;
    raises on any failure. Returns the launch counts of the served runs."""
    failures = _accuracy_anchor(torch, dev)
    torch.cuda.empty_cache()
    launches, failed = _accuracy_full(torch, dev, sz)
    failures += failed
    cli_launches, failed = _accuracy_cli(torch, dev)
    failures += failed
    for k, v in cli_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(json.dumps({"phase": "accuracy_launches", **launches}))
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# moe: the routed-expert families (models/mixtral.py) through the engine
# ---------------------------------------------------------------------------

MOE_ANCHOR = os.path.join(HERE, "artifacts", "anchor-moe")
MOE_PPL_PIN = 3.1571           # JAX's tests/test_accuracy_anchor.py: unquantized ppl on eval_batches(4, 8, 128, 999)
MOE_PPL_TOL = 0.05
MOE_NVFP4_DPPL_PIN = 2 * 0.0249 + 0.005  # ... and NVFP4_DEFAULT_CFG's Δppl under calibration eval_batches(2, 8, 128, 555)


@dataclasses.dataclass(frozen=True)
class MoePath:
    """One served MoE path: a preset, the engine's layout fields, the GEMM
    kernel its projections launch, and whether the preset's calibration
    takes batches."""

    label: str
    preset: str
    gemm: str
    layouts: tuple = ()
    calib: bool = False


MOE_ANCHOR_PATHS = (
    MoePath("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    MoePath("nvfp4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo", calib=True),
    MoePath("w4a8", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", (("int4_layout", "a8"),)),
    MoePath("int4_awq", "INT4_AWQ_CFG", "qmm_int4_wo", calib=True),
    # W8A8 attention (`int8_mm`, no kernel of ours); the experts' input is
    # quantized once for the block, so their int8 weights go through the
    # weight-only byte GEMM, as JAX's engine serves them
    MoePath("int8_smoothquant", "INT8_SMOOTHQUANT_CFG", "qmm_byte_wo", calib=True),
)
MOE_DEPLOY = ("int4", "nvfp4")  # export -> load -> serve
# Qwen/Qwen3-30B-A3B's config.json (the public release), cut to MOE_FULL_DEPTH of its 48 layers
QWEN3_30B_A3B = dict(vocab_size=151936, hidden_size=2048, intermediate_size=768, num_hidden_layers=48,
                     num_attention_heads=32, num_key_value_heads=4, head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6,
                     max_position_embeddings=40960, tie_word_embeddings=False, qk_norm=True, num_experts=128,
                     top_k=8, norm_topk_prob=True)
# 2 layers: its graph captures and eager steps take the default run's time
MOE_FULL_DEPTH = 2
MOE_FULL_PATHS = (
    MoePath("w4a8", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", (("int4_layout", "a8"),)),
    MoePath("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    MoePath("nvfp4", "NVFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
)
MOE_EAGER_STEPS = GRAPH_CHECK_STEPS  # eager token steps the graphed ones are held to
MOE_PLAIN_DEPTH = 2            # kernel engine against the all-plain engine: prefill logits at this depth
# ... held to this share of the logits' scale (the median over the batch's
# last positions; the full phase's depth-2 limit), with the plain engine
# routing every token to the experts the kernel engine chose
# (`_pinned_routes`): on random weights a router's top-8 of 128 has near
# ties everywhere, and a bf16 ulp of a GEMM or of flash that moves one sends
# the token to another expert. Unpinned, W4A8 (bit-exact GEMM; its
# flash-only-plain engine equals the all-plain one) read a largest gap of
# 0.217 at depth 2 with 6.5% of the plain engine's choices apart; pinned,
# 0.044, and a median of 0.034 both ways: flash's ulps move codes of the
# per-token int8 activations, which random layers carry to every position.
# Sound runs read 0.024-0.034 (INT4, NVFP4, W4A8); planted kernel faults
# (tools/torch_kernel_mutation_check.sh, `--phases build,moe_full`) read
# 0.668 (W4A8's last 128-block of K on the block before's scales) and 0.742
# (the weight-only tiles' odd columns on the even columns' scales). The
# unpinned gaps and the choices apart are reported.
MOE_PLAIN_MEDIAN_MAX = 5e-2
# Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json), 2 of its 32 layers, INT4 only
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, rope_theta=1e6, rms_norm_eps=1e-5,
                    max_position_embeddings=32768, tie_word_embeddings=False, num_experts=8, top_k=2)
MIXTRAL_DEPTH = 2
MOE_KERNELS = ("qmm_w4a8", "qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo", "flash_gqa", "kv_decode_attention", "paged_attention_decode",
               "paged_attention_prefill_tc", "paged_attention_prefill_cuda_core")


def _dispatch_host(topi, C: int, E: int) -> list:
    """JAX's capacity rule by a host loop: each (token, choice) pair in
    token-major order takes the next place of its expert's queue and is kept
    while that place is < C."""
    used = [0] * E
    keep = []
    for e in topi.reshape(-1).tolist():
        keep.append(used[e] < C)
        used[e] += 1
    return keep


def _moe_dispatch_check(torch, dev, cfg) -> dict:
    """`mixtral.dispatch_combine` against `_dispatch_host`, at the served
    shapes: the prefill (S = 8 x 2048) and a decode step (S = 8), on routing
    of seeded logits, first on the CPU then on the card; the kept pairs must
    be equal."""
    from tensorrt_model_optimizer_tpu_torch.models import mixtral

    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for S in (8, 8 * 2048):
        topw, topi = mixtral.route(cfg, torch.randn((S, cfg.num_experts), generator=g, device=dev))
        C = mixtral.capacity(cfg, S)
        want = _dispatch_host(topi.cpu(), C, cfg.num_experts)
        for where in ("cpu", dev):
            got = mixtral.dispatch_combine(cfg, topw.to(where), topi.to(where), S, C).keep.cpu().tolist()
            if got != want:
                raise AssertionError(f"moe dispatch ({where}) at S = {S}, C = {C}: "
                                     f"{sum(a != b for a, b in zip(got, want))} pairs kept or dropped otherwise than "
                                     "JAX's capacity rule")
        out[S] = {"C": C, "pairs": len(want), "dropped": len(want) - sum(want)}
    return out


def _moe_anchor(torch, dev) -> dict:
    """(a) artifacts/anchor-moe (qwen3_moe, 6 layers, hidden 256, 4 experts,
    top-2) on the card, bf16 as served: each path of MOE_ANCHOR_PATHS
    calibrated by `quantize_family` (max, or its preset's algorithm on the
    batches JAX's pin calibrates on), packed and served by the kernel engine
    (int8 KV, kernel attention) beside the all-plain engine in lock step (4
    prompts of 32 tokens, 16 greedy steps on the kernel engine's tokens):
    the median logits gap at most 1e-2 of their scale and every argmax flip
    at a plain-logit margin <= 1e-2 (the anchor phase's rule), and W4A8
    (bit-exact GEMM) free-running tokens equal (`_hold_to_plain`). INT4
    then serves through `Engine.serve` over int8 pages against the dense
    engine (f32 activations, GEMMs and flash plain, the KV kernels as
    kernels: every served token equal to the dense engine's greedy one; in
    bf16 the paged path rounds q and the context to bf16 where the dense
    one keeps f32, as JAX's does, so there the tokens off the dense
    engine's and their margins are reported). INT4 and NVFP4 go export -> load -> serve: the loaded arrays
    and the prefill logits and tokens equal the engine's over the export's
    tensors held in memory. Last, in f32, the unquantized perplexity and
    NVFP4_DEFAULT_CFG's Δppl against JAX's pins. Returns the launch counts."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, mixtral
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve import loader
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL
    from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request
    from tensorrt_model_optimizer_tpu_torch.utils import evaluate, synthlang

    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    cfg, params = hf_loader.load_hf_moe_checkpoint(MOE_ANCHOR, device=dev)
    lang = synthlang.SynthLang(0)
    calib = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(2, 8, 128, seed=555)]
    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, device=dev)
    models = {}
    for path in MOE_ANCHOR_PATHS:
        qm = ptq.quantize_family("mixtral", cfg, params, path.preset, calib if path.calib else None, device=dev)
        cm = compress.compress(qm)
        layouts = dict(path.layouts)
        ek, ep = _engine(torch, cm, 64, dev, **layouts), _engine(torch, cm, 64, dev, PLAIN_ALL, **layouts)
        _counts(reset=True)
        steps = _lockstep(torch, (ek, ep), prompts, 16)
        n = _counts()
        add(n)
        _hold_to_plain(torch, f"moe anchor {path.label}", ek, ep, prompts, steps, path.gemm == "qmm_w4a8",
                       {"phase": "moe_anchor", "path": path.label, "preset": path.preset,
                        "kinds_served": sorted(set(ek.cm.kinds.values())), "launches": {k: v for k, v in n.items() if v}})
        want = {"flash_gqa", "kv_decode_attention", path.gemm}
        if {k for k, v in n.items() if v} != want:
            raise AssertionError(f"moe anchor {path.label}: launched {n}, the path's kernels are {sorted(want)}")
        models[path.label] = (qm, cm)
        del ek, ep, steps

    # paged serving: 4 requests behind a 16-token shared prefix, prefix cache, unroll 4
    qm, cm = models["int4"]
    cm32 = dataclasses.replace(cm, model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.float32))
    shared = torch.randint(0, cfg.vocab_size, (16,), generator=g, device=dev)
    tails = [torch.randint(0, cfg.vocab_size, (n,), generator=g, device=dev) for n in (24, 40, 72, 9)]
    prompts_p = [torch.cat([shared, t]) for t in tails]
    serve_rows = {}
    for label, model, plain in (("bf16", cm, ()), ("f32", cm32, ("w4a8", "flash", "int4_wo", "fp4_wo", "byte_wo"))):
        eng = _engine(torch, model, 128, dev, plain, paged_attention_kernel=True)
        reqs = [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts_p, (24, 6, 8, 8)))]
        _counts(reset=True)
        outs, m = eng.serve(reqs, prefix_cache=True, unroll=4, collect_metrics=True, **PAGED_ANCHOR)
        n = _counts()
        add(n)
        margins = [_dense_margins(torch, eng, p, outs[i]) for i, p in enumerate(prompts_p)]
        serve_rows[label] = {"metrics": m, "launches": {k: v for k, v in n.items() if v},
                             "tokens_equal_dense_greedy": sum(x == 0 for mg in margins for x in mg),
                             "tokens": sum(len(mg) for mg in margins), "worst_margin": max(max(mg) for mg in margins)}
        if not (n["paged_attention_decode"] and (n["paged_attention_prefill_tc"] or n["paged_attention_prefill_cuda_core"])):
            raise AssertionError(f"moe anchor serve ({label}): the paged kernels did not launch: {n}")
        if [len(outs[r.rid]) for r in reqs] != [r.max_new_tokens for r in reqs]:
            raise AssertionError(f"moe anchor serve ({label}): output lengths {[len(v) for v in outs.values()]}")
        del eng
    log(json.dumps({"phase": "moe_anchor", "path": "serve: int4 + int8 pages", "serve": serve_rows}))
    f32 = serve_rows["f32"]
    if f32["tokens_equal_dense_greedy"] != f32["tokens"]:
        raise AssertionError(f"moe anchor serve: on f32 activations {f32['tokens'] - f32['tokens_equal_dense_greedy']} "
                             f"of {f32['tokens']} served tokens differ from the dense engine's greedy ones (worst "
                             f"margin {f32['worst_margin']} of the logits' scale)")

    # export -> load -> serve
    for label in MOE_DEPLOY:
        qm, cm = models[label]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as d:
            qc = hf_export.export_hf_checkpoint(qm, d)
            with open(os.path.join(d, "config.json")) as f:
                hf_cfg = json.load(f)
            loaded = loader.load_quantized_checkpoint(d, device=dev)
        streamed = loader.compressed_from_export(hf_cfg, qc["quantization"], dict(hf_export._iter_export_tensors(qm)), dev)
        apart = [f"{name}.{k}" for name, arrays in loaded.params["layers"].items() if isinstance(arrays, dict)
                 for k, a in arrays.items() if isinstance(a, torch.Tensor)
                 and not torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                                     streamed.params["layers"][name][k].view(torch.uint8)
                                     if a.element_size() == 1 else streamed.params["layers"][name][k])]
        outs = []
        for model in (loaded, streamed):
            eng = _engine(torch, model, 64, dev)
            _counts(reset=True)
            c = eng.init_cache(4)
            lg = eng.prefill(prompts, c)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            toks = []
            for _ in range(2):
                tok, c = eng.decode_step(tok, c, unroll=8)
                toks.append(tok)
            add(_counts())
            outs.append((lg, torch.cat(toks, dim=1)))
            eng.release_graphs()
            del eng
        equal = bool(torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]))
        mem = _engine(torch, cm, 64, dev)  # compress's own model: the export's fp16 storage and scale ulps apart
        log(json.dumps({"phase": "moe_anchor", "path": f"deploy: {label}", "quant_algo": qc["quantization"]["quant_algo"],
                        "model_type": hf_cfg["model_type"], "kinds_loaded": sorted(set(loaded.kinds.values())),
                        "arrays_apart": apart, "logits_and_tokens_equal": equal,
                        "median_gap_to_compress": statistics.median(
                            _gaps(outs[0][0], mem.prefill(prompts, mem.init_cache(4)))[0])}))
        del mem
        if apart or not equal:
            raise AssertionError(f"moe anchor deploy {label}: loaded arrays apart {apart}, logits/tokens equal {equal}")
    del models

    # perplexity in f32 against JAX's pin
    cfg32, p32 = hf_loader.load_hf_moe_checkpoint(MOE_ANCHOR, dtype=torch.float32, device=dev)
    ev = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 128, seed=999)]
    calib32 = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(2, 8, 128, seed=555)]
    base = evaluate.perplexity(cfg32, p32, ev, forward_fn=mixtral.forward)
    qm = ptq.quantize_family("mixtral", cfg32, p32, "NVFP4_DEFAULT_CFG", calib32, device=dev)
    nv = evaluate.perplexity(cfg32, qm.params, ev, layout=qm.layout, qstate=qm.qstate, forward_fn=mixtral.forward)
    log(json.dumps({"phase": "moe_anchor", "path": "ppl", "unquantized_ppl": base, "jax_pin": MOE_PPL_PIN,
                    "nvfp4_ppl": nv, "nvfp4_d_ppl": nv - base, "nvfp4_d_ppl_pin": MOE_NVFP4_DPPL_PIN}))
    if not abs(base - MOE_PPL_PIN) < MOE_PPL_TOL:
        raise AssertionError(f"moe anchor: unquantized ppl {base}, JAX's pin {MOE_PPL_PIN} +- {MOE_PPL_TOL}")
    if not nv - base < MOE_NVFP4_DPPL_PIN:
        raise AssertionError(f"moe anchor: NVFP4 d_ppl {nv - base} over JAX's pin {MOE_NVFP4_DPPL_PIN}")
    return launches


class _pinned_routes:
    """`module.route` (`models.mixtral`'s unless another model module is
    given: `models.deepseek`'s takes the bias too) recording each call's
    expert choices (`record`), then handing them back in the same order
    (`replay`) with the weights the module's `route_weights` gives those
    experts on the replaying engine's own logits; `apart` counts the
    choices the replaying engine's own routing would have made otherwise.
    Restores the route on exit."""

    def __init__(self, module=None):
        from tensorrt_model_optimizer_tpu_torch.models import mixtral

        self.module = module or mixtral
        self.real = self.module.route
        self.choices, self.apart = [], 0

    def record(self):
        def route(cfg, logits, *rest):
            w, i = self.real(cfg, logits, *rest)
            self.choices.append(i)
            return w, i
        self.module.route = route
        return self

    def replay(self):
        def route(cfg, logits, *rest):
            i = self.choices.pop(0)
            self.apart += int((self.real(cfg, logits, *rest)[1] != i).sum())
            return self.module.route_weights(cfg, logits, i), i
        self.module.route = route
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.module.route = self.real


def _moe_full_path(torch, dev, sz: Sizes, path: MoePath, cfg, params, prompt, model: str) -> dict:
    """One path at full width: quantize_family (max) -> compress -> the
    kernel engine (int8 KV, kernel attention): TTFT of the 8 x 2048 prefill,
    MOE_EAGER_STEPS eager token steps, the graphed steps held to them
    (`_graphed_decode`, the full phase's; the eager step profiled, the
    replays timed, not profiled: the moe budget), one more prefill profiled
    (device time, idle share, kernels), peak memory, the
    launches per kernel of the prefill and of one token step,
    and the prefill logits against the all-plain engine at MOE_PLAIN_DEPTH
    layers on the kernel engine's routing (`_pinned_routes`; W4A8: the
    engine with only flash on its plain version equals the all-plain one).
    Returns the launch counts."""
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    sync = torch.cuda.synchronize
    layouts = dict(path.layouts)
    t0 = time.perf_counter()
    cm = compress.compress(ptq.quantize_family("mixtral", cfg, params, path.preset, device=dev))
    eng = _engine(torch, cm, sz.max_seq, dev, **layouts)
    del cm
    torch.cuda.empty_cache()
    sync()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    cache = eng.init_cache(sz.batch)
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _counts()
    tok0 = tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    start = _clone_cache(cache)
    step_ms, toks = [], []
    _counts(reset=True)
    for _ in range(MOE_EAGER_STEPS):
        t0 = time.perf_counter()
        tok, step_logits = _eager_step(torch, eng, tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    step_launches = {k: v // MOE_EAGER_STEPS for k, v in _counts().items() if v}
    pre = _profile(torch, f"{model} {path.label} prefill", lambda: eng.prefill(prompt, eng.init_cache(sz.batch)), 1,
                   ttft_ms)
    graphs = _graphed_decode(torch, eng, f"{model} {path.label}", tok0, start, toks, cache, statistics.median(step_ms),
                             profile_unrolls=False)
    eager = graphs.pop("eager")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: n + prefill_launches[k] for k, n in _counts().items()}
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    eng.release_graphs()
    del cache, start
    L = cfg.num_hidden_layers
    gemm = path.gemm
    row = {"phase": "moe_full", "model": model, "path": path.label, "kinds": sorted(set(eng.cm.kinds.values())),
           "layers": L, "experts": cfg.num_experts, "top_k": cfg.top_k, "batch": sz.batch, "prompt": sz.prompt,
           "setup_s": setup_s, "ttft_ms": ttft_ms, "eager_ms_per_token_step": statistics.median(step_ms),
           "graphs": graphs, "peak_mem_gb": peak_gb, "packed_weight_gb": eng.cm.packed_bytes / 1e9,
           "prefill_launches": {k: v for k, v in prefill_launches.items() if v}, "token_step_launches": step_launches,
           "gemm_launches_per_layer_prefill": prefill_launches[gemm] / L,
           "gemm_launches_per_layer_token_step": step_launches.get(gemm, 0) / L,
           "prefill_device_ms": pre["per_call_device_busy_ms"], "prefill_idle_share": pre["device_idle_share"],
           "eager_step_device_ms": eager["device_ms_per_token_step"], "eager_step_idle_share": eager["device_idle_share"],
           "eager_step_kernels": eager["kernels_per_token_step"], "logits_finite": finite}
    if not finite:
        raise AssertionError(f"moe {model} {path.label}: non-finite logits")
    want = {gemm, "kv_decode_attention", "flash_gqa"}
    if {k for k, n in launches.items() if n > 0} != want:
        raise AssertionError(f"moe {model} {path.label}: launched {launches}, the path's kernels are {sorted(want)}")
    depth = min(MOE_PLAIN_DEPTH, L)
    subcm = _truncate(eng.cm, depth)

    def run(plain):
        e = _engine(torch, subcm, sz.max_seq, dev, plain, **layouts)
        return e.prefill(prompt, _cache(e, depth, sz))

    with _pinned_routes() as pins:
        pins.record()
        out = run(())
        pins.replay()
        pinned = run(PLAIN_ALL)
    ref = run(PLAIN_ALL)
    gaps, unpinned = _gaps(out, pinned)[0], _gaps(out, ref)[0]
    row.update(depth=depth, prefill_logits_median_gap_vs_plain_pinned=statistics.median(gaps),
               prefill_logits_worst_gap_vs_plain_pinned=max(gaps), routing_choices_apart=pins.apart,
               prefill_logits_median_gap_vs_plain=statistics.median(unpinned),
               prefill_logits_worst_gap_vs_plain=max(unpinned),
               argmax_agree_vs_plain=float((out.argmax(-1) == ref.argmax(-1)).float().mean()))
    if gemm == "qmm_w4a8":
        row["flash_plain_equals_plain"] = bool(torch.equal(run(("flash",)), ref))
    log(json.dumps(row))
    if not row["prefill_logits_median_gap_vs_plain_pinned"] <= MOE_PLAIN_MEDIAN_MAX:
        raise AssertionError(f"moe {model} {path.label}: depth-{depth} prefill logits lie "
                             f"{row['prefill_logits_median_gap_vs_plain_pinned']} (median) of their scale from the "
                             f"plain engine's on the same routing, the limit is {MOE_PLAIN_MEDIAN_MAX}")
    if gemm == "qmm_w4a8" and not row["flash_plain_equals_plain"]:
        raise AssertionError(f"moe {model} w4a8: with only flash plain, the logits differ from plain")
    del eng, out, ref, subcm
    torch.cuda.empty_cache()
    return launches


def phase_moe(torch, dev, sz: Sizes, anchor: bool = True) -> dict:
    """(a) `_moe_anchor`; (b) Qwen3-30B-A3B at full width on MOE_FULL_DEPTH
    layers (seeded random bf16 weights made on the card; all 48 would take
    61 GB in bf16 before compress doubles them): W4A8, INT4 and NVFP4 through
    `_moe_full_path`; (c) Mixtral-8x7B's widths on MIXTRAL_DEPTH layers,
    INT4 (8 experts, top-2: C = 8192 at the prefill; no q/k norms). The
    dispatch is first held to JAX's capacity rule at both models' shapes
    (`_moe_dispatch_check`). `anchor=False` (`--phases build,moe_full`)
    leaves (a) out. Returns the launch counts of all its runs."""
    from tensorrt_model_optimizer_tpu_torch.models import mixtral

    runs = (("qwen3_30b_a3b", QWEN3_30B_A3B, MOE_FULL_DEPTH, MOE_FULL_PATHS),
            ("mixtral_8x7b", MIXTRAL_8X7B, MIXTRAL_DEPTH, MOE_FULL_PATHS[1:2]))
    for model, spec, depth, _ in runs:
        cfg = mixtral.MixtralConfig(**{**spec, "num_hidden_layers": depth})
        log(json.dumps({"phase": "moe_full", "model": model, "dispatch_vs_host_rule": _moe_dispatch_check(torch, dev, cfg)}))
    launches = dict(_moe_anchor(torch, dev)) if anchor else {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    g = torch.Generator(device=dev).manual_seed(2)
    for model, spec, depth, paths in runs:
        cfg = mixtral.MixtralConfig(**{**spec, "num_hidden_layers": depth})
        t0 = time.perf_counter()
        params = mixtral.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        log(json.dumps({"phase": "moe_full", "model": model, "layers": depth, "init_params_s": time.perf_counter() - t0,
                        "weights_gb": sum(v.numel() * v.element_size() for v in params["layers"].values()) / 1e9}))
        prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
        for path in paths:
            add(_moe_full_path(torch, dev, sz, path, cfg, params, prompt, model))
        del params
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# families: GPT-OSS and Llama4 (models/gpt_oss.py, models/llama4.py) on the
# einsum engine, the one engine JAX serves them on
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FamilyPath:
    """One served path of a family: a preset, the engine's layout fields, the
    GEMM kernel its projections and experts launch, and whether the preset's
    calibration takes batches."""

    label: str
    family: str          # "gpt_oss" | "llama4"
    preset: str
    gemm: str
    layouts: tuple = ()
    calib: bool = False


# (a) the small configs of JAX's TestGptOssServing / TestLlama4Serving
# (tests/test_compress_serve.py) at hidden 256, head_dim 64, 4 layers, in bf16
FAMILY_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=256, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=64, num_experts=4, capacity_factor=4.0,
                    max_position_embeddings=4096)
FAMILY_SMALL_EXTRA = {"gpt_oss": dict(top_k=2, sliding_window=8),
                      "llama4": dict(top_k=1, attention_chunk_size=8, floor_scale=8.0)}
FAMILY_SMALL_PATHS = (
    FamilyPath("gpt_oss mxfp4", "gpt_oss", "MXFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    FamilyPath("gpt_oss nvfp4", "gpt_oss", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo", calib=True),
    FamilyPath("llama4 nvfp4", "llama4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo", calib=True),
    FamilyPath("llama4 w4a8", "llama4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", (("int4_layout", "a8"),)),
)
FAMILY_PROMPT = (4, 32)   # (a): prompts (past the window, the chunk and floor_scale) ...
FAMILY_STEPS = 8          # ... and greedy steps
# (a): the f32 engine on every kernel's plain version against the quantized
# model's own forward (f32 fake-quant, its own masks, sinks and rope): the
# median logits gap over prefill and decode positions, as a share of the
# logits' scale. Sums in another order give ~1e-6; the window on every
# layer, or the sinks left out of the engine's softmax, move every row.
FAMILY_VS_FORWARD_MAX = 1e-3
# (b) openai/gpt-oss-20b's config.json (the public release), seeded random bf16 weights
GPT_OSS_20B = dict(vocab_size=201088, hidden_size=2880, intermediate_size=2880, num_hidden_layers=24,
                   num_attention_heads=64, num_key_value_heads=8, head_dim=64, rope_theta=150000.0,
                   rms_norm_eps=1e-5, max_position_embeddings=131072, tie_word_embeddings=False, num_experts=32,
                   top_k=4, sliding_window=128, swiglu_limit=7.0, attention_bias=True)
GPT_OSS_YARN = dict(rope_type="yarn", factor=32.0, original_max_position_embeddings=4096, beta_fast=32.0,
                    beta_slow=1.0, truncate=False)
# 2 of its 24 layers (a sliding-window layer and a full one): the default
# run's time (at 8, with the train phase, it read 1107 s on one host and
# 1250 s on a slower one; the run with prune at 4 overran 1200 s)
GPT_OSS_DEPTH = 2
GPT_OSS_PATHS = (
    FamilyPath("mxfp4", "gpt_oss", "MXFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    FamilyPath("nvfp4", "gpt_oss", "NVFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    FamilyPath("int4", "gpt_oss", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
)
# (c) meta-llama/Llama-4-Scout-17B-16E's text_config (the public release), 4 of its 48 layers
LLAMA4_SCOUT = dict(vocab_size=202048, hidden_size=5120, intermediate_size=8192, num_hidden_layers=48,
                    num_attention_heads=40, num_key_value_heads=8, head_dim=128, rope_theta=500000.0,
                    rms_norm_eps=1e-5, max_position_embeddings=10485760, tie_word_embeddings=False, num_experts=16,
                    top_k=1, attention_chunk_size=8192, attn_temperature_tuning=True, attn_scale=0.1,
                    floor_scale=8192.0, use_qk_norm=True, no_rope_layer_interval=4)
SCOUT_ROPE = dict(rope_type="llama3", factor=16.0, low_freq_factor=1.0, high_freq_factor=1.0,
                  original_max_position_embeddings=8192)
SCOUT_DEPTH = 4      # layer 3 is its first nope layer
SCOUT_PATHS = (
    FamilyPath("nvfp4", "llama4", "NVFP4_WEIGHT_ONLY_CFG", "qmm_fp4_wo"),
    FamilyPath("w4a8", "llama4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_w4a8", (("int4_layout", "a8"),)),
)
FAMILY_PLAIN_DEPTH = 2   # full width: kernel engine against the all-plain engine at this depth ...
FAMILY_PLAIN_MEDIAN_MAX = 5e-2  # ... on pinned routing (the moe phase's rule and limit)
# Scout: one batch-1 prompt and decode steps past position 8192, where the
# rope layers' second chunk starts and the nope layer (layer 3) scales q by
# its temperature, 1.069: the kernel engine against the all-plain engine on
# pinned routing at all SCOUT_DEPTH layers, so the GEMMs after the nope
# layer's tempered attention are held too. Both engines share the masks and
# the temperature (plain PyTorch): the small configs hold those against the
# model's own forward (chunk 8, floor_scale 8), the CPU tests against JAX.
SCOUT_LONG = (8448, 4)
# ... held to this median share of the logits' scale, 1.5 times the sound
# NVFP4 reading as FAMILY_PLAIN_MEDIAN_MAX is of the moe phase's: NVFP4 reads
# 0.049 at 4 layers (0.022 at 2: the gap grows with random layers), W4A8 0
# (bit-exact GEMM). Planted faults (tools/torch_kernel_mutation_check.sh,
# `--phases build,families_full`) read 0.655 (NVFP4's last 32-chunk of K on
# the chunk before's scales) and 0.672 (W4A8's last 128-block on the block
# before's).
FAMILY_LONG_MEDIAN_MAX = 0.075
FAMILY_KERNELS = ("qmm_fp4_wo", "qmm_int4_wo", "qmm_w4a8")


def _graph_rows(prompt: int, steps: int) -> int:
    """Cache rows `_graphed_decode` needs after a prompt: its checked steps,
    then as many timed ones and 4 calls of the largest unroll."""
    return prompt + 2 * steps + 4 * max(GRAPH_UNROLLS)


def _family_cfg(family: str, spec: dict, dtype, **kw):
    from tensorrt_model_optimizer_tpu_torch.models import gpt_oss, llama, llama4

    spec = {**spec, **kw, "dtype": dtype}
    rs = spec.pop("rope_scaling", None)
    cls = gpt_oss.GptOssConfig if family == "gpt_oss" else llama4.Llama4Config
    return cls(**spec, rope_scaling=rs and llama.RopeScaling(**rs))


def _family_params(torch, dev, cfg, seed: int) -> dict:
    """Seeded random weights made on the card; GPT-OSS's sinks N(0, 1) (its
    init's zeros would leave the sink path idle)."""
    from tensorrt_model_optimizer_tpu_torch.models import registry

    fam = "gpt_oss" if hasattr(cfg, "sliding_window") else "llama4"
    g = torch.Generator(device=dev).manual_seed(seed)
    params = registry.get(fam).init_params(cfg, g, device=dev)
    if "self_attn.sinks" in params["layers"]:
        s = params["layers"]["self_attn.sinks"]
        params["layers"]["self_attn.sinks"] = torch.randn(s.shape, generator=g, device=dev).to(s.dtype)
    return params


def _einsum_engine(torch, cm, max_seq: int, dev, plain: tuple = (), **fields):
    return _engine(torch, cm, max_seq, dev, plain, kv_attention_kernel=False, **fields)


def _vs_forward(torch, dev, label: str, qm, cm, prompts, steps: int) -> dict:
    """The engine in f32 on every kernel's plain version, over an f32 cache,
    against the quantized model's forward (f32), both with the input
    quantizers off, weight-only layouts and f32 weights and scales (dynamic
    NVFP4 activations carry last-bit differences to other codes and to
    other experts; W4A8's int8 activations are the engine's alone; a bf16
    weight or scale rounds the fake-quantized values): the prompts'
    prefill and `steps` decode steps on the forward's own greedy tokens,
    every position's logits against the forward's over the whole
    sequence."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    f32 = dataclasses.replace(cm.model_cfg, dtype=torch.float32)
    cm32 = dataclasses.replace(_without_input_quantizers(cm), model_cfg=f32)
    # f32 weights too: the fake-quantized NVFP4 values (global scale any f32) round to the weights' dtype
    p32 = {k: ({n: t.float() for n, t in v.items()} if k == "layers" else v.float()) for k, v in qm.params.items()}
    qm32 = dataclasses.replace(qm, model_cfg=f32, layout=cm32.layout, params=p32)
    seq = prompts
    for _ in range(steps):
        nxt = qm32.forward(seq)[0][:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    ref = qm32.forward(seq)[0]
    # the forward's f32 k/v; INT4's f32 block scales ("blockdot": the other names round them to bf16)
    eng = _einsum_engine(torch, cm32, prompts.shape[1] + steps, dev, PLAIN_ALL, kv=None, int4_layout="blockdot")
    cache = eng.init_cache(prompts.shape[0])
    got = [eng.prefill(prompts, cache)]
    for t in range(prompts.shape[1], seq.shape[1] - 1):
        got.append(eng._model_step(seq[:, t:t + 1].to(torch.int32), cache))
    gaps = []
    for j, lg in enumerate(got):
        gaps += _gaps(lg, ref[:, prompts.shape[1] - 1 + j])[0]
    out = {"engine_f32_plain_vs_forward_median_gap": statistics.median(gaps), "worst": max(gaps)}
    if not out["engine_f32_plain_vs_forward_median_gap"] <= FAMILY_VS_FORWARD_MAX:
        raise AssertionError(f"families {label}: the f32 engine lies {statistics.median(gaps)} (median) of the "
                             f"logits' scale from the model's forward, the limit is {FAMILY_VS_FORWARD_MAX}")
    return out


def _family_refusals(torch, dev, cm) -> list:
    """Every refusal of the family: the kernel engine, a sparse prefill and
    paged serving raise NotImplementedError. Returns what each said."""
    said = []
    for what, fn in (("kv_attention_kernel", lambda: _engine(torch, cm, 64, dev)),
                     ("attn_sparsity", lambda: _einsum_engine(torch, cm, 64, dev, attn_sparsity=0.5)),
                     ("serve", lambda: _einsum_engine(torch, cm, 64, dev).serve([], n_pages=8, page_size=8,
                                                                                max_slots=1, max_pages_per_seq=4))):
        try:
            fn()
        except NotImplementedError as e:
            said.append(str(e)[:80])
            continue
        raise AssertionError(f"families: {what} did not refuse {type(cm.model_cfg).__name__}")
    return said


def _sink_softmax_check(torch, dev) -> float:
    """`llama.sink_softmax` on the card against the reference's formula (the
    sink column concatenated, softmax, the column dropped) on masked scores;
    returns the largest difference (f32 ulps of the probabilities)."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    g = torch.Generator(device=dev).manual_seed(21)
    scores = torch.randn((2, 8, 33, 70), generator=g, device=dev) * 4
    scores[..., 50:] = -1e9
    sinks = torch.randn((8,), generator=g, device=dev)
    col = sinks[None, :, None, None].expand(2, 8, 33, 1)
    want = torch.softmax(torch.cat([scores, col], dim=-1), dim=-1)[..., :-1]
    err = float((llama.sink_softmax(scores.clone(), sinks, torch.float32) - want).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"families: sink_softmax lies {err} from the concatenated softmax")
    return err


def _families_small(torch, dev) -> dict:
    """(a) Each path of FAMILY_SMALL_PATHS on its family's small config, bf16,
    seeded random weights (GPT-OSS's sinks N(0, 1)): `quantize_family`,
    compress, the einsum engine (int8 KV) in lock step with the all-plain
    engine over FAMILY_PROMPT prompts and FAMILY_STEPS steps (the anchor
    phase's margin rule, W4A8 tokens equal), the graphed decode (unroll 1 and
    8, GRAPH_CHECK_STEPS) bit-equal to the eager steps, the f32 plain engine against the model's
    forward (`_vs_forward`), every refusal; GPT-OSS's deploy loop (MXFP4
    export -> `load_hf_moe_checkpoint` -> `quantize_family` -> compress ->
    serve: logits and tokens equal to the engine's over the export's tensors
    held in memory, the packs equal to compress's of the in-memory model).
    Returns the launch counts."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    log(json.dumps({"phase": "families_small", "sink_softmax_vs_concatenated_max_err": _sink_softmax_check(torch, dev)}))
    g = torch.Generator(device=dev).manual_seed(3)
    B, T = FAMILY_PROMPT
    prompts = torch.randint(0, FAMILY_SMALL["vocab_size"], (B, T), generator=g, device=dev)
    calib = [torch.randint(0, FAMILY_SMALL["vocab_size"], (2, 64), generator=g, device=dev)]
    models, quantized = {}, {}
    for path in FAMILY_SMALL_PATHS:
        t_path = time.perf_counter()
        if path.family not in models:
            cfg = _family_cfg(path.family, FAMILY_SMALL, torch.bfloat16, **FAMILY_SMALL_EXTRA[path.family])
            models[path.family] = (cfg, _family_params(torch, dev, cfg, 5))
        cfg, params = models[path.family]
        qm = ptq.quantize_family(path.family, cfg, params, path.preset, calib if path.calib else None, device=dev)
        cm = compress.compress(qm)
        quantized[path.label] = (qm, cm)
        layouts = dict(path.layouts)
        ek = _einsum_engine(torch, cm, _graph_rows(T, GRAPH_CHECK_STEPS), dev, **layouts)
        ep = _einsum_engine(torch, cm, T + FAMILY_STEPS, dev, PLAIN_ALL, **layouts)
        _counts(reset=True)
        steps = _lockstep(torch, (ek, ep), prompts, FAMILY_STEPS)
        n = _counts()
        add(n)
        row = {"phase": "families_small", "path": path.label, "preset": path.preset,
               "kinds_served": sorted(set(ek.cm.kinds.values())), "launches": {k: v for k, v in n.items() if v}}
        if {k for k, v in n.items() if v} != {path.gemm}:
            raise AssertionError(f"families {path.label}: launched {n}, the path's kernel is {path.gemm}")
        row.update(_vs_forward(torch, dev, path.label, qm, cm, prompts, 8))
        row["refusals"] = _family_refusals(torch, dev, cm)
        _hold_to_plain(torch, f"families {path.label}", ek, ep, prompts, steps, path.gemm == "qmm_w4a8", row)
        # the graphed decode from the prefill's cache, against eager steps
        cache = ek.init_cache(B)
        tok0 = tok = torch.argmax(ek.prefill(prompts, cache), dim=-1).to(torch.int32)[:, None]
        start, toks, walls = _clone_cache(cache), [], []
        _counts(reset=True)
        for _ in range(GRAPH_CHECK_STEPS):
            t0 = time.perf_counter()
            tok, _ = _eager_step(torch, ek, tok, cache)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
        _graphed_decode(torch, ek, f"families {path.label}", tok0, start, toks, cache, statistics.median(walls),
                        profile_unrolls=False)
        add(_counts())
        ek.release_graphs()
        del ek, ep, steps, cache, start
        log(json.dumps({"phase": "families_small", "path": path.label, "seconds": time.perf_counter() - t_path}))

    # GPT-OSS's deploy loop on its native MXFP4 format
    qm, cm = quantized["gpt_oss mxfp4"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gpt_oss_") as d:
        t0 = time.perf_counter()
        hf_export.export_hf_checkpoint(qm, d)
        export_s = time.perf_counter() - t0
        with open(os.path.join(d, "config.json")) as f:
            cfg_d = json.load(f)
        t0 = time.perf_counter()
        loaded = hf_loader.load_hf_moe_checkpoint(d, device=dev)
        load_s = time.perf_counter() - t0
    in_memory = hf_loader.gpt_oss_from_tensors(cfg_d, dict(hf_export._iter_gpt_oss_tensors(qm)), device=dev)
    outs, packs = [], []
    for cfg, params in (loaded, in_memory):
        cm2 = compress.compress(ptq.quantize_family("gpt_oss", cfg, params, "MXFP4_WEIGHT_ONLY_CFG", device=dev))
        eng = _einsum_engine(torch, cm2, T + 16, dev)  # 2 calls of decode_step(unroll=8)
        _counts(reset=True)
        c = eng.init_cache(B)
        lg = eng.prefill(prompts, c)
        tok, toks = torch.argmax(lg, dim=-1).to(torch.int32)[:, None], []
        for _ in range(2):
            tok, c = eng.decode_step(tok, c, unroll=8)
            toks.append(tok)
        add(_counts())
        outs.append((lg, torch.cat(toks, dim=1)))
        packs.append(cm2)
        eng.release_graphs()
        del eng
    equal = bool(torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]))
    apart = [f"{name}.{k}" for name in cm.kinds for k, a in cm.params["layers"][name].items()
             if isinstance(a, torch.Tensor) and not torch.equal(_bits(torch, a), _bits(torch, packs[0].params["layers"][name][k]))]
    mem = _einsum_engine(torch, cm, T + FAMILY_STEPS, dev)
    log(json.dumps({"phase": "families_small", "path": "gpt_oss deploy: mxfp4", "export_s": export_s, "load_s": load_s,
                    "model_type": cfg_d["model_type"], "logits_and_tokens_equal_in_memory_export": equal,
                    "packs_apart_from_compress": apart, "median_gap_to_compress": statistics.median(
                        _gaps(outs[0][0], mem.prefill(prompts, mem.init_cache(B)))[0])}))
    if not equal or apart:
        raise AssertionError(f"families gpt_oss deploy: logits/tokens equal {equal}, packs apart {apart}")
    return launches


def _bits(torch, t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _pinned_pair(torch, make, prompt, steps: int, cache_of, module=None) -> dict:
    """The kernel engine `make(())` on its greedy tokens (prefill, then
    steps - 1 decode steps) with its expert choices recorded, then the
    all-plain engine `make(PLAIN_ALL)` on the same tokens replaying them
    (`_pinned_routes(module)`): each step's logits gaps, the choices the
    plain engine's own routing would have made otherwise, the kernel
    engine's prefill wall time and whether its logits are finite."""
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    with _pinned_routes(module) as pins:
        pins.record()
        ek = make(())
        c = cache_of(ek)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, toks = [ek.prefill(prompt, c)], []
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(steps - 1):
            toks.append(torch.argmax(got[-1], dim=-1).to(torch.int32)[:, None])
            got.append(ek._model_step(toks[-1], c))
        del ek, c
        pins.replay()
        ep = make(PLAIN_ALL)
        c = cache_of(ep)
        ref = [ep.prefill(prompt, c)] + [ep._model_step(t, c) for t in toks]
        del ep, c
    gaps = [x for lg, r in zip(got, ref) for x in _gaps(lg, r)[0]]
    return {"median_gap_vs_plain_pinned": statistics.median(gaps), "worst_gap_vs_plain_pinned": max(gaps),
            "routing_choices_apart": pins.apart, "steps": steps, "kernel_prefill_ms": prefill_ms,
            "kernel_logits_finite": bool(all(torch.isfinite(x).all() for x in got))}


def _family_full_path(torch, dev, sz: Sizes, path: FamilyPath, cfg, prompt, model: str, profile: bool) -> dict:
    """One path at full width: seeded random bf16 weights made on the card,
    `quantize_family` (max), compress (the raw weights then dropped), the
    einsum engine (int8 KV): TTFT of the batch's prefill, sz.decode_steps
    eager token steps, the graphed steps held to them (`_graphed_decode`,
    unroll 1 and 8), peak memory (set-up and serving), launches per kernel
    of the prefill and of one token step, the prefill against the all-plain
    engine at FAMILY_PLAIN_DEPTH layers on the kernel engine's routing
    (`_pinned_pair`), and with `profile` one prefill and two eager steps
    under the profiler (the families phase's budget: the first path of each
    model).
    Scout's paths then serve SCOUT_LONG's prompt on all layers, kernel
    against plain on pinned routing (FAMILY_LONG_MEDIAN_MAX), with the
    kernel engine's TTFT and its logits finite. Returns the launch counts."""
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq

    sync = torch.cuda.synchronize
    layouts = dict(path.layouts)
    secs, t_part = {}, time.perf_counter()

    def lap(name):
        nonlocal t_part
        sync()
        secs[name] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    params = _family_params(torch, dev, cfg, 0)
    cm = compress.compress(ptq.quantize_family(path.family, cfg, params, path.preset, device=dev))
    del params
    torch.cuda.empty_cache()
    lap("setup")
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    max_seq = _graph_rows(prompt.shape[1], sz.decode_steps)
    eng = _einsum_engine(torch, cm, max_seq, dev, **layouts)
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    cache = eng.init_cache(prompt.shape[0])
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _counts()
    tok0 = tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    start = _clone_cache(cache)
    step_ms, toks = [], []
    _counts(reset=True)
    lap("prefill")
    for _ in range(sz.decode_steps):
        t0 = time.perf_counter()
        tok, step_logits = _eager_step(torch, eng, tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    step_launches = {k: v // sz.decode_steps for k, v in _counts().items() if v}
    lap("eager_steps")
    graphs = _graphed_decode(torch, eng, f"{model} {path.label}", tok0, start, toks, cache, statistics.median(step_ms),
                             profile_unrolls=False, profile_eager=profile)
    eager = graphs.pop("eager")
    lap("graphs")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: n + prefill_launches[k] for k, n in _counts().items()}
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    eng.release_graphs()
    del cache, start
    L, gemm = cfg.num_hidden_layers, path.gemm
    row = {"phase": "families_full", "model": model, "path": path.label, "kinds": sorted(set(eng.cm.kinds.values())),
           "layers": L, "batch": prompt.shape[0], "prompt": prompt.shape[1], "setup_peak_mem_gb": setup_peak,
           "ttft_ms": ttft_ms, "eager_ms_per_token_step": statistics.median(step_ms), "graphs": graphs,
           "peak_mem_gb": peak_gb, "packed_weight_gb": eng.cm.packed_bytes / 1e9,
           "prefill_launches": {k: v for k, v in prefill_launches.items() if v}, "token_step_launches": step_launches,
           "eager_step_device_ms": eager["device_ms_per_token_step"], "eager_step_idle_share": eager["device_idle_share"],
           "eager_step_kernels": eager["kernels_per_token_step"], "logits_finite": finite}
    if profile:
        pre = _profile(torch, f"{model} {path.label} prefill",
                       lambda: eng.prefill(prompt, eng.init_cache(prompt.shape[0])), 1, ttft_ms)
        row.update(prefill_device_ms=pre["per_call_device_busy_ms"], prefill_idle_share=pre["device_idle_share"],
                   prefill_top_kernels=pre["top"][:6])
        lap("profile")
    if not finite:
        raise AssertionError(f"families {model} {path.label}: non-finite logits")
    if {k for k, n in launches.items() if n > 0} != {gemm}:
        raise AssertionError(f"families {model} {path.label}: launched {launches}, the path's kernel is {gemm}")
    depth = min(FAMILY_PLAIN_DEPTH, L)
    served = eng.cm
    subcm = _truncate(served, depth)
    del eng, logits, cm
    torch.cuda.empty_cache()
    row.update(depth=depth, **_pinned_pair(torch, lambda plain: _einsum_engine(torch, subcm, max_seq, dev, plain, **layouts),
                                           prompt, 1, lambda e: _cache(e, depth, sz)))
    lap("vs_plain")
    del subcm
    checks = [("depth-%d prefill" % depth, row["median_gap_vs_plain_pinned"], FAMILY_PLAIN_MEDIAN_MAX)]
    if model == "llama4_scout":  # positions past 8192: the second chunk, the nope layer's temperature 1.069
        T, steps = SCOUT_LONG
        long = torch.randint(0, cfg.vocab_size, (1, T), generator=torch.Generator(device=dev).manual_seed(4),
                             device=dev)
        held = _pinned_pair(torch, lambda plain: _einsum_engine(torch, served, T + steps, dev, plain, **layouts),
                            long, steps, lambda e: e.init_cache(1))
        row["long_prompt"] = {"tokens": T, "decode_steps": steps, "layers": L, "ttft_ms": held.pop("kernel_prefill_ms"),
                              "logits_finite": held.pop("kernel_logits_finite"), **held}
        lap("long_prompt")
        checks.append((f"all-layer {T}-token prompt", held["median_gap_vs_plain_pinned"], FAMILY_LONG_MEDIAN_MAX))
    row["seconds"] = secs
    log(json.dumps(row))
    if not row.get("long_prompt", {}).get("logits_finite", True):
        raise AssertionError(f"families {model} {path.label}: the {SCOUT_LONG[0]}-token prompt gives non-finite logits")
    over = [f"the {what}'s logits lie {gap} (median) of their scale from the plain engine's on the same routing, "
            f"the limit is {limit}" for what, gap, limit in checks if not gap <= limit]
    if over:
        raise AssertionError(f"families {model} {path.label}: " + "; ".join(over))
    del served
    torch.cuda.empty_cache()
    return launches


def _families_full(torch, dev, sz: Sizes) -> dict:
    """(c) Llama-4-Scout-17B-16E's widths on SCOUT_DEPTH of its 48 layers
    under NVFP4 and W4A8, and one batch-1 prompt past position 8192; (b)
    GPT-OSS-20B at full width (GPT_OSS_DEPTH of its 24 layers) under MXFP4
    (its native format), NVFP4 and INT4. Each path makes its own seeded
    weights (the raw weights of two paths would not fit beside the served
    one). Returns the launch counts of all its runs."""
    launches = {}
    g = torch.Generator(device=dev).manual_seed(2)
    # Scout first: a planted fault of a GEMM both models run is then read
    # by its all-layer long prompt too (tools/torch_kernel_mutation_check.sh)
    runs = (("llama4_scout", "llama4", {**LLAMA4_SCOUT, "rope_scaling": SCOUT_ROPE}, SCOUT_DEPTH, SCOUT_PATHS),
            ("gpt_oss_20b", "gpt_oss", {**GPT_OSS_20B, "rope_scaling": GPT_OSS_YARN}, GPT_OSS_DEPTH, GPT_OSS_PATHS))
    for model, family, spec, depth, paths in runs:
        cfg = _family_cfg(family, spec, torch.bfloat16, num_hidden_layers=depth)
        prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
        for n, path in enumerate(paths):  # the first path's prefill profiled
            for k, c in _family_full_path(torch, dev, sz, path, cfg, prompt, model, profile=n == 0).items():
                launches[k] = launches.get(k, 0) + c
    return launches


def phase_families(torch, dev, sz: Sizes) -> dict:
    """(a) `_families_small`, then (b) and (c), `_families_full`. Returns the
    launch counts of all its runs."""
    launches = _families_small(torch, dev)
    for k, c in _families_full(torch, dev, sz).items():
        launches[k] = launches.get(k, 0) + c
    return launches


# ---------------------------------------------------------------------------
# deepseek: DeepSeek-V3 (models/deepseek.py, serve/deepseek_engine.py) on its
# own engine over the MLA latent cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeepseekPath:
    """One served DeepSeek path: a preset and the GEMM kernel its
    projections and experts launch."""

    label: str
    preset: str
    gemm: str


# (a) a small config (hidden 256, 4 layers: 1 dense, 3 MoE), bf16, under
# every preset the DeepSeek path serves
DEEPSEEK_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=8, q_lora_rank=128, kv_lora_rank=128,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=16,
                      moe_intermediate_size=128, num_experts_per_tok=4, n_group=4, topk_group=2, n_shared_experts=1,
                      first_k_dense_replace=1, routed_scaling_factor=2.5, max_position_embeddings=4096)
DEEPSEEK_SMALL_PATHS = (
    DeepseekPath("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    DeepseekPath("nvfp4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo"),
    DeepseekPath("fp8", "FP8_DEFAULT_CFG", "qmm_byte_wo"),
    DeepseekPath("int8", "INT8_DEFAULT_CFG", "qmm_byte_wo"),
    DeepseekPath("nvfp4_kv", "NVFP4_KV_CFG", "qmm_fp4_wo"),
)
DEEPSEEK_PROMPT = (4, 32)   # (a): prompts and ...
DEEPSEEK_STEPS = 8          # ... greedy steps (the graphed decode: GRAPH_CHECK_STEPS)
DEEPSEEK_E_BIAS_STD = 0.05  # the routers' correction bias, N(0, std^2): at 0 the bias would move nothing
# (a): the f32 engine on every kernel's plain version against the model's
# own fake-quant cached forward (f32, input quantizers off), teacher-forced
# on the forward's greedy tokens and expert choices: the median logits gap
# as a share of their scale (sums in another order: ~1e-6), and every
# greedy token equal but at a tie of the forward's top two (DEEPSEEK_TIE).
# kv_b's key and value halves swapped in the absorbed form move every row.
DEEPSEEK_VS_FORWARD_MAX = 1e-3
DEEPSEEK_TIE = 1e-4
# (b) deepseek-ai/DeepSeek-V3's config.json (the public release), cut to
# DEEPSEEK_V3_DEPTH of its 61 layers: one of its 3 dense layers and one MoE
# layer (first_k_dense_replace 1), the default run's time
DEEPSEEK_V3 = {"model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168, "intermediate_size": 18432,
               "num_hidden_layers": 61, "num_attention_heads": 128, "num_key_value_heads": 128,
               "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
               "v_head_dim": 128, "n_routed_experts": 256, "num_experts_per_tok": 8, "n_group": 8, "topk_group": 4,
               "n_shared_experts": 1, "moe_intermediate_size": 2048, "first_k_dense_replace": 3,
               "routed_scaling_factor": 2.5, "norm_topk_prob": True, "rope_theta": 10000, "rms_norm_eps": 1e-6,
               "max_position_embeddings": 163840, "tie_word_embeddings": False,
               "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
                                "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096}}
DEEPSEEK_V3_DEPTH = 2
DEEPSEEK_V3_PATHS = (
    DeepseekPath("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "qmm_int4_wo"),
    DeepseekPath("nvfp4_w4a4", "NVFP4_DEFAULT_CFG", "qmm_fp4_wo"),
)
DEEPSEEK_CALIB = (4, 2, 512)   # seeded calibration batches: count, B, T (an expert's C = 64)
DEEPSEEK_V3_STEPS = 32         # (b): eager token steps, and the graphed ones held to them
DEEPSEEK_KERNELS = ("qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo")
# DeepSeek-V3's GEMMs at its widths (kernels phase; alone: `--phases
# build,kernels_deepseek`): projections at the 8 x 2048 prefill (N = 16384)
# and a decode step (N = 8), experts at the prefill's C = 2 S k / E = 1024
# and a decode step's C = 1; kv_a's O = 576 is no multiple of 128
DEEPSEEK_GEMMS = (
    ("deepseek-v3", "q_a_proj", 1536, 7168, ("int4", "nvfp4"), (16384, 8)),
    ("deepseek-v3", "q_b_proj", 24576, 1536, ("int4", "nvfp4"), (16384, 8)),
    ("deepseek-v3", "kv_a_proj", 576, 7168, ("int4", "nvfp4"), (16384, 8)),
    ("deepseek-v3", "o_proj", 7168, 16384, ("int4", "nvfp4"), (16384, 8)),
    ("deepseek-v3", "dense gate", 18432, 7168, ("int4", "nvfp4"), (16384, 8)),
    ("deepseek-v3", "expert gate", 2048, 7168, ("int4", "nvfp4"), (1024, 1)),
    ("deepseek-v3", "expert down", 7168, 2048, ("int4", "nvfp4"), (1024, 1)),
)


def _deepseek_params(torch, dev, cfg, seed: int) -> dict:
    """Seeded random weights made on the card, the routers' `e_bias`
    N(0, DEEPSEEK_E_BIAS_STD^2)."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek

    g = torch.Generator(device=dev).manual_seed(seed)
    params = deepseek.init_params(cfg, g, device=dev)
    b = params["layers_moe"]["moe.e_bias"]
    params["layers_moe"]["moe.e_bias"] = torch.randn(b.shape, generator=g, device=dev) * DEEPSEEK_E_BIAS_STD
    return params


def _route_host(logits, bias, cfg):
    """DeepSeek-V3's routing by a host loop in f64 (the rule, apart from
    `models.deepseek.route`): sigmoid scores, the bias added for the choice,
    groups by the sum of their top two, the top `topk_group` groups, the top
    k of their experts; the weights from the scores, normalised (+1e-20),
    times `routed_scaling_factor`. -> (sets of chosen experts, their
    weights by expert, the margin below the last choice and the last
    group), a row each."""
    import numpy as np

    E, k, G = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_group
    per = E // G
    out = []
    for row in logits:
        scores = 1.0 / (1.0 + np.exp(-row.astype(np.float64)))
        choice = scores + bias
        gscore = np.sort(choice.reshape(G, per), axis=-1)[:, -2:].sum(-1)
        gorder = np.argsort(-gscore, kind="stable")
        allowed = np.concatenate([np.arange(g * per, (g + 1) * per) for g in gorder[:cfg.topk_group]])
        order = allowed[np.argsort(-choice[allowed], kind="stable")]
        top = order[:k]
        w = scores[top] / (scores[top].sum() + 1e-20) * cfg.routed_scaling_factor
        margin = min(choice[order[k - 1]] - choice[order[k]] if len(order) > k else 1.0,
                     gscore[gorder[cfg.topk_group - 1]] - gscore[gorder[cfg.topk_group]] if G > cfg.topk_group else 1.0)
        out.append((set(top.tolist()), dict(zip(top.tolist(), w.tolist())), margin))
    return out


def _deepseek_route_check(torch, dev, cfg) -> dict:
    """`models.deepseek.route` on the card against `_route_host` on seeded
    logits and a N(0, DEEPSEEK_E_BIAS_STD^2) bias, at a decode step's S = 8
    and 2048 rows of a prefill: the same experts in every row but at a tie
    (margin <= 1e-5 in the host's scores), and their weights within 1e-5 of
    the host's."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek

    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for S in (8, 2048):
        logits = torch.randn((S, cfg.n_routed_experts), generator=g, device=dev)
        bias = torch.randn((cfg.n_routed_experts,), generator=g, device=dev) * DEEPSEEK_E_BIAS_STD
        w, i = deepseek.route(cfg, logits, bias)
        host = _route_host(logits.double().cpu().numpy(), bias.double().cpu().numpy(), cfg)
        apart, worst = [], 0.0
        for r, (chosen, hw, margin) in enumerate(host):
            got = i[r].tolist()
            if set(got) != chosen:
                apart.append(margin)
                continue
            worst = max(worst, max(abs(float(w[r, j]) - hw[e]) / abs(hw[e]) for j, e in enumerate(got)))
        out[S] = {"rows": S, "rows_apart_at_ties": len(apart), "weights_worst_rel_err": worst}
        if any(m > 1e-5 for m in apart) or not worst <= 1e-5:
            raise AssertionError(f"deepseek route at S = {S}: {len(apart)} rows chose other experts than the host "
                                 f"rule (margins {apart[:4]}), weights worst rel err {worst} (limit 1e-5)")
    return out


def _f32(torch, params: dict) -> dict:
    return {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float()) for k, v in params.items()}


def _deepseek_absorbed_vs_naive(torch, dev, cfg, params, prompts) -> float:
    """The model's cached forward (the absorbed form, the prompt then one
    token at a time) against its naive forward, f32, within JAX's own 2e-4 /
    1e-3 (tests/test_deepseek.py::test_decode_matches_prefill), with the
    capacity at every token (a decode step's C = max(int(2 S k / E), 1)
    drops repeated picks that the prompt's C keeps). Returns the largest
    difference."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, capacity_factor=cfg.n_routed_experts / cfg.num_experts_per_tok)
    p32 = _f32(torch, params)
    T = prompts.shape[1]
    naive = deepseek.forward(cfg32, p32, prompts)[0]
    cache = deepseek.init_cache(cfg32, prompts.shape[0], T, device=dev)
    half = T // 2
    got, _, cache = deepseek.forward(cfg32, p32, prompts[:, :half], cache=cache)
    steps = [got]
    for t in range(half, T):
        got, _, cache = deepseek.forward(cfg32, p32, prompts[:, t:t + 1], cache=cache)
        steps.append(got)
    cached = torch.cat(steps, dim=1)
    err = float((cached - naive).abs().max())
    if not bool(torch.isclose(cached, naive, atol=2e-4, rtol=1e-3).all()):
        raise AssertionError(f"deepseek: the absorbed (cached) forward lies {err} from the naive one, beyond "
                             "JAX's 2e-4 / 1e-3")
    return err


def _deepseek_vs_forward(torch, dev, label: str, preset: str, cfg, params, calib, prompts, steps: int) -> dict:
    """The f32 model calibrated under `preset` (f32) and served by the f32
    engine on every kernel's plain version: (i) where kv_b has an input
    quantizer, the latent the engine's prefill caches is already on that
    quantizer's grid (quantizing it again moves no element: it was cached
    after the quantizer, as the model's forward caches it); (ii) with the
    input quantizers off (an f32 ulp that moves a static int8 / fp8
    activation code moves every later layer: 1-4% of the logits' scale at
    4 layers in either direction), the engine teacher-forced on the model's
    own fake-quant cached forward's greedy sequence (prefill, then `steps`
    decode steps) and on its expert choices (`_pinned_routes`): every
    position's logits gap (median <= DEEPSEEK_VS_FORWARD_MAX; sums in
    another order read ~1e-6) and its greedy tokens (equal but at a tie of
    the forward's top two, DEEPSEEK_TIE)."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek, llama
    from tensorrt_model_optimizer_tpu_torch.quant import quantizer
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    qm = deepseek.quantize(cfg32, _f32(torch, params), preset, calib, device=dev)
    B, T = prompts.shape
    out = {}
    kvb = qm.layout.get("self_attn.kv_b_proj.input")
    if kvb.enable:
        eng = deepseek_engine.DeepseekEngine(deepseek_engine.compress(qm), T, dev, PLAIN_ALL)
        c = eng.init_cache(B)
        eng.prefill(prompts, c)
        moved = 0
        for key, _ in deepseek.GROUPS:
            if f"ckv_{key}" in c:
                st = qm.qstate[key]["self_attn.kv_b_proj"]["input"]
                for i, rows in enumerate(c[f"ckv_{key}"]):
                    moved += int((quantizer.quantize(rows, kvb, llama.slice_state(st, i)) != rows).sum())
        out["cached_latent_moved_by_its_quantizer"] = moved
        if moved:
            raise AssertionError(f"deepseek {label}: {moved} elements of the cached latent move when kv_b's input "
                                 "quantizer quantizes them again: the latent was cached before it")
        del eng, c
    qm = _without_input_quantizers(qm)
    eng = deepseek_engine.DeepseekEngine(deepseek_engine.compress(qm), T + steps, dev, PLAIN_ALL)
    with _pinned_routes(deepseek) as pins:
        pins.record()
        cache = deepseek.init_cache(cfg32, B, T + steps, device=dev)
        logits, _, cache = qm.forward(prompts, cache=cache)
        ref, seq = [logits[:, -1]], [prompts]
        for _ in range(steps):
            seq.append(ref[-1].argmax(-1)[:, None])
            logits, _, cache = qm.forward(seq[-1], cache=cache)
            ref.append(logits[:, -1])
        pins.replay()
        c = eng.init_cache(B)
        got = [eng.prefill(prompts, c)] + [eng._model_step(t.to(torch.int32), c) for t in seq[1:]]
    gaps, flips = [], []
    for lg, r in zip(got, ref):
        g_, m_ = _gaps(lg, r)
        gaps += g_
        flips += m_
    out.update(engine_f32_plain_vs_forward_median_gap=statistics.median(gaps), worst=max(gaps),
               greedy_flips_at_ties=flips, engine_routing_choices_apart=pins.apart)
    if not out["engine_f32_plain_vs_forward_median_gap"] <= DEEPSEEK_VS_FORWARD_MAX or any(m > DEEPSEEK_TIE for m in flips):
        raise AssertionError(f"deepseek {label}: the f32 engine lies {out['engine_f32_plain_vs_forward_median_gap']} "
                             f"(median) of the logits' scale from the model's fake-quant forward (limit "
                             f"{DEEPSEEK_VS_FORWARD_MAX}); greedy tokens apart at forward margins {flips[:4]} "
                             f"(ties: <= {DEEPSEEK_TIE})")
    return out


def _deepseek_small(torch, dev) -> dict:
    """(a) The small config under each preset of DEEPSEEK_SMALL_PATHS, bf16,
    seeded weights: `deepseek.quantize` (max, on a seeded batch), compress,
    the kernel engine against the all-plain engine on the kernel engine's
    routing over DEEPSEEK_PROMPT and DEEPSEEK_STEPS (MOE_PLAIN_MEDIAN_MAX),
    the path's kernel launched and no other, the graphed decode (unroll 1
    and 8, GRAPH_CHECK_STEPS) bit-equal to the eager steps, the f32 plain engine against the
    model's fake-quant forward (`_deepseek_vs_forward`); once, the absorbed
    form against the naive one and the routing against the host rule
    (`_deepseek_route_check`). Returns the launch counts."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine

    launches: dict = {}
    cfg = deepseek.DeepseekConfig(**DEEPSEEK_SMALL, dtype=torch.bfloat16)
    params = _deepseek_params(torch, dev, cfg, 5)
    g = torch.Generator(device=dev).manual_seed(3)
    B, T = DEEPSEEK_PROMPT
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    calib = [torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)]
    log(json.dumps({"phase": "deepseek_small", "route_vs_host_rule": _deepseek_route_check(torch, dev, cfg),
                    "absorbed_vs_naive_f32_max_err": _deepseek_absorbed_vs_naive(torch, dev, cfg, params, prompts)}))
    rows = _graph_rows(T, GRAPH_CHECK_STEPS)
    for path in DEEPSEEK_SMALL_PATHS:
        t_path = time.perf_counter()
        cm = deepseek_engine.compress(deepseek.quantize(cfg, params, path.preset, calib, device=dev))
        ek = deepseek_engine.DeepseekEngine(cm, rows, dev)
        _counts(reset=True)
        held = _pinned_pair(torch, lambda plain: deepseek_engine.DeepseekEngine(ek.cm, rows, dev, plain), prompts,
                            DEEPSEEK_STEPS, lambda e: e.init_cache(B), deepseek)
        n = _counts()  # the comparison's kernel engine: its kernels, not counted in the kernels line
        row = {"phase": "deepseek_small", "path": path.label, "preset": path.preset,
               "kinds_served": sorted(set(ek.cm.kinds.values())), "launches": {k: v for k, v in n.items() if v},
               **held}
        if {k for k, v in n.items() if v} != {path.gemm}:
            raise AssertionError(f"deepseek {path.label}: launched {n}, the path's kernel is {path.gemm}")
        if not held["kernel_logits_finite"] or not held["median_gap_vs_plain_pinned"] <= MOE_PLAIN_MEDIAN_MAX:
            raise AssertionError(f"deepseek {path.label}: the kernel engine lies {held['median_gap_vs_plain_pinned']} "
                                 f"(median) of the logits' scale from the plain engine's on the same routing (limit "
                                 f"{MOE_PLAIN_MEDIAN_MAX}); logits finite: {held['kernel_logits_finite']}")
        _counts(reset=True)  # the served path: prefill, eager steps, graphed steps
        cache = ek.init_cache(B)
        tok0 = tok = torch.argmax(ek.prefill(prompts, cache), dim=-1).to(torch.int32)[:, None]
        start, toks, walls = _clone_cache(cache), [], []
        for _ in range(GRAPH_CHECK_STEPS):
            t0 = time.perf_counter()
            tok, _ = _eager_step(torch, ek, tok, cache)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
        _graphed_decode(torch, ek, f"deepseek {path.label}", tok0, start, toks, cache, statistics.median(walls),
                        profile_unrolls=False, profile_eager=False)
        for k, c in _counts().items():
            launches[k] = launches.get(k, 0) + c
        ek.release_graphs()
        row.update(_deepseek_vs_forward(torch, dev, path.label, path.preset, cfg, params, calib, prompts,
                                        DEEPSEEK_STEPS))
        row["seconds"] = time.perf_counter() - t_path
        log(json.dumps(row))
        del ek, cm, cache, start
    return launches


class _event_spans:
    """Device time of named functions of modules, summed over their calls:
    each wrapped in a pair of CUDA events (no sync), read on `ms()`.
    Restores the functions on exit."""

    def __init__(self, torch, targets: dict):
        self.torch, self.targets, self.events, self.real = torch, targets, {k: [] for k in targets}, {}

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            real = self.real[name] = getattr(mod, attr)

            def timed(*a, _real=real, _name=name, **kw):
                s, e = self.torch.cuda.Event(enable_timing=True), self.torch.cuda.Event(enable_timing=True)
                s.record()
                out = _real(*a, **kw)
                e.record()
                self.events[_name].append((s, e))
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.real[name])

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in ev) for k, ev in self.events.items()}


def _deepseek_moe_layer(cm):
    """The compressed model cut to its one MoE layer (DEEPSEEK_V3_DEPTH's
    last) alone: no dense group, the same packs and states."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek

    if deepseek.group_layers(cm.model_cfg)[1] != 1:
        raise ValueError(f"{deepseek.group_layers(cm.model_cfg)} layers: the cut takes a model with one MoE layer")
    cfg = dataclasses.replace(cm.model_cfg, num_hidden_layers=1, first_k_dense_replace=0)
    return dataclasses.replace(cm, model_cfg=cfg, params={k: v for k, v in cm.params.items() if k != "layers_dense"},
                               qstate={k: v for k, v in cm.qstate.items() if k != "dense"})


def _deepseek_full_path(torch, dev, sz: Sizes, path: DeepseekPath, cfg, params, prompt, calib,
                        profile: bool) -> dict:
    """One path at DeepSeek-V3's widths: `deepseek.quantize` (max) on
    DEEPSEEK_CALIB's batches, compress, the engine: TTFT of the 8 x 2048
    prefill, DEEPSEEK_V3_STEPS eager token steps, the graphed steps held to
    them (unroll 1 and 8, capture ms), where `profile` one eager step and
    one prefill profiled (device ms, idle share, kernels), one prefill with
    the MLA einsums and the expert GEMMs timed by CUDA events, peak memory
    in set-up and in serving, launches, and the prefill's logits against
    the all-plain engine on all its layers on the kernel engine's routing,
    with the input quantizers off (MOE_PLAIN_MEDIAN_MAX, as the full phase
    holds its paths: W4A4's dynamic NVFP4 block scales cross an e4m3
    rounding edge at a bf16 ulp of a GEMM, which moves a whole block's codes,
    and four such layers at V3's widths read 0.35 of the logits' scale with
    73% of the plain engine's own expert choices apart). W4A4 as served is
    held on the MoE layer alone (`_deepseek_moe_layer`, depth 1: attention,
    the 256 experts, the shared one; MOE_PLAIN_MEDIAN_MAX), before the
    weight-only check. Returns the launch counts."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine, engine

    sync = torch.cuda.synchronize
    secs, t_part = {}, time.perf_counter()

    def lap(name):
        nonlocal t_part
        sync()
        secs[name] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qm = deepseek.quantize(cfg, params, path.preset, calib, device=dev)
    sync()
    calib_s = time.perf_counter() - t0
    cm = deepseek_engine.compress(qm)
    del qm
    rows = _graph_rows(prompt.shape[1], DEEPSEEK_V3_STEPS)
    eng = deepseek_engine.DeepseekEngine(cm, rows, dev)
    del cm
    torch.cuda.empty_cache()
    lap("setup")
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _counts(reset=True)
    cache = eng.init_cache(prompt.shape[0])
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _counts()
    tok0 = tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    start = _clone_cache(cache)
    step_ms, toks = [], []
    _counts(reset=True)
    lap("prefill")
    for _ in range(DEEPSEEK_V3_STEPS):
        t0 = time.perf_counter()
        tok, step_logits = _eager_step(torch, eng, tok, cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    step_launches = {k: v // DEEPSEEK_V3_STEPS for k, v in _counts().items() if v}
    lap("eager_steps")
    label = f"deepseek_v3 {path.label}"
    graphs = _graphed_decode(torch, eng, label, tok0, start, toks, cache, statistics.median(step_ms),
                             profile_unrolls=False, profile_eager=profile)
    eager = graphs.pop("eager")
    lap("graphs")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: n + prefill_launches[k] for k, n in _counts().items()}
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    eng.release_graphs()
    del cache, start
    pre = {"per_call_device_busy_ms": None, "device_idle_share": None, "top": []}
    if profile:
        pre = _profile(torch, f"{label} prefill", lambda: eng.prefill(prompt, eng.init_cache(prompt.shape[0])), 1,
                       ttft_ms)
    with _event_spans(torch, {"mla_einsums": (deepseek_engine, "absorbed_attention"),
                              "expert_gemms": (engine, "_expert_linear")}) as spans:
        eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
    span_ms = spans.ms()
    lap("profile")
    weight_only = _without_input_quantizers(eng.cm)
    held = _pinned_pair(torch, lambda plain: deepseek_engine.DeepseekEngine(weight_only, rows, dev, plain), prompt,
                        1, lambda e: e.init_cache(prompt.shape[0]), deepseek)
    layer = held
    if weight_only.layout != eng.cm.layout:  # W4A4: as served, on the MoE layer alone
        alone = _deepseek_moe_layer(eng.cm)
        layer = _pinned_pair(torch, lambda plain: deepseek_engine.DeepseekEngine(alone, rows, dev, plain), prompt,
                             1, lambda e: e.init_cache(prompt.shape[0]), deepseek)
        del alone
    lap("vs_plain")
    Ld, Lm = deepseek.group_layers(cfg)
    row = {"phase": "deepseek_full", "model": "deepseek_v3", "path": path.label, "preset": path.preset,
           "kinds": sorted(set(eng.cm.kinds.values())), "layers": cfg.num_hidden_layers, "dense_layers": Ld,
           "moe_layers": Lm, "batch": prompt.shape[0], "prompt": prompt.shape[1], "calib_s": calib_s,
           "setup_peak_mem_gb": setup_peak, "ttft_ms": ttft_ms, "prefill_device_ms": pre["per_call_device_busy_ms"],
           "prefill_idle_share": pre["device_idle_share"], "prefill_top_kernels": pre["top"][:6],
           "prefill_mla_einsum_ms": span_ms["mla_einsums"], "prefill_expert_gemm_ms": span_ms["expert_gemms"],
           "eager_ms_per_token_step": statistics.median(step_ms), "graphs": graphs,
           "eager_step_device_ms": eager["device_ms_per_token_step"], "eager_step_idle_share": eager["device_idle_share"],
           "eager_step_kernels": eager["kernels_per_token_step"], "peak_mem_gb": peak_gb,
           "packed_weight_gb": eng.cm.packed_bytes / 1e9,
           "prefill_launches": {k: v for k, v in prefill_launches.items() if v}, "token_step_launches": step_launches,
           "logits_finite": finite, "all_layers_input_quantizers_off": held, "moe_layer_alone_as_served": layer,
           "seconds": secs}
    log(json.dumps(row))
    if not finite or not held["kernel_logits_finite"] or not layer["kernel_logits_finite"]:
        raise AssertionError(f"deepseek v3 {path.label}: non-finite logits")
    if not layer["median_gap_vs_plain_pinned"] <= MOE_PLAIN_MEDIAN_MAX:
        raise AssertionError(f"deepseek v3 {path.label}: as served, the MoE layer alone's prefill logits lie "
                             f"{layer['median_gap_vs_plain_pinned']} (median) of their scale from the plain engine's "
                             f"on the same routing, the limit is {MOE_PLAIN_MEDIAN_MAX}")
    if {k for k, n in launches.items() if n > 0} != {path.gemm}:
        raise AssertionError(f"deepseek v3 {path.label}: launched {launches}, the path's kernel is {path.gemm}")
    if not held["median_gap_vs_plain_pinned"] <= MOE_PLAIN_MEDIAN_MAX:
        raise AssertionError(f"deepseek v3 {path.label}: the prefill's logits over all {cfg.num_hidden_layers} layers "
                             f"(input quantizers off) lie {held['median_gap_vs_plain_pinned']} (median) of their "
                             f"scale from the plain engine's on the same routing, the limit is {MOE_PLAIN_MEDIAN_MAX}")
    del eng, logits
    torch.cuda.empty_cache()
    return launches


def _deepseek_full(torch, dev, sz: Sizes) -> dict:
    """(b) DeepSeek-V3's widths (DEEPSEEK_V3, its published config.json:
    yarn, the softmax factor 1.874) on DEEPSEEK_V3_DEPTH of its 61 layers,
    seeded random bf16 weights made on the card a layer (an expert) at a
    time: the routing against the host rule at its 256 experts, then each
    path of DEEPSEEK_V3_PATHS (`_deepseek_full_path`, the first profiled).
    Returns the launch counts."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader

    cfg = dataclasses.replace(hf_loader.deepseek_config_from_hf(DEEPSEEK_V3), num_hidden_layers=DEEPSEEK_V3_DEPTH,
                              first_k_dense_replace=1)
    log(json.dumps({"phase": "deepseek_full", "model": "deepseek_v3", "softmax_scale_factor": cfg.softmax_scale_factor,
                    "route_vs_host_rule": _deepseek_route_check(torch, dev, cfg)}))
    t0 = time.perf_counter()
    params = _deepseek_params(torch, dev, cfg, 0)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "deepseek_full", "model": "deepseek_v3", "layers": DEEPSEEK_V3_DEPTH,
                    "init_params_s": time.perf_counter() - t0, "weights_gb": sum(
                        t.numel() * t.element_size() for v in params.values()
                        for t in (v.values() if isinstance(v, dict) else [v])) / 1e9}))
    g = torch.Generator(device=dev).manual_seed(2)
    n, B, T = DEEPSEEK_CALIB
    calib = [torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev) for _ in range(n)]
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    launches: dict = {}
    for i, path in enumerate(DEEPSEEK_V3_PATHS):
        for k, c in _deepseek_full_path(torch, dev, sz, path, cfg, params, prompt, calib, profile=i == 0).items():
            launches[k] = launches.get(k, 0) + c
    del params
    torch.cuda.empty_cache()
    return launches


def phase_deepseek(torch, dev, sz: Sizes) -> dict:
    """(a) `_deepseek_small`, then (b) `_deepseek_full`. Returns the launch
    counts of all its runs."""
    launches = _deepseek_small(torch, dev)
    for k, c in _deepseek_full(torch, dev, sz).items():
        launches[k] = launches.get(k, 0) + c
    return launches


# ---------------------------------------------------------------------------
# speculative decoding (PR 15): the drafters trained and measured on the
# anchor, tree verification served on the anchor and on Llama-3.1-8B
# ---------------------------------------------------------------------------

SPEC_RECORD = os.path.join(HERE, "artifacts", "specdec_r02.jsonl")  # JAX's record (tools/bench_specdec.py, CPU)
# tools/bench_specdec.py's settings: 300 train steps of 8 x 65 synthlang
# tokens (stream seed 11, batches from numpy seed 3), lr 1e-3, TTT 3 steps;
# acceptance over 64 tokens after the stream's first 32. The run trains the
# first 100 of those 300 batches (the default run's time), so its acceptance
# is printed beside JAX's 300-step record, not like for like
# (tools/torch_specdec_parity.py holds the 300-step trajectories to JAX's)
SPEC_TRAIN = dict(steps=100, jax_steps=300, batch=8, seq=64, lr=1e-3, ttt=3)
SPEC_PROMPT, SPEC_DECODE = 32, 64
SPEC_DRAFTED = {"medusa": 3, "eagle": 3, "eagle3": 3, "dflash": 4}  # draft tokens a round proposes
SPEC_SERVED = (64, 64)   # the anchor served: prompt (the stream's first 64 tokens) and generate_speculative tokens
SPEC_8B = dict(prompt=128, max_seq=512, new=32, heads=3)  # tools/bench_specdec_engine.py's phase_8b, batch 1
SPEC_DEPTHS = (1, 2)      # 8B: the verify forward on the kernels against the plain GEMMs at these depths ...
SPEC_PLAIN_MAX = 5e-2     # ... relative error of the logits (the full phase's limit for its paths)
# The oracle round (the greedy continuation on the tree's deepest path)
# against eager 1-row steps on the same tokens: the median logits gap at the
# accepted nodes and the compacted rows' relative Frobenius error (worst
# layer, k or v) may be at most these, as a share of their scale. The anchor
# runs f32 activations (ulps of f32 sums apart: int8 codes flip rarely; an
# H100 read 1e-7 and 0); the 8B bf16 (a 7-row forward against 1-row steps:
# the einsum T > 1 path against the split T = 1 path, bf16 roundings
# carried through 32 layers): an H100 read 0.0164 and 0.0184 there, and
# 0.0530 and 0.0921 with the verify mask letting each node see its siblings
# (the planted fault whose effect is smallest: one more row among 135)
SPEC_ANCHOR_ORACLE_MAX = 1e-4
SPEC_ORACLE_MAX = 3e-2
SPEC_ROWS_MAX = 3e-2
SPEC_TIE_MAX = 1e-2  # 8B: where the speculative tokens leave generate_host's, the reference's top-2 gap (the anchors' rule)
SPEC_KERNELS = ("qmm_w4a8", "qmm_int4_wo")
# the GEMMs of the 8B verify round (7 tree rows at batch 1) and of a batch-1
# decode step, INT4 (the 8B path's) and W4A8 (the anchor's)
SPEC_GEMMS = tuple(("llama3-8b", label, O, K, ("int4", "w4a8"), (7, 1)) for O, K, label in Sizes().qmm_shapes)


def _spec_batches(stream, n: int, rng, bs: int, seq: int):
    import numpy as np

    for _ in range(n):
        starts = rng.integers(0, stream.size - seq - 1, size=bs)
        yield np.stack([stream[s: s + seq + 1] for s in starts])


def _spec_train(torch, dev, cfg, params, stream) -> dict:
    """Medusa (3 heads), EAGLE-1 TTT, EAGLE-3 TTT and DFlash (block 4)
    trained on the card with JAX's settings for SPEC_TRAIN's steps: name -> (draft,
    {train_s, last_loss, last_accs}). Medusa's and DFlash's accuracies are
    read after training on the last batch (per head / offset: top-1 against
    the token it predicts), TTT's are its step's."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch.speculative import dflash, eagle, medusa

    t = SPEC_TRAIN
    g = torch.Generator(device=dev).manual_seed(1)
    makers = {
        "medusa": (medusa.init_medusa(cfg, medusa.MedusaConfig(num_heads=3, num_layers=1), g, device=dev),
                   medusa.make_medusa_train_step(cfg, lr=t["lr"])),
        "eagle": (eagle.init_eagle(cfg, eagle.EagleConfig(num_layers=1), g, device=dev),
                  eagle.make_eagle_ttt_train_step(cfg, ttt_steps=t["ttt"], lr=t["lr"])),
        "eagle3": (eagle.init_eagle3(cfg, eagle.EagleConfig(num_layers=1), g, device=dev),
                   eagle.make_eagle3_ttt_train_step(cfg, ttt_steps=t["ttt"], lr=t["lr"])),
        "dflash": (dflash.init_dflash(cfg, dflash.DFlashConfig(block_size=4), g, device=dev),
                   dflash.make_dflash_train_step(cfg, dflash.DFlashConfig(block_size=4), lr=t["lr"])),
    }
    out = {}
    for name, (draft, step) in makers.items():
        rng = np.random.default_rng(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in _spec_batches(stream, t["steps"], rng, t["batch"], t["seq"]):
            res = step(draft, params, torch.from_numpy(b).to(dev))
            draft = res[0]
        torch.cuda.synchronize()
        info = {"train_s": time.perf_counter() - t0, "last_loss": float(res[1])}
        toks = torch.from_numpy(b).to(dev)
        with torch.no_grad():
            if name == "medusa":
                _, hl = medusa.medusa_logits(cfg, params, draft, toks)
                accs = [hl[h][:, :-(h + 2)].argmax(-1).eq(toks[:, h + 2:]).float().mean() for h in range(3)]
            elif name == "dflash":
                _, blk = dflash.dflash_logits(cfg, params, draft, toks)
                accs = [blk[i][:, :-(i + 1)].argmax(-1).eq(toks[:, i + 1:]).float().mean() for i in range(4)]
            else:
                accs = list(res[2])
        info["last_accs"] = [float(a) for a in accs]
        if not math.isfinite(info["last_loss"]):
            raise AssertionError(f"speculative anchor: {name}'s training loss is {info['last_loss']}")
        out[name] = (draft, info)
    return out


def _spec_acceptance(cfg, params, qm, drafts: dict, prompt) -> dict:
    """Each drafter's acceptance over SPEC_DECODE tokens with the
    unquantized base and with the W4A8 fake-quant base (`qm`'s layout; JAX's
    DFlash harness takes no layout, so DFlash has the first only); tokens
    per verify = 1 + rate x drafted tokens (bench_specdec's count)."""
    from tensorrt_model_optimizer_tpu_torch.speculative import dflash, eagle, medusa

    verify = {"medusa": medusa.propose_and_verify, "eagle": eagle.propose_and_verify,
              "eagle3": eagle.propose_and_verify, "dflash": dflash.propose_and_verify}
    out = {}
    for name, (draft, _) in drafts.items():
        t0 = time.perf_counter()
        _, rate = verify[name](cfg, params, draft, prompt, SPEC_DECODE)
        row = {"accept_rate_unquantized_base": rate, "tokens_per_step_unquantized_base": 1 + rate * SPEC_DRAFTED[name],
               "accept_rate_w4a8_base": None, "tokens_per_step_w4a8_base": None}
        if name != "dflash":
            _, rq = verify[name](cfg, qm.params, draft, prompt, SPEC_DECODE, layout=qm.layout, qstate=qm.qstate)
            row.update(accept_rate_w4a8_base=rq, tokens_per_step_w4a8_base=1 + rq * SPEC_DRAFTED[name])
        row["harness_s"] = time.perf_counter() - t0
        out[name] = row
    return out


def _oracle_candidates(tree, greedy: list, vocab: int):
    """Candidate tokens with the greedy continuation on the tree's deepest
    path (node 0 = greedy[0]) and tokens outside it on every other node ->
    (cand, the path's nodes, node 0 first)."""
    import numpy as np

    node = max(range(tree.n_nodes), key=lambda i: (tree.depth[i], -i))
    chain = [node]
    while tree.parent[chain[-1]] >= 0:
        chain.append(tree.parent[chain[-1]])
    chain.reverse()
    others = iter(t for t in range(vocab) if t not in set(greedy))
    cand = np.array([next(others) for _ in range(tree.n_nodes)], np.int32)
    for i in chain:
        cand[i] = greedy[tree.depth[i]]
    return cand, chain


def _rows_gap(got, ref) -> float:
    """The worst layer's relative Frobenius error of stored k or v rows
    [L, 1, a, n_kv, C] (int8 codes and bf16 values read as floats)."""
    d = (got.float() - ref.float()).flatten(1).norm(dim=1)
    return float((d / ref.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max())


def _spec_oracle(torch, eng, prompt, label: str, logits_max: float, rows_max: float, decode_on: int = 8) -> dict:
    """One verify round through `_verify_round` / `_compact` with the
    greedy continuation on the default tree's deepest path, held against
    eager 1-row steps on the same tokens: the logits at the path's nodes
    against the steps' (median gap <= logits_max of the scale), and the
    path's compacted k / v rows against the rows the steps stored (worst
    layer's relative Frobenius error <= rows_max). Then the cache decodes
    `decode_on` greedy steps on: where its tokens first part from greedy,
    the 1-row step's top-2 gap must be a near tie (SPEC_TIE_MAX); the
    acceptance and the bonus are reported (the caller holds them where it
    must)."""
    from tensorrt_model_optimizer_tpu_torch.speculative.tree import accept_nodes, build_tree

    tree = build_tree()
    a = tree.max_depth + 1
    ref = eng.init_cache(1)
    logits = eng.prefill(prompt, ref)
    greedy, steps = [int(logits.argmax())], []
    for _ in range(a + decode_on):
        lg = eng._model_step(torch.tensor([[greedy[-1]]], dtype=torch.int32, device=prompt.device), ref)
        steps.append(lg[0])
        greedy.append(int(lg.argmax()))
    cand, chain = _oracle_candidates(tree, greedy, eng.cfg.vocab_size)
    cache, _, _ = eng._spec_prefill(prompt)
    v_logits, _, pos = eng._verify_round(cache, cand, tree)
    nodes, bonus = accept_nodes(tree, cand, v_logits.argmax(-1).cpu().numpy())
    gaps, _ = _gaps(v_logits[chain], torch.stack(steps[:a]))
    eng._compact(cache, pos, chain)
    rows = max(_rows_gap(cache[n][:, :, pos:pos + a], ref[n][:, :, pos:pos + a]) for n in ("k", "v"))
    more = eng.decode(torch.tensor([[greedy[a]]], dtype=torch.int32, device=prompt.device), cache, decode_on)[0]
    eng.release_graphs()
    apart = [j for j, t in enumerate(more.tolist()) if t != greedy[a + 1 + j]]
    tie = None  # where the decoded tokens first part from greedy: the 1-row step's top-2 gap there
    if apart:
        top2 = steps[a + apart[0]].topk(2).values
        tie = float((top2[0] - top2[1]) / steps[a + apart[0]].abs().max())
    row = {"phase": "speculative", "what": f"{label} oracle round", "tree_nodes": tree.n_nodes, "path": chain,
           "accepted_nodes": nodes, "bonus_equal_greedy": bonus == greedy[a],
           "median_logits_gap_vs_1row_steps": statistics.median(gaps), "worst_logits_gap_vs_1row_steps": max(gaps),
           "compacted_rows_rel_err_vs_1row_steps": rows, "decoded_on_equal_greedy": not apart,
           "decoded_on_first_apart": apart[0] if apart else None, "reference_top2_gap_there": tie}
    log(json.dumps(row))
    if not statistics.median(gaps) <= logits_max:
        raise AssertionError(f"{label} oracle round: the verify logits at the accepted nodes lie "
                             f"{statistics.median(gaps)} of their scale (median) from the 1-row steps', limit {logits_max}")
    if not rows <= rows_max:
        raise AssertionError(f"{label} oracle round: the compacted rows lie {rows} (relative) from the rows the "
                             f"1-row steps stored, limit {rows_max}")
    if tie is not None and not tie <= SPEC_TIE_MAX:
        raise AssertionError(f"{label} oracle round: the compacted cache decodes away from greedy at step "
                             f"{apart[0]}, not at a near tie (top-2 gap {tie})")
    return row


def _spec_anchor(torch, dev) -> dict:
    """(a) artifacts/anchor-llama in f32, as tools/bench_specdec.py and
    tools/bench_specdec_engine.py's anchor phase run it: the four drafters
    trained on the card (`_spec_train`), their acceptance with the
    unquantized and the W4A8_AWQ_BETA fake-quant base beside JAX's CPU
    record; then W4A8_AWQ_BETA_CFG compressed and served by the einsum
    engine (W4A8 GEMM, int8 KV): `generate_speculative` with the trained
    Medusa heads, its tokens equal to `generate_host`'s, the verify forward
    on the kernels against the all-plain engine's (f32: equal within 1e-6),
    and the oracle round (`_spec_oracle`). Returns the served run's
    launches."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve.engine import PLAIN_ALL
    from tensorrt_model_optimizer_tpu_torch.speculative.tree import build_tree
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    stream = synthlang.SynthLang(0).token_stream(max(SPEC_TRAIN["jax_steps"], 64) * 8 * 65, seed=11)
    t0 = time.perf_counter()
    drafts = _spec_train(torch, dev, cfg, params, stream)
    calib = [torch.from_numpy(stream[i * 2048:(i + 1) * 2048].reshape(8, 256).astype(np.int64)).to(dev)
             for i in range(2)]
    qm = ptq.quantize(cfg, params, "W4A8_AWQ_BETA_CFG", calib, device=dev)
    prompt = torch.from_numpy(stream[:SPEC_PROMPT][None].astype(np.int64)).to(dev)
    accept = _spec_acceptance(cfg, params, qm, drafts, prompt)
    with open(SPEC_RECORD) as f:
        record = {r["method"]: r for r in map(json.loads, f)}
    for name, (_, info) in drafts.items():
        log(json.dumps({"phase": "speculative", "what": f"anchor {name}", **info, **accept[name],
                        "jax_cpu_record": record.get(name)}))
    # served: W4A8 on the einsum engine, int8 KV
    n_prompt, n_new = SPEC_SERVED
    served = torch.from_numpy(stream[:n_prompt][None].astype(np.int64)).to(dev)
    cm = compress.compress(qm)
    max_seq = n_prompt + n_new + build_tree().n_nodes + 1
    eng = _engine(torch, cm, max_seq, dev, kv_attention_kernel=False, int4_layout="a8")
    plain = _engine(torch, cm, max_seq, dev, PLAIN_ALL, kv_attention_kernel=False, int4_layout="a8")
    heads = drafts["medusa"][0]
    eng.generate_speculative(served, heads, 8)  # warm-up
    torch.cuda.synchronize()
    _counts(reset=True)
    t1 = time.perf_counter()
    toks, rate = eng.generate_speculative(served, heads, n_new)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t1
    launches = _counts()
    eng.generate_host(served, 8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = eng.generate_host(served, n_new)[0].tolist()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    # the verify forward of one round, kernels against plain, on the same cache state
    tree = build_tree()
    cand = np.array(toks[:tree.n_nodes], np.int32)
    vk = eng._verify_round(eng._spec_prefill(served)[0], cand, tree)[0]
    vp = plain._verify_round(plain._spec_prefill(served)[0], cand, tree)[0]
    row = {"phase": "speculative", "what": "anchor served, W4A8_AWQ_BETA, einsum engine, int8 KV",
           "prompt": n_prompt, "new_tokens": n_new, "accept_rate": rate, "tokens_equal_generate_host": toks == host,
           "wall_s_speculative": spec_s, "wall_s_generate_host": host_s,
           "verify_logits_rel_err_kernel_vs_plain": _rel(vk, vp), "launches": {k: v for k, v in launches.items() if v}}
    log(json.dumps(row))
    if toks != host:
        first = next(i for i, (a, b) in enumerate(zip(toks, host)) if a != b)
        raise AssertionError(f"speculative anchor: generate_speculative's tokens leave generate_host's at {first}")
    if not row["verify_logits_rel_err_kernel_vs_plain"] <= 1e-6:
        raise AssertionError(f"speculative anchor: verify logits kernel vs plain {row['verify_logits_rel_err_kernel_vs_plain']}")
    oracle = _spec_oracle(torch, eng, served, "anchor", SPEC_ANCHOR_ORACLE_MAX, SPEC_ANCHOR_ORACLE_MAX)
    if oracle["accepted_nodes"] != oracle["path"] or not oracle["bonus_equal_greedy"] \
            or not oracle["decoded_on_equal_greedy"]:
        raise AssertionError(f"speculative anchor: the oracle round did not accept its path and decode on to the "
                             f"greedy tokens: {oracle}")
    log(json.dumps({"phase": "speculative", "what": "anchor", "seconds": time.perf_counter() - t0}))
    return launches


def _spec_full(torch, dev, sz: Sizes, timer: Timer, rows: dict) -> dict:
    """(b) Llama-3.1-8B at full width (32 layers, seeded random bf16 weights
    made on the card as the full phase makes them), INT4 weight-only, the
    einsum engine with a bf16 cache, batch 1, a 128-token prompt, max_seq_len
    512, 3 seeded Medusa heads at the 8B's widths: `generate_speculative`
    for 32 tokens (launches counted), the verify round's wall, device time
    and idle share, GEMM launches a round, the batch-1 `decode_step(unroll=8)`
    per token and r = verify / step, peak memory; the verify forward on the
    kernels against the plain GEMMs at depths 1 and 2; the oracle round
    (`_spec_oracle`); the speculative tokens against `generate_host`'s, a
    mismatch traced to the reference's top-2 gap. The GEMMs at the verify
    round's N = 7 and a step's N = 1 (SPEC_GEMMS) join the kernels line's
    shapes. Returns the speculative run's launches."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, config, ptq
    from tensorrt_model_optimizer_tpu_torch.speculative import medusa
    from tensorrt_model_optimizer_tpu_torch.speculative.tree import build_tree

    for k in ("qmm_w4a8", "qmm_int4_wo"):
        rows.setdefault(k, {"shapes": []})
    _phase_kernels_families(torch, dev, sz, timer, rows, torch.Generator(device=dev).manual_seed(0), SPEC_GEMMS)
    sync = torch.cuda.synchronize
    s = SPEC_8B
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cm = compress.compress(ptq.quantize(cfg, params, config.INT4_BLOCKWISE_WEIGHT_ONLY_CFG, device=dev))
    del params
    heads = medusa.init_medusa(cfg, medusa.MedusaConfig(num_heads=s["heads"]),
                               torch.Generator(device=dev).manual_seed(4), device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, s["prompt"]), generator=torch.Generator(device=dev).manual_seed(2),
                           device=dev)
    eng = _engine(torch, cm, s["max_seq"], dev, kv=None, kv_attention_kernel=False)
    sync()
    setup_s = time.perf_counter() - t0
    eng.generate_speculative(prompt, heads, 4)  # warm-up
    sync()
    rounds = []
    real = eng._verify_round

    def timed_round(*a):
        sync()
        t1 = time.perf_counter()
        out = real(*a)
        sync()
        rounds.append((time.perf_counter() - t1) * 1e3)
        return out

    eng._verify_round = timed_round
    _counts(reset=True)
    t1 = time.perf_counter()
    toks, rate = eng.generate_speculative(prompt, heads, s["new"])
    sync()
    spec_s = time.perf_counter() - t1
    launches = _counts()
    eng._verify_round = real
    # one verify round alone: its GEMM launches, wall, device time, idle share
    tree = build_tree()
    cand = np.array(toks[:tree.n_nodes], np.int32)
    cache, _, _ = eng._spec_prefill(prompt)

    def one_round():
        cache["pos"].fill_(s["prompt"])
        eng._verify_round(cache, cand, tree)

    one_round()
    _counts(reset=True)
    one_round()
    gemms_per_round = _counts()["qmm_int4_wo"]
    walls = []
    for _ in range(5):
        sync()
        t1 = time.perf_counter()
        one_round()
        sync()
        walls.append((time.perf_counter() - t1) * 1e3)
    verify_ms = statistics.median(walls)
    prof = _profile(torch, "8B verify round (7 tree rows, batch 1)", one_round, 1, verify_ms)
    # the batch-1 graphed step, unroll 8
    c1 = eng.init_cache(1)
    tok = eng.prefill(prompt, c1).argmax(-1).to(torch.int32)[:, None]
    tok, _ = eng.decode_step(tok, c1, unroll=8)  # the capture
    step_walls = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        tok, _ = eng.decode_step(tok, c1, unroll=8)
        sync()
        step_walls.append((time.perf_counter() - t1) * 1e3 / 8)
    step_ms = statistics.median(step_walls)
    eng.release_graphs()
    del c1
    host = eng.generate_host(prompt, s["new"])[0].tolist()
    match = [a == b for a, b in zip(toks, host)]
    trace = None
    if not all(match):  # the reference's top-2 gap where the tokens first part
        first = match.index(False)
        rc = eng.init_cache(1)
        lg = eng.prefill(prompt, rc)
        for t in host[:first]:
            lg = eng._model_step(torch.tensor([[t]], dtype=torch.int32, device=dev), rc)
        top2 = lg[0].topk(2).values
        trace = {"first_mismatch": first, "reference_top2_gap": float((top2[0] - top2[1]) / lg[0].abs().max())}
        del rc
    row = {"phase": "speculative", "what": "llama3_8b, INT4 weight-only, einsum engine, bf16 cache",
           "layers": cfg.num_hidden_layers, "batch": 1, "prompt": s["prompt"], "max_seq_len": s["max_seq"],
           "medusa_heads": s["heads"], "new_tokens": s["new"], "setup_s": setup_s, "accept_rate": rate,
           "verify_rounds": len(rounds), "tokens_per_verify": (len(toks) - 1) / max(len(rounds), 1),
           "wall_s_speculative": spec_s, "verify_round_ms_in_run_median": statistics.median(rounds),
           "verify_round_ms": verify_ms, "verify_round_device_ms": prof["per_call_device_busy_ms"],
           "verify_round_device_idle_share": prof["device_idle_share"],
           "verify_round_kernels": prof["per_call_kernel_launches"], "gemm_launches_per_verify_round": gemms_per_round,
           "graphed_step_unroll8_ms_per_token": step_ms, "r_verify_over_step": verify_ms / step_ms,
           "tokens_equal_generate_host": sum(match), "mismatch_trace": trace,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: v for k, v in launches.items() if v}}
    log(json.dumps(row))
    if gemms_per_round != 7 * cfg.num_hidden_layers:
        raise AssertionError(f"speculative 8B: {gemms_per_round} INT4 GEMM launches a verify round, want 224")
    if trace is not None and not trace["reference_top2_gap"] <= SPEC_TIE_MAX:
        raise AssertionError(f"speculative 8B: tokens leave generate_host's away from a near tie: {trace}")
    # the verify forward on the kernels against the plain GEMMs, at depths 1 and 2
    for d in SPEC_DEPTHS:
        sub = _truncate(cm, d)
        out = []
        for plain in ((), ("int4_wo",)):
            e = _engine(torch, sub, s["max_seq"], dev, plain, kv=None, kv_attention_kernel=False)
            out.append(e._verify_round(e._spec_prefill(prompt)[0], cand, tree)[0])
            del e
        rel = _rel(out[0], out[1])
        log(json.dumps({"phase": "speculative", "what": "8B verify forward, kernels vs plain GEMMs", "depth": d,
                        "logits_rel_err": rel, "argmax_agree": float((out[0].argmax(-1) == out[1].argmax(-1))
                                                                     .float().mean())}))
        if not rel <= SPEC_PLAIN_MAX:
            raise AssertionError(f"speculative 8B: depth-{d} verify logits rel err {rel} vs plain > {SPEC_PLAIN_MAX}")
    _spec_oracle(torch, eng, prompt, "8B", SPEC_ORACLE_MAX, SPEC_ROWS_MAX)
    del eng, cm, heads, cache
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "speculative", "what": "8B", "seconds": time.perf_counter() - t0}))
    return launches


def phase_speculative(torch, dev, sz: Sizes, timer: Timer, rows: dict) -> dict:
    """(a) `_spec_anchor`, then (b) `_spec_full`. Returns the launch counts
    of both served runs; raises unless each of SPEC_KERNELS launched."""
    launches = _spec_anchor(torch, dev)
    for k, c in _spec_full(torch, dev, sz, timer, rows).items():
        launches[k] = launches.get(k, 0) + c
    never = [k for k in SPEC_KERNELS if not launches.get(k)]
    if never:
        raise AssertionError(f"speculative: kernels its paths did not launch: {never}")
    return launches


# --------------------------------------------------------------------------
# train: the training side (QAT, LSQ, QAD, QLoRA, the trainer, AutoQuantize)
# --------------------------------------------------------------------------

TRAIN_DEPTH = 4              # (a), (d): Llama-3.1-8B's widths on 4 of its 32 layers
TRAIN_TOKENS = (4, 512)      # (a): a step's batch, 4 x 512 tokens (and the 513th as the last target)
TRAIN_STEPS = 3              # (a): timed Adam steps a mode, after one untimed warm-up step, all on one batch
TRAIN_LR = 1e-4              # Adam's learning rate in (a) and (b) (JAX's make_optax_train_step default)
TRAIN_PRESET = "W4A8_AWQ_BETA_CFG"
TRAIN_CALIB = (2, 2, 512)    # (a): seeded calibration batches: count, B, T
TRAIN_LORA_RANK = 16         # (a): QLoRA adapters on all seven projections
TRAIN_SERVE = (2, 64, 8)     # (a): the QAT'd model served: prompts B x T, greedy steps
# (a) the QAT'd model served through both GEMM routes, each kernel engine
# against the engine whose GEMM (only) runs its plain version: W4A8 (row 1,
# bit-exact: every step's logits and the free-running tokens equal) and INT4
# weight-only (row 4) by the calib phase's rule, the first CALIB_PLAIN_DEPTH
# layers' prefill logits within CALIB_PLAIN_REL_MAX with the input
# quantizers off (AWQ's pre_quant_scale kept); its 4-layer lock step is
# printed. On the QAT'd model (trained to a loss of 0.48 on its batch) a bf16
# ulp of INT4's output grows over 4 layers: the median gap read 0.076 of the
# logits' scale, 0.066 with the static FP8 input quantizer on; W4A8 with the
# attention kernels plain too read 0.044 (flash's bf16 P.V against f32)
TRAIN_SERVED = (("w4a8", (("int4_layout", "a8"),), "qmm_w4a8"), ("int4", (), "qmm_int4_wo"))
TRAIN_KERNELS = ("qmm_w4a8", "qmm_int4_wo", "flash_gqa", "kv_decode_attention")
# (b): gradients and updated tensors, card against CPU, relative Frobenius, of
# INT8 weight-only QAT and LSQ steps. With INT8_DEFAULT's static activation
# quantizers on, the two devices' f32 activations put codes on either side of
# rounding ties (each an amax / 127 step of a per-tensor grid): the loss read
# 1.6e-4 apart and k_proj's gradient 0.039 (relative Frobenius); the weights'
# codes are the same bits on both devices
TRAIN_CARD_CPU_FROB_MAX = 1e-4
TRAIN_TRAINER = dict(steps=6, save=3, batch=4, seq=129)  # (c): steps, checkpoint cadence, batch of the stream
TRAIN_AUTOQ = dict(bits=6.0, tokens=(2, 256), candidates=(TRAIN_PRESET, "FP8_DEFAULT_CFG"))  # (d), as hf_ptq.py:143
# (e) JAX's QAT recovery on the anchor (ACCURACY.md: INT8_SMOOTHQUANT_CFG ppl
# 2.9087 -> 2.8777 after QAT, bf16 2.8594; MMLU 0.863 -> 0.868, 600
# questions); the port must take at least half of JAX's 0.0310 off its own
# PTQ ppl, in the first QAT_RECOVERY_STEPS of the recipe's 600 steps (the
# default run's time: 600 took 59 s on an H100's host)
QAT_RECOVERY_STEPS = 150
QAT_RECOVERY = dict(preset="INT8_SMOOTHQUANT_CFG", jax_ppl=(2.9087, 2.8777), jax_mmlu=(0.863, 0.868),
                    jax_bf16_ppl=2.8594, mmlu_n=120)
QAT_RECOVERY_MIN = 0.5 * (2.9087 - 2.8777)


def _lsq_cfg(qcfg):
    """`qcfg` with learn_amax on every static int site, sequential children
    included (llm_qat's --lsq rule, one level down for W4A8's INT4 stage)."""
    from tensorrt_model_optimizer_tpu_torch.quant.config import QuantizeConfig

    def lsq(c):
        if c.sequential:
            return c.replace(sequential=tuple(lsq(s) for s in c.sequential))
        return c.replace(learn_amax=True) if c.enable and not c.is_fp and not c.dynamic else c

    return QuantizeConfig(rules=tuple((p, lsq(c)) for p, c in qcfg.rules), algorithm=qcfg.algorithm)


def _adam_mode(torch, loss_of, tree, steps: int) -> dict:
    """Adam (TRAIN_LR) on `tree` through `qat.value_and_grad(loss_of)`, one
    untimed warm-up step then `steps` timed ones: {"losses", "step_ms",
    "peak_gb", "tree"}."""
    from tensorrt_model_optimizer_tpu_torch.quant import qat

    adam = qat.Adam(TRAIN_LR)
    state = adam.init(tree)
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = qat.value_and_grad(loss_of, tree)
        updates, state = adam.update(grads, state)
        tree = qat.apply_updates(tree, updates)
        del grads, updates
        losses.append(float(loss))  # syncs
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": statistics.median(walls), "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tree": tree}


def _train_full(torch, dev) -> dict:
    """(a) Llama-3.1-8B's widths on TRAIN_DEPTH layers, seeded bf16 weights
    on the card: TRAIN_PRESET calibrated, then Adam QAT steps on one
    TRAIN_TOKENS batch: plain, LSQ (learn_amax on the int sites, the amax
    trained with the weights), QAD (KD against the unquantized teacher) and
    QLoRA (rank-TRAIN_LORA_RANK adapters over the frozen fake-quant base):
    losses finite and falling, step ms, tokens/s, peak memory. The plain
    mode's model is compressed and served by the kernel engine through
    TRAIN_SERVED's routes against the same engine on the plain GEMM. (d) AutoQuantize of
    the same weights: TRAIN_AUTOQ's candidates under its budget, the mixed
    model through `forward_unrolled`. Returns the serve runs' launch counts."""
    from tensorrt_model_optimizer_tpu_torch.distill import distillation
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.peft import lora
    from tensorrt_model_optimizer_tpu_torch.quant import auto, compress, ptq, qat

    sync = torch.cuda.synchronize
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_hidden_layers=TRAIN_DEPTH)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    n, B, T = TRAIN_CALIB
    calib = [torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev) for _ in range(n)]
    batch = torch.randint(0, cfg.vocab_size, (TRAIN_TOKENS[0], TRAIN_TOKENS[1] + 1), generator=g, device=dev)
    qm = ptq.quantize(cfg, params, TRAIN_PRESET, calib, device=dev)
    sync()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in [params["embed_tokens"], params["lm_head"], params["norm"],
                                      *params["layers"].values()])
    tokens = TRAIN_TOKENS[0] * TRAIN_TOKENS[1]
    card = nvidia_smi()
    rows, failures = {}, []

    def report(mode, res, extra=None):
        ls = res["losses"]
        row = {"phase": "train_full", "mode": mode, "layers": TRAIN_DEPTH, "params_b": n_params / 1e9,
               "batch": list(TRAIN_TOKENS), "losses": ls, "step_ms": res["step_ms"],
               "tokens_per_s": tokens / (res["step_ms"] / 1e3), "peak_gb": res["peak_gb"], "card": card,
               **(extra or {})}
        log(json.dumps(row))
        rows[mode] = row
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            failures.append(f"train {mode}: losses {ls} not finite and falling")

    lsq_layout = llama.build_layout(cfg, _lsq_cfg(qm.quant_cfg))
    tcfg = qat.train_cfg(cfg)
    res = _adam_mode(torch, lambda p: qat.qat_loss(cfg, qm.layout, p, qm.qstate, batch), qm.params, TRAIN_STEPS)
    trained = dataclasses.replace(qm, params=res.pop("tree"))
    report("qat", res)
    res = _adam_mode(torch, lambda pq: qat.qat_loss(cfg, lsq_layout, pq[0], pq[1], batch), (qm.params, qm.qstate),
                     TRAIN_STEPS)
    p_lsq, qs_lsq = res.pop("tree")
    moved = max(float((a - b).abs().max()) for a, b in zip(
        [s.amax[0] for s in (qs_lsq[k]["weight"] for k in llama.PROJ_NAMES)],
        [s.amax[0] for s in (qm.qstate[k]["weight"] for k in llama.PROJ_NAMES)]))
    report("lsq", res, {"int4_block_amax_moved_max": moved})
    if not moved > 0:
        failures.append("train lsq: the INT4 block amax did not move")
    del p_lsq, qs_lsq
    kd = distillation.KDConfig()
    res = _adam_mode(torch, lambda p: distillation.distill_loss(cfg, p, params, batch, kd, qm.layout, qm.qstate),
                     qm.params, TRAIN_STEPS)
    res.pop("tree")
    report("qad", res, {"teacher": "the unquantized bf16 weights", "kd": dataclasses.asdict(kd)})
    adapters = lora.init_adapters(cfg, lora.LoRAConfig(rank=TRAIN_LORA_RANK), torch.Generator(device=dev).manual_seed(3),
                                  device=dev)
    res = _adam_mode(torch, lambda a: qat.cross_entropy(
        llama.forward(tcfg, qm.params, batch[:, :-1], layout=qm.layout, qstate=qm.qstate, adapters=a)[0],
        batch[:, 1:]), adapters, TRAIN_STEPS)
    res.pop("tree")
    report("qlora", res, {"rank": TRAIN_LORA_RANK})
    del adapters, res
    torch.cuda.empty_cache()

    # the QAT'd model served on the ported GEMMs, kernel against plain
    cm = compress.compress(trained)
    del trained
    B, T, steps = TRAIN_SERVE
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    _counts(reset=True)
    for label, layouts, gemm in TRAIN_SERVED:
        exact = gemm == "qmm_w4a8"
        served = cm if exact else _without_input_quantizers(cm)
        plain = (PLAIN_NAME[gemm],)
        ek = _engine(torch, served, T + 2 * steps, dev, **dict(layouts))
        ep = _engine(torch, served, T + 2 * steps, dev, plain, **dict(layouts))
        held = _lockstep(torch, (ek, ep), prompts, steps)
        gaps = [g for lk, lp in held for g in _gaps(lk, lp)[0]]
        row = {"phase": "train_serve", "path": label, "plain": plain[0], "kinds": sorted(set(ek.cm.kinds.values())),
               "lockstep_median_gap": statistics.median(gaps), "lockstep_worst_gap": max(gaps), "card": card}
        if exact:
            free = ek.generate(prompts, steps)
            row.update(logits_equal=all(torch.equal(k, p) for k, p in held),
                       tokens_equal=bool(torch.equal(free, ep.generate(prompts, steps))))
            if not row["logits_equal"] or not row["tokens_equal"]:
                failures.append(f"train serve {label}: the bit-exact GEMM's engine leaves its plain version's: {row}")
        else:
            sub = _truncate(served, CALIB_PLAIN_DEPTH)
            out = _engine(torch, sub, T, dev, **dict(layouts))
            ref = _engine(torch, sub, T, dev, plain, **dict(layouts))
            rel = _rel(out.prefill(prompts, out.init_cache(B)), ref.prefill(prompts, ref.init_cache(B)))
            row.update(depth=CALIB_PLAIN_DEPTH, prefill_logits_rel_err=rel, limit=CALIB_PLAIN_REL_MAX,
                       tokens_row0=ek.generate(prompts, steps)[0].tolist())
            if not rel <= CALIB_PLAIN_REL_MAX:
                failures.append(f"train serve {label}: depth-{CALIB_PLAIN_DEPTH} prefill logits {rel} from plain")
            del out, ref
        log(json.dumps(row))
        del ek, ep
    launches = _counts()
    log(json.dumps({"phase": "train_launches", "served": [label for label, _, _ in TRAIN_SERVED],
                    **{k: launches[k] for k in TRAIN_KERNELS}}))
    del cm

    # (d) AutoQuantize at full width
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = TRAIN_AUTOQ
    toks = torch.randint(0, cfg.vocab_size, a["tokens"], generator=g, device=dev)
    res = auto.auto_quantize(cfg, params, list(a["candidates"]), [toks], effective_bits=a["bits"])
    sync()
    search_s = time.perf_counter() - t0
    with torch.no_grad():
        logits, _ = llama.forward_unrolled(cfg, params, toks, res.layer_layouts, res.qstate_list)
    picks = [v for c in res.choice for v in c.values()]
    row = {"phase": "train_autoquantize", "layers": TRAIN_DEPTH, "candidates": list(a["candidates"]),
           "budget_bits": a["bits"], "achieved_bits": res.effective_bits,
           "picks": {c: picks.count(i) for i, c in enumerate(a["candidates"])}, "choice": res.choice,
           "search_s": search_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "mixed_logits_finite": bool(torch.isfinite(logits).all()), "card": card}
    log(json.dumps(row))
    if not res.effective_bits <= a["bits"] or not row["mixed_logits_finite"]:
        failures.append(f"train autoquantize: {res.effective_bits} bits against {a['bits']}, finite "
                        f"{row['mixed_logits_finite']}")
    log(json.dumps({"phase": "train_full_setup", "setup_s": setup_s, "card": card}))
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def _train_anchor(torch, dev) -> None:
    """On artifacts/anchor-llama in f32: (b) one QAT step and one LSQ step
    (Adam, TRAIN_LR) on the card and on the CPU from the same weights, INT8
    weight-only (the LSQ step learning the weights' per-channel amax), each
    device calibrating itself on one batch and training on another: every
    gradient and updated tensor within TRAIN_CARD_CPU_FROB_MAX (relative
    Frobenius); (c) the QATTrainer (quantize on the first step,
    checkpoints, resume) under deterministic algorithms: a run stopped at
    TRAIN_TRAINER["save"] and resumed ends equal to the uninterrupted run,
    and its saved state restores to equal logits; (e) JAX's QAT recovery
    (QAT_RECOVERY, the recipe of tools/torch_accuracy_table.py): ppl and
    MMLU before and after, beside JAX's."""
    import importlib.util
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.models import hf_loader
    from tensorrt_model_optimizer_tpu_torch.opt import state as mto
    from tensorrt_model_optimizer_tpu_torch.opt import trainer
    from tensorrt_model_optimizer_tpu_torch.quant import ptq, qat
    from tensorrt_model_optimizer_tpu_torch.quant.config import get_preset
    from tensorrt_model_optimizer_tpu_torch.utils import synthlang

    card = nvidia_smi()
    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    cpu_params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")[1]
    lang = synthlang.SynthLang(0)
    calib = lang.eval_batches(1, 4, 256, seed=555)
    train = lang.eval_batches(1, 4, 129, seed=777)[0]

    # (b) card against CPU
    out = {}
    weights_only = get_preset("INT8_DEFAULT_CFG").with_rules({"*input_quantizer": {"enable": False}})
    for name, qcfg, lsq in (("qat", weights_only, False), ("lsq", _lsq_cfg(weights_only), True)):
        for where, p in (("card", params), ("cpu", cpu_params)):
            d = p["embed_tokens"].device
            qm = ptq.quantize(cfg, p, qcfg, [torch.from_numpy(b).to(d) for b in calib], device=d)
            toks = torch.from_numpy(train).to(d)
            tree = (qm.params, qm.qstate) if lsq else qm.params
            loss, grads = qat.value_and_grad(
                lambda t: qat.qat_loss(cfg, qm.layout, t[0] if lsq else t, t[1] if lsq else qm.qstate, toks), tree)
            adam = qat.Adam(TRAIN_LR)
            updates, _ = adam.update(grads, adam.init(tree))
            out[(name, where)] = (float(loss), grads, qat.apply_updates(tree, updates))
        from tensorrt_model_optimizer_tpu_torch.utils.tree import flatten_with_names

        worst = {}
        for what, i in (("gradients", 1), ("updated", 2)):
            c, h = flatten_with_names(out[(name, "card")][i]), flatten_with_names(out[(name, "cpu")][i])
            frob = {k: _rel_frob(c[k].cpu(), h[k]) for k in c if h[k].float().norm() > 0}
            k = max(frob, key=frob.get)
            worst[what] = {"tensor": k, "rel_frobenius": frob[k], "tensors": len(frob)}
        row = {"phase": "train_card_cpu", "mode": name, "loss_card": out[(name, "card")][0],
               "loss_cpu": out[(name, "cpu")][0], **worst, "limit": TRAIN_CARD_CPU_FROB_MAX, "card": card}
        log(json.dumps(row))
        if not all(w["rel_frobenius"] <= TRAIN_CARD_CPU_FROB_MAX for w in worst.values()):
            raise AssertionError(f"train card/cpu {name}: {worst}")
    del out

    # (c) the trainer: resume equals the uninterrupted run
    t = TRAIN_TRAINER
    stream = lang.token_stream(16 * t["batch"] * t["seq"], seed=99)
    batches = [stream[i * t["batch"] * t["seq"]:(i + 1) * t["batch"] * t["seq"]].reshape(t["batch"], t["seq"])
               for i in range(t["steps"] + 2)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
            def make(out_dir, steps):
                return trainer.QATTrainer(cfg, params, trainer.TrainerConfig(
                    output_dir=os.path.join(d, out_dir), max_steps=steps, save_steps=t["save"], eval_steps=t["save"],
                    quant_preset="INT8_DEFAULT_CFG", calib_batches=2), eval_batches=batches[-1:], device=dev)

            whole = make("whole", t["steps"]).train(iter(batches))
            first = make("split", t["save"])
            first.train(iter(batches))
            again = make("split", t["steps"])
            if not again.resume() or again.step != t["save"]:
                raise AssertionError("train trainer: resume found no checkpoint at the save step")
            resumed = again.train(iter(batches[t["save"]:]))
            diff = max(float((resumed.params["layers"][k] - v).abs().max()) for k, v in whole.params["layers"].items())
            diff = max(diff, float((resumed.params["embed_tokens"] - whole.params["embed_tokens"]).abs().max()))
            path = os.path.join(d, "saved")
            mto.save(resumed, path)
            back = mto.restore(path, device=dev)
            probe = torch.from_numpy(batches[0]).to(dev)
            with torch.no_grad():
                same_logits = torch.equal(back.forward(probe)[0], resumed.forward(probe)[0])
            row = {"phase": "train_trainer", "steps": t["steps"], "resumed_at": t["save"],
                   "resumed_vs_uninterrupted_max_abs": diff, "saved_state_logits_equal": same_logits,
                   "history": again.history, "seconds": time.perf_counter() - t0, "card": card}
    finally:
        torch.use_deterministic_algorithms(was)
    log(json.dumps(row))
    if diff != 0.0 or not same_logits:
        raise AssertionError(f"train trainer: resumed run {diff} from the uninterrupted one, saved-state logits "
                             f"equal {same_logits}")

    # (e) JAX's QAT recovery on the anchor
    spec = importlib.util.spec_from_file_location("torch_accuracy_table",
                                                  os.path.join(HERE, "tools", "torch_accuracy_table.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    r = QAT_RECOVERY
    calib8 = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(8, 4, 256, seed=555)]  # JAX's tool's
    ev = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(4, 8, 256, seed=999)]
    data_dir = lang.write_mmlu_data(tempfile.mkdtemp(prefix="chip_smoke_qat_mmlu_"), n_test=r["mmlu_n"])
    ptq_m = ptq.quantize(cfg, params, r["preset"], calib8, device=dev)
    with torch.no_grad():
        before = tool.score(lambda x: ptq_m.forward(x)[0], ev, data_dir, mmlu_n=r["mmlu_n"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = tool.qat_recover(ptq_m, dev, steps=QAT_RECOVERY_STEPS)
    torch.cuda.synchronize()
    qat_s = time.perf_counter() - t0
    with torch.no_grad():
        after = tool.score(lambda x: model.forward(x)[0], ev, data_dir, mmlu_n=r["mmlu_n"])
    row = {"phase": "train_qat_recovery", "preset": r["preset"], "steps": QAT_RECOVERY_STEPS,
           "jax_steps": tool.QAT_RECIPE["steps"],
           "ppl_ptq": before["ppl"], "ppl_qat": after["ppl"],
           "recovered": before["ppl"] - after["ppl"], "required": QAT_RECOVERY_MIN,
           "gap_to_jax_qat": after["ppl"] - r["jax_ppl"][1], "mmlu_ptq": before["mmlu"], "mmlu_qat": after["mmlu"], "mmlu_n": after["mmlu_n"], "jax_ppl": r["jax_ppl"], "jax_mmlu": r["jax_mmlu"],
           "jax_bf16_ppl": r["jax_bf16_ppl"], "first_loss": losses[0], "last_loss": losses[-1],
           "qat_s": qat_s, "ms_per_step": qat_s * 1e3 / len(losses), "card": card}
    log(json.dumps(row))
    if not row["recovered"] >= QAT_RECOVERY_MIN:
        raise AssertionError(f"train qat recovery: ppl {before['ppl']} -> {after['ppl']}, recovered "
                             f"{row['recovered']} < {QAT_RECOVERY_MIN}")


def phase_train(torch, dev) -> dict:
    """(a) + (d) at full width, then (b), (c), (e) on the anchor. Returns
    the launch counts of (a)'s served runs (the training steps launch no
    kernel of the port: the flash kernel has no backward and training reads
    flash as einsum; the GEMM kernels serve packed weights only)."""
    launches = _train_full(torch, dev)
    torch.cuda.empty_cache()
    _train_anchor(torch, dev)
    return launches


# ---------------------------------------------------------------------------
# prune: weight sparsity, Minitron pruning and the search framework
# (sparsity/{magnitude,sparsegpt,sparsify}.py, prune/, opt/, nas/)
# ---------------------------------------------------------------------------

PRUNE_DEPTH = 4             # (a)-(c): Llama-3.1-8B's widths on 4 of its 32 layers: the first 4 ...
PRUNE_DEPTH_FROM = 8        # ... of a seeded 8-layer model, whose depth prune (b) keeps 4 of its 8
PRUNE_CALIB = (4, 2, 512)   # seeded calibration batches (count, B, T): SparseGPT's Hessians, the importance
PRUNE_PRESET = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"  # served under PRUNE_SERVED's two routes, as FULL_PATHS' W4A8 and INT4
PRUNE_SERVED = TRAIN_SERVED  # W4A8 (row 1, held bit for bit to its plain GEMM) and INT4 weight-only (row 4)
# nvidia/Llama-3.1-Minitron-4B-Width-Base's config.json: hidden 3072, FFN 9216,
# 32 query / 8 kv heads of 128 (Llama-3.1-8B's heads kept, head_dim kept)
MINITRON_WIDTH = dict(hidden_size=3072, intermediate_size=9216, num_kv_heads=8)
PRUNE_KD = dict(steps=4, tokens=(2, 512))  # (b): KD Adam steps (TRAIN_LR) of the pruned student on one batch
PRUNE_QAT_STEPS = 3         # (c): masked Adam steps on TRAIN_PRESET, one TRAIN_TOKENS batch
PRUNE_MOE = dict(depth=2, keep=64)  # (d): Qwen3-30B-A3B on 2 of its 48 layers, 128 -> 64 experts a layer
# The GEMM shapes the Minitron-4B-Width widths give rows 1 and 4 (new K:
# 3072 and 9216), at a prefill of 8 x 2048 and a decode step of 8
MINITRON_GEMMS = tuple(("minitron-4b-width", label, O, K, ("int4", "w4a8"), (16384, 8)) for label, O, K in (
    ("q_proj", 4096, 3072), ("k_proj/v_proj", 1024, 3072), ("o_proj", 3072, 4096),
    ("gate_proj/up_proj", 9216, 3072), ("down_proj", 3072, 9216)))
PRUNE_KERNELS = ("qmm_w4a8", "qmm_int4_wo", "flash_gqa", "kv_decode_attention")
# (e) on artifacts/anchor-llama in f32, the card against the CPU. Magnitude
# masks and weights are equal bit for bit. SparseGPT's choices follow f32
# sums in another order (cuSOLVER's Cholesky against LAPACK's), and the
# anchor's activations make H ill-conditioned (mlp's down_proj: K = 704 from
# 512 tokens, rank-deficient but for the damping): a mask that flips at a
# near tie cascades through its row's later blocks. So SparseGPT is held by
# what it optimizes: each projection's reconstruction error ||X (W_s -
# W)^T||^2 on the card within PRUNE_OUT_ERR_REL of the CPU's, with at most
# PRUNE_MASK_APART_MAX of its mask elements apart; the weights' relative
# Frobenius distance is printed. On an H100: q / k / v masks equal, weights
# 1.0e-5 apart; o / gate / up / down 4 / 22 / 6 / 210 mask elements apart
# (down 1.9e-4 of its elements), weights 3.4e-3-1.4e-2 apart, the
# reconstruction errors within 7.2e-5 of the CPU's
PRUNE_OUT_ERR_REL = 1e-3
PRUNE_MASK_APART_MAX = 1e-3
PRUNE_ANCHOR_SEARCH = dict(fastnas_steps=6, search_iterations=4)


def _masked_nonzero(torch, cm, masks: dict) -> dict:
    """Each masked projection of a compressed model decoded by the plain
    dequantizer (`compress.decompress_weight`: the canonical "int4" / "fp8"
    packs, or the served "int4a8" / "int4wo" rows a layer at a time): the
    number of decoded values that are not 0 where the mask is off."""
    from tensorrt_model_optimizer_tpu_torch.quant import compress

    out = {}
    for name, mask in masks.items():
        kind, arrays = cm.kinds[name], cm.params["layers"][name]
        L, O, K = mask.shape
        if kind in ("int4", "fp8"):
            w = compress.decompress_weight(kind, arrays, torch.float32)
        else:
            w = torch.stack([compress.decompress_weight(kind, compress.layer_arrays(arrays, i), torch.float32)
                             for i in range(L)])
        out[name] = int((w[..., :K][~mask] != 0).sum())
    return out


def _serve_ab(torch, engines: dict, prompt, steps: int, launches: dict) -> dict:
    """TTFT and the graphed token step of each engine (name -> engine) in
    the same call, in order then in reverse (A B B A): an untimed warm-up
    prefill each, then each round a prefill of `prompt` (TTFT) and `steps`
    steps through decode_step(unroll=8) (wall a token step: the calls after
    the capturing one). Medians over the two rounds; the timed runs' launch
    counts are added to `launches`."""
    sync = torch.cuda.synchronize
    for eng in engines.values():
        eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
    times = {name: {"ttft_ms": [], "step_ms": []} for name in engines}
    for order in (list(engines), list(engines)[::-1]):
        for name in order:
            eng = engines[name]
            cache = eng.init_cache(prompt.shape[0])
            _counts(reset=True)
            sync()
            t0 = time.perf_counter()
            logits = eng.prefill(prompt, cache)
            sync()
            times[name]["ttft_ms"].append((time.perf_counter() - t0) * 1e3)
            tok, walls = torch.argmax(logits, dim=-1).to(torch.int32)[:, None], []
            for _ in range(steps // 8):
                t0 = time.perf_counter()
                tok, cache = eng.decode_step(tok, cache, unroll=8)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            times[name]["step_ms"].append(statistics.median(walls[1:]) / 8)
            for k, n in _counts().items():
                launches[k] = launches.get(k, 0) + n
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"prune: {name}'s prefill logits are not finite")
            eng.release_graphs()
            del cache
    return {name: {"ttft_ms": statistics.median(t["ttft_ms"]), "graphed_ms_per_token_step": statistics.median(
        t["step_ms"]), "readings": t} for name, t in times.items()}


def _hold_served(torch, dev, sz: Sizes, label: str, cm, gemm: str, layouts: dict, prompt) -> dict:
    """The kernel engine over `cm` against the engine whose GEMM (only)
    runs its plain version: W4A8 (bit-exact) in lock step over the prompt
    and sz.decode_steps tokens, every step's logits equal; INT4 weight-only
    by the calib phase's rule, the first CALIB_PLAIN_DEPTH layers' prefill
    logits within CALIB_PLAIN_REL_MAX. Raises; returns the readings."""
    plain = (PLAIN_NAME[gemm],)
    if gemm == "qmm_w4a8":
        ek = _engine(torch, cm, sz.max_seq, dev, **layouts)
        ep = _engine(torch, cm, sz.max_seq, dev, plain, **layouts)
        held = _lockstep(torch, (ek, ep), prompt, sz.decode_steps)
        gaps = [g for lk, lp in held for g in _gaps(lk, lp)[0]]
        row = {"steps_held": len(held), "logits_equal_every_step": all(torch.equal(k, p) for k, p in held),
               "worst_logits_gap": max(gaps)}
        if not row["logits_equal_every_step"]:
            raise AssertionError(f"prune {label}: the W4A8 engine's logits leave its plain GEMM's: {row}")
        return row
    sub = _truncate(cm, CALIB_PLAIN_DEPTH)
    out = _engine(torch, sub, sz.max_seq, dev, **layouts)
    ref = _engine(torch, sub, sz.max_seq, dev, plain, **layouts)
    rel = _rel(out.prefill(prompt, out.init_cache(sz.batch)), ref.prefill(prompt, ref.init_cache(sz.batch)))
    row = {"depth": CALIB_PLAIN_DEPTH, "prefill_logits_rel_err": rel, "limit": CALIB_PLAIN_REL_MAX}
    if not rel <= CALIB_PLAIN_REL_MAX:
        raise AssertionError(f"prune {label}: depth-{CALIB_PLAIN_DEPTH} prefill logits {rel} from the plain GEMM's")
    return row


def _prune_full(torch, dev, sz: Sizes, timer: Timer, rows: dict) -> dict:
    """(a) 2:4 sparsity at Llama-3.1-8B's widths on PRUNE_DEPTH layers
    (seeded bf16 on the card): magnitude, then SparseGPT from PRUNE_CALIB
    (seconds, peak memory); the dense and the SparseGPT model through
    PRUNE_PRESET -> compress -> the kernel engine under both PRUNE_SERVED
    routes: TTFT of 8 x 2048 and the graphed step side by side (`_serve_ab`),
    the packed weights decoded by the plain dequantizer 0 wherever the mask
    is off, and the sparse model held to its plain GEMM (`_hold_served`).
    (b) Minitron: importance from PRUNE_CALIB, the 4-layer model cut to
    MINITRON_WIDTH and the 8-layer one to 4 layers by depth; PRUNE_KD
    steps of the width-pruned student against the dense teacher (losses
    finite and falling); the student served under both routes and held the
    same way; W4A8's unified HF export -> `load_quantized_checkpoint` ->
    engine, its logits equal to the engine's over the export's tensors held
    in memory; rows 1 and 4 at MINITRON_GEMMS. (c) Masked QAT: TRAIN_PRESET
    on the SparseGPT model, PRUNE_QAT_STEPS Adam steps through
    `make_optax_train_step(masks=...)`: finite losses, every masked-off
    weight 0 after every step. (d) Qwen3-30B-A3B's widths on PRUNE_MOE's
    layers, its experts pruned 128 -> 64 by routing importance, W4A8 served
    on the MoE engine (`_moe_full_path`: held to the all-plain engine on
    pinned routes). Returns the launch counts of the served runs."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.distill import distillation
    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import llama, mixtral
    from tensorrt_model_optimizer_tpu_torch.prune import minitron, minitron_moe
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq, qat
    from tensorrt_model_optimizer_tpu_torch.serve import loader
    from tensorrt_model_optimizer_tpu_torch.sparsity import magnitude, sparsify

    sync = torch.cuda.synchronize
    card = nvidia_smi()
    launches: dict = {}
    cfg8 = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_hidden_layers=PRUNE_DEPTH_FROM)
    t0 = time.perf_counter()
    params8 = llama.init_params(cfg8, torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg = dataclasses.replace(cfg8, num_hidden_layers=PRUNE_DEPTH)
    params = {**params8, "layers": {k: v[:PRUNE_DEPTH] for k, v in params8["layers"].items()}}
    g = torch.Generator(device=dev).manual_seed(7)
    n, B, T = PRUNE_CALIB
    calib = [torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev) for _ in range(n)]
    prompt = torch.randint(0, cfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    sync()
    log(json.dumps({"phase": "prune_setup", "layers": PRUNE_DEPTH_FROM, "init_params_s": time.perf_counter() - t0,
                    "card": card}))

    # (a) 2:4 sparsity
    t0 = time.perf_counter()
    _, mag_masks = sparsify.sparsify(cfg, params, "magnitude")
    sync()
    mag_s = time.perf_counter() - t0
    sync()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    sp, masks = sparsify.sparsify(cfg, params, "sparsegpt", calib_batches=calib)
    sync()
    sgpt_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ratios = {k: magnitude.sparsity_ratio(m) for k, m in masks.items()}
    off = {k: int((sp["layers"][k][~m] != 0).sum()) for k, m in masks.items()}
    row = {"phase": "prune_sparsify", "layers": PRUNE_DEPTH, "pattern": "2:4", "calib_batches": list(PRUNE_CALIB),
           "magnitude_s": mag_s, "sparsegpt_s": sgpt_s, "sparsegpt_s_per_layer": sgpt_s / PRUNE_DEPTH,
           "peak_gb": peak_gb, "peak_over_start_gb": peak_gb - base_gb,
           "down_proj_hessian_gb": cfg.intermediate_size ** 2 * 4 / 1e9, "sparsity": ratios,
           "masked_weights_not_zero": off,
           "mask_agreement_with_magnitude": {k: float((masks[k] == mag_masks[k]).float().mean()) for k in masks},
           "card": card}
    log(json.dumps(row))
    if any(off.values()) or any(r != 0.5 for r in ratios.values()):
        raise AssertionError(f"prune sparsify: {row}")
    del mag_masks

    served = {}
    for label, layouts, gemm in PRUNE_SERVED:
        layouts = dict(layouts)
        cms = {"dense": compress.compress(ptq.quantize(cfg, params, PRUNE_PRESET, None, device=dev)),
               "sparse_2_4": compress.compress(ptq.quantize(cfg, sp, PRUNE_PRESET, None, device=dev))}
        engines = {k: _engine(torch, cm, sz.max_seq, dev, **layouts) for k, cm in cms.items()}
        zeros = {"canonical": _masked_nonzero(torch, cms["sparse_2_4"], masks),
                 "served": _masked_nonzero(torch, engines["sparse_2_4"].cm, masks)}
        times = _serve_ab(torch, engines, prompt, sz.decode_steps, launches)
        del engines
        held = _hold_served(torch, dev, sz, f"2:4 {label}", cms["sparse_2_4"], gemm, layouts, prompt)
        row = {"phase": "prune_sparse_serve", "path": label, "layers": PRUNE_DEPTH, "batch": sz.batch,
               "prompt": sz.prompt, "decode_steps": sz.decode_steps, **{k: v for k, v in times.items()},
               "sparse_over_dense_ttft": times["sparse_2_4"]["ttft_ms"] / times["dense"]["ttft_ms"],
               "sparse_over_dense_step": times["sparse_2_4"]["graphed_ms_per_token_step"] /
               times["dense"]["graphed_ms_per_token_step"],
               "masked_values_not_zero": zeros, "vs_plain_gemm": held, "card": card}
        log(json.dumps(row))
        served[label] = times["dense"]
        if any(n for z in zeros.values() for n in z.values()):
            raise AssertionError(f"prune 2:4 {label}: decoded packed weights not 0 where the mask is off: {zeros}")
        del cms
        torch.cuda.empty_cache()

    # (b) Minitron width and depth pruning
    sync()
    t0 = time.perf_counter()
    scores = minitron.importance(cfg, params, calib)
    scfg, student, plan = minitron.prune(cfg, params, scores, **MINITRON_WIDTH)
    sync()
    prune_s = time.perf_counter() - t0
    shapes = {k: list(v.shape[1:]) for k, v in student["layers"].items() if k in llama.PROJ_NAMES}
    q, kv = cfg.num_attention_heads * cfg.hd, cfg.num_key_value_heads * cfg.hd
    H, I = MINITRON_WIDTH["hidden_size"], MINITRON_WIDTH["intermediate_size"]
    want = {"self_attn.q_proj": [q, H], "self_attn.k_proj": [kv, H], "self_attn.v_proj": [kv, H],
            "self_attn.o_proj": [H, q], "mlp.gate_proj": [I, H], "mlp.up_proj": [I, H], "mlp.down_proj": [H, I]}
    t0 = time.perf_counter()
    dcfg, dparams, dplan = minitron.prune(cfg8, params8, minitron.importance(cfg8, params8, calib),
                                          num_layers=PRUNE_DEPTH)
    with torch.no_grad():
        dlogits = llama.forward(dcfg, dparams, calib[0])[0]
    sync()
    row = {"phase": "prune_minitron", "widths": {"hidden": scfg.hidden_size, "ffn": scfg.intermediate_size,
                                                 "heads": scfg.num_attention_heads, "kv_heads": scfg.num_key_value_heads,
                                                 "head_dim": scfg.hd},
           "projection_shapes": shapes, "importance_and_prune_s": prune_s,
           "kept_kv_groups": plan.keep_kv_groups.tolist(), "kept_hidden_first": plan.keep_hidden[:8].tolist(),
           "depth": {"from": PRUNE_DEPTH_FROM, "to": dcfg.num_hidden_layers, "kept_layers": dplan.keep_layers.tolist(),
                     "s": time.perf_counter() - t0, "logits_finite": bool(torch.isfinite(dlogits).all())},
           "student_params_b": sum(v.numel() for v in [student["embed_tokens"], student["lm_head"],
                                                       *student["layers"].values()]) / 1e9, "card": card}
    log(json.dumps(row))
    if shapes != want or scfg.hd != cfg.hd or dplan.keep_layers.tolist()[-1] != PRUNE_DEPTH_FROM - 1 or \
            not row["depth"]["logits_finite"]:
        raise AssertionError(f"prune minitron: {row}")
    del dparams, dlogits
    kd_batch = torch.randint(0, cfg.vocab_size, (PRUNE_KD["tokens"][0], PRUNE_KD["tokens"][1] + 1), generator=g,
                             device=dev)
    kd = distillation.KDConfig()
    res = _adam_mode(torch, lambda p: distillation.distill_loss(scfg, p, params, kd_batch, kd, teacher_cfg=cfg),
                     student, PRUNE_KD["steps"])
    student = res.pop("tree")
    row = {"phase": "prune_distill", "steps": PRUNE_KD["steps"] + 1, "batch": list(PRUNE_KD["tokens"]),
           "losses": res["losses"], "step_ms": res["step_ms"], "peak_gb": res["peak_gb"],
           "teacher": f"the dense {PRUNE_DEPTH}-layer bf16 model", "kd": dataclasses.asdict(kd), "card": card}
    log(json.dumps(row))
    ls = res["losses"]
    if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
        raise AssertionError(f"prune distill: losses {ls} not finite and falling")
    del res
    torch.cuda.empty_cache()
    for label, layouts, gemm in PRUNE_SERVED:
        layouts = dict(layouts)
        qm = ptq.quantize(scfg, student, PRUNE_PRESET, None, device=dev)
        cm = compress.compress(qm)
        times = _serve_ab(torch, {"minitron_4b_width": _engine(torch, cm, sz.max_seq, dev, **layouts)}, prompt,
                          sz.decode_steps, launches)["minitron_4b_width"]
        held = _hold_served(torch, dev, sz, f"minitron {label}", cm, gemm, layouts, prompt)
        row = {"phase": "prune_minitron_serve", "path": label, "layers": PRUNE_DEPTH, **times,
               "dense_8b_widths_same_call": served[label],
               "over_dense_ttft": times["ttft_ms"] / served[label]["ttft_ms"],
               "over_dense_step": times["graphed_ms_per_token_step"] / served[label]["graphed_ms_per_token_step"],
               "vs_plain_gemm": held, "card": card}
        if gemm == "qmm_w4a8":  # export -> load -> serve
            with tempfile.TemporaryDirectory(prefix="chip_smoke_prune_") as d:
                sync()
                t0 = time.perf_counter()
                qc = hf_export.export_hf_checkpoint(qm, d)
                with open(os.path.join(d, "config.json")) as f:
                    hf_cfg = json.load(f)
                loaded = loader.load_quantized_checkpoint(d, device=dev)
                sync()
                deploy_s = time.perf_counter() - t0
            streamed = loader.compressed_from_export(hf_cfg, qc["quantization"],
                                                     dict(hf_export._iter_export_tensors(qm)), dev)
            outs = {}
            for name, model in (("loaded", loaded), ("in_memory_export", streamed), ("in_memory_compress", cm)):
                e = _engine(torch, model, sz.max_seq, dev, **layouts)
                outs[name] = e.prefill(prompt, e.init_cache(sz.batch))
                del e
            row["deploy"] = {"quant_algo": qc["quantization"]["quant_algo"], "export_load_s": deploy_s,
                             "hf_config": {k: hf_cfg[k] for k in ("hidden_size", "intermediate_size", "head_dim",
                                                                  "num_attention_heads", "num_key_value_heads")},
                             "logits_equal_in_memory_export": bool(torch.equal(outs["loaded"], outs["in_memory_export"])),
                             "median_gap_vs_compress": statistics.median(_gaps(outs["loaded"], outs["in_memory_compress"])[0])}
            if not row["deploy"]["logits_equal_in_memory_export"]:
                raise AssertionError(f"prune minitron deploy: the loaded engine's logits differ from the engine's "
                                     f"over the export's tensors: {row['deploy']}")
            del loaded, streamed, outs
        log(json.dumps(row))
        del qm, cm
        torch.cuda.empty_cache()
    for k in ("qmm_w4a8", "qmm_int4_wo"):
        rows.setdefault(k, {"shapes": []})
    _phase_kernels_families(torch, dev, sz, timer, rows, torch.Generator(device=dev).manual_seed(0), MINITRON_GEMMS)
    del student, scores
    torch.cuda.empty_cache()

    # (c) masked QAT
    qm = ptq.quantize(cfg, sp, TRAIN_PRESET, calib[:2], device=dev)
    before = {k: int((qm.params["layers"][k][~m] != 0).sum()) for k, m in masks.items()}
    step_fn, init_fn = qat.make_optax_train_step(cfg, qm.layout, qat.Adam(TRAIN_LR), masks=masks)
    opt = init_fn(qm.params, qm.qstate)
    batch = torch.randint(0, cfg.vocab_size, (TRAIN_TOKENS[0], TRAIN_TOKENS[1] + 1), generator=g, device=dev)
    p, losses, walls, off, negative = qm.params, [], [], [], 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PRUNE_QAT_STEPS):
        sync()
        t0 = time.perf_counter()
        p, _, opt, loss = step_fn(p, qm.qstate, opt, batch)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
        off.append(sum(int((p["layers"][k][~m] != 0).sum()) for k, m in masks.items()))
        negative = sum(int(torch.signbit(p["layers"][k][~m]).sum()) for k, m in masks.items())
    moved = all(not torch.equal(p["layers"][k], qm.params["layers"][k]) for k in masks)
    row = {"phase": "prune_masked_qat", "preset": TRAIN_PRESET, "layers": PRUNE_DEPTH, "batch": list(TRAIN_TOKENS),
           "losses": losses, "step_ms": walls, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "masked_not_zero_before": sum(before.values()), "masked_not_zero_after_each_step": off,
           "masked_zeros_negative_sign": negative, "kept_weights_moved": moved, "card": card}
    log(json.dumps(row))
    if not all(math.isfinite(v) for v in losses) or any(off) or any(before.values()) or not moved:
        raise AssertionError(f"prune masked qat: {row}")
    del qm, p, opt, sp, params, params8, masks
    torch.cuda.empty_cache()

    # (d) expert pruning at Qwen3-30B-A3B's widths
    mcfg = mixtral.MixtralConfig(**{**QWEN3_30B_A3B, "num_hidden_layers": PRUNE_MOE["depth"]})
    mparams = mixtral.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    mcalib = [torch.randint(0, mcfg.vocab_size, (B, T), generator=g, device=dev) for _ in range(n)]
    sync()
    t0 = time.perf_counter()
    mscores = minitron_moe.expert_importance(mcfg, mparams, mcalib)
    pcfg, pparams = minitron_moe.prune_experts(mcfg, mparams, PRUNE_MOE["keep"], mscores)
    sync()
    row = {"phase": "prune_experts", "model": "qwen3_30b_a3b", "layers": PRUNE_MOE["depth"],
           "experts": [mcfg.num_experts, pcfg.num_experts], "top_k": pcfg.top_k, "seconds": time.perf_counter() - t0,
           "kept_importance_share": [float(torch.sort(mscores[i], descending=True).values[:PRUNE_MOE["keep"]].sum() /
                                           mscores[i].sum()) for i in range(PRUNE_MOE["depth"])],
           "router_rows": list(pparams["layers"]["moe.router"].shape), "card": card}
    log(json.dumps(row))
    if pparams["layers"]["moe.gate_proj"].shape[1] != PRUNE_MOE["keep"] or pcfg.top_k != mcfg.top_k:
        raise AssertionError(f"prune experts: {row}")
    del mparams
    mprompt = torch.randint(0, pcfg.vocab_size, (sz.batch, sz.prompt), generator=g, device=dev)
    for k, v in _moe_full_path(torch, dev, sz, MOE_FULL_PATHS[0], pcfg, pparams, mprompt,
                               f"qwen3_30b_a3b_{PRUNE_MOE['keep']}_experts").items():
        launches[k] = launches.get(k, 0) + v
    del pparams
    torch.cuda.empty_cache()
    return launches


def _sgpt_out_err(torch, cfg, params, new, caps) -> dict:
    """||X (W_s - W)^T||_F^2 of each projection over the captured inputs
    (f64, on the CPU): the reconstruction error SparseGPT minimizes."""
    from tensorrt_model_optimizer_tpu_torch.quant.ptq import CAPTURE_GROUPS

    out = {}
    for key, members in CAPTURE_GROUPS.items():
        X = caps[key].double()
        for name in members:
            d = (new["layers"][name].cpu().double() - params["layers"][name].double())
            out[name] = float(sum((X[i] @ d[i].t()).square().sum() for i in range(cfg.num_hidden_layers)))
    return out


def _prune_anchor(torch, dev) -> dict:
    """(e) artifacts/anchor-llama in f32: magnitude and SparseGPT 2:4 on the
    card and on the CPU from the same weights and synthlang calibration
    batches (magnitude: masks and weights equal; SparseGPT: masks apart at
    most PRUNE_MASK_APART_MAX, the reconstruction error within
    PRUNE_OUT_ERR_REL of the CPU's); ppl dense -> magnitude -> SparseGPT ->
    SparseGPT + FP8_DEFAULT (fake quant), and that FP8 model in bf16
    served by the kernel engine (FP8 byte GEMM) against its fake-quant
    forward (ENGINE_VS_FAKE_QUANT_MAX), its packed codes 0 where the mask is
    off; FastNAS's ratio and a short AutoNAS search's best config on the
    card equal to the CPU's. Returns the served run's launch counts."""
    from tensorrt_model_optimizer_tpu_torch.models import hf_loader, llama
    from tensorrt_model_optimizer_tpu_torch.nas import autonas
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.sparsity import sparsify
    from tensorrt_model_optimizer_tpu_torch.utils import evaluate, synthlang

    cfg, params = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device=dev)
    cpu = hf_loader.load_hf_checkpoint(ANCHOR, dtype=torch.float32, device="cpu")[1]
    lang = synthlang.SynthLang(0)
    ev = [torch.from_numpy(b).to(dev) for b in lang.eval_batches(2, 8, 256, seed=999)]
    calib_np = lang.eval_batches(4, 4, 256, seed=555)
    calib, calib_cpu = [torch.from_numpy(b).to(dev) for b in calib_np], [torch.from_numpy(b) for b in calib_np]
    with torch.no_grad():
        caps = sparsify._captures(cfg, cpu, calib_cpu, 128)
    failures, card_models = [], {}
    for method in ("magnitude", "sparsegpt"):
        t0 = time.perf_counter()
        on_card, m_card = sparsify.sparsify(cfg, params, method, calib_batches=calib)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu, m_cpu = sparsify.sparsify(cfg, cpu, method, calib_batches=calib_cpu)
        cpu_s = time.perf_counter() - t0
        per = {}
        for name in llama.PROJ_NAMES:
            a, b = on_card["layers"][name].cpu(), on_cpu["layers"][name]
            per[name] = {"masks_apart": int((m_card[name].cpu() != m_cpu[name]).sum()),
                         "weights_rel_frob": _rel_frob(a, b), "weights_equal": bool(torch.equal(a, b))}
        row = {"phase": "prune_anchor_card_cpu", "method": method, "card_s": card_s, "cpu_s": cpu_s, "per": per}
        if method == "sparsegpt":
            e_card, e_cpu = _sgpt_out_err(torch, cfg, cpu, on_card, caps), _sgpt_out_err(torch, cfg, cpu, on_cpu, caps)
            for name in per:
                per[name]["out_err_rel_vs_cpu"] = abs(e_card[name] - e_cpu[name]) / e_cpu[name]
                per[name]["masks_apart_share"] = per[name]["masks_apart"] / m_cpu[name].numel()
            bad = {k: v for k, v in per.items() if not (v["out_err_rel_vs_cpu"] <= PRUNE_OUT_ERR_REL
                                                        and v["masks_apart_share"] <= PRUNE_MASK_APART_MAX)}
        else:
            bad = {k: v for k, v in per.items() if v["masks_apart"] or not v["weights_equal"]}
        log(json.dumps(row))
        if bad:
            failures.append(f"prune anchor {method}: card against CPU: {bad}")
        card_models[method] = (on_card, m_card)
        del on_cpu, m_cpu
    sgpt, masks = card_models["sparsegpt"]
    fp8 = ptq.quantize(cfg, sgpt, "FP8_DEFAULT_CFG", calib, device=dev)
    ppl = {"dense": evaluate.perplexity(cfg, params, ev),
           "magnitude_2_4": evaluate.perplexity(cfg, card_models["magnitude"][0], ev),
           "sparsegpt_2_4": evaluate.perplexity(cfg, sgpt, ev),
           "sparsegpt_2_4_fp8": evaluate.perplexity(cfg, fp8.params, ev, layout=fp8.layout, qstate=fp8.qstate)}
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bf = ptq.quantize(bcfg, {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else
                                 {n: a.to(torch.bfloat16) for n, a in v.items()}) for k, v in sgpt.items()},
                      "FP8_DEFAULT_CFG", calib, device=dev)
    cm = compress.compress(bf)
    g = torch.Generator(device=dev).manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device=dev)
    eng = _engine(torch, cm, 128, dev, kv=None)
    _counts(reset=True)
    served = eng.prefill(prompt, eng.init_cache(prompt.shape[0]))
    launches = _counts()
    gap = statistics.median(_gaps(served, bf.forward(prompt)[0][:, -1])[0])
    zeros = _masked_nonzero(torch, cm, masks)
    t0 = time.perf_counter()
    ratio_card = autonas.fastnas_prune(cfg, params, calib, steps=PRUNE_ANCHOR_SEARCH["fastnas_steps"])[2]
    ratio_cpu = autonas.fastnas_prune(cfg, cpu, calib_cpu, steps=PRUNE_ANCHOR_SEARCH["fastnas_steps"])[2]
    space = autonas.convert(cfg)
    it = PRUNE_ANCHOR_SEARCH["search_iterations"]
    s_card = autonas.search(cfg, params, space, calib, iterations=it)[0]
    s_cpu = autonas.search(cfg, cpu, space, calib_cpu, iterations=it)[0]
    row = {"phase": "prune_anchor", "ppl": ppl, "fp8_served_vs_fake_quant_median_gap": gap,
           "limit": ENGINE_VS_FAKE_QUANT_MAX, "fp8_masked_codes_not_zero": zeros,
           "kinds_served": sorted(set(eng.cm.kinds.values())),
           "fastnas_ratio": {"card": ratio_card, "cpu": ratio_cpu},
           "autonas_best": {"card": s_card.best_config, "cpu": s_cpu.best_config,
                            "card_score": s_card.best_score, "cpu_score": s_cpu.best_score},
           "search_s": time.perf_counter() - t0, "card": nvidia_smi()}
    log(json.dumps(row))
    if not all(math.isfinite(v) for v in ppl.values()) or not gap <= ENGINE_VS_FAKE_QUANT_MAX or any(zeros.values()):
        failures.append(f"prune anchor: ppl {ppl}, FP8 served gap {gap}, codes not zero {zeros}")
    if ratio_card != ratio_cpu or s_card.best_config != s_cpu.best_config:
        failures.append(f"prune anchor: the searches on the card and on the CPU differ: {row['fastnas_ratio']}, "
                        f"{row['autonas_best']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def phase_prune(torch, dev, sz: Sizes, timer: Timer, rows: dict) -> dict:
    """(a)-(d) at full width (`_prune_full`), then (e) on the anchor
    (`_prune_anchor`). Returns the launch counts of the served runs."""
    launches = _prune_full(torch, dev, sz, timer, rows)
    torch.cuda.empty_cache()
    for k, n in _prune_anchor(torch, dev).items():
        launches[k] = launches.get(k, 0) + n
    return launches


# ---------------------------------------------------------------------------
# diffusion: DiT-XL/2 served on the weight-only GEMMs, the UNet, fastgen
# ---------------------------------------------------------------------------

# facebookresearch/DiT models.py `DiT_XL_2`: hidden 1152, depth 28, 16 heads,
# patch 2, on 32 x 32 x 4 latents (256 px): 256 tokens a latent
DIT_XL2 = dict(img_size=32, patch_size=2, in_channels=4, hidden_size=1152, depth=28, num_heads=16)
# its block GEMMs at N = 8 latents x 256 tokens (attn.qkv, attn.proj, mlp.fc1, mlp.fc2)
DIT_GEMMS = tuple(("dit-xl/2", label, O, K, ("int4", "nvfp4", "mxfp4", "fp8"), (2048,)) for label, O, K in (
    ("attn.qkv", 3456, 1152), ("attn.proj", 1152, 1152), ("mlp.fc1", 4608, 1152), ("mlp.fc2", 1152, 4608)))
DIFF_BATCH = 8            # latents a denoise step
DIFF_CALIB = 4            # seeded (x, t) calibration batches of DIFF_BATCH
DIFF_FORMATS = (("int8", "INT8_DEFAULT_CFG"), ("fp8", "FP8_DEFAULT_CFG"), ("nvfp4", "NVFP4_DEFAULT_CFG"),
                ("int4", "INT4_AWQ_CFG"), ("mxfp4", "MXFP4_DEFAULT_CFG"))
DIFF_STEP_REPS = 5        # timed denoise steps (CUDA events) after one warm-up
DIFF_TRAJ = 12            # chained steps x <- x - 0.1 eps of the quality proxy (tools/bench_diffusion.py)
DIFF_PLAIN_DEPTH = 2      # the kernels' step against the all-plain step at this depth ...
DIFF_PLAIN_MAX = 5e-2     # ... max |eps - eps_plain| over max |eps_plain| (the families' depth-2 rule)
DIFF_RANDOM_STD = 0.02    # std of the tensors the adaLN-zero init leaves at 0 (bench_diffusion's)
DIFF_PLAIN_OPS = ("int4_wo", "fp4_wo", "byte_wo")
DIFFUSION_KERNELS = ("qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo")
# runwayml/stable-diffusion-v1-5 unet/config.json: block_out_channels 320 / 640 /
# 1280 / 1280, 2 layers a block, 32 norm groups; 8 heads, time_dim 1280
UNET_LATENT = (2, 64, 64)   # batch, latent H = W (512 px)
UNET_FORMATS = ("FP8_DEFAULT_CFG", "INT8_DEFAULT_CFG")
UNET_CORR_MIN = 0.95        # quantized against unquantized eps (JAX's tests/test_unet.py bar)
FASTGEN_DEPTH = 4           # (c): DiT-XL/2's widths on 4 of its 28 blocks, f32
FASTGEN_FM = dict(steps=4, lr=1e-3)   # flow-matching SGD steps on one batch and one draw
FASTGEN_DMD = dict(rounds=3, lr=1e-4, gan_loss_weight_gen=1e-2)
CARD_CPU_TOL = 1e-5         # (d): forwards and amax, as the CPU tests hold the port to JAX
CARD_CPU_GRAD = 1e-4        # (d): losses and gradients, relative Frobenius


def _randomized_dit(torch, params: dict, g, std: float) -> dict:
    """A DiT's parameters with the adaLN-zero init's zeros (adaLN.mod,
    final_mod, final_proj, every bias) drawn from N(0, std^2), seeded."""
    def rnd(t):
        return (torch.randn(t.shape, generator=g, device=t.device) * std).to(t.dtype)

    blocks = {k: (rnd(v) if k == "adaLN.mod" or k.endswith("__bias") else v) for k, v in params["blocks"].items()}
    return {**params, "blocks": blocks, "final_mod": rnd(params["final_mod"]),
            "final_proj": rnd(params["final_proj"])}


def _dit_depth(cfg, params: dict, packed: dict, qstate: dict, depth: int):
    """The first `depth` blocks of a DiT, its packs and its state."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    def cut(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if type(tree).__name__ == "QuantizerState":
            return llama._map_state(lambda a: a[:depth], tree)
        return tree[:depth] if hasattr(tree, "shape") else tree

    return (dataclasses.replace(cfg, depth=depth), {**params, "blocks": cut(params["blocks"])}, cut(packed),
            cut(qstate))


def _event_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of `fn` over `reps` calls after one warm-up,
    each call on its own (host gaps count: a denoise step's wall)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _diffusion_dit(torch, dev) -> dict:
    """(a) DiT-XL/2 at full width in bf16: per format, calibration, packs,
    DIFF_TRAJ chained denoise steps and the timed step on the kernels (the
    launches counted), then the holds against the all-plain step. Returns
    the launch counts of the kernels' runs."""
    from tensorrt_model_optimizer_tpu_torch.models import dit

    cfg = dit.DiTConfig(**DIT_XL2, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(18)
    t_set = time.perf_counter()
    params = _randomized_dit(torch, dit.init_params(cfg, g, device=dev), g, DIFF_RANDOM_STD)

    def latents():
        return (torch.randn((DIFF_BATCH, cfg.img_size, cfg.img_size, cfg.in_channels), generator=g, device=dev)
                .to(cfg.dtype), torch.randint(0, 1000, (DIFF_BATCH,), generator=g, device=dev, dtype=torch.int32))

    x0, t = latents()
    calib = [latents() for _ in range(DIFF_CALIB)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_set

    def trajectory(step):
        """DIFF_TRAJ chained steps from x0: (each step's eps, the last x)."""
        x, eps_all = x0, []
        for _ in range(DIFF_TRAJ):
            eps = step(x)
            eps_all.append(eps)
            x = x - 0.1 * eps
        return eps_all, x

    launches: dict = {}
    with torch.no_grad():
        def bf16_step(x):
            return dit.forward(cfg, params, x, t)[0]

        ref_eps, ref_x = trajectory(bf16_step)
        out = {"bf16": {"step_ms": _event_ms(torch, lambda: bf16_step(x0), DIFF_STEP_REPS)}}
        torch.cuda.reset_peak_memory_stats()
        for fmt, preset in DIFF_FORMATS:
            t0 = time.perf_counter()
            layout, qstate = dit.quantize_dit(cfg, params, preset, calib)
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            kinds, packed = dit.serving_layouts(*dit.compress_dit(cfg, params, layout, qstate))
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0

            def step(x, cfg=cfg, params=params, kinds=kinds, packed=packed, layout=layout, qstate=qstate, plain=()):
                return dit.forward_packed(cfg, params, kinds, packed, x, t, layout=layout, qstate=qstate,
                                          plain_ops=plain)

            _counts(reset=True)
            eps_all, x_end = trajectory(step)
            ms = _event_ms(torch, lambda: step(x0), DIFF_STEP_REPS)
            torch.cuda.synchronize()
            counted = _counts()
            for k, n in counted.items():
                launches[k] = launches.get(k, 0) + n
            finite = all(bool(torch.isfinite(e).all()) for e in eps_all)
            if not finite:
                raise AssertionError(f"diffusion dit {fmt}: the denoise step's eps is not finite")
            # the holds (not counted): the kernels' step against the all-plain one
            cut = _dit_depth(cfg, params, packed, qstate, DIFF_PLAIN_DEPTH)
            held = _rel(step(x0, *cut[:2], kinds, cut[2], layout, cut[3]),
                        step(x0, *cut[:2], kinds, cut[2], layout, cut[3], plain=DIFF_PLAIN_OPS))
            full = _rel(step(x0), step(x0, plain=DIFF_PLAIN_OPS))
            row = {"step_ms": ms, "x_bf16": out["bf16"]["step_ms"] / ms, "kinds": sorted(set(kinds.values())),
                   "launches": {k: n for k, n in counted.items() if n},
                   "plain_hold_depth": DIFF_PLAIN_DEPTH, "plain_rel": held, "plain_rel_full_depth": full,
                   "limit": DIFF_PLAIN_MAX,
                   "eps_rel_err_steps": [_rel_frob(e, r) for e, r in zip(eps_all, ref_eps)],
                   f"x_rel_drift_{DIFF_TRAJ}steps": _rel_frob(x_end, ref_x),
                   "calib_s": calib_s, "pack_s": pack_s}
            out[fmt] = row
            log(json.dumps({"phase": "diffusion", "part": "dit-xl/2", "format": fmt, "preset": preset, **row}))
            if not held <= DIFF_PLAIN_MAX:
                raise AssertionError(f"diffusion dit {fmt}: depth-{DIFF_PLAIN_DEPTH} eps {held} of its scale from "
                                     f"the plain GEMMs' (limit {DIFF_PLAIN_MAX})")
            del kinds, packed, layout, qstate
        peak = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"phase": "diffusion", "part": "dit-xl/2", "batch": DIFF_BATCH, "tokens": DIFF_BATCH * 256,
                    "bf16_step_ms": out["bf16"]["step_ms"], "setup_s": setup_s, "peak_mem_gb": peak}))
    del params, calib
    return launches


def _diffusion_unet(torch, dev) -> dict:
    """(b) the UNet at SD-1.5's channel widths in bf16: FP8 and INT8 PTQ,
    the quantized eps against the unquantized (correlation), and a 4-step
    DDIM sample through the quantized model, finite."""
    from tensorrt_model_optimizer_tpu_torch.models import unet

    cfg = unet.UNetConfig.sd15(dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(19)
    params = unet.init_params(cfg, g, device=dev)
    for k, v in params.items():  # conv_out's zero init and the zero biases drawn at random
        if k == "conv_out" or k.endswith("__bias"):
            params[k] = (torch.randn(v.shape, generator=g, device=dev) * DIFF_RANDOM_STD).to(v.dtype)
    B, H, _ = UNET_LATENT

    def latents():
        return (torch.randn((B, H, H, cfg.in_channels), generator=g, device=dev).to(cfg.dtype),
                torch.randint(0, 1000, (B,), generator=g, device=dev, dtype=torch.int32))

    x, t = latents()
    rows = {"params_m": sum(v.numel() for v in params.values()) / 1e6}
    with torch.no_grad():
        ref = unet.forward(cfg, params, x, t)[0]
        rows["bf16_ms"] = _event_ms(torch, lambda: unet.forward(cfg, params, x, t), 3)
        for preset in UNET_FORMATS:
            t0 = time.perf_counter()
            layout, qstate = unet.quantize_unet(cfg, params, preset, [latents(), latents()])
            calib_s = time.perf_counter() - t0
            q = unet.forward(cfg, params, x, t, layout=layout, qstate=qstate)[0]
            corr = float(torch.corrcoef(torch.stack([q.float().flatten(), ref.float().flatten()]))[0, 1])
            h = x
            for ti in (900, 600, 300, 0):
                h = h - 0.1 * unet.forward(cfg, params, h, torch.full((B,), ti, dtype=torch.int32, device=dev),
                                           layout=layout, qstate=qstate)[0]
            finite = bool(torch.isfinite(h).all())
            rows[preset] = {"corr": corr, "ddim4_finite": finite, "calib_s": calib_s,
                            "fake_quant_ms": _event_ms(torch, lambda: unet.forward(cfg, params, x, t, layout=layout,
                                                                                   qstate=qstate), 3)}
            if not (corr >= UNET_CORR_MIN and finite):
                raise AssertionError(f"diffusion unet {preset}: corr {corr} (min {UNET_CORR_MIN}), finite {finite}")
    log(json.dumps({"phase": "diffusion", "part": "unet sd-1.5 widths", "latent": list(UNET_LATENT), **rows}))
    return rows


def _dmd_round(torch, cfg, models: dict, noise, latents, g, lr: float, dcfg):
    """One DMD2 alternation: an SGD step of the student, the fake score and
    the discriminator, each on its own loss and draws -> their losses."""
    from tensorrt_model_optimizer_tpu_torch.fastgen import dmd
    from tensorrt_model_optimizer_tpu_torch.quant import qat

    sl, fl, dl = dmd.make_dmd_losses(cfg, dcfg)
    losses = {}
    d = dmd.draw(noise, g)
    loss, gr = qat.value_and_grad(lambda s: sl(s, models["teacher"], models["fake"], models["disc"], noise, d)[0],
                                  models["student"])
    models["student"], losses["student"] = qat.sgd_update(models["student"], gr, lr), float(loss)
    d = dmd.draw(noise, g)
    loss, gr = qat.value_and_grad(lambda f: fl(f, models["student"], noise, d), models["fake"])
    models["fake"], losses["fake_score"] = qat.sgd_update(models["fake"], gr, lr), float(loss)
    d = dmd.draw(noise, g, r1=True)
    loss, gr = qat.value_and_grad(lambda w: dl(w, models["teacher"], models["student"], latents, noise, d),
                                  models["disc"])
    models["disc"], losses["disc"] = qat.sgd_update(models["disc"], gr, lr), float(loss)
    return losses


def _diffusion_fastgen(torch, dev) -> dict:
    """(c) fastgen in f32 at DiT-XL/2's widths on FASTGEN_DEPTH blocks:
    flow-matching SGD steps on one batch and one draw (the loss must fall),
    a few-step-distillation step, DMD2 alternations (student, fake score,
    discriminator)."""
    from tensorrt_model_optimizer_tpu_torch.fastgen import dmd, trainers
    from tensorrt_model_optimizer_tpu_torch.models import dit

    cfg = dit.DiTConfig(**{**DIT_XL2, "depth": FASTGEN_DEPTH}, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(20)
    models = {k: _randomized_dit(torch, dit.init_params(cfg, g, device=dev), g, DIFF_RANDOM_STD)
              for k in ("teacher", "student", "fake")}
    models["disc"] = dmd.init_discriminator(cfg, dmd.DiscriminatorConfig(), g, device=dev)
    shape = (DIFF_BATCH, cfg.img_size, cfg.img_size, cfg.in_channels)
    x0, noise = torch.randn(shape, generator=g, device=dev), torch.randn(shape, generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    step = trainers.make_flow_matching_step(cfg, lr=FASTGEN_FM["lr"])
    draws = trainers.flow_matching_draws(x0, g)
    p, losses, walls = models["teacher"], [], []
    for _ in range(FASTGEN_FM["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, loss = step(p, x0, draws)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
    out["flow_matching"] = {"losses": losses, "step_ms": statistics.median(walls[1:])}
    if not losses[-1] < losses[0]:
        raise AssertionError(f"diffusion fastgen: flow matching's loss does not fall on one batch: {losses}")
    t0 = time.perf_counter()
    _, loss = trainers.make_distill_fewstep_step(cfg, teacher_steps=4, lr=FASTGEN_DMD["lr"])(
        models["student"], models["teacher"], noise)
    out["distill_fewstep"] = {"loss": float(loss), "step_ms": (time.perf_counter() - t0) * 1e3}
    dcfg = dmd.DMDConfig(gan_loss_weight_gen=FASTGEN_DMD["gan_loss_weight_gen"])
    rounds = []
    for _ in range(FASTGEN_DMD["rounds"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds.append({**_dmd_round(torch, cfg, models, noise, x0, g, FASTGEN_DMD["lr"], dcfg),
                       "ms": (time.perf_counter() - t0) * 1e3})
    out["dmd2"] = rounds
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for r in rounds for v in r.values()) or not math.isfinite(out["distill_fewstep"]["loss"]):
        raise AssertionError(f"diffusion fastgen: a loss is not finite: {out}")
    log(json.dumps({"phase": "diffusion", "part": f"fastgen f32, dit-xl/2 widths, {FASTGEN_DEPTH} blocks", **out}))
    return out


def _card_cpu(torch, label: str, card, cpu, tol: float, frob: bool = False) -> float:
    """The card's tensor against the CPU's: max-relative (or relative
    Frobenius) error, raised above `tol`."""
    card = card.detach().cpu()
    err = _rel_frob(card, cpu) if frob else _rel(card, cpu.detach())
    if not err <= tol:
        raise AssertionError(f"diffusion card vs CPU {label}: {err} > {tol}")
    return err


def _diffusion_card_cpu(torch, dev) -> dict:
    """(d) tiny f32 DiT, UNet and fastgen losses on the card against the CPU,
    the same weights and inputs: forwards and calibrated amax within
    CARD_CPU_TOL, losses and gradients within CARD_CPU_GRAD (relative
    Frobenius), the CPU tests' tolerances against JAX."""
    from tensorrt_model_optimizer_tpu_torch.fastgen import dmd, trainers
    from tensorrt_model_optimizer_tpu_torch.models import dit, unet
    from tensorrt_model_optimizer_tpu_torch.quant import qat
    from tensorrt_model_optimizer_tpu_torch.utils.tree import flatten_with_names, map_tensors

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(21)
    to = (lambda tree: map_tensors(lambda a: a.to(dev), tree))
    errs = {}
    dcfg = dit.DiTConfig.tiny(hidden_size=128, img_size=16, patch_size=2)
    dp = {k: _randomized_dit(torch, dit.init_params(dcfg, g, device=cpu), g, 0.05) for k in ("a", "b", "c")}
    x, t = torch.randn((2, 16, 16, 4), generator=g), torch.tensor([100, 700], dtype=torch.int32)
    errs["dit_forward"] = _card_cpu(torch, "dit forward", dit.forward(dcfg, to(dp["a"]), x.to(dev), t.to(dev))[0],
                                    dit.forward(dcfg, dp["a"], x, t)[0], CARD_CPU_TOL)
    lay, q_cpu = dit.quantize_dit(dcfg, dp["a"], "NVFP4_DEFAULT_CFG", [(x, t)])
    _, q_card = dit.quantize_dit(dcfg, to(dp["a"]), "NVFP4_DEFAULT_CFG", [(x.to(dev), t.to(dev))])
    errs["dit_amax"] = max(_card_cpu(torch, f"dit amax {k}", v, flatten_with_names(q_cpu)[k], CARD_CPU_TOL)
                           for k, v in flatten_with_names(q_card).items())
    ucfg = unet.UNetConfig.tiny(ch_mult=(1, 2, 2))
    up = unet.init_params(ucfg, g, device=cpu)
    up["conv_out"] = torch.randn(up["conv_out"].shape, generator=g) * 0.1
    ux = torch.randn((2, 8, 8, 4), generator=g)
    errs["unet_forward"] = _card_cpu(torch, "unet forward", unet.forward(ucfg, to(up), ux.to(dev), t.to(dev))[0],
                                     unet.forward(ucfg, up, ux, t)[0], CARD_CPU_TOL)
    _, uq_cpu = unet.quantize_unet(ucfg, up, "INT8_DEFAULT_CFG", [(ux, t)])
    _, uq_card = unet.quantize_unet(ucfg, to(up), "INT8_DEFAULT_CFG", [(ux.to(dev), t.to(dev))])
    errs["unet_amax"] = max(_card_cpu(torch, f"unet amax {k}", v, flatten_with_names(uq_cpu)[k], CARD_CPU_TOL)
                            for k, v in flatten_with_names(uq_card).items())
    # losses and gradients: flow matching and the DMD2 student loss, on the CPU's draws
    draws = trainers.flow_matching_draws(x, g)
    lc, gc = qat.value_and_grad(lambda p: trainers.flow_matching_loss(dcfg, p, x, draws), dp["a"])
    lg, gg = qat.value_and_grad(lambda p: trainers.flow_matching_loss(dcfg, p, x.to(dev), to(draws)), to(dp["a"]))
    disc = dmd.init_discriminator(dcfg, dmd.DiscriminatorConfig(hidden=32), g, device=cpu)
    sl, _, _ = dmd.make_dmd_losses(dcfg, dmd.DMDConfig(gan_loss_weight_gen=1e-2))
    sd = dmd.draw(x, g)
    sc, sgc = qat.value_and_grad(lambda s: sl(s, dp["b"], dp["c"], disc, x, sd)[0], dp["a"])
    sg, sgg = qat.value_and_grad(lambda s: sl(s, to(dp["b"]), to(dp["c"]), to(disc), x.to(dev), to(sd))[0],
                                 to(dp["a"]))
    errs["losses"] = max(_card_cpu(torch, "flow matching loss", lg, lc, CARD_CPU_GRAD, frob=True),
                         _card_cpu(torch, "dmd student loss", sg, sc, CARD_CPU_GRAD, frob=True))
    errs["grads"] = max(_card_cpu(torch, f"grad {k}", v, ref[k], CARD_CPU_GRAD, frob=True)
                        for card, ref in ((gg, flatten_with_names(gc)), (sgg, flatten_with_names(sgc)))
                        for k, v in flatten_with_names(card).items() if float(ref[k].abs().max()) > 0)
    log(json.dumps({"phase": "diffusion", "part": "card vs cpu (tiny, f32)", **errs,
                    "limits": {"forward_amax": CARD_CPU_TOL, "loss_grad_frob": CARD_CPU_GRAD}}))
    return errs


def phase_diffusion(torch, dev) -> dict:
    """(a) DiT-XL/2 on the kernels, (b) the UNet at SD-1.5's widths, (c)
    fastgen at DiT-XL/2's widths, (d) tiny card against CPU. Returns the
    launch counts of (a)'s runs on the kernels."""
    launches = _diffusion_dit(torch, dev)
    torch.cuda.empty_cache()
    _diffusion_unet(torch, dev)
    torch.cuda.empty_cache()
    _diffusion_fastgen(torch, dev)
    torch.cuda.empty_cache()
    _diffusion_card_cpu(torch, dev)
    return launches


# ---------------------------------------------------------------------------
# vision: the VLM at LLaVA-1.5-7B's widths and its export, the RNNs, CV FastNAS
# ---------------------------------------------------------------------------

# llava-hf/llava-1.5-7b-hf config.json: a CLIP ViT-L/14 at 336 px (hidden 1024,
# 24 layers, 16 heads: 576 patches), the 2-layer GELU projector, and Llama-2-7B's
# text widths (hidden 4096, FFN 11008, 32 heads, vocab 32000)
LLAVA_VIT = dict(img_size=336, patch_size=14, hidden_size=1024, depth=24, num_heads=16)
LLAVA_LM = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-5, max_position_embeddings=4096)
VLM_DEPTH = 4               # of the LM's 32 layers
VLM_BATCH = (2, 64)         # images and text tokens a batch
VLM_CALIB = 2               # calibration batches
VLM_FORMATS = ("NVFP4_DEFAULT_CFG", "FP8_DEFAULT_CFG")
# quantized text logits against bf16's, correlation. Random weights through
# the 24-block ViT, the projector and 4 LM layers: on an H100 80GB HBM3 at
# 700 W NVFP4 (W4A4) read 0.867 and FP8 0.990, NVFP4 below the 0.9 JAX's
# tests/test_vlm.py asks of its tiny model; these bars were set after that
# reading
VLM_CORR_MIN = {"NVFP4_DEFAULT_CFG": 0.8, "FP8_DEFAULT_CFG": 0.95}
RNN_SHAPE = dict(input_size=1024, hidden_size=1024, num_layers=2)
RNN_BATCH = (8, 256)        # sequences, steps
RNN_CORR_MIN = 0.99         # INT8 outputs against unquantized


def _vision_vlm(torch, dev) -> dict:
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.export import hf_export
    from tensorrt_model_optimizer_tpu_torch.models import llama, vlm
    from tensorrt_model_optimizer_tpu_torch.utils.dataset import vlm_calib_batches

    cfg = vlm.VLMConfig(vision=vlm.ViTConfig(**LLAVA_VIT, dtype=torch.bfloat16),
                        lm=llama.LlamaConfig(**{**LLAVA_LM, "num_hidden_layers": VLM_DEPTH}, dtype=torch.bfloat16))
    t0 = time.perf_counter()
    params = vlm.init_params(cfg, torch.Generator(device=dev).manual_seed(22), device=dev)
    B, T = VLM_BATCH
    batches = [(torch.from_numpy(px).to(dev).to(torch.bfloat16), torch.from_numpy(tk).to(dev))
               for px, tk in vlm_calib_batches(VLM_CALIB + 1, batch=B, img=cfg.vision.img_size, seq=T, seed=3)]
    setup_s = time.perf_counter() - t0
    px, tk = batches[-1]
    out = {"setup_s": setup_s, "image_tokens": cfg.vision.n_patches}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ref = vlm.forward(cfg, params, px, tk)[0]
        out["bf16_forward_ms"] = _event_ms(torch, lambda: vlm.forward(cfg, params, px, tk), 3)
        for preset in VLM_FORMATS:
            t0 = time.perf_counter()
            layout, qstate = vlm.quantize_vlm(cfg, params, preset, batches[:VLM_CALIB])
            calib_s = time.perf_counter() - t0
            q = vlm.forward(cfg, params, px, tk, layout=layout, qstate=qstate)[0]
            corr = float(torch.corrcoef(torch.stack([q.float().flatten(), ref.float().flatten()]))[0, 1])
            moved = vlm.forward(cfg, params, torch.roll(px, 7, dims=1), tk, layout=layout, qstate=qstate)[0]
            delta = float((moved - q).abs().max() / q.abs().max())
            row = {"corr": corr, "image_delta_rel": delta, "calib_s": calib_s}
            if preset.startswith("NVFP4"):
                with tempfile.TemporaryDirectory() as d:
                    t0 = time.perf_counter()
                    hqc = hf_export.export_vlm_checkpoint(cfg, params, layout, qstate, d, quant_cfg=preset)
                    row["export_s"] = time.perf_counter() - t0
                    row["export_bytes"] = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
                    row["quant_algo"] = hqc["quantization"]["quant_algo"]
            out[preset] = row
            if not (corr >= VLM_CORR_MIN[preset] and delta > 1e-3):
                raise AssertionError(f"vision vlm {preset}: corr {corr} (min {VLM_CORR_MIN[preset]}), image delta "
                                     f"{delta}")
            del layout, qstate
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"phase": "vision", "part": f"vlm llava-1.5-7b widths, lm {VLM_DEPTH} of 32 layers", **out}))
    return out


def _vision_rnn(torch, dev) -> dict:
    from tensorrt_model_optimizer_tpu_torch.models import rnn

    out = {}
    B, T = RNN_BATCH
    for cell in ("lstm", "gru"):
        cfg = rnn.RNNConfig(**RNN_SHAPE, cell=cell)
        g = torch.Generator(device=dev).manual_seed(23)
        params = rnn.init_params(cfg, g, device=dev)
        x = torch.randn((B, T, cfg.input_size), generator=g, device=dev)
        with torch.no_grad():
            ref, _, _ = rnn.forward(cfg, params, x)
            layout, qstate = rnn.quantize_rnn(cfg, params, "INT8_DEFAULT_CFG", [x])
            q, hq, _ = rnn.forward(cfg, params, x, layout=layout, qstate=qstate)
            ms = _event_ms(torch, lambda: rnn.forward(cfg, params, x, layout=layout, qstate=qstate), 2)
        corr = float(torch.corrcoef(torch.stack([q.flatten(), ref.flatten()]))[0, 1])
        out[cell] = {"int8_corr": corr, "forward_ms": ms, "finite": bool(torch.isfinite(hq).all())}
        if not (corr >= RNN_CORR_MIN and out[cell]["finite"]):
            raise AssertionError(f"vision rnn {cell}: INT8 corr {corr} (min {RNN_CORR_MIN})")
    log(json.dumps({"phase": "vision", "part": f"rnn hidden {RNN_SHAPE['hidden_size']}, 2 layers, {B} x {T}",
                    **out}))
    return out


def _vision_cv(torch, dev) -> dict:
    """CV FastNAS and GradNAS on the card against the CPU: the same ratio,
    widths and kept channels."""
    from tensorrt_model_optimizer_tpu_torch.nas import cv
    from tensorrt_model_optimizer_tpu_torch.utils.tree import map_tensors

    cfg = cv.CVConfig.tiny(widths=(16, 32))
    g = torch.Generator().manual_seed(24)
    params = cv.init_params(cfg, g, device="cpu")
    for k in params:
        if k.endswith("__bias"):
            params[k] = torch.randn(params[k].shape, generator=g) * 0.1
    batches = [(torch.randn((4, 16, 16, 3), generator=g), torch.randint(0, 10, (4,), generator=g))
               for _ in range(2)]
    out = {}
    for mode, budget in (("magnitude", 0.0), ("gradnas", -0.005)):
        c_cfg, c_sub, c_ratio = cv.fastnas_prune(cfg, params, batches, max_loss_increase=budget, steps=6,
                                                 score_mode=mode)
        g_cfg, g_sub, g_ratio = cv.fastnas_prune(cfg, map_tensors(lambda a: a.to(dev), params),
                                                 [(x.to(dev), y.to(dev)) for x, y in batches],
                                                 max_loss_increase=budget, steps=6, score_mode=mode)
        same = g_ratio == c_ratio and g_cfg == c_cfg and all(torch.equal(g_sub[k].cpu(), v) for k, v in c_sub.items())
        out[mode] = {"ratio": g_ratio, "widths": list(g_cfg.widths), "card_equals_cpu": same}
        if not same:
            raise AssertionError(f"vision cv {mode}: card ({g_ratio}, {g_cfg.widths}) against CPU ({c_ratio}, "
                                 f"{c_cfg.widths})")
    log(json.dumps({"phase": "vision", "part": "cv fastnas, card vs cpu", **out}))
    return out


def phase_vision(torch, dev) -> dict:
    """The VLM and its export, the RNNs, the CV FastNAS. None of them
    reaches a TPU kernel in JAX, and none launches one here: the launch
    counts must stay 0."""
    _counts(reset=True)
    out = {"vlm": _vision_vlm(torch, dev)}
    torch.cuda.empty_cache()
    out["rnn"] = _vision_rnn(torch, dev)
    out["cv"] = _vision_cv(torch, dev)
    launched = {k: n for k, n in _counts().items() if n}
    if launched:
        raise AssertionError(f"vision: launched kernels {launched}; its paths have none")
    log(json.dumps({"phase": "vision", "kernels": "none: the VLM, RNN and CV paths run no TPU kernel in JAX, and "
                    "launched none here (every count 0)"}))
    return out

# ---------------------------------------------------------------------------
# hybrid: Nemotron-H-8B, its PTQ, hybrid Minitron, Puzzletron, the utilities
# ---------------------------------------------------------------------------

HYBRID_PROMPT = (8, 2048)    # (a): the prefill, batch x tokens
HYBRID_STEPS = 32            # (a): greedy steps after the prefill
HYBRID_TAIL = 4              # (a): recurrent steps held against the full forward
# (a): the last logits' relative Frobenius gap, bf16 throughout: its roundings compound over 52 random
# blocks (0.033-0.037 on the CPU at widths 512-1024, tools/torch_hybrid_ptq_depth.py --tail); a lost state is O(1)
HYBRID_CACHE_MAX = 1e-1
HYBRID_CALIB = (2, 2, 512)   # (b): seeded calibration batches: count, B, T
HYBRID_EVAL = (2, 512)       # (b): the batch the fake-quant logits are correlated on
HYBRID_FQ_STEPS = 4          # (b): timed fake-quant decode steps
# (b): the logits' correlation with bf16. JAX's bars (tests/test_mamba.py:77-78) hold at its test's depth,
# 5 blocks: they are held on Nemotron-H-8B's blocks HYBRID_JAX_CUT. Over random weights the quantization
# noise compounds with depth in both packages (tools/torch_hybrid_ptq_depth.py, CPU: 0.938 / 0.622 at 52
# blocks, width independent): all 52 blocks are held to HYBRID_CORR_52.
HYBRID_CORR_JAX = {"FP8_DEFAULT_CFG": 0.98, "NVFP4_DEFAULT_CFG": 0.75}
HYBRID_JAX_CUT = (12, 17)    # "M-M*-": a mixer, MLPs, the attention block, as JAX's "MM*M-"
HYBRID_CORR_52 = {"FP8_DEFAULT_CFG": 0.90, "NVFP4_DEFAULT_CFG": 0.55}
HYBRID_CUT = (12, 20)        # (c): Nemotron-H-8B's blocks 12-19, "M-M*-M-M"
HYBRID_PRUNE = dict(mamba_num_heads=64, intermediate_size=10752, hidden_size=3072, num_kv_heads=8, num_blocks=6)
HYBRID_PRUNE_STEPS = 8       # (c): timed decode steps of the pruned and unpruned cuts
PUZZLE_DEPTH = 4             # (d): Llama-3.1-8B's widths on 4 layers
PUZZLE_TOKENS = (2, 128)     # (d): the scoring batch (and one more for the importance)
PUZZLE_DISTILL = 120         # (d): attn2mamba's Adam steps, JAX's default
PUZZLE_RATIO = 0.7
HYBRID_CARD_CPU = 1e-5       # (e): max-relative, the CPU tests' tolerance against JAX
HYBRID_CARD_CPU_ADAM = 1e-3  # (e): attn2mamba's distilled score (Adam amplifies the sums' order)
OOM_CEILING = 64             # (f): batch rows probed at most


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _decode_ms(torch, fwd, cfg, params, prompt, steps: int, max_len: int) -> dict:
    """Prefill (the TTFT, a synchronized wall) then `steps` greedy steps,
    each timed alone -> {"ttft_ms", "step_ms" (median), "tokens"}."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba

    cache = mamba.init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    (logits, _, cache), ttft = _sync_time(torch, lambda: fwd(prompt, cache))
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    del logits
    toks, times = [tok], []
    for _ in range(steps):
        (logits, _, cache), ms = _sync_time(torch, lambda: fwd(tok, cache))
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks.append(tok)
        times.append(ms)
    return {"ttft_ms": ttft, "step_ms": statistics.median(times), "tokens": torch.cat(toks, dim=1)}


def _hybrid_full(torch, dev) -> dict:
    """(a) and (b): Nemotron-H-8B, all 52 blocks."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba

    cfg = mamba.MambaConfig.nemotron_h_8b()
    g = torch.Generator(device=dev).manual_seed(19)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = _sync_time(torch, lambda: mamba.init_params(cfg, g, dev))
    n_params = sum(v.numel() for sub in params.values() for v in (sub.values() if isinstance(sub, dict) else [sub]))
    B, T = HYBRID_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (B, T + HYBRID_TAIL), generator=g, device=dev, dtype=torch.int32)
    max_len = T + HYBRID_STEPS + 1
    fwd = (lambda t, c: mamba.forward(cfg, params, t, cache=c))
    with torch.no_grad():
        timed_run = _decode_ms(torch, fwd, cfg, params, prompt[:, :T], HYBRID_STEPS, max_len)
        gen = mamba.generate(cfg, params, prompt[:, :T], max_new_tokens=HYBRID_STEPS + 1, max_len=max_len)
        if not torch.equal(gen, timed_run["tokens"]):
            raise AssertionError("hybrid (a): generate's tokens differ from the timed loop's")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # prefill + HYBRID_TAIL recurrent steps against the full forward on the same tokens
        full_last = mamba.forward(cfg, params, prompt)[0][:, -1].float()
        cache = mamba.init_cache(cfg, B, T + HYBRID_TAIL, device=dev)
        one_logits, _, cache = mamba.forward(cfg, params, prompt[:, :T], cache=cache)
        one_last = one_logits[:, -1].float()
        del one_logits
        for t in range(T, T + HYBRID_TAIL):
            step, _, cache = mamba.forward(cfg, params, prompt[:, t:t + 1], cache=cache)
        tail_err, tail_max = _rel_frob(step[:, -1].float(), full_last), _rel(step[:, -1].float(), full_last)
        # two chunks of T / 2 against the one-shot prefill
        cache = mamba.init_cache(cfg, B, T, device=dev)
        _, _, cache = mamba.forward(cfg, params, prompt[:, :T // 2], cache=cache)
        two = mamba.forward(cfg, params, prompt[:, T // 2:T], cache=cache)[0][:, -1].float()
        chunk_err, chunk_max = _rel_frob(two, one_last), _rel(two, one_last)
        del cache, two, step
    for name, err in (("prefill + recurrent vs full forward", tail_err), ("two-chunk vs one-shot prefill", chunk_err)):
        if not err <= HYBRID_CACHE_MAX:
            raise AssertionError(f"hybrid (a): {name}: {err} > {HYBRID_CACHE_MAX}")
    out = {"params_b": n_params / 1e9, "init_ms": init_ms, "ttft_ms": timed_run["ttft_ms"],
           "step_ms": timed_run["step_ms"], "peak_gib": peak, "tail_vs_full_frob": tail_err, "tail_vs_full_max": tail_max,
           "two_chunk_vs_one_frob": chunk_err, "two_chunk_vs_one_max": chunk_max, "limit_frob": HYBRID_CACHE_MAX}
    log(json.dumps({"phase": "hybrid", "part": f"(a) nemotron-h-8b, 52 blocks, bf16, {B} x {T} + {HYBRID_STEPS} steps",
                    **out}))
    torch.cuda.empty_cache()
    out["ptq"] = _hybrid_ptq(torch, dev, cfg, params, g)
    return out


def _hybrid_ptq(torch, dev, cfg, params, g) -> dict:
    """(b) FP8 and NVFP4 at all 52 blocks: max calibration, the fake-quant
    TTFT and step, the logits' correlation with bf16."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba

    n, cb, ct = HYBRID_CALIB
    calib = [torch.randint(0, cfg.vocab_size, (cb, ct), generator=g, device=dev, dtype=torch.int32) for _ in range(n)]
    ev = torch.randint(0, cfg.vocab_size, HYBRID_EVAL, generator=g, device=dev, dtype=torch.int32)
    cut_cfg, cut_params = _pattern_slice(cfg, params, *HYBRID_JAX_CUT)

    def corr_of(c, p, qm) -> tuple[bool, float]:
        with torch.no_grad():
            ref = mamba.forward(c, p, ev)[0].double().flatten()
            got = qm.forward(ev)[0]
            finite = bool(torch.isfinite(got).all())
            return finite, float(torch.corrcoef(torch.stack([got.double().flatten(), ref]))[0, 1])

    out = {}
    for preset in ("FP8_DEFAULT_CFG", "NVFP4_DEFAULT_CFG"):
        qm, calib_ms = _sync_time(torch, lambda: mamba.quantize(cfg, params, preset, calib, device=dev))
        finite, corr = corr_of(cfg, params, qm)
        with torch.no_grad():
            fwd = (lambda t, c: qm.forward(t, cache=c))
            run = _decode_ms(torch, fwd, cfg, params, ev[:, :256], HYBRID_FQ_STEPS, 256 + HYBRID_FQ_STEPS + 1)
        del qm
        cut_finite, cut_corr = corr_of(cut_cfg, cut_params, mamba.quantize(cut_cfg, cut_params, preset, calib,
                                                                          device=dev))
        if not (finite and cut_finite and corr >= HYBRID_CORR_52[preset] and cut_corr >= HYBRID_CORR_JAX[preset]):
            raise AssertionError(f"hybrid (b) {preset}: finite {finite} / {cut_finite}, corr {corr} (>= "
                                 f"{HYBRID_CORR_52[preset]}), 5-block corr {cut_corr} (>= {HYBRID_CORR_JAX[preset]})")
        out[preset] = {"calib_s": calib_ms / 1e3, "fq_ttft_ms_2x256": run["ttft_ms"], "fq_step_ms": run["step_ms"],
                       "corr_52": corr, "corr_52_min": HYBRID_CORR_52[preset], "corr_5": cut_corr,
                       "corr_5_min_jax": HYBRID_CORR_JAX[preset]}
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "hybrid", "part": f"(b) ptq, 52 blocks (and blocks {HYBRID_JAX_CUT[0]}-"
                    f"{HYBRID_JAX_CUT[1] - 1}, {cut_cfg.hybrid_pattern}), calib {n} x [{cb}, {ct}], eval "
                    f"{HYBRID_EVAL[0]} x {HYBRID_EVAL[1]}", **out}))
    return out


def _pattern_slice(cfg, params: dict, lo: int, hi: int):
    """Blocks lo .. hi-1 of a hybrid model: (cfg, params) sharing the
    model's tensors (views of its stacks, the same embedding and head)."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba

    sub = {k: v for k, v in params.items() if not isinstance(v, dict)}
    for kind, key in mamba.PARAM_KEY.items():
        occ = [cfg.hybrid_pattern[:i].count(kind) for i in range(lo, hi) if cfg.hybrid_pattern[i] == kind]
        if occ:
            sub[key] = {n: t[occ[0]:occ[-1] + 1] for n, t in params[key].items()}
    return dataclasses.replace(cfg, hybrid_pattern=cfg.hybrid_pattern[lo:hi]), sub


def _hybrid_cut(torch, dev, g):
    """Nemotron-H-8B's blocks HYBRID_CUT at full width, seeded bf16."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba

    full = mamba.MambaConfig.nemotron_h_8b()
    cfg = dataclasses.replace(full, hybrid_pattern=full.hybrid_pattern[HYBRID_CUT[0]:HYBRID_CUT[1]])
    return cfg, mamba.init_params(cfg, g, dev)


def _hybrid_minitron(torch, dev) -> dict:
    """(c) hybrid Minitron on the 8-block cut."""
    from tensorrt_model_optimizer_tpu_torch.models import mamba
    from tensorrt_model_optimizer_tpu_torch.prune import minitron_hybrid

    g = torch.Generator(device=dev).manual_seed(20)
    cfg, params = _hybrid_cut(torch, dev, g)
    batches = [torch.randint(0, cfg.vocab_size, (2, 512), generator=g, device=dev, dtype=torch.int32)
               for _ in range(2)]
    scores, imp_ms = _sync_time(torch, lambda: minitron_hybrid.importance(cfg, params, batches))
    (pcfg, pparams, plan), prune_ms = _sync_time(torch, lambda: minitron_hybrid.prune(cfg, params, scores,
                                                                                        **HYBRID_PRUNE))
    if pcfg.mamba_num_heads % pcfg.n_groups or len(pcfg.hybrid_pattern) != HYBRID_PRUNE["num_blocks"]:
        raise AssertionError(f"hybrid (c): pruned to {pcfg}")
    B, T = HYBRID_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev, dtype=torch.int32)
    out = {"pattern": cfg.hybrid_pattern, "pruned_pattern": plan.new_pattern, "importance_ms": imp_ms,
           "prune_ms": prune_ms}
    with torch.no_grad():
        for label, c, p in (("unpruned", cfg, params), ("pruned", pcfg, pparams)):
            run = _decode_ms(torch, (lambda t, cache, c=c, p=p: mamba.forward(c, p, t, cache=cache)), c, p, prompt,
                             HYBRID_PRUNE_STEPS, T + HYBRID_PRUNE_STEPS + 1)
            lg = mamba.forward(c, p, prompt[:2, :256])[0]
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"hybrid (c): {label} logits not finite")
            out[label] = {"ttft_ms": run["ttft_ms"], "step_ms": run["step_ms"],
                          "params_b": sum(v.numel() for sub in p.values()
                                          for v in (sub.values() if isinstance(sub, dict) else [sub])) / 1e9}
    log(json.dumps({"phase": "hybrid", "part": f"(c) minitron on blocks {HYBRID_CUT[0]}-{HYBRID_CUT[1] - 1}, "
                    f"{B} x {T} + {HYBRID_PRUNE_STEPS} steps", "targets": HYBRID_PRUNE, **out}))
    return {"cfg": cfg, "params": params, **out}


def _hybrid_puzzle(torch, dev) -> dict:
    """(d) Puzzletron at Llama-3.1-8B's widths on PUZZLE_DEPTH layers."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.puzzletron import puzzle

    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=PUZZLE_DEPTH)
    g = torch.Generator(device=dev).manual_seed(22)
    params = llama.init_params(cfg, g, dev)
    batches = [torch.randint(0, cfg.vocab_size, PUZZLE_TOKENS, generator=g, device=dev, dtype=torch.int32)
               for _ in range(2)]
    kinds = puzzle.DEFAULT_KINDS + ("attn2mamba",)
    lib, lib_ms = _sync_time(torch, lambda: puzzle.build_and_score_library(cfg, params, batches, kinds=kinds,
                                                                           distill_steps=PUZZLE_DISTILL))
    res = puzzle.run_puzzle(lib, PUZZLE_RATIO)
    full_stats = [puzzle.subblock_stats(c[0]) for c in lib]
    budget_ms = PUZZLE_RATIO * sum(s.decode_ms for s in full_stats)
    cres = puzzle.run_puzzle_constrained(lib, decode_budget_ms=budget_ms)
    with torch.no_grad():
        lg = puzzle.forward_hetero(cfg, params, res, batches[1])
        clg = puzzle.forward_hetero(cfg, params, cres, batches[1])
        if not (bool(torch.isfinite(lg).all()) and bool(torch.isfinite(clg).all())):
            raise AssertionError("hybrid (d): forward_hetero not finite")
        with tempfile.TemporaryDirectory() as d:
            puzzle.save_child(d, cfg, params, res)
            bcfg, bparams, back = puzzle.load_child(d, device=dev)
        for c, orig in zip(back.layers, res.layers):  # the shared gap: a saved child keeps no mixer config
            c.mamba_cfg = orig.mamba_cfg
        round_trip = float((puzzle.forward_hetero(bcfg, bparams, back, batches[1]) - lg).abs().max())
    if round_trip != 0.0 or bcfg != cfg:
        raise AssertionError(f"hybrid (d): save_child -> load_child moved the logits by {round_trip}")
    mamba_scores = [c.score for cands in lib for c in cands if c.name == "attn2mamba"]
    out = {"library_s": lib_ms / 1e3, "distill_steps": PUZZLE_DISTILL, "candidates": [len(c) for c in lib],
           "attn2mamba_scores": mamba_scores, "choices": res.choices,
           "params_ratio": res.total_params / res.full_params, "constrained_choices": cres.choices,
           "decode_budget_ms": budget_ms,
           "constrained_decode_ms": sum(puzzle.subblock_stats(c).decode_ms for c in cres.layers),
           "round_trip_max_abs": round_trip}
    log(json.dumps({"phase": "hybrid", "part": f"(d) puzzletron, llama-3.1-8b widths, {PUZZLE_DEPTH} layers, "
                    f"{PUZZLE_TOKENS[0]} x {PUZZLE_TOKENS[1]}", **out}))
    return out


def _hybrid_card_cpu(torch, dev) -> dict:
    """(e) tiny configs in f32 (TF32 off), the card against the CPU."""
    from tensorrt_model_optimizer_tpu_torch.models import llama, mamba
    from tensorrt_model_optimizer_tpu_torch.prune import minitron_hybrid
    from tensorrt_model_optimizer_tpu_torch.puzzletron import puzzle
    from tensorrt_model_optimizer_tpu_torch.utils.tree import flatten_with_names, map_tensors

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("hybrid (e): TF32 is on")
    cpu = torch.device("cpu")
    to = (lambda tree: map_tensors(lambda a: a.to(dev), tree))
    g = torch.Generator().manual_seed(23)
    cfg = mamba.MambaConfig.tiny(hybrid_pattern="MM*M-M*-", mamba_num_heads=8)
    p = mamba.init_params(cfg, g, cpu)
    p["layers_mamba"]["mixer.conv_b"] = torch.randn(p["layers_mamba"]["mixer.conv_b"].shape, generator=g) * 0.1
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g, dtype=torch.int32)
    errs = {}
    with torch.no_grad():
        errs["forward"] = _card_cpu(torch, "mamba forward", mamba.forward(cfg, to(p), toks.to(dev))[0],
                                    mamba.forward(cfg, p, toks)[0], HYBRID_CARD_CPU)
        c_card, c_cpu = mamba.init_cache(cfg, 2, 32, device=dev), mamba.init_cache(cfg, 2, 32, device=cpu)
        worst = 0.0
        for sl in (slice(0, 20), slice(20, 21), slice(21, 22), slice(22, 23)):
            a, _, c_card = mamba.forward(cfg, to(p), toks[:, sl].to(dev), cache=c_card)
            b, _, c_cpu = mamba.forward(cfg, p, toks[:, sl], cache=c_cpu)
            worst = max(worst, _card_cpu(torch, "prefill/decode logits", a, b, HYBRID_CARD_CPU),
                        *(_card_cpu(torch, f"cache {k}", c_card[k], c_cpu[k], HYBRID_CARD_CPU)
                          for k in ("conv", "ssm", "k", "v")))
        errs["prefill_decode"] = worst
        q_card = mamba.quantize(cfg, to(p), "FP8_DEFAULT_CFG", [toks.to(dev)], device=dev)
        q_cpu = mamba.quantize(cfg, p, "FP8_DEFAULT_CFG", [toks], device=cpu)
        ref = flatten_with_names(q_cpu.qstate)
        errs["fp8_amax"] = max(_card_cpu(torch, f"amax {k}", v, ref[k], HYBRID_CARD_CPU)
                               for k, v in flatten_with_names(q_card.qstate).items())
        # JAX's rule for fake-quant logits: the CPU's state on both sides
        q_card.qstate = to(q_cpu.qstate)
        errs["fp8_logits"] = _card_cpu(torch, "fp8 logits", q_card.forward(toks.to(dev))[0],
                                       q_cpu.forward(toks)[0], HYBRID_CARD_CPU)
    batches = [torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32) for _ in range(2)]
    s_cpu = minitron_hybrid.importance(cfg, p, batches)
    s_card = minitron_hybrid.importance(cfg, to(p), [b.to(dev) for b in batches])
    errs["prune_scores"] = max(_card_cpu(torch, f"importance {f}", torch.from_numpy(getattr(s_card, f)),
                                         torch.from_numpy(getattr(s_cpu, f)), HYBRID_CARD_CPU)
                               for f in ("mamba_head", "kv_group", "ffn", "hidden", "block"))
    kw = dict(mamba_num_heads=4, intermediate_size=96, hidden_size=48, num_blocks=6)
    pc_cpu, pp_cpu, _ = minitron_hybrid.prune(cfg, p, s_cpu, **kw)
    pc_card, pp_card, _ = minitron_hybrid.prune(cfg, to(p), s_cpu, **kw)
    shapes = lambda t: {k: tuple(v.shape) for k, v in flatten_with_names(t).items()}
    if pc_cpu != pc_card or shapes(pp_cpu) != shapes(pp_card):
        raise AssertionError("hybrid (e): the pruned shapes differ")
    lcfg = llama.LlamaConfig.tiny(num_hidden_layers=2, dtype=torch.float32)
    lp = llama.init_params(lcfg, g, cpu)
    lb = [torch.randint(0, lcfg.vocab_size, (2, 16), generator=g, dtype=torch.int32) for _ in range(2)]
    kinds = puzzle.DEFAULT_KINDS + ("attn2mamba",)
    inits = [puzzle.seeded_mixer(puzzle.mixer_config(lcfg), i, cpu) for i in range(2)]  # one start for both
    lib_card = puzzle.build_and_score_library(lcfg, to(lp), [b.to(dev) for b in lb], kinds=kinds, distill_steps=20,
                                              init_mixers=inits)
    lib_cpu = puzzle.build_and_score_library(lcfg, lp, lb, kinds=kinds, distill_steps=20, init_mixers=inits)
    worst = worst_adam = 0.0
    for cc, cp in zip(lib_card, lib_cpu):
        for a, b in zip(cc, cp):
            err = abs(a.score - b.score) / max(abs(b.score), 1e-30)
            lim = HYBRID_CARD_CPU_ADAM if a.name == "attn2mamba" else HYBRID_CARD_CPU
            if a.name != b.name or not err <= lim:
                raise AssertionError(f"hybrid (e): puzzletron {a.name} score {err} > {lim}")
            if a.name == "attn2mamba":
                worst_adam = max(worst_adam, err)
            else:
                worst = max(worst, err)
    errs["puzzle_scores"], errs["puzzle_attn2mamba_score"] = worst, worst_adam
    log(json.dumps({"phase": "hybrid", "part": "(e) card vs cpu (tiny, f32, tf32 off)", **errs,
                    "limits": {"max_rel": HYBRID_CARD_CPU, "attn2mamba_score": HYBRID_CARD_CPU_ADAM}}))
    return errs


def _hybrid_utils(torch, dev, cut: dict) -> dict:
    """(f) the OOM probe on (c)'s 8 blocks at 2048 tokens, the host packer."""
    import numpy as np

    from tensorrt_model_optimizer_tpu_torch import csrc
    from tensorrt_model_optimizer_tpu_torch.models import mamba
    from tensorrt_model_optimizer_tpu_torch.ops import numerics
    from tensorrt_model_optimizer_tpu_torch.utils import memory, perf

    cfg, params = cut["cfg"], cut["params"]
    g = torch.Generator(device=dev).manual_seed(24)
    probes = []

    def try_fn(b):
        probes.append(b)
        torch.cuda.empty_cache()  # each probe on an emptied cache: the boundary is not the last probe's fragments
        toks = torch.randint(0, cfg.vocab_size, (b, HYBRID_PROMPT[1]), generator=g, device=dev, dtype=torch.int32)
        with torch.no_grad():
            mamba.forward(cfg, params, toks)
        torch.cuda.synchronize()

    torch.cuda.empty_cache()
    timer = perf.Timer()
    with timer.time("probe"):
        best = memory.find_max_batch_size(try_fn, start=1, ceiling=OOM_CEILING)
    oomed = [b for b in probes if b > best]
    if not oomed or best >= OOM_CEILING:
        raise AssertionError(f"hybrid (f): the probe met no OOM below {OOM_CEILING} (probes {probes})")
    try_fn(best)  # the card recovered: the largest fitting batch runs again after the OOMs
    stats = memory.device_memory_stats()
    # the host packer against the port's torch packers, on the card's weights
    w = params["layers_mlp"]["mlp.up_proj"][0][:256, :1024].float()
    bam = w.abs().reshape(256, -1, 64).amax(-1)
    scale = torch.where(bam == 0, torch.ones_like(bam), bam / 7.0)
    q = torch.clamp(torch.round(w / scale.repeat_interleave(64, dim=1)), -8, 7).to(torch.int8)
    wn, sn = w.cpu().numpy(), scale.cpu().numpy()
    int4_equal = bool(np.array_equal(csrc.int4_round_and_pack(wn, sn, 64), numerics.pack_int4(q).cpu().numpy()))
    g_amax = w.abs().max()
    packed, scales = csrc.nvfp4_quantize_and_pack(wn, float(g_amax) / (6.0 * 448.0), 16)
    tp, ts, _ = numerics.real_quant_nvfp4(w, 16, g_amax)
    nvfp4_equal = bool(np.array_equal(packed, tp.cpu().numpy())) and bool(
        np.allclose(scales, ts.float().cpu().numpy(), rtol=1e-6, atol=0))
    unpack_equal = bool(np.array_equal(csrc.int4_unpack(csrc.int4_round_and_pack(wn, sn, 64)), q.cpu().numpy()))
    if not (int4_equal and nvfp4_equal and unpack_equal):
        raise AssertionError(f"hybrid (f): pack_ext int4 {int4_equal}, nvfp4 {nvfp4_equal}, unpack {unpack_equal}")
    out = {"max_batch": best, "ceiling": OOM_CEILING, "probes": probes, "probe_s": timer.totals["probe"],
           "bytes_limit_gib": stats["bytes_limit"] / 2**30, "pack_ext_lib": os.path.relpath(csrc.build(), HERE),
           "int4_equal": int4_equal, "nvfp4_equal": nvfp4_equal, "unpack_equal": unpack_equal}
    log(json.dumps({"phase": "hybrid", "part": f"(f) find_max_batch_size, {len(cfg.hybrid_pattern)} blocks x "
                    f"{HYBRID_PROMPT[1]} tokens; pack_ext", **out}))
    return out


def phase_hybrid(torch, dev) -> dict:
    """The Mamba2 hybrid family, Minitron, Puzzletron and the utilities. No
    part reaches a TPU kernel in JAX, and none launches one here: the
    launch counts must stay 0."""
    _counts(reset=True)
    out = {"full": _hybrid_full(torch, dev)}
    torch.cuda.empty_cache()
    cut = _hybrid_minitron(torch, dev)
    torch.cuda.empty_cache()
    out["utils"] = _hybrid_utils(torch, dev, cut)
    del cut
    torch.cuda.empty_cache()
    out["puzzle"] = _hybrid_puzzle(torch, dev)
    torch.cuda.empty_cache()
    out["card_cpu"] = _hybrid_card_cpu(torch, dev)
    launched = {k: n for k, n in _counts().items() if n}
    if launched:
        raise AssertionError(f"hybrid: launched kernels {launched}; its paths have none")
    log(json.dumps({"phase": "hybrid", "kernels": "none: Mamba, Minitron-hybrid, Puzzletron, the tracer and the "
                    "utilities reach no TPU kernel in JAX, and launched none here (every count 0)"}))
    return out


# ------------------------------------------------------------------ tp phase
# Multi-GPU serving on the one card: W ranks, each its own process
# (`parallel.mesh.launch`), nccl with a card a rank where there are W cards,
# else gloo with every rank on cuda:0. Every rank launches the ported kernels
# at its shard's local shapes; the parent builds and compresses each model
# once, runs its single-card reference and frees it, and hands each rank only
# its shard (CUDA IPC: no copy). The timings are single-card times with host
# collectives, not multi-card times.
TP_WORLD = 4
TP_LLAMA_DEPTH = 4               # (a): Llama-3.1-8B's widths on 4 of its 32 layers (tp_full: 8)
TP_FORMATS = (                   # (a): label, preset, EngineConfig layouts, the GEMM kernel
    ("w4a8", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", (("int4_layout", "a8"),), "qmm_w4a8"),
    ("int4", "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", (), "qmm_int4_wo"),
    ("nvfp4", "NVFP4_WEIGHT_ONLY_CFG", (), "qmm_fp4_wo"),
)
TP_STEPS = 32                    # (a), (c): the prefill and 31 eager decode steps
# The prefill's and every decode step's logits, the steps teacher-forced (each
# rank fed the single card's greedy tokens): the median over the rows of max
# |tp - single| / the single card's largest. bf16: each row site's partials
# are rounded to bf16 and summed in bf16 (JAX's psum in the output dtype), a
# few ulps a GEMM; W4A8's per-token int8 codes amplify them over random
# layers: prefill medians 0.032-0.034 (INT4, NVFP4), 0.078-0.085 (W4A8) at 4
# layers; a row site's SUM halved reads 0.61-0.63 (H100 80GB HBM3, 700.00
# W). (c) and (d) replay the single card's expert choices
# (`_pinned_routes`): unpinned, a bf16 ulp sends a token to another of 128
# random routers' near-tied experts (Qwen3-30B-A3B read 0.088, 0.150 and 0.175
# on three prompts), which would hide a wrong expert slice; the unpinned
# prefill gap is reported beside. Pinned, DeepSeek-V3 reads 0.0153 (prefill)
# and <= 0.0149 (steps), held at MOE_PLAIN_MEDIAN_MAX; Qwen3-30B-A3B 0.054 and
# <= 0.065, held at TP_MOE_PINNED_MAX; each rank running the next rank's
# experts' rows (a wrong expert offset, planted) reads 1.19 and 0.65 (H100 80GB
# HBM3, 700.00 W).
TP_LOGITS_MAX = 0.2
TP_MOE_PINNED_MAX = 0.1
# The W4A8 row site alone (`engine._qlinear` of layer 0's down_proj on each
# rank's K-slice of one seeded f32 input [TP_ROWSITE_ROWS, 14336], against
# the single card's on the whole input): the same int8 codes (the per-token
# amax MAX-reduced), int32-exact block sums, so the gap is the f32 SUM's order;
# a shard that quantizes against its own amax moves its codes by the int8
# step. Over whole models the logits cannot see that fault: a per-token int8
# code flips at an ulp of its input, so bf16 and even f32 models read 0.10 /
# 0.035 of the scale with the MAX and 0.10 / 0.061 without it (H100 80GB HBM3,
# 700.00 W).
TP_ROWSITE_ROWS = 2048
TP_ROWSITE_MAX = 1e-5
TP_TIE_MAX = 0.2                 # (b): a request's first token apart only where the reference's margin is this small
TP_PAGED_SLOTS = 8               # (b), teacher-forced: 8 of the requests, a slot each,
TP_PAGED_CHUNK = 64              # ... their last 64 prompt tokens one paged chunk step,
TP_PAGED_STEPS = 16              # ... then 15 paged decode steps, each held at TP_LOGITS_MAX
TP_MOE_DEPTH = 2                 # (c): Qwen3-30B-A3B, 2 of 48 layers, EP 4, INT4
TP_MOE_PROMPT = (4, 512)
TP_DS_PROMPT = (4, 512)          # (d): DeepSeek-V3, 2 of 61 layers (1 dense, 1 MoE), TP / EP 4, INT4
TP_DS_STEPS = 16                 # (d): the prefill and 15 decode steps
TP_RING = (4, 2048, 32, 8, 128)  # (e): B, tokens a rank, q heads, kv heads, head_dim
TP_RING_MAX = 2e-4               # ring against SDPA (f32), JAX's bound
TP_PIPE_TOKENS = (4, 512)        # (e): the pipeline's batch (4 microbatches) at 8B widths, TP_LLAMA_DEPTH layers
TP_PIPE_MAX = 5e-2               # bf16: the microbatches' GEMMs take other shapes than the whole batch's
TP_SAVE_DEPTH = 2                # (f): the INT4-calibrated model saved and restored, 2 layers at 8B widths
# The local GEMM shapes the tp phase's ranks launch (Llama-3.1-8B at TP 4 and
# 2: gate / up, down, k_proj; Qwen3-30B-A3B's and DeepSeek-V3's experts under
# EP 4 keep their per-expert shapes, which the moe and deepseek phases time):
# prefill (N = 16384) and decode (N = 8) rows, W4A8, INT4 and NVFP4.
TP_GEMMS = (
    ("llama3-8b tp4", "gate/up", 3584, 4096, ("w4a8", "int4", "nvfp4"), (16384, 8)),
    ("llama3-8b tp4", "down", 4096, 3584, ("w4a8", "int4", "nvfp4"), (16384, 8)),
    ("llama3-8b tp4", "k_proj", 256, 4096, ("w4a8", "int4", "nvfp4"), (16384, 8)),
    ("llama3-8b tp2", "gate/up", 7168, 4096, ("w4a8",), (16384, 8)),
    ("llama3-8b tp2", "down", 4096, 7168, ("w4a8",), (16384, 8)),
)
TP_ATTN = (8, 8, 2, 128, 2080, 2048)  # flash and kv decode at TP 4: B, q heads, kv heads, hd, S, pos
TP_PAGED = (8, 16, 4, 128)            # paged decode / prefill at TP 2: B, q heads, kv heads, hd
TP_KERNELS = ("qmm_w4a8", "qmm_int4_wo", "qmm_fp4_wo", "flash_gqa", "kv_decode_attention", "paged_attention_decode",
              "paged_attention_prefill_tc")


def _tp_attention_rows(torch, dev, sz: Sizes, timer: Timer, rows: dict, g) -> None:
    """Flash and kv decode at TP 4's local heads (TP_ATTN: 8 q / 2 kv heads
    of the 8B's 32 / 8), paged decode and paged prefill (tensor cores) at TP
    2's (TP_PAGED), each against its plain version, timed, with its bound;
    the rows join each kernel's `shapes`."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, paged_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, Hkv, hd, S, pos = TP_ATTN
    q = torch.randn((B, H, pos, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, pos, hd), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    out = flash_gqa.flash_attention_gqa(q, k, v)
    worst, err = _held(out, flash_gqa.flash_attention_gqa_plain(q.float(), k.float(), v.float()))
    if not worst <= 1.0:
        raise AssertionError(f"flash_gqa tp4: worst err/limit {worst}, max abs err {err}")
    ms = timer(lambda: flash_gqa.flash_attention_gqa(q, k, v), sz.reps)
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * H * hd * pos * (pos + 1) / 2, "bf16")
    row = {"shape": f"llama3-8b tp4 B={B} H={H} Hkv={Hkv} T={pos} d={hd}", "route": "tensor_core",
           "max_abs_err": err, "worst_err_over_limit": worst, "ms": ms,
           "plain_ms": timer(lambda: flash_gqa.flash_attention_gqa_plain(q, k, v), 2), "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms,
           "library_ms": timer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), sz.reps)}
    rows.setdefault("flash_gqa", {"shapes": []})["shapes"].append(row)
    log(json.dumps({"kernel": "flash_gqa", **row}))
    del q, k, v, out
    kc, ks, qf = _stored_rows(torch, dev, g, (B, Hkv, S, hd), "int8")
    vc, vs, _ = _stored_rows(torch, dev, g, (B, Hkv, S, hd), "int8")
    qd = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd) * qf
    kn, vn = (torch.randn((B, Hkv, 1, hd), generator=g, device=dev) for _ in range(2))
    args = (qd, kc, vc, kn, vn, torch.tensor(pos, dtype=torch.int32, device=dev), "int8", ks, vs)
    out, ref = kv_attention.kv_decode_attention(*args), kv_attention.kv_decode_attention_plain(*args)
    rel = _rel(out, ref)
    if not rel <= 1e-5:
        raise AssertionError(f"kv_decode_attention tp4: rel err {rel} > 1e-5")
    ms = timer(lambda: kv_attention.kv_decode_attention(*args), sz.reps)
    b_ms, b_by = bound(2 * B * Hkv * pos * _kv_row_bytes("int8", hd) + 2 * B * Hkv * hd * 4 + 2 * qd.numel() * 4,
                       4.0 * B * H * (pos + 1) * hd, "bf16")
    row = {"shape": f"int8 llama3-8b tp4 B={B} n_kv={Hkv} rep={H // Hkv} S={S} pos={pos}",
           "max_abs_err": float((out - ref).abs().max()), "rel_err": rel, "ms": ms,
           "plain_ms": timer(lambda: kv_attention.kv_decode_attention_plain(*args), 2), "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
    rows.setdefault("kv_decode_attention", {"shapes": []})["shapes"].append(row)
    log(json.dumps({"kernel": "kv_decode_attention", **row}))
    del kc, vc, ks, vs
    B, nH, n_kv, hd = TP_PAGED
    psz = dataclasses.replace(sz, kv=(B, n_kv, nH // n_kv, hd, S, pos))
    page = sz.page
    kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, psz, "int8", [2048] * B, 2048 // page + 2)
    q = (torch.randn((B, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
    args = (q, kp, vp, table, tl, "raw", ksp, vsp)
    out = paged_attention.paged_attention_decode(*args)
    worst, err = _held(out, paged_attention.paged_attention_decode_plain(*args, out_dtype=torch.float32))
    if not worst <= 1.0:
        raise AssertionError(f"paged_attention_decode tp2: worst err/limit {worst}, max abs err {err}")
    ms = timer(lambda: paged_attention.paged_attention_decode(*args), sz.reps)
    b_ms, b_by = bound(2 * n_kv * 2048 * B * _kv_row_bytes("int8", hd) + 2 * q.numel() * 2 + table.numel() * 4,
                       4.0 * nH * 2048 * B * hd, "bf16")
    row = {"shape": f"int8 llama3-8b tp2 B={B} n_kv={n_kv} rep={nH // n_kv} page={page} lens=2048", "max_abs_err": err,
           "worst_err_over_limit": worst, "ms": ms,
           "plain_ms": timer(lambda: paged_attention.paged_attention_decode_plain(*args), 2), "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
    rows.setdefault("paged_attention_decode", {"shapes": []})["shapes"].append(row)
    log(json.dumps({"kernel": "paged_attention_decode", **row}))
    T, ctx = sz.chunk, [1024] * B
    kp, vp, ksp, vsp, qf, table, tl = _paged_pool(torch, dev, g, psz, "int8", ctx, 1024 // page + 2)
    ck, cks, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), "int8")
    cv, cvs, _ = _stored_rows(torch, dev, g, (B, T, n_kv, hd), "int8")
    q = (torch.randn((B, T, nH, hd), generator=g, device=dev) * qf).to(torch.bfloat16)
    args = (q, kp, vp, table, tl, ck, cv, "raw", ksp, vsp, cks, cvs)
    out = paged_attention.paged_attention_prefill(*args)
    worst, err = _held(out, paged_attention.paged_attention_prefill_plain(*args, out_dtype=torch.float32))
    if not worst <= 1.0:
        raise AssertionError(f"paged_attention_prefill tp2: worst err/limit {worst}, max abs err {err}")
    ms = timer(lambda: paged_attention.paged_attention_prefill(*args), sz.reps)
    rows_read = sum(ctx) + B * T
    b_ms, b_by = bound(2 * n_kv * rows_read * _kv_row_bytes("int8", hd) + 2 * q.numel() * 2 + table.numel() * 4,
                       4.0 * nH * T * hd * sum(c + T for c in ctx), "bf16")
    row = {"shape": f"int8 llama3-8b tp2 B={B} T={T} n_kv={n_kv} rep={nH // n_kv} page={page} ctx=1024",
           "route": "tensor_core", "max_abs_err": err, "worst_err_over_limit": worst, "ms": ms,
           "plain_ms": timer(lambda: paged_attention.paged_attention_prefill_plain(*args), 2), "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": None}
    rows.setdefault("paged_attention_prefill_tc", {"shapes": []})["shapes"].append(row)
    log(json.dumps({"kernel": "paged_attention_prefill", **row}))


def _tp_decode(torch, eng, prompt, steps: int, ref=None) -> dict:
    """The prefill of `prompt`, then steps - 1 eager decode steps, each fed
    the greedy token of the step before (the single card's reference run,
    `ref` None) or the reference's token at that step (teacher-forced: a
    rank, `ref` the reference's readings), so every step's logits can be
    held against the reference's at the same context. Returns the prefill
    logits [B, V] f32, the greedy tokens [B, steps], the prefill's and a
    step's wall ms (synchronized); the reference also every step's logits
    `steps` [steps - 1, B, V], a rank each step's rows' gaps `step_gaps`
    (`_gaps`) against them."""
    sync = torch.cuda.synchronize
    cache = eng.init_cache(prompt.shape[0])
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt, cache)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, outs = [tok], []
    t0 = time.perf_counter()
    for j in range(steps - 1):
        feed = tok if ref is None else ref["tokens"][:, j:j + 1].to(device=tok.device, dtype=torch.int32)
        step = eng._dp_gather(eng._model_step(eng._dp_rows(feed), cache)).float()
        outs.append(step)
        tok = torch.argmax(step, dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    out = {"logits": logits.float(), "tokens": torch.cat(toks, dim=1), "prefill_ms": prefill_ms, "step_ms": step_ms,
           "limit": TP_LOGITS_MAX}
    if ref is None:
        out["steps"] = torch.stack(outs)
    else:
        out["step_gaps"] = [_gaps(o, r.to(o.device))[0] for o, r in zip(outs, ref["steps"])]
    return out


def _forced_ref(ref: dict) -> dict:
    """What a teacher-forced rank needs of the single card's run."""
    return {"tokens": ref["tokens"], "steps": ref["steps"]}


def _tp_hold(torch, label: str, got: dict, ref: dict) -> dict:
    """A rank's teacher-forced run against the single card's: the median
    over the rows of each row's max |Δ| of the prefill logits, and of every
    decode step's logits, within `ref["limit"]` of the reference's largest
    logit (the holds; the max reported), and the count of greedy choices
    equal to the reference's at the same context. Returns the readings, and
    under "failed" the holds they fail."""
    gaps, _ = _gaps(got["logits"].cpu(), ref["logits"].cpu())
    step_medians = [statistics.median(g) for g in got["step_gaps"]]
    toks, rtoks = got["tokens"].cpu(), ref["tokens"].cpu()
    reading = {"max_gap": max(gaps), "median_gap": statistics.median(gaps), "limit": ref["limit"],
               "steps_held": len(step_medians), "step_median_gap_max": max(step_medians, default=0.0),
               "step_median_gap_median": statistics.median(step_medians) if step_medians else 0.0,
               "step_max_gap": max((max(g) for g in got["step_gaps"]), default=0.0),
               "equal_tokens": int((toks == rtoks).sum()), "tokens": toks.numel(), "failed": []}
    if not reading["median_gap"] <= ref["limit"]:
        reading["failed"].append(f"tp {label}: prefill logits {reading['median_gap']} of the single card's scale "
                                 f"apart (median) > {ref['limit']}")
    if not reading["step_median_gap_max"] <= ref["limit"]:
        worst = max(range(len(step_medians)), key=step_medians.__getitem__)
        reading["failed"].append(f"tp {label}: decode step {worst + 1}'s logits {step_medians[worst]} of the "
                                 f"single card's scale apart (median) > {ref['limit']}")
    return reading


def _paged_forced(torch, eng, prompts: list, geom: dict, steps: int, ref=None) -> dict:
    """Paged serving's steps held one by one: each prompt in a slot of its
    own (its pages in turn), its first tokens prefilled into the slot
    (`prefill_into_slot`), its last TP_PAGED_CHUNK as one chunk step over
    every slot (the paged prefill), then steps - 1 paged decode steps, fed
    the greedy token (`ref` None) or the reference's (teacher-forced).
    Returns the chunk's and the steps' logits [steps, B, V] and greedy
    tokens [B, steps] (the reference), or the rows' gaps a step against
    the reference's and the tokens (a rank)."""
    n, P, C = len(prompts), prompts[0].shape[0], TP_PAGED_CHUNK
    per_seq = geom["max_pages_per_seq"] - 1
    cache = eng.init_paged_cache(geom["n_pages"], geom["page_size"], n, geom["max_pages_per_seq"])
    for s in range(n):
        cache.block_table[s, :per_seq] = torch.arange(s * per_seq, (s + 1) * per_seq, dtype=torch.int32)
        eng.prefill_into_slot(cache, s, prompts[s][None, :P - C])
    active = torch.ones((n,), dtype=torch.bool, device=eng.device)
    outs = [eng.paged_step(torch.stack([p[P - C:] for p in prompts]), cache, active).float()]
    toks = [torch.argmax(outs[0], dim=-1).to(torch.int32)[:, None]]
    for j in range(steps - 1):
        feed = toks[-1] if ref is None else ref["tokens"][:, j:j + 1].to(device=eng.device, dtype=torch.int32)
        outs.append(eng.paged_step(feed, cache, active).float())
        toks.append(torch.argmax(outs[-1], dim=-1).to(torch.int32)[:, None])
    tokens = torch.cat(toks, dim=1)
    if ref is None:
        return {"steps": torch.stack(outs), "tokens": tokens}
    return {"step_gaps": [_gaps(o, r.to(o.device))[0] for o, r in zip(outs, ref["steps"])], "tokens": tokens.cpu()}


def _tp_rank(rank: int, world: int, parts: list) -> dict:
    """A rank of the tp phase: each part of the plan in turn (every rank the
    same parts, in the same order, each with this rank's shard); returns
    {label: readings}."""
    import torch

    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    from tensorrt_model_optimizer_tpu_torch.parallel.mesh import launch_device

    out = {}
    for part in parts:
        part = _to_device(part, launch_device())  # the parent's tensors live on cuda:0
        kind, label = part["kind"], part["label"]
        torch.cuda.reset_peak_memory_stats()
        _counts(reset=True)
        if kind == "llama":
            mesh = M.Mesh({"tp": part["tp"]})
            eng = E.Engine(part["cm"], E.EngineConfig(mesh=mesh, max_seq_len=part["max_seq"], kv_dtype=torch.int8,
                                                      kv_attention_kernel=True, **dict(part["layouts"])))
            eng._eager = True  # gloo's collectives run on the host: no CUDA graph
            res = _tp_decode(torch, eng, part["prompt"], part["steps"], part["ref"])
            res["logits"], res["tokens"] = res["logits"].cpu(), res["tokens"].cpu()
            if part.get("rowsite") is not None:
                res["launches"] = {k: n for k, n in _counts().items() if n}  # the served path's, not the check's
                x, ref = part["rowsite"]
                k = x.shape[1] // eng._tp.size
                y = _tp_rowsite(eng, x[:, eng._tp.index * k:(eng._tp.index + 1) * k])
                res["rowsite_gap"] = float((y - ref).abs().max() / ref.abs().max())
            del eng
        elif kind == "paged":
            from tensorrt_model_optimizer_tpu_torch.serve.scheduler import Request

            mesh = M.Mesh({"tp": part["tp"]})
            eng = E.Engine(part["cm"], E.EngineConfig(mesh=mesh, max_seq_len=part["max_seq"], kv_dtype=torch.int8,
                                                      kv_attention_kernel=True, paged_attention_kernel=True))
            eng._eager = True
            reqs = [Request(rid=i, prompt=p.cpu().numpy(), max_new_tokens=n)
                    for i, (p, n) in enumerate(zip(part["prompts"], part["new"]))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, metrics = eng.serve(reqs, **part["geom"], prefix_cache=True, unroll=part["unroll"],
                                      collect_metrics=True)
            torch.cuda.synchronize()
            res = {"outs": outs, "wall_s": time.perf_counter() - t0, "tok_s": metrics["tok_s"],
                   "chunked_prefills": metrics["chunked_prefills"],
                   "forced": _paged_forced(torch, eng, part["prompts"][:TP_PAGED_SLOTS], part["geom"],
                                           TP_PAGED_STEPS, part["forced_ref"])}
            del eng
        elif kind == "moe":
            from tensorrt_model_optimizer_tpu_torch.quant import sharded

            calib_mesh = M.Mesh({"expert": world})
            qm = sharded.quantize_sharded("mixtral", part["cfg"], part["params"], part["preset"], part["calib"],
                                          calib_mesh, device=calib_mesh.device)
            gap = _state_gap(torch, qm.qstate, part["ref_qstate"])
            if gap != 0.0:
                raise AssertionError(f"tp moe: sharded amax {gap} apart from the single card's (weight-only: equal)")
            del qm
            mesh = M.Mesh({"tp": world})
            eng = E.Engine(part["cm"], E.EngineConfig(mesh=mesh, max_seq_len=part["max_seq"], kv_dtype=torch.int8,
                                                      kv_attention_kernel=True))
            eng._eager = True
            res = _tp_pinned(torch, eng, part, None)
            res["amax_gap"] = gap
            del eng
        elif kind == "deepseek":
            from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine as dse

            mesh = M.Mesh({"tp": world})
            eng = dse.DeepseekEngine(part["cm"], part["max_seq"], mesh=mesh)
            eng._eager = True
            from tensorrt_model_optimizer_tpu_torch.models import deepseek

            res = _tp_pinned(torch, eng, part, deepseek)
            del eng
        elif kind == "ring":
            from tensorrt_model_optimizer_tpu_torch.parallel import ring_attention as ra

            mesh = M.Mesh({"context": world})
            q, k, v = part["qkv"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ra.ring_attention(q, k, v, mesh, "context", True)
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) * 1e3
            r = part["ref"]
            res = {"max_err": float((o.float() - r).abs().max() / r.abs().max()), "ms": ring_ms}
            mesh = M.Mesh({"pipe": world})
            from tensorrt_model_optimizer_tpu_torch.parallel import pipeline

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = pipeline.pipeline_forward(part["cfg"], part["params"], part["tokens"], mesh, num_microbatches=world)
            torch.cuda.synchronize()
            res["pipeline_ms"] = (time.perf_counter() - t0) * 1e3
            pr = part["pipe_ref"]
            res["pipeline_max_err"] = float((logits - pr).abs().max() / pr.abs().max())
        elif kind == "save":
            from tensorrt_model_optimizer_tpu_torch.opt import state

            mesh = M.Mesh({"tensor": world})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.save_sharded(part["model"], part["path"], mesh)
            save_s = time.perf_counter() - t0
            local = state.restore_sharded(part["path"], mesh)
            specs = state._param_specs(part["model"])
            from tensorrt_model_optimizer_tpu_torch.utils import tree

            want, got = tree.flatten_with_names(part["model"].params), tree.flatten_with_names(local.params)
            for name, w in want.items():
                shard = state._shard_of(tuple(specs.get(name, ())), mesh.coords, mesh.shape)
                if not torch.equal(got[name], state._slice(w, shard)):
                    raise AssertionError(f"tp save: rank {rank}'s restored {name} differs from its shard")
            res = {"save_s": save_s, "restore_s": time.perf_counter() - t0 - save_s}
        else:
            raise ValueError(kind)
        res.setdefault("launches", {k: n for k, n in _counts().items() if n})
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[label] = res
        torch.cuda.empty_cache()
    return out


def _tp_pinned(torch, eng, part: dict, module) -> dict:
    """(c), (d) on a rank: the teacher-forced run on the single card's
    expert choices (`_pinned_routes(module)` replaying the reference's,
    `part["routes"]`), and the prefill again on the rank's own routing (its
    gaps reported beside, not held)."""
    with _pinned_routes(module) as pins:
        pins.choices = list(part["routes"])
        pins.replay()
        res = _tp_decode(torch, eng, part["prompt"], part["steps"], part["ref"])
        if pins.choices:
            raise AssertionError(f"tp {part['label']}: {len(pins.choices)} recorded routings left over")
    own = eng.prefill(part["prompt"], eng.init_cache(part["prompt"].shape[0])).float().cpu()
    gaps, _ = _gaps(own, part["ref_logits"].cpu())
    return {**{k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in res.items()},
            "routing_choices_apart": pins.apart, "unpinned_median_gap": statistics.median(gaps),
            "unpinned_max_gap": max(gaps)}


def _to_device(x, dev):
    """x with every tensor in it (dicts, lists, tuples, dataclasses) on dev."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_device(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _tp_rowsite(eng, x):
    """Layer 0's down_proj of `eng` through `engine._qlinear` on x (f32): on a
    rank under a mesh its row-parallel form (the per-token amax MAX-reduced,
    the partial SUMmed), on the single card the whole GEMM."""
    from tensorrt_model_optimizer_tpu_torch.quant.compress import layer_arrays
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E

    name = "mlp.down_proj"
    arrays = layer_arrays(eng.cm.params["layers"][name], 0)
    return E._qlinear(x, name, eng.cm.kinds[name], arrays, eng.cm, None, eng._ops, tp=eng._tp, row=eng._tp is not None)


def _state_gap(torch, a: dict, b: dict) -> float:
    """max |a - b| over every amax and pre_quant_scale of two quantizer states."""
    from tensorrt_model_optimizer_tpu_torch.utils import tree

    fa, fb = tree.flatten_with_names(a), tree.flatten_with_names(b)
    if set(fa) != set(fb):
        raise AssertionError(f"tp: quantizer states with other sites: {sorted(set(fa) ^ set(fb))}")
    return max((float((fa[k].float() - fb[k].float()).abs().max()) for k in fa
                if isinstance(fa[k], torch.Tensor) and fa[k].numel()), default=0.0)


def _tp_launch(torch, world: int, rank_parts: list) -> tuple[list, str, list]:
    """The ranks of the tp phase: backend and devices by `mesh.rank_devices`,
    printed; returns (each rank's readings, backend, devices)."""
    from tensorrt_model_optimizer_tpu_torch.parallel import mesh as M

    backend, devices = M.rank_devices(world)
    log(json.dumps({"phase": "tp", "ranks": world, "backend": backend,
                    "rank_devices": {r: d for r, d in enumerate(devices)}}))
    t0 = time.perf_counter()
    out = M.launch(_tp_rank, world, backend=backend, devices=devices, args=(world,),
                   rank_args=[(p,) for p in rank_parts], timeout_s=600)
    log(json.dumps({"phase": "tp", "ranks": world, "launch_s": time.perf_counter() - t0}))
    return out, backend, devices


TP_PARTS = "abcdef"


def phase_tp(torch, dev, sz: Sizes, timer: Timer, rows: dict, full: bool = False, parts: str = TP_PARTS) -> dict:
    """Tensor, expert and data parallel serving of the port on the one card
    (see the module docstring's `tp`): the local-shape kernel rows, then the
    single-card references and each rank's shard, then the ranks; returns
    the launch counts summed over ranks. `parts` names the parts run
    ("a": Llama alone is `--phases build,tp_llama`, "cd" the MoE models
    alone `tp_moe`; both skip the kernel rows)."""
    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E
    from tensorrt_model_optimizer_tpu_torch.serve import tp as tp_mod

    if parts == TP_PARTS:
        for k in ("qmm_w4a8", "qmm_int4_wo", "qmm_fp4_wo"):
            rows.setdefault(k, {"shapes": []})
        gk = torch.Generator(device=dev).manual_seed(24)
        _phase_kernels_families(torch, dev, sz, timer, rows, gk, TP_GEMMS)
        _tp_attention_rows(torch, dev, sz, timer, rows, gk)
    g = torch.Generator(device=dev).manual_seed(20)
    sync = torch.cuda.synchronize
    W, depth = TP_WORLD, (2 * TP_LLAMA_DEPTH if full else TP_LLAMA_DEPTH)
    refs, parts4, parts2 = {}, [[] for _ in range(W)], [[] for _ in range(2)]
    t0 = time.perf_counter()

    # (a) Llama-3.1-8B, TP 4 in three formats and W4A8 at TP 2
    cfg = llama.LlamaConfig.llama3_8b(num_hidden_layers=depth)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    B, T = sz.batch, sz.prompt
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    max_seq = T + TP_STEPS
    cms = {}
    row_x = torch.randn((TP_ROWSITE_ROWS, cfg.intermediate_size), generator=g, device=dev)
    for label, preset, layouts, _ in (TP_FORMATS if "a" in parts else ()):
        cm = cms.setdefault(preset, compress.compress(ptq.quantize(cfg, params, preset, device=dev)))
        eng = E.Engine(cm, E.EngineConfig(max_seq_len=max_seq, kv_dtype=torch.int8, kv_attention_kernel=True,
                                          **dict(layouts)), device=dev)
        eng._eager = True
        refs[label] = _tp_decode(torch, eng, prompt, TP_STEPS)
        if label == "w4a8":
            refs["rowsite"] = _tp_rowsite(eng, row_x)
        del eng
        torch.cuda.empty_cache()
        for world, plan in ((W, parts4),) + (((2, parts2),) if label == "w4a8" else ()):
            lab = f"llama3_8b {label} tp{world}"
            refs[lab] = refs[label]
            for r in range(world):
                plan[r].append({"kind": "llama", "label": lab, "tp": world, "layouts": layouts, "max_seq": max_seq,
                                 "prompt": prompt, "steps": TP_STEPS, "ref": _forced_ref(refs[label]),
                                 "rowsite": (row_x, refs["rowsite"]) if label == "w4a8" else None,
                                 "cm": tp_mod.shard_compressed(cm, world, r, "tp")})
    save_dir = None
    if "b" in parts:
        _tp_paged_part(torch, dev, sz, cfg, cms, refs, parts2, max_seq)
    if "f" in parts:
        save_dir = _tp_save_part(torch, dev, params, parts4)
    # each part draws its data from a generator of its own, so what it reads
    # does not depend on the parts before it
    if "e" in parts:
        _tp_ring_part(torch, dev, torch.Generator(device=dev).manual_seed(21), cfg, params, parts4)
    if "c" in parts:
        _tp_moe_part(torch, dev, torch.Generator(device=dev).manual_seed(22), refs, parts4)
    if "d" in parts:
        _tp_deepseek_part(torch, dev, torch.Generator(device=dev).manual_seed(23), refs, parts4)
    del cms
    torch.cuda.empty_cache()
    sync()
    log(json.dumps({"phase": "tp", "setup_s": time.perf_counter() - t0,
                    "parent_gb": torch.cuda.memory_allocated() / 1e9}))
    launches = _tp_run(torch, refs, parts4, parts2)
    if save_dir is not None:
        _tp_save_check(torch, dev, save_dir, parts4[0])
    never = [k for k in TP_KERNELS if not launches.get(k)] if parts == TP_PARTS else []
    if never:
        raise AssertionError(f"tp: kernels no rank launched: {never}")
    return launches


def _tp_paged_part(torch, dev, sz, cfg, cms, refs, parts2, max_seq):
    """(b) paged serving at TP 2: INT4, int8 pages, 12 requests behind a shared prefix."""
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E
    from tensorrt_model_optimizer_tpu_torch.serve import tp as tp_mod

    run = PagedRun()
    geom = run.geometry(sz.page)
    prompts, reqs = run.make(torch, dev, cfg.vocab_size, seed=7)
    new = [r.max_new_tokens for r in reqs()]
    cm = cms["INT4_BLOCKWISE_WEIGHT_ONLY_CFG"]
    eng = E.Engine(cm, E.EngineConfig(max_seq_len=max_seq, kv_dtype=torch.int8, kv_attention_kernel=True,
                                      paged_attention_kernel=True), device=dev)
    eng._eager = True
    refs["paged"] = eng.serve(reqs(), **geom, prefix_cache=True, unroll=run.unroll)
    first = eng.init_cache(len(prompts), max_len=run.prompt)
    refs["paged_first"] = eng.prefill(torch.stack(prompts), first)  # each request's first-token logits
    refs["paged_forced"] = _paged_forced(torch, eng, prompts[:TP_PAGED_SLOTS], geom, TP_PAGED_STEPS)
    del eng, first
    for r in range(2):
        parts2[r].append({"kind": "paged", "label": "llama3_8b int4 paged tp2", "tp": 2, "max_seq": max_seq,
                          "cm": tp_mod.shard_compressed(cm, 2, r, "tp"), "prompts": prompts, "new": new,
                          "geom": geom, "unroll": run.unroll, "forced_ref": refs["paged_forced"]})


def _tp_save_part(torch, dev, params, parts4) -> str:
    """(f) the INT4 model's first TP_SAVE_DEPTH layers, saved by the ranks."""
    import tempfile

    from tensorrt_model_optimizer_tpu_torch.models import llama
    from tensorrt_model_optimizer_tpu_torch.quant import ptq

    qm = ptq.quantize(llama.LlamaConfig.llama3_8b(num_hidden_layers=TP_SAVE_DEPTH),
                      {**params, "layers": {k: v[:TP_SAVE_DEPTH] for k, v in params["layers"].items()}},
                      "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", device=dev)
    save_dir = tempfile.mkdtemp(prefix="tp_save_")
    for r in range(TP_WORLD):
        parts4[r].append({"kind": "save", "label": "save_sharded", "model": qm, "path": os.path.join(save_dir, "ckpt")})
    return save_dir


def _tp_save_check(torch, dev, save_dir: str, part0: list) -> None:
    """(f) the restore with no mesh gathers the saved model, equal."""
    import shutil

    from tensorrt_model_optimizer_tpu_torch.opt import state
    from tensorrt_model_optimizer_tpu_torch.utils import tree

    qm = next(p["model"] for p in part0 if p["kind"] == "save")
    t0 = time.perf_counter()
    back = tree.flatten_with_names(state.restore_sharded(os.path.join(save_dir, "ckpt"), device=dev).params)
    for name, w in tree.flatten_with_names(qm.params).items():
        if not torch.equal(back[name], w):
            raise AssertionError(f"tp save: the gathered restore's {name} differs from the saved model's")
    log(json.dumps({"phase": "tp", "part": "save_sharded", "gathered_restore_s": time.perf_counter() - t0,
                    "equal": True}))
    shutil.rmtree(save_dir, ignore_errors=True)


def _tp_ring_part(torch, dev, g, cfg, params, parts4) -> None:
    """(e) ring attention at 8B's attention widths, the pipeline on the 8B's layers."""
    from tensorrt_model_optimizer_tpu_torch.models import llama

    W = TP_WORLD
    Bq, Tr, Hq, Hk, hd = TP_RING
    qkv = [torch.randn((Bq, W * Tr, H, hd), generator=g, device=dev) for H in (Hq, Hk, Hk)]
    q, k, v = qkv[0], *(x.repeat_interleave(Hq // Hk, dim=2) for x in qkv[1:])
    ring_ref = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True).transpose(1, 2)
    ptoks = torch.randint(0, cfg.vocab_size, TP_PIPE_TOKENS, generator=g, device=dev)
    pipe_ref = llama.forward(cfg, params, ptoks)[0]
    for r in range(W):
        sl = slice(r * Tr, (r + 1) * Tr)
        parts4[r].append({"kind": "ring", "label": "ring+pipeline", "qkv": (q[:, sl], k[:, sl], v[:, sl]),
                          "ref": ring_ref[:, sl], "cfg": cfg, "params": params, "tokens": ptoks,
                          "pipe_ref": pipe_ref})


def _tp_moe_part(torch, dev, g, refs, parts4) -> None:
    """(c) Qwen3-30B-A3B at EP 4: the sharded calibration, then serving."""
    from tensorrt_model_optimizer_tpu_torch.models import mixtral
    from tensorrt_model_optimizer_tpu_torch.quant import compress, ptq
    from tensorrt_model_optimizer_tpu_torch.serve import engine as E
    from tensorrt_model_optimizer_tpu_torch.serve import tp as tp_mod

    W = TP_WORLD
    mcfg = mixtral.MixtralConfig(**{**QWEN3_30B_A3B, "num_hidden_layers": TP_MOE_DEPTH})
    mparams = mixtral.init_params(mcfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    mcal = [torch.randint(0, mcfg.vocab_size, TP_MOE_PROMPT, generator=g, device=dev)]
    mq = ptq.quantize_family("mixtral", mcfg, mparams, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", mcal, device=dev)
    mcm = compress.compress(mq)
    mprompt = torch.randint(0, mcfg.vocab_size, TP_MOE_PROMPT, generator=g, device=dev)
    eng = E.Engine(mcm, E.EngineConfig(max_seq_len=TP_MOE_PROMPT[1] + TP_STEPS, kv_dtype=torch.int8,
                                       kv_attention_kernel=True), device=dev)
    eng._eager = True
    label = "qwen3_30b_a3b int4 ep4"
    with _pinned_routes() as pins:
        pins.record()
        ref = refs[label] = dict(_tp_decode(torch, eng, mprompt, TP_STEPS), limit=TP_MOE_PINNED_MAX)
    del eng
    for r in range(W):
        parts4[r].append({"kind": "moe", "label": label, "cfg": mcfg, "params": mparams,
                          "preset": "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "calib": mcal, "ref_qstate": mq.qstate,
                          "cm": tp_mod.shard_compressed(mcm, W, r, "tp"), "prompt": mprompt, "steps": TP_STEPS,
                          "max_seq": TP_MOE_PROMPT[1] + TP_STEPS, "ref": _forced_ref(ref), "routes": pins.choices,
                          "ref_logits": ref["logits"]})



def _tp_deepseek_part(torch, dev, g, refs, parts4) -> None:
    """(d) DeepSeek-V3 at TP / EP 4."""
    from tensorrt_model_optimizer_tpu_torch.models import deepseek, hf_loader
    from tensorrt_model_optimizer_tpu_torch.serve import deepseek_engine, deepseek_tp

    W = TP_WORLD

    dcfg = dataclasses.replace(hf_loader.deepseek_config_from_hf(DEEPSEEK_V3), num_hidden_layers=DEEPSEEK_V3_DEPTH,
                               first_k_dense_replace=1)
    dparams = _deepseek_params(torch, dev, dcfg, 0)
    dcal = [torch.randint(0, dcfg.vocab_size, (1, 64), generator=g, device=dev)]
    dcm = deepseek_engine.compress(deepseek.quantize(dcfg, dparams, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", dcal,
                                                     device=dev))
    del dparams
    torch.cuda.empty_cache()
    dprompt = torch.randint(0, dcfg.vocab_size, TP_DS_PROMPT, generator=g, device=dev)
    dmax = TP_DS_PROMPT[1] + TP_DS_STEPS
    eng = deepseek_engine.DeepseekEngine(dcm, dmax, dev)
    eng._eager = True
    label = "deepseek_v3 int4 tp4"
    with _pinned_routes(deepseek) as pins:
        pins.record()
        ref = refs[label] = dict(_tp_decode(torch, eng, dprompt, TP_DS_STEPS), limit=MOE_PLAIN_MEDIAN_MAX)
    del eng
    for r in range(W):
        parts4[r].append({"kind": "deepseek", "label": label, "cm": deepseek_tp.shard_deepseek(dcm, W, r),
                          "prompt": dprompt, "steps": TP_DS_STEPS, "max_seq": dmax, "ref": _forced_ref(ref),
                          "routes": pins.choices, "ref_logits": ref["logits"]})


def _tp_run(torch, refs: dict, parts4: list, parts2: list) -> dict:
    """Launch the ranks (4, then 2) and hold what each returns (every
    reading printed before a failed hold raises); returns the launch counts
    summed over ranks."""
    launches: dict = {}
    failed = []
    for world, parts in ((TP_WORLD, parts4), (2, parts2)):
        if not any(parts):
            continue
        outs, backend, _ = _tp_launch(torch, world, parts)
        for rank, res in enumerate(outs):
            for label, got in res.items():
                for kname, n in got["launches"].items():
                    launches[kname] = launches.get(kname, 0) + n
                row = {"phase": "tp", "part": label, "rank": rank, "backend": backend,
                       "peak_gb": got["peak_gb"], "launches": got["launches"]}
                if label in refs and "logits" in got:
                    row.update(_tp_hold(torch, f"{label} rank {rank}", got, refs[label]))
                    failed += row["failed"]
                    row.update(prefill_ms=got["prefill_ms"], step_ms=got["step_ms"],
                               single_card_prefill_ms=refs[label]["prefill_ms"],
                               single_card_step_ms=refs[label]["step_ms"])
                    row.update({k: got[k] for k in ("amax_gap", "routing_choices_apart", "unpinned_median_gap",
                                                     "unpinned_max_gap") if k in got})
                    if "rowsite_gap" in got:
                        row["rowsite_gap"] = got["rowsite_gap"]
                        if not got["rowsite_gap"] <= TP_ROWSITE_MAX:
                            failed.append(f"tp {label} rank {rank}: the W4A8 row site {got['rowsite_gap']} of the "
                                          f"single card's scale apart > {TP_ROWSITE_MAX}")
                    gemm = {"w4a8": "qmm_w4a8", "int4": "qmm_int4_wo", "nvfp4": "qmm_fp4_wo"}.get(
                        label.split()[1], "qmm_int4_wo")
                    if not got["launches"].get(gemm):
                        failed.append(f"tp {label} rank {rank}: {gemm} never launched: {got['launches']}")
                elif "outs" in got:
                    ref = refs["paged"]
                    equal = sum(int(a == b) for rid in ref for a, b in zip(got["outs"][rid], ref[rid]))
                    total = sum(len(v) for v in ref.values())
                    first = refs["paged_first"]
                    margins = [float((first[rid].max() - first[rid, got["outs"][rid][0]]) / first[rid].abs().max())
                               for rid in ref if got["outs"][rid][0] != ref[rid][0]]
                    row.update(equal_tokens=equal, tokens=total, first_apart_margins=margins,
                               wall_s=got["wall_s"], tok_s=got["tok_s"], chunked_prefills=got["chunked_prefills"])
                    forced = got["forced"]
                    medians = [statistics.median(g) for g in forced["step_gaps"]]
                    row["forced"] = {"steps_held": len(medians), "median_gap_max": max(medians),
                                     "median_gap_median": statistics.median(medians),
                                     "max_gap": max(max(g) for g in forced["step_gaps"]),
                                     "equal_tokens": int((forced["tokens"] == refs["paged_forced"]["tokens"].cpu()).sum()),
                                     "tokens": forced["tokens"].numel()}
                    if not max(medians) <= TP_LOGITS_MAX:
                        failed.append(f"tp paged rank {rank}: a teacher-forced paged step's logits {max(medians)} of "
                                      f"the single card's scale apart (median) > {TP_LOGITS_MAX}")
                    failed += [f"tp paged rank {rank}: {k} never launched"
                               for k in ("paged_attention_decode", "paged_attention_prefill_tc") if not got["launches"].get(k)]
                    if margins and not max(margins) <= TP_TIE_MAX:
                        failed.append(f"tp paged rank {rank}: a request's first token parts from the single card's "
                                      f"where its margin is {max(margins)} > {TP_TIE_MAX}")
                elif label == "ring+pipeline":
                    row.update({k: got[k] for k in ("max_err", "ms", "pipeline_ms", "pipeline_max_err")})
                    if not got["max_err"] <= TP_RING_MAX:
                        failed.append(f"tp ring rank {rank}: {got['max_err']} > {TP_RING_MAX} of SDPA's scale")
                    if not got["pipeline_max_err"] <= TP_PIPE_MAX:
                        failed.append(f"tp pipeline rank {rank}: {got['pipeline_max_err']} > {TP_PIPE_MAX}")
                else:
                    row.update({k: got[k] for k in ("save_s", "restore_s")})
                log(json.dumps(row))
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


KERNELS = {
    "qmm_w4a8": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_w4a8.cu",
                 "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:1410"),
    "kv_decode_attention": ("tensorrt_model_optimizer_tpu_torch/csrc/kv_decode_attention.cu",
                            "tensorrt_model_optimizer_tpu/ops/pallas/kv_attention.py:220"),
    "flash_gqa": ("tensorrt_model_optimizer_tpu_torch/csrc/flash_gqa.cu",
                  "tensorrt_model_optimizer_tpu/ops/pallas/flash_gqa.py:80"),
    # one kernel for one function that the TPU package wrote in several layouts
    "qmm_int4_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_int4_wo.cu",
                    "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:1184 (qmm_int4_bd2), :189 (qmm_int4), "
                    ":751 (qmm_int4_word), :871 (qmm_int4_word2)"),
    "qmm_fp4_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_fp4_wo.cu",
                   "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:997 (qmm_nvfp4_word2), :289 (qmm_nvfp4), "
                   ":434 (qmm_nvfp4_perm), :651 (qmm_nvfp4_word), :1625 (qmm_nvfp4_bd4)"),
    "qmm_byte_wo": ("tensorrt_model_optimizer_tpu_torch/csrc/qmm_byte_wo.cu",
                    "tensorrt_model_optimizer_tpu/ops/pallas/qmm.py:80 (qmm_int8), :122 (qmm_fp8)"),
    "paged_attention_decode": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_decode.cu",
                               "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:108"),
    # one TPU kernel, two routes of one source (`paged_attention.prefill_route`)
    "paged_attention_prefill_tc": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_prefill.cu",
                                   "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:246"),
    "paged_attention_prefill_cuda_core": ("tensorrt_model_optimizer_tpu_torch/csrc/paged_attention_prefill.cu",
                                          "tensorrt_model_optimizer_tpu/ops/pallas/paged_attention.py:246"),
    # one TPU kernel, two routes of one source (`sparse_attention.route`)
    "skip_softmax_flash_tc": ("tensorrt_model_optimizer_tpu_torch/csrc/skip_softmax_flash.cu",
                              "tensorrt_model_optimizer_tpu/ops/pallas/sparse_attention.py:138"),
    "skip_softmax_flash_cuda_core": ("tensorrt_model_optimizer_tpu_torch/csrc/skip_softmax_flash.cu",
                                     "tensorrt_model_optimizer_tpu/ops/pallas/sparse_attention.py:138"),
}
# f32 only: the RULER curve on the anchor launches the first, the anchor's
# f32 paged engine the second
ANCHOR_ONLY = ("skip_softmax_flash_cuda_core", "paged_attention_prefill_cuda_core")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,anchor,full,deploy,calib,accuracy,moe,families,deepseek,"
                                        "speculative,train,prune,diffusion,vision,hybrid,tp",
                    help="comma-separated; add 'profile' for device time by kernel (torch.profiler: the prefill and "
                         "decode steps of each phase's paths, the full run's at FULL_DEPTH)")
    args = ap.parse_args(argv)
    import torch

    from tensorrt_model_optimizer_tpu_torch.ops.cuda import _build  # fails outside the repo

    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    global PROFILING
    PROFILING = "profile" in phases
    if "build" in phases:  # nvcc compiles while the kernels phase runs what is built
        _build.start_all()
    dev, sz = torch.device("cuda"), Sizes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    timer = Timer(torch, dev)
    rows: dict = {}
    launches = None
    seconds = {}
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    if "kernels" in phases:
        timed("kernels", phase_kernels, torch, dev, sz, timer, rows)
    if "build" in phases:  # what is still compiling (the kernels phase has waited for what it ran)
        timed("build", phase_build)
    if "kernels" not in phases:  # the families', DeepSeek-V3's or DiT-XL/2's GEMM shapes alone
        for name, table in (("kernels_families", FAMILY_GEMMS), ("kernels_deepseek", DEEPSEEK_GEMMS),
                            ("kernels_dit", DIT_GEMMS)):
            if name in phases:
                for k in ("qmm_w4a8", "qmm_int4_wo", "qmm_fp4_wo", "qmm_byte_wo"):
                    rows.setdefault(k, {"shapes": []})
                timed(name, _phase_kernels_families, torch, dev, sz, timer, rows,
                      torch.Generator(device=dev).manual_seed(0), table)
    anchor_launches = {}
    if "anchor" in phases:
        anchor_launches = timed("anchor", phase_anchor, torch, dev, sz)
    if "full" in phases:
        launches = {**timed("full", phase_full, torch, dev, sz, "profile" in phases), **anchor_launches}
        never = [name for name in KERNELS if not launches.get(name) and (name not in ANCHOR_ONLY or anchor_launches)]
        if never:
            raise AssertionError(f"full: kernels that no path launched: {never}")
    if "deploy" in phases:
        deployed = timed("deploy", phase_deploy, torch, dev, sz)
        want = {"qmm_w4a8", "qmm_fp4_wo", "flash_gqa", "kv_decode_attention"}
        if {k for k, n in deployed.items() if n} != want:
            raise AssertionError(f"deploy: launched {deployed}, its kernels are {sorted(want)}")
    if "calib_anchor" in phases and "calib" not in phases:  # the anchor part of calib alone
        timed("calib_anchor", _calib_anchor, torch, dev)
    if "calib" in phases:
        calibrated = timed("calib", phase_calib, torch, dev, sz)
        never = [k for k in CALIB_KERNELS if not calibrated.get(k)]
        if never:
            raise AssertionError(f"calib: kernels its paths did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + calibrated.get(k, 0) for k in KERNELS}
    if "accuracy" in phases:
        accurate = timed("accuracy", phase_accuracy, torch, dev, sz)
        never = [k for k in ACCURACY_KERNELS if not accurate.get(k)]
        if never:
            raise AssertionError(f"accuracy: kernels its paths did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + accurate.get(k, 0) for k in KERNELS}
    if "moe_full" in phases and "moe" not in phases:  # (b) and (c) of moe alone
        timed("moe_full", phase_moe, torch, dev, sz, False)
    if "moe" in phases:
        moe = timed("moe", phase_moe, torch, dev, sz)
        never = [k for k in MOE_KERNELS if not moe.get(k)]
        if never:
            raise AssertionError(f"moe: kernels its paths did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + moe.get(k, 0) for k in KERNELS}
    if "families_small" in phases and "families" not in phases:  # (a) of families alone
        timed("families_small", _families_small, torch, dev)
    if "families_full" in phases and "families" not in phases:  # (c) and (b) of families alone
        timed("families_full", _families_full, torch, dev, sz)
    if "families" in phases:
        fam = timed("families", phase_families, torch, dev, sz)
        never = [k for k in FAMILY_KERNELS if not fam.get(k)]
        if never:
            raise AssertionError(f"families: kernels its paths did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + fam.get(k, 0) for k in KERNELS}
    if "deepseek_small" in phases and "deepseek" not in phases:  # (a) of deepseek alone
        timed("deepseek_small", _deepseek_small, torch, dev)
    if "deepseek_full" in phases and "deepseek" not in phases:  # (b) of deepseek alone
        timed("deepseek_full", _deepseek_full, torch, dev, sz)
    if "deepseek" in phases:
        ds = timed("deepseek", phase_deepseek, torch, dev, sz)
        never = [k for k in DEEPSEEK_KERNELS if not ds.get(k)]
        if never:
            raise AssertionError(f"deepseek: kernels its paths did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + ds.get(k, 0) for k in KERNELS}
    if "speculative_anchor" in phases and "speculative" not in phases:  # (a) of speculative alone
        timed("speculative_anchor", _spec_anchor, torch, dev)
    if "speculative_full" in phases and "speculative" not in phases:  # (b) of speculative alone
        timed("speculative_full", _spec_full, torch, dev, sz, timer, rows)
    if "speculative" in phases:
        spec = timed("speculative", phase_speculative, torch, dev, sz, timer, rows)
        launches = {k: (launches or {}).get(k, 0) + spec.get(k, 0) for k in KERNELS}
    if "train_full" in phases and "train" not in phases:  # (a) and (d) of train alone
        timed("train_full", _train_full, torch, dev)
    if "train_anchor" in phases and "train" not in phases:  # (b), (c) and (e) of train alone
        timed("train_anchor", _train_anchor, torch, dev)
    if "train" in phases:
        trained = timed("train", phase_train, torch, dev)
        never = [k for k in TRAIN_KERNELS if not trained.get(k)]
        if never:
            raise AssertionError(f"train: kernels its served runs did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + trained.get(k, 0) for k in KERNELS}
    if "prune_full" in phases and "prune" not in phases:  # (a)-(d) of prune alone
        timed("prune_full", _prune_full, torch, dev, sz, timer, rows)
    if "prune_anchor" in phases and "prune" not in phases:  # (e) of prune alone
        timed("prune_anchor", _prune_anchor, torch, dev)
    if "prune" in phases:
        pruned = timed("prune", phase_prune, torch, dev, sz, timer, rows)
        never = [k for k in PRUNE_KERNELS if not pruned.get(k)]
        if never:
            raise AssertionError(f"prune: kernels its served runs did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + pruned.get(k, 0) for k in KERNELS}
    if "diffusion" in phases:
        diffused = timed("diffusion", phase_diffusion, torch, dev)
        never = [k for k in DIFFUSION_KERNELS if not diffused.get(k)]
        if never:
            raise AssertionError(f"diffusion: kernels its DiT-XL/2 runs did not launch: {never}")
        launches = {k: (launches or {}).get(k, 0) + diffused.get(k, 0) for k in KERNELS}
    if "vision" in phases:
        timed("vision", phase_vision, torch, dev)
    if "hybrid" in phases:
        timed("hybrid", phase_hybrid, torch, dev)
    if "tp" in phases or "tp_full" in phases:  # tp_full: (a) at twice the depth
        ranked = timed("tp", phase_tp, torch, dev, sz, timer, rows, "tp_full" in phases)
        launches = {k: (launches or {}).get(k, 0) + ranked.get(k, 0) for k in KERNELS}
    elif "tp_llama" in phases:  # (a) alone
        timed("tp_llama", phase_tp, torch, dev, sz, timer, rows, False, "a")
    elif "tp_moe" in phases:  # (c) and (d) alone
        timed("tp_moe", phase_tp, torch, dev, sz, timer, rows, False, "cd")
    log(json.dumps({"phase_seconds": seconds, "total_seconds": round(time.perf_counter() - t_start, 1)}))
    out = []
    for name, (src, replaces) in KERNELS.items():
        r = rows.get(name, {})
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": (launches or {}).get(name), "max_abs_err": r.get("max_abs_err"),
                    "ms": r.get("ms"), "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                    "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
                    "shape": r.get("shape")})
    log(json.dumps({"kernels": out}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
