#!/bin/bash
# Mutation checks of chip_smoke.py's checks of the port's GEMM kernels
# (tensorrt_model_optimizer_tpu_torch/csrc/qmm_*_wo.cu, both routes of
# qmm_wo_common.cuh: the prefill tiles and the split-K decode; qmm_w4a8.cu,
# both routes: the TMA-fed wgmma prefill and the split-K decode), KV-cache
# attention kernels (kv_decode_attention.cu, paged_attention_*.cu, the
# paged prefill's two routes), the engine's use of a calibrated
# pre_quant_scale (serve/engine.py), the
# tensor-core flash kernel (flash_gqa.cu on the tile primitives of
# attn_tc.cuh) and the skip-softmax kernel (skip_softmax_flash.cu, both
# routes), of the engine's CUDA-graph decode step (serve/step_graph.py), and
# of compress's MX packs (quant/compress.py, the accuracy phase), and of the
# einsum engine's sinks and per-layer masks (serve/engine.py, the families
# phase), and of DeepSeek's routing weights, absorbed MLA and latent-cache
# order (models/deepseek.py, serve/deepseek_engine.py, the deepseek phase)
# and of its W4A4 hold at DeepSeek-V3's widths, and of the engine's tree
# verification and compaction (serve/engine.py, the speculative phase), and
# of the DiT denoise step on the three weight-only GEMMs (the diffusion
# phase).
# Each case plants one fault in a copy of the tree in a fresh `mktemp -d`
# directory (under $TMPDIR, removed on exit) and runs `chip_smoke.py --phases
# build,kernels` there (a case may name other phases); every case must exit
# non-zero.
# Needs one CUDA card and nvcc. Run from the root of the repo:
#
#     bash tools/torch_kernel_mutation_check.sh            # every case
#     bash tools/torch_kernel_mutation_check.sh skip_running_max   # the named cases only
#
# Prints one "MUTATION <name>: exit <code>" line per case with the assertion
# that caught it; the logs go to build/mutation_logs/mut_<name>.log. Exits 1 if a
# planted fault went unnoticed.
set -u
logs=build/mutation_logs
mkdir -p "$logs"
work=$(mktemp -d) || exit 1
trap 'rm -rf "$work"' EXIT
missed=0
only=" $* "
run() {  # name, file under csrc/ (or a path under the package, with a /), sed expression[, phases]
  [ "$only" = "  " ] || [[ "$only" == *" $1 "* ]] || return 0
  local f="csrc/$2"
  [[ "$2" == */* ]] && f="$2"
  rm -rf "$work/tree" && mkdir "$work/tree" && cp -r chip_smoke.py tensorrt_model_optimizer_tpu_torch artifacts examples "$work/tree/"
  sed -i "$3" "$work/tree/tensorrt_model_optimizer_tpu_torch/$f"
  if diff -q "tensorrt_model_optimizer_tpu_torch/$f" "$work/tree/tensorrt_model_optimizer_tpu_torch/$f" >/dev/null; then
    echo "MUTATION $1: the edit changed nothing (the source moved on: update this script)"; missed=1; return; fi
  (cd "$work/tree" && python3 chip_smoke.py --phases "${4:-build,kernels}") > "$logs/mut_$1.log" 2>&1; rc=$?
  echo "MUTATION $1: exit $rc"; grep -E "AssertionError|Error" "$logs/mut_$1.log" | tail -1
  [ "$rc" -ne 0 ] || missed=1
}
# int4: the odd column of each pair takes the even column's block scale
run int4_scale_col qmm_wo_common.cuh 's/__fmul_rn(part\[i\]\[j\]\[1\], s1)/__fmul_rn(part[i][j][1], s0)/'
# fp4: the second 16-block of a chunk takes the first block's scale
run fp4_second_block qmm_fp4_wo.cu 's/sc = wo::e4m3_to_float(q < 2 ? r.s \& 0xFFu : (r.s >> 8) \& 0xFFu);/sc = wo::e4m3_to_float(r.s \& 0xFFu);/'
# main loop: the last 16 k of every K tile are skipped
run skip_last_k16 qmm_wo_common.cuh 's/for (int kk = 0; kk < BK; kk += 16) {/for (int kk = 0; kk < BK - 16; kk += 16) {/'
# int4: the sign flip of the nibbles dropped (each code read as its nibble - 8)
run int4_sign qmm_int4_wo.cu 's/r.v.z : r.v.w) ^ 0x88888888u;/r.v.z : r.v.w);/'
# weight-only decode route: the fix-up skips the last split
run wo_splitk_drop_last qmm_wo_common.cuh 's/s + q < n_split/s + q < n_split - 1/g'
# weight-only decode route: the fix-up leaves its tile's arrival counter set,
# so no later call on the workspace finds itself last
run wo_splitk_no_reset qmm_wo_common.cuh '/counters\[wt\] = 0;/d'
# W4A8 prefill route: every block but the last folds with the next block's scales
run w4a8_prefill_next_scale qmm_w4a8.cu 's/__ldg(s + (size_t)kb \* O + orow + 8 \* h)/__ldg(s + (size_t)min(kb + 1, nblk - 1) * O + orow + 8 * h)/'
# W4A8 prefill route: the last k32 step (wgmma) of every 128-block is skipped
run w4a8_prefill_skip_last_k32 qmm_w4a8.cu 's/for (int step = 0; step < 4; ++step) wgmma_m64n128k32(/for (int step = 0; step < 3; ++step) wgmma_m64n128k32(/'
# W4A8 decode route: the last k32 step of every 128-block is skipped
run w4a8_decode_skip_last_k32 qmm_w4a8.cu 's/for (int step = 0; step < 4; ++step) {/for (int step = 0; step < 3; ++step) {/'
# W4A8 decode route: the fix-up skips the last split
run w4a8_splitk_drop_last qmm_w4a8.cu 's/s0 + q < n_split/s0 + q < n_split - 1/g'
# W4A8 decode route: the fix-up leaves its tile's arrival counter set
run w4a8_splitk_no_reset qmm_w4a8.cu '/counters\[wt\] = 0;/d'
# W4A8, both routes: the codes' sign dropped (16q decoded without its top bit)
run w4a8_no_sign_extension qmm_w4a8.cu 's/0xF0F0F0F0u/0x70707070u/g'
# paged decode: the last live row of every sequence is masked out
run paged_decode_last_row paged_attention_decode.cu 's/const int len = min(lens\[b\], max_pages \* page);/const int len = min(lens[b] - 1, max_pages * page);/'
# paged decode: the merge skips the last split of the table
run paged_decode_merge_drop_last paged_attention_decode.cu 's/merge_splits<HD, REP>(ml, acc, n_split, idx, -1e30f/merge_splits<HD, REP>(ml, acc, n_split - 1, idx, -1e30f/'
# paged prefill, CUDA-core route (f32 q): the causal mask takes < for <= (a
# token no longer sees itself)
run paged_prefill_causal paged_attention_prefill.cu 's/if (j <= t) {/if (j < t) {/; s/if (base + u > t) break;/if (base + u >= t) break;/'
# paged prefill, tensor-core route: the chunk's causal mask one column late
# (a token sees the next one)
run paged_prefill_tc_causal_late paged_attention_prefill.cu 's/(!ctx_tile \&\& col > t);/(!ctx_tile \&\& col > t + 1);/'
# paged prefill, tensor-core route: the tile loader skips the last page of
# every 64-key context tile
run paged_prefill_tc_skip_last_page paged_attention_prefill.cu 's/        if (s >= ctx) return -1;/        if (s >= ctx || r \/ page == TBK \/ page - 1) return -1;/'
# kv decode: the merge drops the last split of the cache
run kv_decode_merge_drop_last kv_decode_attention.cu 's/merge_splits<HD, REP>(ml, acc, n_split, idx, s_new/merge_splits<HD, REP>(ml, acc, n_split - 1, idx, s_new/'
# kv decode: the split kernel reads pos + 1 from the device (a row past the
# valid ones joins the softmax)
run kv_decode_pos_plus_one kv_decode_attention.cu 's/const int pos = min(max(__ldg(pos_p), 0), S);/const int pos = min(max(__ldg(pos_p) + 1, 0), S);/'
# the graphed decode step replays without copying the caller's token in
# (every replay decodes the token it was captured with); the full phase
# holds the graphed tokens against the eager steps'
run replay_skips_token_copy serve/step_graph.py 's/            buf.copy_(t)/            pass/' build,full
# NVFP4 rows (CUDA-core walk, `Rows<Fp4>`): the high plane takes the low
# plane's block-scale bytes
run nvfp4_high_plane_scale kv_common.cuh 's|s(static_cast<const uint8_t\*>(scales) + lane \* E / 16)|s(static_cast<const uint8_t*>(scales) + (lane \& 15) * E / 16)|'
# kv decode's NVFP4 chunks (`Lane16<Fp4>`): the high dims take the low
# block's scale byte
run nvfp4_lane16_high_scale kv_common.cuh 's|((uint32_t)__ldg(sr + HD / 32) << 8)|((uint32_t)__ldg(sr) << 8)|'
# the tensor-core prefill's NVFP4 tile stage (`Stage<Fp4>`): the high dims
# take the low block's scale byte
run nvfp4_stage_high_scale paged_attention_prefill.cu 's|s1 = s0 + HD / 32;|s1 = s0;|'
# skip-softmax, both routes (the tensor-core one first in the kernels phase):
# the decision limit follows the last kept tile's max, not the running max
# over the kept tiles
run skip_running_max skip_softmax_flash.cu 's/run = fmaxf(run, bm);/run = bm;/'
# flash: the diagonal tile masked one column late (a row sees the next key)
run flash_diag_late flash_gqa.cu 's/(causal \&\& col > row);/(causal \&\& col > row + 1);/'
# P.V without the p_lo term (p in two bf16 terms, ~16 bits): within the
# per-element limit, but more outputs than ULP_OFF_MAX an ulp from plain
run pv_drop_lo attn_tc.cuh '/mma16816(o\[mt\]\[2 \* dp[^]]*\], alo\[mt\], /d'
# P.V on p_hi alone (one bf16 P): the per-element limit needs the split
run pv_hi_only attn_tc.cuh '/mma16816(o\[mt\]\[2 \* dp[^]]*\], a\(mid\|lo\)\[mt\], /d'
# the W4A8 path of the engine's `_qlinear` drops the input's pre_quant_scale
# (AWQ's activation-side 1/s): the calib phase's anchor check holds the
# engine against the calibrated fake-quant forward
run w4a8_pre_quant_scale_dropped serve/engine.py '0,/x = x \* ist.pre_quant_scale.to(x.dtype)/s//x = x  # dropped/' build,calib_anchor
# int4 decode route at 64-wide blocks (NF4_WEIGHT_ONLY_CFG): the second half
# of every 128-block folds with the first half's scale
run int4_b64_second_half_scale qmm_wo_common.cuh 's/const int s = NS == 2 ? q >> 1 : 0;/const int s = 0;/'
# compress: MXFP6 / MXFP8 weights stored under doubled block scales (twice
# their grid values); the accuracy phase's anchor engines lie far from their
# fake-quant forward
run compress_mx_scale_doubled quant/compress.py 's|{"w": numerics.fake_quant_mx(w32, e, m, bsz).to(torch.bfloat16)}|{"w": (2 * numerics.fake_quant_mx(w32, e, m, bsz)).to(torch.bfloat16)}|' build,accuracy
# MoE dispatch: the capacity test dropped, every (token, choice) pair kept;
# the moe phase's dispatch check against JAX's capacity rule fails at a
# decode step of Qwen3-30B-A3B's shape (C = 1), on the CPU before the card
run moe_dispatch_no_capacity models/mixtral.py 's/keep = pos < C/keep = pos >= 0/' build,moe
# The moe phase's full-width check alone (`--phases build,moe_full`: the
# kernel engine against the all-plain one at depth 2 on pinned routing,
# MOE_PLAIN_MEDIAN_MAX), each fault where the kernels phase would catch it
# first: W4A8 prefill route, the last 128-block of K folds with the block
# before's scales (1 of 16 blocks at K 2048, 1 of 6 at K 768) ...
run moe_full_w4a8_last_block_scale qmm_w4a8.cu 's/__ldg(s + (size_t)kb \* O + orow + 8 \* h)/__ldg(s + (size_t)(kb == nblk - 1 \&\& kb > 0 ? kb - 1 : kb) * O + orow + 8 * h)/' build,moe_full
# ... and the weight-only prefill tiles, the odd column of each pair with
# the even column's block scale (INT4 and NVFP4)
run moe_full_int4_scale_col qmm_wo_common.cuh 's/__fmul_rn(part\[i\]\[j\]\[1\], s1)/__fmul_rn(part[i][j][1], s0)/' build,moe_full
# The families phase's small configs alone (`--phases build,families_small`:
# the f32 engine against the model's own forward, FAMILY_VS_FORWARD_MAX), two
# faults of the einsum engine's plain PyTorch attention that no kernel
# comparison sees (the kernel and the plain engine share it): the sink
# column left out of the softmax ...
run families_sink_dropped serve/engine.py 's/        if sinks is not None:/        if False:/' build,families_small
# ... and the sliding window (Llama4: the chunk) applied to every layer, the full ones too
run families_window_everywhere serve/engine.py 's/span = cfg.span() if self._flags\[i\] else None/span = cfg.span()/' build,families_small
# The families phase's full-width checks alone (`--phases build,families_full`:
# the kernel engine against the all-plain one on pinned routing, the 8 x 2048
# prefill at depth 2, FAMILY_PLAIN_MEDIAN_MAX, and Scout's 8448-token prompt
# at all 4 layers, FAMILY_LONG_MEDIAN_MAX; Scout runs first): NVFP4 (Scout's
# first path), the last 32-chunk of K with the chunk before's block scales
# (1 of 160 at K 5120, 1 of 256 at K 8192) ...
run families_full_nvfp4_last_chunk_scale qmm_fp4_wo.cu 's/reinterpret_cast<const uint16_t\*>(sp + 2 \* chunk)/reinterpret_cast<const uint16_t*>(sp + 2 * (chunk > 0 \&\& (chunk + 1) * 16 >= row_bytes ? chunk - 1 : chunk))/' build,families_full
# ... W4A8's prefill route (Scout's second path), the last 128-block of K
# with the block before's scales (1 of 40 at K 5120) ...
run families_full_w4a8_last_block_scale qmm_w4a8.cu 's/__ldg(s + (size_t)kb \* O + orow + 8 \* h)/__ldg(s + (size_t)(kb == nblk - 1 \&\& kb > 0 ? kb - 1 : kb) * O + orow + 8 * h)/' build,families_full
# ... and INT4's weight-only prefill tiles (GPT-OSS-20B's third path; Scout
# has no INT4 path), the odd column of each pair with the even column's
# block scale
run families_full_int4_scale_col qmm_wo_common.cuh 's/__fmul_rn(part\[i\]\[j\]\[1\], s1)/__fmul_rn(part[i][j][1], s0)/' build,families_full
# The deepseek phase's small config alone (`--phases build,deepseek_small`),
# three faults of DeepSeek's plain PyTorch path that no kernel comparison
# sees (the kernel and the plain engine share it): the route's weights
# taken from the choice (scores + e_bias) instead of the scores, which the
# host rule of `_deepseek_route_check` reads first ...
run deepseek_route_weights_from_choice models/deepseek.py 's/    return _weights(cfg, scores, topi), topi/    return _weights(cfg, choice, topi), topi/' build,deepseek_small
# ... kv_b's key and value halves swapped in the engine's absorbed form (the
# f32 engine against the model's fake-quant forward, DEEPSEEK_VS_FORWARD_MAX) ...
run deepseek_kvb_halves_swapped serve/deepseek_engine.py 's/        wk, wv = wkb\[hs, :dn\].float(), wkb\[hs, dn:\].float()/        wv, wk = wkb[hs, :dn].float(), wkb[hs, dn:].float()/' build,deepseek_small
# ... and the latent cached before kv_b's input quantizer (the cached latent
# moves when that quantizer quantizes it again)
run deepseek_latent_cached_before_kvb_quantizer serve/deepseek_engine.py 's/    eng_mod._write_rows(ckv, 1, rows, c_q)/    eng_mod._write_rows(ckv, 1, rows, c_kv)/' build,deepseek_small
# The deepseek phase's V3 widths alone (`--phases build,deepseek_full`): W4A4
# as served on the MoE layer alone against the all-plain engine
# (MOE_PLAIN_MEDIAN_MAX, held before the weight-only check of both
# layers), NVFP4's last 32-chunk of K with the chunk before's block scales
# (1 of 224 at K 7168)
run deepseek_full_nvfp4_last_chunk_scale qmm_fp4_wo.cu 's/reinterpret_cast<const uint16_t\*>(sp + 2 \* chunk)/reinterpret_cast<const uint16_t*>(sp + 2 * (chunk > 0 \&\& (chunk + 1) * 16 >= row_bytes ? chunk - 1 : chunk))/' build,deepseek_full
# The speculative phase (`--phases build,speculative`): three faults of the
# engine's tree verification that no kernel comparison sees (the kernel and
# the plain engine share it), each caught by the oracle round against eager
# 1-row steps (SPEC_ANCHOR_ORACLE_MAX on the anchor, first): the compaction
# takes rows pos .. pos + a - 1 in slot order instead of the accepted nodes'
# slots ...
run spec_compact_slot_order serve/engine.py 's/take = torch.tensor(\[pos + i for i in nodes\], device=self.device)/take = torch.arange(pos, pos + a, device=self.device)/' build,speculative
# ... the verify mask lets each node see its siblings ...
run spec_tree_mask_siblings serve/engine.py 's/allow\[:, pos:pos + N\] = tree.attn_mask$/allow[:, pos:pos + N] = tree.attn_mask | (np.array(tree.parent)[:, None] == np.array(tree.parent)[None, :])/' build,speculative
# ... and the verify positions taken as pos + node index instead of pos + depth
run spec_positions_by_node_index serve/engine.py 's/positions = torch.tensor(\[\[pos + d for d in tree.depth\]\]/positions = torch.tensor([[pos + j for j in range(N)]]/' build,speculative
# The same three at Llama-3.1-8B's width alone (`--phases
# build,speculative_full`): the 8B oracle round's limits (SPEC_ORACLE_MAX,
# SPEC_ROWS_MAX) against each fault
run spec_full_compact_slot_order serve/engine.py 's/take = torch.tensor(\[pos + i for i in nodes\], device=self.device)/take = torch.arange(pos, pos + a, device=self.device)/' build,speculative_full
run spec_full_tree_mask_siblings serve/engine.py 's/allow\[:, pos:pos + N\] = tree.attn_mask$/allow[:, pos:pos + N] = tree.attn_mask | (np.array(tree.parent)[:, None] == np.array(tree.parent)[None, :])/' build,speculative_full
run spec_full_positions_by_node_index serve/engine.py 's/positions = torch.tensor(\[\[pos + d for d in tree.depth\]\]/positions = torch.tensor([[pos + j for j in range(N)]]/' build,speculative_full
# The prune phase (`--phases build,prune`): W4A8's prefill route at the
# Minitron-4B-Width widths' K = 3072 only (24 128-blocks: q, k, v, gate and
# up of the pruned student), the last block of K with the block before's
# scales; the student's W4A8 engine held to its plain GEMM (logits equal at
# every step) and MINITRON_GEMMS' bit-exact rows see it, no other shape does
run prune_w4a8_k3072_last_block_scale qmm_w4a8.cu 's/__ldg(s + (size_t)kb \* O + orow + 8 \* h)/__ldg(s + (size_t)(kb == nblk - 1 \&\& nblk == 24 ? kb - 1 : kb) * O + orow + 8 * h)/' build,prune
# The diffusion phase (`--phases build,diffusion`): DiT-XL/2's denoise step on
# the weight-only GEMMs against the all-plain step at depth 2
# (DIFF_PLAIN_MAX), one fault in each kernel the step launches: FP8 (the
# step's second format), the e4m3 decoder's high pair read from the low
# half of each word ...
run diffusion_fp8_high_pair qmm_byte_wo.cu 's/hi = fpdec::e4m3x2_to_float2(w >> 16);/hi = fpdec::e4m3x2_to_float2(w);/' build,diffusion
# ... NVFP4 (the third), the second 16-block of every 32-chunk with the
# first block's scale ...
run diffusion_fp4_second_block qmm_fp4_wo.cu 's/sc = wo::e4m3_to_float(q < 2 ? r.s \& 0xFFu : (r.s >> 8) \& 0xFFu);/sc = wo::e4m3_to_float(r.s \& 0xFFu);/' build,diffusion
# ... and INT4_AWQ (the fourth), the nibbles' sign flip dropped
run diffusion_int4_sign qmm_int4_wo.cu 's/r.v.z : r.v.w) ^ 0x88888888u;/r.v.z : r.v.w);/' build,diffusion
exit $missed
