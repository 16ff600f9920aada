#!/bin/bash
# Mutation checks of chip_smoke.py's checks of the port's weight-only GEMM
# kernels (tensorrt_model_optimizer_tpu_torch/csrc/qmm_*_wo.cu), KV-cache
# attention kernels (kv_decode_attention.cu, paged_attention_*.cu, the
# paged prefill's two routes), the
# tensor-core flash kernel (flash_gqa.cu on the tile primitives of
# attn_tc.cuh) and the skip-softmax kernel (skip_softmax_flash.cu, both
# routes). Each case
# plants one fault in a copy of the tree in a fresh `mktemp -d` directory
# (under $TMPDIR, removed on exit) and runs `chip_smoke.py --phases
# build,kernels` there; every case must exit non-zero.
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
run() {  # name, file under csrc/, sed expression
  [ "$only" = "  " ] || [[ "$only" == *" $1 "* ]] || return 0
  rm -rf "$work/tree" && mkdir "$work/tree" && cp -r chip_smoke.py tensorrt_model_optimizer_tpu_torch artifacts "$work/tree/"
  sed -i "$3" "$work/tree/tensorrt_model_optimizer_tpu_torch/csrc/$2"
  if diff -q "tensorrt_model_optimizer_tpu_torch/csrc/$2" "$work/tree/tensorrt_model_optimizer_tpu_torch/csrc/$2" >/dev/null; then
    echo "MUTATION $1: the edit changed nothing (the source moved on: update this script)"; missed=1; return; fi
  (cd "$work/tree" && python3 chip_smoke.py --phases build,kernels) > "$logs/mut_$1.log" 2>&1; rc=$?
  echo "MUTATION $1: exit $rc"; grep -E "AssertionError|Error" "$logs/mut_$1.log" | tail -1
  [ "$rc" -ne 0 ] || missed=1
}
# int4: the odd column of each pair takes the even column's block scale
run int4_scale_col qmm_wo_common.cuh 's/__fmul_rn(part\[i\]\[j\]\[1\], s1)/__fmul_rn(part[i][j][1], s0)/'
# fp4: the second 16-block of a chunk takes the first block's scale
run fp4_second_block qmm_fp4_wo.cu 's/const float sc = j < 2 ? s0 : s1;/const float sc = s0;/'
# main loop: the last 16 k of every K tile are skipped
run skip_last_k16 qmm_wo_common.cuh 's/for (int kk = 0; kk < BK; kk += 16) {/for (int kk = 0; kk < BK - 16; kk += 16) {/'
# int4: nibble sign extension dropped (codes 8..15 read as +8..+15)
run int4_sign qmm_int4_wo.cu 's/__vsub4((v\[j\] \& 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u)/(v[j] \& 0x0F0F0F0Fu)/'
# paged decode: the last live row of every sequence is masked out
run paged_decode_last_row paged_attention_decode.cu 's/const int len = min(lens\[b\], max_pages \* page);/const int len = min(lens[b] - 1, max_pages * page);/'
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
run kv_decode_merge_drop_last kv_decode_attention.cu 's/for (int sp = 0; sp < n_split; ++sp) {/for (int sp = 0; sp < n_split - 1; ++sp) {/'
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
exit $missed
