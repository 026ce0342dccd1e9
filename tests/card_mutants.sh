#!/bin/bash
# Mutation checks of the K4, K5, K8, K9, K10 and K11 CUDA kernels and of
# the adam_lowp kernel, on a machine with the card.
#
#   bash tests/card_mutants.sh [prefix ...]
#
# With prefixes (k4, k8, ...) only the mutants whose names start with one
# of them run.
# Each mutant is a copy of the tree under $TMPDIR with one kernel line edited
# by sed (the tree itself is never edited). For each, the smoke's phase
# function (chip_smoke.py::head_adam_vs_plain, kernel_vs_plain,
# trunk_argmax_vs_plain, nn_fused_vs_plain, chamfer_fused_vs_plain,
# decode_vs_plain or adam_lowp_vs_plain) and the matching card tests of tests/test_torch_cuda.py
# run in the copy; a mutant is caught when the phase fails (SmokeFailure, or
# a CUDA error: the trunk kernel traps a pipeline wait that lasts seconds)
# and card tests fail.
#   k4_idle_arrival  a CTA without a tile (odd tile counts) skips its
#                    pipeline: no barrier arrivals for its partner
#   k4_slab_swizzle  the epilogues write the second 64-column slab with the
#                    wrong swizzle
#   k11_last_row   K11 drops the last batch row of every 32-row chunk
#   k8_lane_ties   K8's keys inside a tile prefer the later of equal rows
#   k8_tile_ties   K8 merges tiles' equal maxima to the later tile
#   k5_pair_ties   K5's butterfly keeps the later query of equal distances
#   k5_dir1_store  the sweep merges direction 1 across key splits with a
#                  plain store, not the 64-bit atomicMin
#   k5_split_end   each key split stops one key short of its end (the last
#                  one only when it is full)
#   k9_dir2_sign   K9 scatters direction 2 into grad_a with the wrong sign
#   k10_bias       K10's CUDA-core kernel drops the bias in the TPU kernel's
#                  rounding wherever `finish` adds it (fp32: the last layer;
#                  bf16: every layer after the first)
#   k10_tile       the CUDA-core kernel's register tile swaps two of its points
#   k10_simt_chain the CUDA-core kernel's chain rounding skips the rounding
#                  of the product (bf16 widths it takes; one bf16 rounding
#                  apart, caught by the roundings' equal shares)
#   k10_tc_bias    K10's bf16 kernel drops the hidden layers' bias
#   k10_tc_chain   K10's bf16 kernel swaps the halves of a layer's
#                  accumulators as it chains them into the next layer's A
#                  fragments (rows 8-15 of channels 0-7 and rows 0-7 of 8-15)
#   k10_tc_round   the bf16 kernel's chain rounding rounds the hidden layers
#                  as the TPU kernel does (caught by the equal shares)
#   adam_round     adam_lowp keeps (1 - b1) g unrounded in a bf16 or fp16
#                  parameter's dtype
#   adam_fma       adam_lowp contracts p + (-lr u) into one FMA
#   adam_tail      adam_lowp's vector loop leaves the last n % 4 values
#   adam_bc        adam_lowp divides nu by bc1 instead of bc2
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
only=" $* "
K11_PY='import torch, chip_smoke as c
try:
    c.head_adam_vs_plain(torch.device("cuda", 0)); print("MUTANT SURVIVED the smoke phase")
except c.SmokeFailure as e: print("MUTANT CAUGHT by the smoke phase:", e)'
TRUNK_PY='import sys, torch, chip_smoke as c
d = torch.device("cuda", 0)
_, model = c.build_model("bfloat16")
phase = c.kernel_vs_plain if sys.argv[1] == "k4" else c.trunk_argmax_vs_plain
try:
    phase(model.serving_params().to(d), d); print("MUTANT SURVIVED the smoke phase")
except Exception as e: print("MUTANT CAUGHT by the smoke phase:", type(e).__name__, str(e).strip().splitlines()[0])'
PHASE_PY='import copy, sys, torch, chip_smoke as c
d = torch.device("cuda", 0)
_, model = c.build_model("bfloat16")
model32 = copy.deepcopy(model)
model32.compute_dtype = "float32"
model32 = model32.to(d)
phase = {"k5": lambda: c.nn_fused_vs_plain(model32, d),
         "k9": lambda: c.chamfer_fused_vs_plain(d),
         "k10": lambda: c.decode_vs_plain(model, model32, d)}[sys.argv[1]]
try:
    phase(); print("MUTANT SURVIVED the smoke phase")
except Exception as e:  # SmokeFailure, or a CUDA error (an index left at -1 faults a gather)
    print("MUTANT CAUGHT by the smoke phase:", type(e).__name__, str(e).strip().splitlines()[0])'
ADAM_PY='import torch, chip_smoke as c
_, model = c.build_model("float32")
try:
    c.adam_lowp_vs_plain(model, torch.device("cuda", 0)); print("MUTANT SURVIVED the smoke phase")
except c.SmokeFailure as e: print("MUTANT CAUGHT by the smoke phase:", str(e).splitlines()[0][:300])'

mutant () {  # name, source file under csrc/, python check, pytest -k, sed expressions...
  name=$1; file=$2; check=$3; tests=$4; shift 4
  if [ "$only" != "  " ] && [[ "$only" != *" ${name%%_*} "* ]]; then return; fi
  copy=$tmp/mutant_$name
  rm -rf "$copy"; mkdir -p "$copy"
  tar --exclude=./_smoke_checkout --exclude=./hyperpocket_tpu_torch/_build \
      -cf - . | tar -xf - -C "$copy"
  for expr in "$@"; do sed -i "$expr" "$copy/hyperpocket_tpu_torch/csrc/$file"; done
  echo "== $name"
  if ! diff "hyperpocket_tpu_torch/csrc/$file" "$copy/hyperpocket_tpu_torch/csrc/$file"; then
    (cd "$copy" && python3 -c "$check" ${name%%_*} 2>&1 | tail -n 1 &&
     python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q \
         -k "$tests" 2>&1 | tail -n 1)
  else
    echo "sed changed nothing: the mutant is stale"
  fi
  rm -rf "$copy"
}

mutant k11_last_row head_adam.cu "$K11_PY" head_adam \
  's/for (int b = 0; b < rows; ++b) {/for (int b = 0; b < rows - 1; ++b) {/'
mutant k4_idle_arrival trunk_pool.cu "$TRUNK_PY" trunk \
  's/int cloud = 0, row0 = 0, valid_rows = 0;/if (tile >= p.tiles) continue; int cloud = 0, row0 = 0, valid_rows = 0;/'
mutant k4_slab_swizzle trunk_pool.cu "$TRUNK_PY" "trunk and not argmax" \
  's/((cc >> 3) ^ (row \& 7))/((cc >> 3) ^ ((row + (col >> 6 == 1)) \& 7))/'
mutant k8_lane_ties trunk_pool.cu "$TRUNK_PY" argmax \
  's/(0xFFFFu - (uint32_t)row)/((uint32_t)row)/' \
  's/0xFFFF - (int)(key \& 0xFFFFu)/(int)(key \& 0xFFFFu)/'
mutant k8_tile_ties trunk_pool.cu "$TRUNK_PY" argmax \
  's/(0xFFFFFFFFu - (unsigned)(row0 + row_key_row(m)))/((unsigned)(row0 + row_key_row(m)))/' \
  's/idx\[i\] = (int)(0xFFFFFFFFu - (unsigned)(k \& 0xFFFFFFFFull));/idx[i] = (int)(k \& 0xFFFFFFFFull);/'
mutant k5_pair_ties nn_fused.cuh "$PHASE_PY" fused_planes \
  's/return d < e || (d == e \&\& i < j);/return d < e || (d == e \&\& i > j);/'
mutant k5_dir1_store nn_fused.cuh "$PHASE_PY" "fused_planes or k5_and_k9" \
  's/if (i < n) atomicMin(\&query_words\[(size_t)b \* n + i\], pack_pair(best\[s\], arg\[s\]));/if (i < n) query_words[(size_t)b * n + i] = pack_pair(best[s], arg[s]);/'
mutant k5_split_end nn_fused.cuh "$PHASE_PY" "fused_planes or k5_and_k9" \
  's/min((long long)first + length, (long long)m)/min((long long)first + length - 1, (long long)m)/'
mutant k9_dir2_sign chamfer_loss_grad.cu "$PHASE_PY" chamfer_loss \
  's/atomicAdd(g + c, -diff);/atomicAdd(g + c, diff);/'
mutant k10_bias decode_batch.cu "$PHASE_PY" decode \
  's/rnd<T>(first ? acc : __fadd_rn(acc, b))/rnd<T>(acc)/'
mutant k10_tile decode_batch.cu "$PHASE_PY" decode \
  's/av\[p + 2\] = a.z, av\[p + 3\] = a.w;/av[p + 2] = a.w, av[p + 3] = a.z;/'
mutant k10_simt_chain decode_batch.cu "$PHASE_PY" "decode and wide" \
  's/rnd<T>(__fadd_rn(rnd<T>(acc), b))/rnd<T>(__fadd_rn(acc, b))/'
mutant k10_tc_bias decode_batch_tc.cu "$PHASE_PY" decode \
  's/\*reinterpret_cast<const float2\*>(bias + 16 \* nc + 2 \* t)/make_float2(0.f, 0.f)/' \
  's/\*reinterpret_cast<const float2\*>(bias + 16 \* nc + 8 + 2 \* t)/make_float2(0.f, 0.f)/'
mutant k10_tc_chain decode_batch_tc.cu "$PHASE_PY" decode \
  's/h\[nc\]\[mt\]\[2 \* half + 1\] = pack_relu(acc\[u\]\[half\]\[mt\]\[2\], acc\[u\]\[half\]\[mt\]\[3\]);/h[nc][mt][2 * half + 1] = pack_relu(acc[u][half ^ 1][mt][0], acc[u][half ^ 1][mt][1]);/'
mutant k10_tc_round decode_batch_tc.cu "$PHASE_PY" "decode and chain" \
  's/const float2 b_lo = chain ? make_float2(0.f, 0.f) : bs\[u\]\[0\];/const float2 b_lo = bs[u][0];/' \
  's/const float2 b_hi = chain ? make_float2(0.f, 0.f) : bs\[u\]\[1\];/const float2 b_hi = bs[u][1];/' \
  's/          if (chain) {/          if (false) {/'
mutant adam_round adam_lowp.cu "$ADAM_PY" adam_lowp \
  's/rnd<P>(__fmul_rn(g, sc.one_b1))/__fmul_rn(g, sc.one_b1)/'
mutant adam_fma adam_lowp.cu "$ADAM_PY" adam_lowp \
  's/p = from_f<P>(__fadd_rn(pf, rnd<P>(__fmul_rn(u, sc.neg_lr))));/p = from_f<P>(fmaf(u, sc.neg_lr, pf));/'
mutant adam_tail adam_lowp.cu "$ADAM_PY" adam_lowp \
  's/    done = vecs \* kVec;/    done = n;/'
mutant adam_bc adam_lowp.cu "$ADAM_PY" adam_lowp \
  's/__fdiv_rn(to_f(nu), bc2)/__fdiv_rn(to_f(nu), bc1)/'
