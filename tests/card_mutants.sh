#!/bin/bash
# Mutation checks of the K5, K8, K9, K10 and K11 CUDA kernels, on a machine
# with the card.
#
#   bash tests/card_mutants.sh
#
# Each mutant is a copy of the tree under $TMPDIR with one kernel line edited
# by sed (the tree itself is never edited). For each, the smoke's phase
# function (chip_smoke.py::head_adam_vs_plain, trunk_argmax_vs_plain,
# nn_fused_vs_plain, chamfer_fused_vs_plain or decode_vs_plain) and the
# matching card tests of tests/test_torch_cuda.py run in the copy; a mutant
# is caught when the phase raises SmokeFailure and card tests fail.
#   k11_last_row   K11 drops the last batch row of every 32-row chunk
#   k8_lane_ties   K8 merges lanes' equal maxima to the later row
#   k8_tile_ties   K8 merges tiles' equal maxima to the later tile
#   k5_pair_ties   K5's butterfly keeps the later query of equal distances
#   k9_dir2_sign   K9 scatters direction 2 into grad_a with the wrong sign
#   k10_bias       K10 drops the hidden layers' bias of every second point
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
K11_PY='import torch, chip_smoke as c
try:
    c.head_adam_vs_plain(torch.device("cuda", 0)); print("MUTANT SURVIVED the smoke phase")
except c.SmokeFailure as e: print("MUTANT CAUGHT by the smoke phase:", e)'
K8_PY='import torch, chip_smoke as c
d = torch.device("cuda", 0)
_, model = c.build_model("bfloat16")
try:
    c.trunk_argmax_vs_plain(model.serving_params().to(d), d); print("MUTANT SURVIVED the smoke phase")
except c.SmokeFailure as e: print("MUTANT CAUGHT by the smoke phase:", e)'
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
except c.SmokeFailure as e: print("MUTANT CAUGHT by the smoke phase:", e)'

mutant () {  # name, source file under csrc/, python check, pytest -k, sed expressions...
  name=$1; file=$2; check=$3; tests=$4; shift 4
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
mutant k8_lane_ties trunk_pool.cu "$K8_PY" argmax \
  's/(v == m \&\& row < r)/(v == m \&\& row > r)/'
mutant k8_tile_ties trunk_pool.cu "$K8_PY" argmax \
  's/(0xFFFFFFFFu - (unsigned)(row0 + r\([01]\)))/((unsigned)(row0 + r\1))/' \
  's/idx\[i\] = (int)(0xFFFFFFFFu - (unsigned)(k \& 0xFFFFFFFFull));/idx[i] = (int)(k \& 0xFFFFFFFFull);/'
mutant k5_pair_ties nn_fused.cuh "$PHASE_PY" fused_planes \
  's/(other_d == keep_d \&\& other_i < keep_i)/(other_d == keep_d \&\& other_i > keep_i)/'
mutant k9_dir2_sign chamfer_loss_grad.cu "$PHASE_PY" chamfer_loss \
  's/atomicAdd(g + c, -diff);/atomicAdd(g + c, diff);/'
mutant k10_bias decode_batch.cu "$PHASE_PY" decode \
  's/__fadd_rn(a1\[j\], bias\[c\])/a1[j]/'
