#!/bin/bash
# Where the fused NN sweep's time goes (K5, K9), on a machine with the card.
#
#   bash tests/card_nn_fused_variants.sh
#
# Each variant is a copy of the tree under $TMPDIR with csrc/nn_fused.cuh (or
# ops/nn.py's split planner) edited by sed (the tree itself is never edited),
# built, and timed with chip_smoke.py's CUDA-event timer: K5 at B=64 with
# 1024x2048, 2048x1024 and 2048x2048, K9 at 2048x2048, and K1 twice and K3
# at 1024x2048 as a yardstick that no variant changes. Variants that change
# no arithmetic stay right; only the times mean anything, and only beside
# the base in the same call.
#   base       the kernel as it is
#   one_split  the planner never splits the keys: one block per tile
#   no_butterfly  the butterfly skipped (outputs wrong); the compiler then
#              also drops the per-key merges of all keys but the first
#   qpt4       4 queries a thread (512-query tiles), the planner told so
#   blocks3    launch bounds of 3 blocks an SM (up to 168 registers), the
#              planner told so
#   threads256 256 threads a block (2048-query tiles), 2 blocks an SM
#   base2      the base again, for the spread within the call
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
TIME_PY='import sys, torch, chip_smoke as c
from hyperpocket_tpu_torch.ops import nn
d = torch.device("cuda", 0)
g = torch.Generator(device=d).manual_seed(c.SEED)
def cloud(n):
    return torch.randn((64, n, 3), generator=g, device=d) * 0.3
out = {}
for n, m in ((1024, 2048), (2048, 1024), (2048, 2048)):
    q, k = cloud(n), cloud(m)
    out[f"K5_{n}x{m}"] = c.cuda_ms(lambda: nn.nn_fused_planes(q, k))
    if n == m:
        out[f"K9_{n}x{m}"] = c.cuda_ms(lambda: nn.chamfer_loss_grad(q, k))
    if (n, m) == (1024, 2048):
        out["K1_twice_1024x2048"] = c.cuda_ms(
            lambda: (nn.nn_one_direction(q, k), nn.nn_one_direction(k, q)))
        out["K3_1024x2048"] = c.cuda_ms(lambda: nn.nn_min_fused(q, k))
print(sys.argv[1], " ".join(f"{key} {v:.4f}" for key, v in out.items()))'

variant () {  # name, then "file:sed expression" for each edit (file under hyperpocket_tpu_torch/)
  name=$1; shift
  copy=$tmp/variant_$name
  rm -rf "$copy"; mkdir -p "$copy"
  tar --exclude=./_smoke_checkout --exclude=./hyperpocket_tpu_torch/_build \
      -cf - . | tar -xf - -C "$copy"
  stale=
  for edit in "$@"; do
    file=hyperpocket_tpu_torch/${edit%%:*}
    sed -i "${edit#*:}" "$copy/$file"
    if diff -q "$file" "$copy/$file" > /dev/null; then stale=1; fi
  done
  if [ -n "$stale" ]; then
    echo "$name: sed changed nothing: the variant is stale"
  else
    (cd "$copy" && python3 -c "$TIME_PY" "$name" 2>&1 | grep "^$name " || echo "$name: failed")
  fi
  rm -rf "$copy"
}

nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
variant base
variant one_split 'ops/nn.py:s/^    splits = max(1, min(.*$/    splits = 1/'
variant no_butterfly \
  'csrc/nn_fused.cuh:s/^\(\s*\)reduce_keys(part, pidx, lane);/\1if (lane < 0) reduce_keys(part, pidx, lane);/'
variant qpt4 'csrc/nn_fused.cuh:s/constexpr int kFusedQpt = 8;/constexpr int kFusedQpt = 4;/' \
  'ops/nn.py:s/^FUSED_QUERIES = 1024$/FUSED_QUERIES = 512/'
variant blocks3 \
  'csrc/nn_fused.cuh:s/constexpr int kFusedBlocksPerSm = 4; /constexpr int kFusedBlocksPerSm = 3; /' \
  'ops/nn.py:s/^FUSED_BLOCKS_PER_SM = 4$/FUSED_BLOCKS_PER_SM = 3/'
variant threads256 \
  'csrc/nn_fused.cuh:s/constexpr int kFusedThreads = 128; /constexpr int kFusedThreads = 256; /' \
  'csrc/nn_fused.cuh:s/constexpr int kFusedBlocksPerSm = 4; /constexpr int kFusedBlocksPerSm = 2; /' \
  'ops/nn.py:s/^FUSED_QUERIES = 1024$/FUSED_QUERIES = 2048/' \
  'ops/nn.py:s/^FUSED_BLOCKS_PER_SM = 4$/FUSED_BLOCKS_PER_SM = 2/'
variant base2
nvidia-smi --query-gpu=clocks.sm --format=csv,noheader
