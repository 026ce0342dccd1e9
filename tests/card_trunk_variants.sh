#!/bin/bash
# Where the trunk kernels' time goes, on a machine with the card.
#
#   bash tests/card_trunk_variants.sh
#
# Each variant is a copy of the tree under $TMPDIR with csrc/trunk_pool.cu
# edited by sed (the tree itself is never edited), built, and timed: K4 and
# K8 at B=256 and B=64, N=1024, on the served chair encoder's weights, with
# chip_smoke.py's CUDA-event timer. Outputs of the edited kernels are wrong;
# only their times mean anything, and only beside the base in the same call.
#   base       the kernel as it is
#   no_mma     no wgmma: the weight pipeline, epilogues and merges alone
#   no_loads   TMA loads only for the first tile's layer-2 chunk; the other
#              chunks are arrivals without bytes: no weight traffic from L2
#   stages2    a ring of two 16 KB stages instead of six
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
TIME_PY='import sys, torch, chip_smoke as c
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_argmax
d = torch.device("cuda", 0)
_, model = c.build_model("bfloat16")
layers = [(l.weight, l.bias) for l in model.serving_params().to(d).real_encoder.conv]
g = torch.Generator(device=d).manual_seed(c.SEED)
for b in (c.BENCH_BATCH, c.SERVE_BATCH):
    x = (torch.randn((b, c.N_EXISTING, 3), generator=g, device=d) * 0.3).to(torch.bfloat16)
    print(sys.argv[1], f"B={b}", "K4_ms", c.cuda_ms(lambda: trunk_pooled(layers, x)),
          "K8_ms", c.cuda_ms(lambda: trunk_pooled_argmax(layers, x)))'

variant () {  # name, sed expressions...
  name=$1; shift
  copy=$tmp/variant_$name
  rm -rf "$copy"; mkdir -p "$copy"
  tar --exclude=./_smoke_checkout --exclude=./hyperpocket_tpu_torch/_build \
      -cf - . | tar -xf - -C "$copy"
  for expr in "$@"; do sed -i "$expr" "$copy/hyperpocket_tpu_torch/csrc/trunk_pool.cu"; done
  if [ $# -gt 0 ] && diff -q hyperpocket_tpu_torch/csrc/trunk_pool.cu \
      "$copy/hyperpocket_tpu_torch/csrc/trunk_pool.cu" > /dev/null; then
    echo "$name: sed changed nothing: the variant is stale"
  else
    (cd "$copy" && python3 -c "$TIME_PY" "$name" 2>&1 | grep "^$name " || echo "$name: failed")
  fi
  rm -rf "$copy"
}

nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
variant base
variant no_mma 's/^\(\s*\)wgmma_m64n128k16\(_rs\)\?(acc,/\1if (wg_tid < 0) wgmma_m64n128k16\2(acc,/'
variant no_loads \
  's/mbar_expect_tx(full + 8 \* stage, kChunkBytes);/mbar_expect_tx(full + 8 * stage, (pair == blockIdx.x \/ kClusterSize \&\& l == 0) ? kChunkBytes : 0u);/' \
  's/^\(\s*\)tma_load_multicast(base/\1if (pair == blockIdx.x \/ kClusterSize \&\& l == 0) tma_load_multicast(base/'
variant stages2 's/constexpr int kStages = 6;/constexpr int kStages = 2;/'
nvidia-smi --query-gpu=clocks.sm --format=csv,noheader
