#!/bin/bash
# Where the bf16 decode kernel's time goes (K10, csrc/decode_batch_tc.cu), on
# a machine with the card.
#
#   bash tests/card_decode_variants.sh
#
# Each variant is a copy of the tree under $TMPDIR with the kernel (or
# ops/decoder.py's tile rule) edited by sed (the tree itself is never
# edited), built, and timed with chip_smoke.py's device timer (calls queued
# behind a sleep) at B=256 and B=64, N=2048, chair widths, bf16, with the
# kernel's ptxas registers. Variants marked "wrong" compute garbage; only
# the times mean anything, and only beside the base in the same call.
#   base       the kernel as it is
#   chunks1    one 16-channel chunk at a time (4 accumulator chains a warp)
#   no_mma     the mma.sync instructions left out (wrong): what the rest costs
#   no_staging the row's copy and the layers' reformatting left out (wrong)
#   blocks4    the tile rule aims at 4 blocks an SM (two waves): half the
#              tile, twice the weight staging
#   base2      the base again, for the spread within the call
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
TIME_PY='import json, sys, torch, chip_smoke as c
from pathlib import Path
from hyperpocket_tpu_torch.ops import _build, decoder
from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
log = (Path(_build.library()._name).parent / _build.LOG_NAME).read_text()
regs = [e.get("registers") for e in _build.ptxas_report(log, "decode_batch_tc_kernel")]
ch = (32, 64, 128, 64)
g = torch.Generator(device="cuda").manual_seed(c.SEED)
out = {}
for b in (256, 64):
    flat = (torch.randn((b, target_weight_count(list(ch), True)), generator=g,
                        device="cuda") * 0.1).bfloat16()
    pts = (torch.randn((b, 2048, 3), generator=g, device="cuda") * 0.5).bfloat16()
    out[f"B{b}_ms"] = c.device_ms(lambda: decoder.decode_batch(flat, pts, ch), iters=50, windows=7)
print(sys.argv[1], "registers", regs, " ".join(f"{k} {v:.5f}" for k, v in out.items()))'

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

K=csrc/decode_batch_tc.cu
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
variant base
variant chunks1 "$K:s/constexpr int kChunks = 2;/constexpr int kChunks = 1;/"
variant no_mma "$K:s/\"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 \"/\"\/\/ \"/"
variant no_staging "$K:s/16 \* c < bytes/16 * c < 0/" \
  "$K:s/for (int li = 0; li < L.n_layers; ++li) {/for (int li = 0; li < 0; ++li) {/"
variant blocks4 "ops/decoder.py:s/_BF16_BLOCKS_PER_SM = 2 /_BF16_BLOCKS_PER_SM = 4 /"
variant base2
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
