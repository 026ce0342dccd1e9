#!/bin/bash
# Where K10's time goes, on a machine with the card: the bf16 kernel
# (csrc/decode_batch_tc.cu) and the fp32 kernel (csrc/decode_batch.cu).
#
#   bash tests/card_decode_variants.sh [bf16|fp32|all [NAME ...]]
#
# With an argument only that kernel's variants run; names after it pick
# variants by name.
# Each variant is a copy of the tree under $TMPDIR with the kernel (or
# ops/decoder.py's tile rule) edited by sed (the tree itself is never
# edited), built, and timed with chip_smoke.py's device timer (calls queued
# behind a sleep) at B=256 and B=64, N=2048, chair widths, in the kernel's
# dtype and the model route's (chain) rounding, with the kernel's ptxas
# registers. Variants marked "wrong" compute garbage; only the times mean
# anything, and only beside the base in the same call.
# bf16:
#   base       the kernel as it is
#   chunks1    one 16-channel chunk at a time (4 accumulator chains a warp)
#   no_mma     the mma.sync instructions left out (wrong): what the rest costs
#   no_staging the row's copy and the layers' reformatting left out (wrong)
#   blocks4    the tile rule aims at 4 blocks an SM (two waves): half the
#              tile, twice the weight staging
#   base2      the base again, for the spread within the call
# fp32:
#   f_base       the kernel as it is
#   f_unroll2    the register tile's channel loop unrolled 2 deep, not 4
#   f_unroll8    ... 8 deep
#   f_no_fma     the register tile's 32 FMAs a channel cut to 4 (wrong):
#                what the loads, barriers and staging cost
#   f_no_staging the row's copy and transposition left out (wrong)
#   f_points64   sub-tiles of half the points (16 a team, not 32)
#   f_teams2     two teams of 4 warps on sub-tiles of 64 points, not four
#                of 2 warps on 32 (the same tiles, barriers of 4 warps)
#   f_one_team   one team of 8 warps on sub-tiles of 128 points
#   f_teams8     eight teams of one warp on sub-tiles of 16 points: each
#                warp's barriers wait for itself only
#   f_teams8_split8  both that and f_split8
#   f_no_lds     the register tile's shared-memory loads replaced by
#                constants (wrong): what the FMAs and the rest cost
#   f_unroll1    the channel loop not unrolled
#   f_no_tile    the resident layers' register tiles skipped (wrong): the
#                staging, the points, the last layer, stores and barriers
#   f_split8     8 x 8 tiles also where they give only every second thread
#                one (64 channels at 32 points), the input channels split
#                between a warp's halves, not 4 x 8 tiles
#   f_tile4      register tiles of 4 points x 8 channels in every layer
#   f_threads512 blocks of 16 warps, not 8 (the channel loop unrolled 2 deep
#                to stay within 128 registers)
#   f_tile4_threads512  both
#   f_split_pts  an 8 x 8 tile's points are two runs of 4, half a sub-tile
#                apart, not one run of 8: a warp's float4 loads of the
#                activations fall on distinct banks
#   f_base2      the base again
cd "$(dirname "$0")/.."
tmp=${TMPDIR:-/tmp}
TIME_PY='import json, sys, torch, chip_smoke as c
from pathlib import Path
from hyperpocket_tpu_torch.ops import _build, decoder
from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
log = (Path(_build.library()._name).parent / _build.LOG_NAME).read_text()
fp32 = sys.argv[1].startswith("f_")
dtype = torch.float32 if fp32 else torch.bfloat16
kernel = "decode_batch_kernel" if fp32 else "decode_batch_tc_kernel"
regs = [e.get("registers") for e in _build.ptxas_report(log, kernel)]
ch = (32, 64, 128, 64)
g = torch.Generator(device="cuda").manual_seed(c.SEED)
out = {}
for b in (256, 64):
    flat = (torch.randn((b, target_weight_count(list(ch), True)), generator=g,
                        device="cuda") * 0.1).to(dtype)
    pts = (torch.randn((b, 2048, 3), generator=g, device="cuda") * 0.5).to(dtype)
    out[f"B{b}_ms"] = c.device_ms(lambda: decoder.decode_batch(flat, pts, ch, round_product=True),
                                  iters=50, windows=7)
print(sys.argv[1], "registers", regs, " ".join(f"{k} {v:.5f}" for k, v in out.items()))'

variant () {  # name, then "file:sed expression" for each edit (file under hyperpocket_tpu_torch/)
  name=$1; shift
  if [ -n "$names" ] && [[ " $names " != *" $name "* ]]; then return; fi
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
F=csrc/decode_batch.cu
which=${1:-all}
names="${*:2}"
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
if [ "$which" != fp32 ]; then
  variant base
  variant chunks1 "$K:s/constexpr int kChunks = 2;/constexpr int kChunks = 1;/"
  variant no_mma "$K:s/\"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 \"/\"\/\/ \"/"
  variant no_staging "$K:s/16 \* c < bytes/16 * c < 0/" \
    "$K:s/for (int li = 0; li < L.n_layers; ++li) {/for (int li = 0; li < 0; ++li) {/"
  variant blocks4 "ops/decoder.py:s/_BF16_BLOCKS_PER_SM = 2 /_BF16_BLOCKS_PER_SM = 4 /"
  variant base2
fi
if [ "$which" != bf16 ]; then
  variant f_base
  variant f_unroll2 "$F:s/^#pragma unroll 4$/#pragma unroll 2/"
  variant f_unroll8 "$F:s/^#pragma unroll 4$/#pragma unroll 8/"
  variant f_no_fma "$F:s/acc\[p\]\[j\] = fmaf(av\[p\], wv\[j\], acc\[p\]\[j\]);/if (j == 0) acc[p][0] = fmaf(av[p], wv[0] + wv[7], acc[p][0]);/"
  variant f_no_staging "$F:s/16 \* c < bytes; c += kThreads)/16 * c < 0; c += kThreads)/" \
    "$F:s/for (int e = threadIdx.x; e < in \* pad; e += kThreads) {/for (int e = threadIdx.x; e < 0; e += kThreads) {/"
  variant f_points64 "$F:s/constexpr int kMaxPoints = 128; /constexpr int kMaxPoints = 64; /"
  variant f_teams2 "$F:s/constexpr int kTeams = 4; /constexpr int kTeams = 2; /"
  variant f_one_team "$F:s/constexpr int kTeams = 4; /constexpr int kTeams = 1; /"
  variant f_teams8 "$F:s/constexpr int kTeams = 4; /constexpr int kTeams = 8; /"
  variant f_teams8_split8 "$F:s/constexpr int kTeams = 4; /constexpr int kTeams = 8; /" \
    "$F:s/  if ((s.points \/ 8) \* (pad \/ 8) >= s.size)/  if (2 * (s.points \/ 8) * (pad \/ 8) >= s.size)/"
  variant f_no_lds "$F:s/const float4 a = \*reinterpret_cast<const float4\*>(h + k \* hs + p);/const float4 a = make_float4(k, p, 1.f, 2.f);/" \
    "$F:s/const float4 wa = \*reinterpret_cast<const float4\*>(w + k \* ws);/const float4 wa = make_float4(k, 1.f, 2.f, 3.f);/" \
    "$F:s/const float4 wb = \*reinterpret_cast<const float4\*>(w + k \* ws + 4);/const float4 wb = make_float4(1.f, k, 2.f, 3.f);/"
  variant f_unroll1 "$F:s/^#pragma unroll 4$/#pragma unroll 1/"
  variant f_no_tile "$F:s/    if (mine) tile_fma(acc, hin + pt,/    if (mine \&\& k1 < 0) tile_fma(acc, hin + pt,/"
  variant f_split8 "$F:s/  if ((s.points \/ 8) \* (pad \/ 8) >= s.size)/  if (2 * (s.points \/ 8) * (pad \/ 8) >= s.size)/"
  variant f_tile4 "$F:s/  if ((s.points \/ 8) \* (pad \/ 8) >= s.size)/  if (false)/"
  variant f_threads512 "$F:s/constexpr int kThreads = 256;/constexpr int kThreads = 512;/" \
    "$F:s/^#pragma unroll 4$/#pragma unroll 2/"
  variant f_tile4_threads512 "$F:s/constexpr int kThreads = 256;/constexpr int kThreads = 512;/" \
    "$F:s/  if ((s.points \/ 8) \* (pad \/ 8) >= s.size)/  if (false)/"
  variant f_split_pts "$F:s/const float4 a = \*reinterpret_cast<const float4\*>(h + k \* hs + p);/const float4 a = *reinterpret_cast<const float4*>(h + k * hs + (p ? hs \/ 2 : 0));/" \
    "$F:s/const int pt = NP \* (u % cols), c0 = 8 \* (u \/ cols);/const int pt = 4 * (u % cols), c0 = 8 * (u \/ cols);/" \
    "$F:s/reinterpret_cast<float4\*>(s.hout + c \* s.points + pt + p) =/reinterpret_cast<float4*>(s.hout + c * s.points + pt + (p ? s.points \/ 2 : 0)) =/" \
    "$F:s/const int i = s.p0 + pt + p;/const int i = s.p0 + pt + p % 4 + (p \/ 4) * (s.points \/ 2);/"
  variant f_base2
fi
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
