#!/bin/bash
# Serving and artifact throughput of two trees of this repository in one
# call, on a machine with the card, in turns (A B B A), so that the host's
# and the card's drift falls on both alike.
#
#   bash tests/card_serving_ab.sh DIR_A DIR_B [ROUNDS]
#
# ROUNDS (default 1) repeats the A B B A turns, for the spread of host-bound
# cells.
# Each run is a fresh process in its tree (which builds its own kernels):
# the chair model of chip_smoke.py (seed 1856, every bias drawn anew),
# make_serving_fn and the exported artifact in bf16 and fp32 at B=256 and
# B=64, clouds/s from chip_smoke.py's clouds_per_s (5 windows of 10 calls,
# each ending in a synchronize). One JSON line a run.
a=$(cd "$1" && pwd); b=$(cd "$2" && pwd); rounds=${3:-1}
PY='import copy, json, sys, torch, chip_smoke as c
from hyperpocket_tpu_torch import serving
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d = torch.device("cuda", 0)
_, model = c.build_model("bfloat16")
model32 = copy.deepcopy(model)
model32.compute_dtype = "float32"
gen = torch.Generator(device=d).manual_seed(3)
out = {"tree": sys.argv[1]}
for batch in (c.BENCH_BATCH, c.SERVE_BATCH):
    existing = torch.randn((batch, c.N_EXISTING, 3), generator=gen, device=d) * 0.3
    noise = torch.randn((batch, model.get_noise_size()), generator=gen, device=d) * 0.1
    for name, m in (("bf16", model), ("fp32", model32)):
        f = serving.make_serving_fn(m, num_output_points=c.N_OUT, device=d)
        out[f"serving_{name}_B{batch}"] = c.clouds_per_s(
            lambda s: f(existing, noise, s), batch)["clouds_per_s"]
        art = serving.load_completion(serving.export_completion(
            m, batch=batch, n_existing=c.N_EXISTING, num_output_points=c.N_OUT, device=d))
        out[f"artifact_{name}_B{batch}"] = c.clouds_per_s(
            lambda s: art(existing, noise, s), batch)["clouds_per_s"]
print(json.dumps(out))'
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
for _ in $(seq "$rounds"); do
  for tree in "$a" "$b" "$b" "$a"; do
    (cd "$tree" && python3 -c "$PY" "$tree" 2> /dev/null | tail -n 1)
  done
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
