#!/bin/bash
# The measurements behind panel_factor's block and schedule
# (csrc/panel.cu, csrc/tri_blocked.cuh), on a machine with an NVIDIA Hopper
# GPU and the CUDA toolkit. Run from the root of a checkout:
#
#     bash tools/panel_factor_probe.sh
#
# Builds tools/panel_factor_probe.cu (which includes csrc/panel.cu) into
# build/panel_factor_probe/, prints the card, each factor kernel's
# registers and spills, and one JSON line per case and per stamped kernel
# (see the .cu's header).
# nvcc is found as kernels/build.py finds it (torch's CUDA_HOME).
set -u
cd "$(dirname "$0")/.."
out=build/panel_factor_probe
mkdir -p "$out"
cuda_home=$(python3 -c 'from torch.utils.cpp_extension import CUDA_HOME; print(CUDA_HOME or "")')
[ -n "$cuda_home" ] || { echo "the CUDA toolkit (nvcc) was not found"; exit 1; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
if "$cuda_home/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
    -Isrc/repro_torch/kernels/csrc -o "$out/panel_factor_probe" tools/panel_factor_probe.cu \
    > "$out/build.log" 2>&1; then
  grep -A4 "Compiling entry.*factor_kernel\|Compiling entry.*no_ahead_kernel\|Compiling entry.*tri_inv_kernel" "$out/build.log" |
    grep -E "Compiling entry|registers|spill" | sed 's/^/ptxas: /'
  "$out/panel_factor_probe"
else
  echo "panel_factor_probe: build failed"; grep -m20 -i error "$out/build.log"; exit 1
fi
