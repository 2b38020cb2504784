#!/bin/bash
# The measurements behind csrc/gemm_nt.cuh, on a machine with an NVIDIA
# Hopper GPU and the CUDA toolkit. Run from the root of a checkout:
#
#     bash tools/gemm_nt_probe.sh
#
# First, which f64 mma shapes nvcc takes for sm_90a (tools/dmma_probe.cu
# built for each; a shape that does not build is reported as refused) and,
# for each one taken, its fragment layout and rate; then every candidate
# tile of panel.cu's products at the streamed paths' shapes
# (tools/gemm_nt_tiles.cu, which includes csrc/panel.cu). nvcc is found as
# kernels/build.py finds it (torch's CUDA_HOME). Builds into
# build/gemm_nt_probe/; prints the card and one line (mostly JSON) per
# measurement.
set -u
cd "$(dirname "$0")/.."
out=build/gemm_nt_probe
mkdir -p "$out"
cuda_home=$(python3 -c 'from torch.utils.cpp_extension import CUDA_HOME; print(CUDA_HOME or "")')
[ -n "$cuda_home" ] || { echo "the CUDA toolkit (nvcc) was not found"; exit 1; }
nvcc=$cuda_home/bin/nvcc
flags=(-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3)
"$nvcc" --version | tail -1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"$nvcc" "${flags[@]}" -Xptxas -v -Isrc/repro_torch/kernels/csrc -o "$out/gemm_nt_tiles" \
  tools/gemm_nt_tiles.cu > "$out/gemm_nt_tiles.log" 2>&1 &
tiles=$!
for k in 4 8 16; do
  if "$nvcc" "${flags[@]}" -DPROBE_K=$k -o "$out/dmma_probe_$k" tools/dmma_probe.cu \
      > "$out/dmma_probe_$k.log" 2>&1; then
    echo "mma.m16n8k$k.f64: taken"
    "$out/dmma_probe_$k"
  else
    echo "mma.m16n8k$k.f64: refused: $(grep -m2 -i error "$out/dmma_probe_$k.log" | tr '\n' ' ')"
  fi
done
if wait $tiles; then
  grep -A4 "Compiling entry.*gemm_nt_kernel" "$out/gemm_nt_tiles.log" |
    grep -E "Compiling entry|registers|spill" | sed 's/^/ptxas: /'
  "$out/gemm_nt_tiles"
else
  echo "gemm_nt_tiles: build failed"; grep -m20 error "$out/gemm_nt_tiles.log"; exit 1
fi
