// One f64 mma shape of sm_90 (m16n8k4, m16n8k8 or m16n8k16, chosen by
// -DPROBE_K=4, 8 or 16): its fragment layout as csrc/gemm_nt.cuh assumes
// it (a[q] = A[g + 8·(q % 2)][t + 4·(q / 2)], b[q] = B[t + 4·q][g],
// d[q] = D[g + 8·(q / 2)][2t + q % 2]) checked against a product on the
// host, and its rate with eight independent accumulators a warp, at one to
// eight warps on each scheduler of every SM. Built and run by
// tools/gemm_nt_probe.sh, which reports a shape that does not build as
// refused; prints one JSON line.
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdlib>
#include <cmath>

#if PROBE_K == 4
#define FRAG_A 2
#define ASM "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
#define ARGS_A(a) "d"(a[0]), "d"(a[1])
#define ARGS_B(b) "d"(b[0])
#elif PROBE_K == 8
#define FRAG_A 4
#define ASM "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
#define ARGS_A(a) "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3])
#define ARGS_B(b) "d"(b[0]), "d"(b[1])
#else
#define FRAG_A 8
#define ASM "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
#define ARGS_A(a) "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7])
#define ARGS_B(b) "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3])
#endif
constexpr int K = PROBE_K;

__device__ __forceinline__ void mma(double (&d)[4], const double* a, const double* b) {
  asm volatile(ASM : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : ARGS_A(a), ARGS_B(b));
}

__global__ void layout(const double* A, const double* B, double* D) {  // A 16×K row, B K×8 (B[k][n])
  int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[FRAG_A], b[K / 4], d[4] = {0, 0, 0, 0};
  for (int q = 0; q < K / 2; ++q) a[q] = A[(g + 8 * (q % 2)) * K + t + 4 * (q / 2)];
  for (int q = 0; q < K / 4; ++q) b[q] = B[(t + 4 * q) * 8 + g];
  mma(d, a, b);
  for (int q = 0; q < 4; ++q) D[(g + 8 * (q / 2)) * 8 + 2 * t + q % 2] = d[q];
}

__global__ void rate(double* out, int iters) {
  double a[FRAG_A], b[K / 4], d[8][4];
  for (int q = 0; q < FRAG_A; ++q) a[q] = 1e-3 * (threadIdx.x + q);
  for (int q = 0; q < K / 4; ++q) b[q] = 1e-3 * q;
  for (int i = 0; i < 8; ++i) for (int q = 0; q < 4; ++q) d[i][q] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) mma(d[i], a, b);
  double s = 0;
  for (int i = 0; i < 8; ++i) for (int q = 0; q < 4; ++q) s += d[i][q];
  if (s == 12345.0) out[0] = s;
}

int main() {
  double hA[16 * K], hB[K * 8], hD[128], *A, *B, *D;
  srand(1);
  for (auto& x : hA) x = rand() / (double)RAND_MAX - 0.5;
  for (auto& x : hB) x = rand() / (double)RAND_MAX - 0.5;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&D, sizeof hD);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout<<<1, 32>>>(A, B, D);
  cudaMemcpy(hD, D, sizeof hD, cudaMemcpyDeviceToHost);
  double err = 0;
  for (int i = 0; i < 16; ++i) for (int j = 0; j < 8; ++j) {
    double s = 0; for (int k = 0; k < K; ++k) s += hA[i * K + k] * hB[k * 8 + j];
    err = fmax(err, fabs(s - hD[i * 8 + j]));
  }
  // the rate at 1, 2, 4 and 8 warps on each of an SM's four schedulers
  // (blocks of four warps, one to eight an SM): with one, each warp's eight
  // chains of mma are all a scheduler has to hide the mma's latency
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096, threads = 128;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  printf("{\"probe\": \"m16n8k%d\", \"layout_max_err\": %.3e, \"tflops_by_warps_per_scheduler\": {",
         K, err);
  for (int per = 1; per <= 8; per *= 2) {
    const int blocks = sms * per;
    rate<<<blocks, threads>>>(D, 16);
    cudaEventRecord(e0);
    rate<<<blocks, threads>>>(D, iters);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double flops = 2.0 * 16 * 8 * K * 8.0 * iters * blocks * (threads / 32);
    printf("%s\"%d\": %.2f", per > 1 ? ", " : "", per, flops / ms / 1e9);
  }
  printf("}, \"err\": \"%s\"}\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
