// Throughput probe of the float64 tensor cores (report only, chip_smoke.py).
//
// Each warp runs 8 independent accumulator chains of one mma.sync shape on
// register operands, so the time is the tensor cores' throughput alone: the
// ceiling a float64 GEMM on that shape can reach on this card. It compares
// the two shapes csrc/matmul_wstream.cu could use: m8n8k4 (the sm_80 DMMA)
// and m16n8k16 (sm_90).
#include <cuda_runtime.h>

namespace {

template <int SHAPE>
__global__ void dmma_probe_kernel(double* out, int iters) {
  double c[8][4] = {};
  double a[8], b[4];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = threadIdx.x * 1e-3 + q;
#pragma unroll
  for (int q = 0; q < 4; ++q) b[q] = threadIdx.x * 1e-3 - q;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if constexpr (SHAPE == 884) {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(c[t][0]), "+d"(c[t][1])
                     : "d"(a[0]), "d"(b[0]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
            "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
            : "+d"(c[t][0]), "+d"(c[t][1]), "+d"(c[t][2]), "+d"(c[t][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]),
              "d"(b[1]), "d"(b[2]), "d"(b[3]));
      }
    }
  }
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 8; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// shape 884 (m8n8k4) or 16816 (m16n8k16); out: blocks·256 doubles. Each
// call runs blocks·8 warps × iters × 8 products of 2·m·n·k flop.
extern "C" int p2v_dmma_rate_probe(int shape, void* out, int blocks, int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shape == 884)
    dmma_probe_kernel<884><<<blocks, 256, 0, st>>>(static_cast<double*>(out), iters);
  else if (shape == 16816)
    dmma_probe_kernel<16816><<<blocks, 256, 0, st>>>(static_cast<double*>(out), iters);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
