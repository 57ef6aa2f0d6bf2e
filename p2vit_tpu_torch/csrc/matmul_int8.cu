// int8 matmul with the fused PoT requant epilogue (ops/matmul_int8.py), over
// an int8 weight store or an int4-packed one.
//
// Replaces the Pallas kernels p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant
// and :int4_matmul_requant (the packed store, _packed_kernel).
// out[m, n] = clip(round(acc·r[n] + b[n]))                 (gelu = 0)
//           = clip(round(GELU(acc·r[n] + b[n])·out_inv))   (gelu = 1)
// acc = Σ_k x[m, k]·w[n, k], exact in int32.
//
// The int8 store runs the Hopper kernel of gemm_wgmma.cuh (TMA ring, wgmma,
// persistent warp-specialized grid; its note there). The int4 store keeps the
// mma.sync tile of matmul_tiles.cuh: one 128x128 output tile per block, edges
// masked in the loads and the stores. The int4 store halves the weight bytes,
// which bound the GEMM only at small M (a few hundred rows); its B chunks are
// unpacked with plain 16-byte loads (shift, mask, sign-extend four bytes at a
// time) into the same int8 stage, so the tensor-core loop and the epilogue
// are the fused layer's.
#include "gemm_wgmma.cuh"

namespace {

// The int4-store kernel: the same tile, its B rows unpacked from the packed
// store (p2v::PackedInt4Rows) into the int8 stage; K = 2·khalf.
__global__ void __launch_bounds__(p2v::kThreads)
    int4_matmul_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                               const float* __restrict__ r, const float* __restrict__ b,
                               const float* __restrict__ scal, int8_t* __restrict__ out, int M,
                               int N, int K, int qmin, int qmax, int gelu) {
  __shared__ __align__(16) int8_t smem[p2v::RequantGemm::SMEM_BYTES];
  const int n0 = blockIdx.x * 128;
  p2v::requant_tile(x, p2v::PackedInt4Rows{wp, n0, N, K / 2}, r, b, scal[0], out, M, N, K,
                    static_cast<float>(qmin), static_cast<float>(qmax), gelu != 0, blockIdx.y * 128, n0,
                    smem);
}

using RequantKernel = void (*)(CUtensorMap, CUtensorMap, const float*, const float*, const float*, int8_t*, int,
                               int, int, int, float, float);

// The built instances: every width of p2v::wg::kWidths and kGeluWidths.
struct Instance {
  int bn, nc;
  bool gelu;
  RequantKernel kern;
  int launch_regs;    // the registers setmaxnreg's hand-over assumes at launch
  int consumer_regs;  // a consumer thread's registers after it
  bool ready;
};

template <int BN, int NC, bool GELU>
Instance instance() {
  using R = p2v::wg::Regs<NC>;
  return {BN, NC, GELU, p2v::wg::requant_kernel<BN, NC, GELU>, R::kLaunch, R::kConsumer, false};
}

Instance g_instances[] = {
    instance<256, 2, false>(), instance<192, 2, false>(), instance<144, 2, false>(),
    instance<128, 2, false>(), instance<96, 2, false>(),  instance<64, 6, true>(),
};

Instance* find_instance(const p2v::wg::RequantPlan& plan, bool gelu) {
  for (Instance& in : g_instances)
    if (in.bn == plan.bn && in.nc == plan.nc && in.gelu == gelu) return &in;
  return nullptr;
}

// The instance of the plan's width, its shared-memory limit raised and its
// register count checked on first use: the consumers' setmaxnreg.inc waits
// for registers the producer gives back, so a kernel built with fewer
// registers than the hand-over assumes must not launch.
const Instance* pick_kernel(const p2v::wg::RequantPlan& plan, bool gelu, cudaError_t* err) {
  Instance* found = find_instance(plan, gelu);
  if (found != nullptr) {
    Instance& in = *found;
    *err = cudaSuccess;
    if (!in.ready) {
      cudaFuncAttributes attr{};
      *err = p2v::set_smem(in.kern, p2v::wg::kMaxSmem);
      if (*err == cudaSuccess) *err = cudaFuncGetAttributes(&attr, in.kern);
      if (*err == cudaSuccess && attr.numRegs != in.launch_regs) *err = cudaErrorInvalidConfiguration;
      in.ready = *err == cudaSuccess;
    }
    return &in;
  }
  *err = cudaErrorInvalidValue;
  return nullptr;
}

}  // namespace

// x (M, K) int8, w (N, K) int8, K % 16 == 0, both 16-byte aligned (TMA's
// stride rules; the wrapper checks them). grid: the persistent grid of the
// plan when 0, else that many CTAs (a measurement hook: grid = tiles runs
// one tile per CTA).
extern "C" int p2v_int8_matmul_requant_grid(const void* x, const void* w, const void* r, const void* b,
                                            const void* scal, void* out, int M, int N, int K, int qmin,
                                            int qmax, int gelu, int grid, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (abs(qmin) > p2v::wg::kMaxCode || abs(qmax) > p2v::wg::kMaxCode) return static_cast<int>(cudaErrorInvalidValue);
  const p2v::wg::RequantPlan plan = p2v::wg::requant_plan(M, N, p2v::wg::sm_count(), gelu != 0);
  cudaError_t err;
  const Instance* in = pick_kernel(plan, gelu != 0, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tmx, tmw;
  if (!p2v::wg::tensor_map(&tmx, x, M, K, p2v::wg::kBM) || !p2v::wg::tensor_map(&tmw, w, N, K, plan.bn))
    return static_cast<int>(cudaErrorInvalidValue);
  in->kern<<<grid > 0 ? grid : plan.grid, p2v::wg::threads_of(plan.nc), plan.smem,
             static_cast<cudaStream_t>(stream)>>>(
      tmx, tmw, static_cast<const float*>(r), static_cast<const float*>(b), static_cast<const float*>(scal),
      static_cast<int8_t*>(out), M, N, K, plan.stages, static_cast<float>(qmin), static_cast<float>(qmax));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2v_int8_matmul_requant(const void* x, const void* w, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  return p2v_int8_matmul_requant_grid(x, w, r, b, scal, out, M, N, K, qmin, qmax, gelu, 0, stream);
}

// The launch facts of the int8 kernel at (M, N, K): out[0..11] = BN,
// consumer warpgroups, stages, tiles in M, tiles in N, grid, dynamic shared
// memory, registers per thread at launch, spill bytes per thread, a
// consumer's registers after setmaxnreg, CTAs per SM, SMs.
extern "C" int p2v_int8_matmul_requant_info(int M, int N, int K, int gelu, void* out) {
  const int sms = p2v::wg::sm_count();
  const p2v::wg::RequantPlan plan = p2v::wg::requant_plan(M, N, sms, gelu != 0);
  const Instance* in = find_instance(plan, gelu != 0);
  if (in == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  int per_sm = 0;
  cudaError_t err = p2v::set_smem(in->kern, p2v::wg::kMaxSmem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, in->kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in->kern, p2v::wg::threads_of(plan.nc), plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[12] = {plan.bn,   plan.nc,   plan.stages,  plan.tiles_m, plan.tiles_n,
                        plan.grid, plan.smem, attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        in->consumer_regs, per_sm, sms};
  for (int i = 0; i < 12; ++i) static_cast<int*>(out)[i] = vals[i];
  return 0;
}

namespace {

// Over every float32 bit pattern: codes where rint_clip (or rint_clipf)
// differs from requant's rintf-then-clip.
__global__ void rint_clip_check_kernel(float lo, float hi, unsigned long long* bad) {
  unsigned long long n = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x; u < (1ull << 32); u += stride) {
    const float y = __uint_as_float(static_cast<unsigned>(u));
    const float want = p2v::requant(y, lo, hi);
    n += p2v::rint_clip(y, lo, hi) != static_cast<int>(want) || p2v::rint_clipf(y, lo, hi) != want;
  }
  n = p2v::warp_sum(n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

}  // namespace

// The exhaustive card check of the kernel's rewritten rounding: *bad (a
// zeroed uint64 on the card) += the floats whose codes differ at [qmin, qmax].
extern "C" int p2v_requant_rint_check(int qmin, int qmax, void* bad, void* stream) {
  rint_clip_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float>(qmin), static_cast<float>(qmax), static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) int8 codes, K = 2·khalf with khalf % 16 == 0; wp (N, khalf) the
// pack_int4 store.
extern "C" int p2v_int4_matmul_requant(const void* x, const void* wp, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + 127) / 128, (M + 127) / 128);
  int4_matmul_requant_kernel<<<grid, p2v::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp), static_cast<const float*>(r),
      static_cast<const float*>(b), static_cast<const float*>(scal), static_cast<int8_t*>(out), M,
      N, K, qmin, qmax, gelu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* p2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
