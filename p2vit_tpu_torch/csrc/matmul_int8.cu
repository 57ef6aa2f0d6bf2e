// int8 matmul with the fused PoT requant epilogue (ops/matmul_int8.py), over
// an int8 weight store or an int4-packed one.
//
// Replaces the Pallas kernels p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant
// and :int4_matmul_requant (the packed store, _packed_kernel).
// out[m, n] = clip(round(acc·r[n] + b[n]))                 (gelu = 0)
//           = clip(round(GELU(acc·r[n] + b[n])·out_inv))   (gelu = 1)
// acc = Σ_k x[m, k]·w[n, k], exact in int32.
//
// Both stores run one body, the Hopper kernel of gemm_wgmma.cuh (TMA ring,
// wgmma, persistent warp-specialized grid; its note there), one instance per
// width of the plan and store. The int4 store's boxes hold half the int8
// store's weight bytes for the same codes, unpacked in shared memory by the
// producer warpgroup's idle warps; the products and the epilogue are the
// int8 store's, so the two stores give the same codes bit for bit. The
// weight bytes bound the GEMM only at small M (a few hundred rows); above,
// the products, the L2 reads of the weights and, with GELU, the epilogue.
#include "gemm_wgmma.cuh"

namespace {

using RequantKernel = void (*)(CUtensorMap, CUtensorMap, const float*, const float*, const float*, int8_t*, int,
                               int, int, int, float, float, int);

// The built instances: every width of p2v::wg::kWidths and kGeluWidths, for
// each store.
struct Instance {
  int bn, nc;
  bool gelu, packed;
  RequantKernel kern;
  int launch_regs;    // the registers setmaxnreg's hand-over assumes at launch
  int consumer_regs;  // a consumer thread's registers after it
  bool ready;
};

template <int BN, int NC, bool GELU, bool PACKED>
Instance instance() {
  using R = p2v::wg::Regs<NC>;
  return {BN, NC, GELU, PACKED, p2v::wg::requant_kernel<BN, NC, GELU, PACKED>, R::kLaunch, R::kConsumer, false};
}

Instance g_instances[] = {
    instance<256, 2, false, false>(), instance<192, 2, false, false>(), instance<144, 2, false, false>(),
    instance<128, 2, false, false>(), instance<96, 2, false, false>(),  instance<64, 6, true, false>(),
    instance<256, 2, false, true>(),  instance<192, 2, false, true>(),  instance<144, 2, false, true>(),
    instance<128, 2, false, true>(),  instance<96, 2, false, true>(),   instance<64, 6, true, true>(),
};

Instance* find_instance(const p2v::wg::RequantPlan& plan, bool gelu, bool packed) {
  for (Instance& in : g_instances)
    if (in.bn == plan.bn && in.nc == plan.nc && in.gelu == gelu && in.packed == packed) return &in;
  return nullptr;
}

// The instance of the plan's width, its shared-memory limit raised and its
// register count checked on first use: the consumers' setmaxnreg.inc waits
// for registers the producer gives back, so a kernel built with fewer
// registers than the hand-over assumes must not launch.
const Instance* pick_kernel(const p2v::wg::RequantPlan& plan, bool gelu, bool packed, cudaError_t* err) {
  Instance* found = find_instance(plan, gelu, packed);
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

// One launch over either store: x (M, K) int8 through a map of 64-row
// boxes; w the int8 store (N, K) or the packed one (N, K/2), through a map
// of BN-row boxes.
int launch_requant(const void* x, const void* w, const void* r, const void* b, const void* scal, void* out, int M,
                   int N, int K, int qmin, int qmax, int gelu, bool packed, int grid, cudaStream_t stream) {
  const bool wide = abs(qmin) > p2v::wg::kMaxCode || abs(qmax) > p2v::wg::kMaxCode;
  if (wide && !packed) return static_cast<int>(cudaErrorInvalidValue);
  const p2v::wg::RequantPlan plan = p2v::wg::requant_plan(M, N, p2v::wg::sm_count(), gelu != 0, packed);
  cudaError_t err;
  const Instance* in = pick_kernel(plan, gelu != 0, packed, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tmx, tmw;
  const int box_k = packed ? p2v::wg::kPBK : p2v::wg::kBK;
  if (!p2v::wg::tensor_map(&tmx, x, M, K, p2v::wg::kBM, box_k) ||
      !p2v::wg::tensor_map(&tmw, w, N, packed ? K / 2 : K, plan.bn, box_k))
    return static_cast<int>(cudaErrorInvalidValue);
  in->kern<<<grid > 0 ? grid : plan.grid, p2v::wg::threads_of(plan.nc), plan.smem, stream>>>(
      tmx, tmw, static_cast<const float*>(r), static_cast<const float*>(b), static_cast<const float*>(scal),
      static_cast<int8_t*>(out), M, N, K, plan.stages, static_cast<float>(qmin), static_cast<float>(qmax), wide);
  return static_cast<int>(cudaGetLastError());
}

// The launch facts at (M, N) of either store: out[0..11] = BN, consumer
// warpgroups, stages, tiles in M, tiles in N, grid, dynamic shared memory,
// registers per thread at launch, spill bytes per thread, a consumer's
// registers after setmaxnreg, CTAs per SM, SMs.
int requant_info(int M, int N, int gelu, bool packed, void* out) {
  const int sms = p2v::wg::sm_count();
  const p2v::wg::RequantPlan plan = p2v::wg::requant_plan(M, N, sms, gelu != 0, packed);
  const Instance* in = find_instance(plan, gelu != 0, packed);
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

}  // namespace

// x (M, K) int8, w (N, K) int8, K % 16 == 0, both 16-byte aligned (TMA's
// stride rules; the wrapper checks them); |qmin|, |qmax| ≤ 2^22. grid: the
// persistent grid of the plan when 0, else that many CTAs (a measurement
// hook: grid = tiles runs one tile per CTA).
extern "C" int p2v_int8_matmul_requant_grid(const void* x, const void* w, const void* r, const void* b,
                                            const void* scal, void* out, int M, int N, int K, int qmin,
                                            int qmax, int gelu, int grid, void* stream) {
  if (M == 0 || N == 0) return 0;
  return launch_requant(x, w, r, b, scal, out, M, N, K, qmin, qmax, gelu, false, grid,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int p2v_int8_matmul_requant(const void* x, const void* w, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  return p2v_int8_matmul_requant_grid(x, w, r, b, scal, out, M, N, K, qmin, qmax, gelu, 0, stream);
}

// The launch facts of the int8 kernel at (M, N, K) (requant_info above).
extern "C" int p2v_int8_matmul_requant_info(int M, int N, int K, int gelu, void* out) {
  return requant_info(M, N, gelu, false, out);
}

// x (M, K) int8 codes, K = 2·kh with kh % 16 == 0; wp (N, kh) the pack_int4
// store; both 16-byte aligned. Any qmin, qmax. grid as the int8 entry's.
extern "C" int p2v_int4_matmul_requant_grid(const void* x, const void* wp, const void* r, const void* b,
                                            const void* scal, void* out, int M, int N, int K, int qmin,
                                            int qmax, int gelu, int grid, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_requant(x, wp, r, b, scal, out, M, N, K, qmin, qmax, gelu, true, grid,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int p2v_int4_matmul_requant(const void* x, const void* wp, const void* r, const void* b,
                                       const void* scal, void* out, int M, int N, int K, int qmin,
                                       int qmax, int gelu, void* stream) {
  return p2v_int4_matmul_requant_grid(x, wp, r, b, scal, out, M, N, K, qmin, qmax, gelu, 0, stream);
}

// The launch facts of the int4-store kernel at (M, N, K) (requant_info above).
extern "C" int p2v_int4_matmul_requant_info(int M, int N, int K, int gelu, void* out) {
  return requant_info(M, N, gelu, true, out);
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

extern "C" const char* p2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
