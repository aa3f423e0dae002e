// Probe of the rate at which the card issues f32 min/max (FMNMX), the
// instruction that bounds the FAST stencil of K1, K3 and K4
// (fast_score.cuh: 119 of its ~135 instructions per scored pixel). Not a
// port of any TPU kernel; chip_smoke.py times it to set the stencil
// kernels' min/max floor beside the published-peak bound.
//
// Each thread runs kChains chains of fminf/fmaxf, each step combining one
// chain with the next one's value, so the compiler cannot fold a step away
// (it cannot know the values) and the steps of one sweep are independent
// enough to hide the instruction latency. The loop's own counter adds one
// add and one compare per kUnroll * kChains min/max. Thread 0 of each block
// records its SM, and clock64() (the SM's cycle counter) and %globaltimer
// (ns) around the loop, so that the caller has each SM's min/max per cycle
// over the span its blocks ran, and the SM clock over the run, without
// assuming how many blocks an SM holds at once.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 16;
constexpr int kUnroll = 4;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// record[block] = (SM, start cycle, end cycle, start ns, end ns)
__global__ void minmax_probe_kernel(const float* __restrict__ in,
                                    float* __restrict__ out,
                                    long long* __restrict__ record, int iters) {
  float v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = in[(threadIdx.x + k) & 63];
  __syncthreads();
  const long long c0 = clock64();
  const unsigned long long t0 = global_ns();
#pragma unroll kUnroll
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const float o = v[(k + 1) % kChains];
      v[k] = (k & 1) ? fminf(v[k], o) : fmaxf(v[k], o);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc += v[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* r = record + 5 * blockIdx.x;
    r[0] = sm_id();
    r[1] = c0;
    r[2] = clock64();
    r[3] = static_cast<long long>(t0);
    r[4] = static_cast<long long>(global_ns());
  }
}

}  // namespace

// in: 64 floats; out: blocks * threads floats; record: blocks * 5 int64.
// Each thread runs iters * kChains min/max.
extern "C" int minmax_probe(const void* in, void* out, void* record, int blocks,
                            int threads, int iters, void* stream) {
  if (blocks < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      iters < 1 || iters % kUnroll != 0)
    return cudaErrorInvalidValue;
  minmax_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<long long*>(record), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
