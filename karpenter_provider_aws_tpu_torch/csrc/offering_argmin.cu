// Cheapest-offering finalization of the grouped-FFD pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `cheapest_offering_pallas` of
// karpenter_provider_aws_tpu/ops/offering_argmin.py (pl.pallas_call at :92).
// Its plain PyTorch version is `cheapest_offering_ref` in
// karpenter_provider_aws_tpu_torch/ops/offering_argmin.py, which also holds
// the wrapper that checks the tensors and launches this code.
//
// What it computes, per bin b:
//   best_v[b] = min over (t, zc) with tmask[b,t] != 0 and zcmask[b,zc] != 0
//               of price[t, zc]
//   best_i[b] = t * ZC + zc of that minimum; ties go to the lowest index,
//               and a bin with no finite allowed offering gets (+inf, 0),
// exactly what torch.argmin / jnp.argmin give over the flat masked row.
// Inputs: tmask [B,T] u8, zcmask [B,ZC] u8, price [T,ZC] f32 (+inf where an
// offering is unavailable). Outputs: best_v [B] f32, best_i [B] i32. Unlike
// the TPU kernel, nothing is padded: any B, any T, any ZC up to 4096.
//
// Bound. The kernel reads each input once and writes 8 bytes per bin: at the
// north-star shape (B=2048 bins, T=759 types, ZC=10 zone x capacity-type
// cells) that is about 1.6 MB, 0.5 us at 3.35 TB/s, and at most B*T*ZC = 15.5M
// float compares, 0.5 us at 33.5e12 float32 instructions/s (132 SMs x 128
// lanes x 1.98 GHz). The compares a run does are those of the types and
// cells its bins allow, far fewer than B*T*ZC, so it is bound by bytes, and
// at this size its time is launch latency.
//
// Design. One warp per bin, 8 bins per block. The TPU kernel built a
// [128,128,128] masked window in VMEM per step; here the price panel is
// staged in shared memory (T*ZC*4 bytes, 30 KB at the real catalog) and each
// lane walks its own types (t = lane, lane+32, ...), skipping types the bin
// cannot use, and keeps a running (value, index) with a strict `<` so that
// the lowest index wins within the lane. A warp-shuffle reduction ordered by
// (value, then index) gives the lowest index overall. A panel above 192 KB
// is streamed through shared memory in chunks of types; the running pair
// carries across chunks. Reading the tmask row is the bulk of the traffic;
// it is coalesced byte loads, one 32-byte segment per warp step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // bins per block
constexpr int kThreads = kWarps * 32;
constexpr int kPanelBytesMax = 192 * 1024;   // price chunk staged per pass
constexpr int kMaxZC = 4096;                 // keeps panel + masks <= 227 KB

__device__ __forceinline__ bool precedes(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
cheapest_offering_kernel(const uint8_t* __restrict__ tmask,
                         const uint8_t* __restrict__ zcmask,
                         const float* __restrict__ price,
                         float* __restrict__ best_v,
                         int32_t* __restrict__ best_i,
                         int B, int T, int ZC, int t_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* panel = reinterpret_cast<float*>(smem);                 // [t_chunk*ZC]
  uint8_t* zc_s = smem + (size_t)t_chunk * ZC * sizeof(float);   // [kWarps*ZC]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool live = b < B;

  // the zone x capacity-type masks of this block's bins, read once
  for (int k = threadIdx.x; k < kWarps * ZC; k += kThreads) {
    const int w = k / ZC;
    const int bb = blockIdx.x * kWarps + w;
    zc_s[k] = bb < B ? zcmask[(size_t)bb * ZC + (k - w * ZC)] : 0;
  }
  const uint8_t* my_zc = zc_s + warp * ZC;
  const uint8_t* my_t = tmask + (size_t)(live ? b : 0) * T;

  float v = INFINITY;
  int idx = 0;
  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int nt = min(t_chunk, T - t0);
    __syncthreads();   // the previous chunk is consumed by every warp
    const float* src = price + (size_t)t0 * ZC;
    for (int k = threadIdx.x; k < nt * ZC; k += kThreads) panel[k] = src[k];
    __syncthreads();
    if (live) {
      for (int t = lane; t < nt; t += 32) {
        if (!my_t[t0 + t]) continue;
        const float* row = panel + t * ZC;
        const int base = (t0 + t) * ZC;
        for (int zc = 0; zc < ZC; ++zc) {
          if (my_zc[zc]) {
            const float p = row[zc];
            if (p < v) {
              v = p;
              idx = base + zc;
            }
          }
        }
      }
    }
  }

  // every lane of the warp takes part, live bin or not
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (precedes(ov, oi, v, idx)) {
      v = ov;
      idx = oi;
    }
  }
  if (live && lane == 0) {
    best_v[b] = v;
    best_i[b] = idx;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// It does not synchronise and allocates nothing: the caller owns every buffer.
extern "C" int cheapest_offering_launch(const void* tmask, const void* zcmask,
                                        const void* price, void* best_v,
                                        void* best_i, int B, int T, int ZC,
                                        void* stream) {
  if (B <= 0 || T <= 0 || ZC <= 0 || ZC > kMaxZC ||
      (long long)T * ZC > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int t_chunk = kPanelBytesMax / (ZC * (int)sizeof(float));
  if (t_chunk > T) t_chunk = T;
  const size_t smem = (size_t)t_chunk * ZC * sizeof(float) + (size_t)kWarps * ZC;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cheapest_offering_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  cheapest_offering_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tmask), static_cast<const uint8_t*>(zcmask),
      static_cast<const float*>(price), static_cast<float*>(best_v),
      static_cast<int32_t*>(best_i), B, T, ZC, t_chunk);
  return (int)cudaGetLastError();
}
