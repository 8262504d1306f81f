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
// the TPU kernel, nothing is padded: any B, any T, any ZC up to 4096, and
// T * ZC below 2**31.
//
// Bound. Each input read once and 8 bytes written per bin: at the
// north-star shape (B=2048 bins, T=759 types, ZC=10 zone x capacity-type
// cells) about 1.6 MB, 0.5 us at 3.35 TB/s. The compares are the allowed
// (type, cell) pairs, about 30k there (1 ns at the card's float32 rate),
// so bytes bound it on paper, and in practice the launch: on an H100 the
// smallest kernel takes about 5 us from one launch to the next, ten times
// the byte bound. What a design can still win is the chain of dependent
// steps inside one bin: the mask loads, the compaction, one round of price
// loads, the warp reduction. PERF.md has the times of each step.
//
// Design. One warp per bin, kWarps bins per block, no block-wide barrier
// and no copy of the price panel.
//  1. Cells: for ZC <= 32 (ZC=10 on the real catalog) one ballot turns the
//     bin's zc mask into a register bitmask, and each allowed cell's lane
//     writes its cell into a 32-byte table of this warp (the c-th allowed
//     cell at entry c); above 32 the mask goes to this warp's words in
//     shared memory (at most 128 words, ZC <= 4096). A bin with no allowed
//     cell writes (+inf, 0) and does no price work.
//  2. Types: every mask load of the row starts first. Each lane loads
//     kLoads x 16 bytes of the type row (an aligned body; see the traps)
//     and turns each 16 bytes into a 16-bit mask of allowed types with a
//     per-byte compare (__vcmpne4) and one multiply. A warp prefix sum of
//     the lanes' popcounts (__shfl_up_sync) compacts the set bits into
//     this warp's list of allowed types in shared memory (16-bit offsets
//     from the round's first type). A round is 32 x kLoads
//     loads, 1,024 types: one round for the real catalog. Longer rows take
//     more rounds, each starting the next round's loads before its own price
//     work. A bin with an empty row does no price work.
//  3. Pairs: the warp shares the (allowed type x allowed cell) pairs among
//     its lanes: lane l takes cell (l mod ncell) of type slot (l div ncell),
//     32 div ncell types at once. The divisions go by a float reciprocal
//     (every quotient of these operands lies at least 1/64 from the next
//     integer, so the truncation is exact) and the cell by a table of the
//     warp's allowed cells: both cut the main path's time by more than the
//     spread of the call that timed them (PERF.md). Prices are read only at those pairs, through the
//     read-only path (__ldg); the panel (30 KB on the real catalog) stays in
//     L2 and in L1. Above 32 cells the warp walks the list one type at a
//     time, its lanes over that type's cells.
//  4. Ties: a lane does not see indices in one increasing order, so its
//     running (value, index) is updated with precedes() (value, then
//     index). It starts at (+inf, 0), so a bin whose allowed offerings are
//     all +inf returns index 0. A shuffle reduction with the same
//     precedes() gives the warp's least (value, index); -0 and +0 compare
//     equal there, so a tie between them goes to the lower index.
//
// Traps.
//  - Unaligned rows: row b starts at byte b*T, and T=759 is odd, so no row
//    after the first is 16-byte aligned (nor is a contiguous view's first
//    row). The bytes before the row's first 16-byte boundary (head, < 16)
//    and after its last (tail, < 16) are read one byte per lane (lanes 0-15
//    the head, 16-31 the tail); only the aligned body is read with 16-byte
//    loads. The head goes into the first round's list, the tail into the
//    last round's. The wrapper does not pad tmask.
//  - Out-of-range bits: no load reaches past the row: body loads cover
//    whole 16-byte chunks inside it, and an edge lane reads only if its byte
//    is inside the head or the tail. Cell bits at or past ZC are never set.
//  - Edge shapes: B not a multiple of kWarps (warps past B return at once;
//    there is no block barrier they could miss), T < 16 (no body, only a
//    head and a tail), ZC of 32 (the last register-mask width) and 33 and
//    above (the shared-memory words).
//  - Launch errors: the launcher returns cudaGetLastError(); the wrapper
//    raises on anything but 0 and counts each launch. There is no fallback.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // bins per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kLoads = 2;                    // 16-byte loads per lane per round
constexpr int kRoundTypes = 32 * 16 * kLoads;  // body types of one round
constexpr int kListCap = kRoundTypes + 32;   // and the head and the tail
constexpr int kMaxZC = 4096;
constexpr int kZcWords = kMaxZC / 32;        // wide cell mask, per warp
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool precedes(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// four mask bytes -> four bits, bit k set when byte k is not zero
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned bits16(uint4 q) {
  return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 | nibble(q.w) << 12;
}

__global__ void __launch_bounds__(kThreads)
cheapest_offering_kernel(const uint8_t* __restrict__ tmask,
                         const uint8_t* __restrict__ zcmask,
                         const float* __restrict__ price,
                         float* __restrict__ best_v,
                         int32_t* __restrict__ best_i,
                         int B, int T, int ZC) {
  // allowed types of one round, as offsets from the round's first type
  __shared__ uint16_t s_types[kWarps][kListCap];
  __shared__ unsigned s_zc[kWarps][kZcWords];
  __shared__ uint8_t s_cell[kWarps][32];     // narrow: the c-th allowed cell

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one

  // the row's layout: head bytes, n16 aligned 16-byte chunks, tail bytes
  const uint8_t* row = tmask + (size_t)b * T;
  const int head = min((int)((16u - ((uintptr_t)row & 15u)) & 15u), T);
  const int n16 = (T - head) >> 4;
  const int tail0 = head + (n16 << 4);
  const int tail = T - tail0;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int rounds = max((n16 + 32 * kLoads - 1) / (32 * kLoads), 1);

  // start the first loads of both masks before using any of them
  const int edge = lane < 16 ? lane : tail0 + lane - 16;
  const bool in_edge = lane < 16 ? lane < head : lane - 16 < tail;
  const uint8_t e_byte = in_edge ? __ldg(row + edge) : 0;
  uint4 cur[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int c = k * 32 + lane;
    cur[k] = c < n16 ? __ldg(body + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  const bool narrow = ZC <= 32;
  const uint8_t* zrow = zcmask + (size_t)b * ZC;
  unsigned zbits = __ballot_sync(kAll, lane < ZC && __ldg(zrow + lane));
  if (!narrow) {
    unsigned any = zbits;
    if (lane == 0) s_zc[warp][0] = zbits;
    for (int w = 1; w * 32 < ZC; ++w) {
      const int zc = w * 32 + lane;
      const unsigned m = __ballot_sync(kAll, zc < ZC && __ldg(zrow + zc));
      if (lane == 0) s_zc[warp][w] = m;
      any |= m;
    }
    __syncwarp();
    zbits = any;               // only its emptiness is read below
  }
  const unsigned ebits = __ballot_sync(kAll, e_byte != 0);

  float v = INFINITY;
  int idx = 0;
  if (zbits != 0) {
    // narrow path: which type slot and which cell this lane serves.
    // per = 32 div ncell and slot = lane div ncell, exact in float: the
    // quotients are at least 1/64 from the next integer
    const int ncell = narrow ? __popc(zbits) : 1;
    const float rcp = __frcp_rn((float)ncell);
    const int per = (int)(32.5f * rcp);
    const int slot = (int)((lane + 0.5f) * rcp);
    if (narrow && ((zbits >> lane) & 1u)) s_cell[warp][__popc(zbits & below)] = lane;

    uint16_t* list = s_types[warp];
    for (int r = 0; r < rounds; ++r) {
      const int c0 = r * 32 * kLoads;        // first chunk of this round
      const int base = head + c0 * 16;       // first body type of this round
      uint4 nxt[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int c = c0 + 32 * kLoads + k * 32 + lane;
        nxt[k] = c < n16 ? __ldg(body + c) : make_uint4(0u, 0u, 0u, 0u);
      }

      // the head goes into round 0's list, the tail into the last round's,
      // both first; offsets are from `base` (the head's are below zero)
      const unsigned eb = (r == 0 ? ebits & 0xffffu : 0u) |
                          (r == rounds - 1 ? ebits & 0xffff0000u : 0u);
      if ((eb >> lane) & 1u) list[__popc(eb & below)] = (uint16_t)(edge - base);
      unsigned m16[kLoads];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        m16[k] = bits16(cur[k]);
        cnt += __popc(m16[k]);
      }
      // warp prefix sum of cnt: this lane's first slot and the list's length
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
      }
      int pos = __popc(eb) + incl - cnt;
      const int n = __popc(eb) + __shfl_sync(kAll, incl, 31);
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int t0 = (k * 32 + lane) * 16;
        for (unsigned w = m16[k]; w; w &= w - 1u) {
          list[pos++] = (uint16_t)(t0 + __ffs(w) - 1);
        }
      }
      __syncwarp();

      if (narrow) {
        if (slot < per) {
          const int cell = s_cell[warp][lane - slot * ncell];
#pragma unroll 4
          for (int j = slot; j < n; j += per) {
            const int i = (base + (int16_t)list[j]) * ZC + cell;
            const float p = __ldg(price + i);
            if (precedes(p, i, v, idx)) {
              v = p;
              idx = i;
            }
          }
        }
      } else {
        const unsigned* words = s_zc[warp];
        for (int j = 0; j < n; ++j) {
          const int row_i = (base + (int16_t)list[j]) * ZC;
          for (int zc = lane; zc < ZC; zc += 32) {
            if ((words[zc >> 5] >> (zc & 31)) & 1u) {
              const float p = __ldg(price + row_i + zc);
              if (precedes(p, row_i + zc, v, idx)) {
                v = p;
                idx = row_i + zc;
              }
            }
          }
        }
      }
      __syncwarp();   // the list is rewritten by the next round
#pragma unroll
      for (int k = 0; k < kLoads; ++k) cur[k] = nxt[k];
    }
  }

  // the warp's least (value, index)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kAll, v, off);
    const int oi = __shfl_down_sync(kAll, idx, off);
    if (precedes(ov, oi, v, idx)) {
      v = ov;
      idx = oi;
    }
  }
  if (lane == 0) {
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
  const int blocks = (B + kWarps - 1) / kWarps;
  cheapest_offering_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tmask), static_cast<const uint8_t*>(zcmask),
      static_cast<const float*>(price), static_cast<float*>(best_v),
      static_cast<int32_t*>(best_i), B, T, ZC);
  return (int)cudaGetLastError();
}
