// Paged attention for Hopper (sm_90a): causal, optionally sliding-window,
// grouped-query attention read straight out of a paged K/V pool.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::_paged_kernel
// (the Pallas TPU kernel) with the same semantics:
//   * table slot pi of row b covers kv positions [pi*page, (pi+1)*page);
//     a query at position p keeps kv position t when t <= p and, with a
//     window, t > p - window;
//   * masked scores are NEG_INF = -1e30 (not -inf), the running (m, l)
//     softmax starts at m = -1e30, and the final l is clamped at 1e-30,
//     so idle lanes (all-trash table, positions 0) give finite output
//     and a fully masked stretch before the first valid key is wiped by
//     alpha = exp(-1e30 - m) = 0 when that key arrives;
//   * query head h reads kv head h / (H / KV);
//   * q and the pools are f32 or bf16, everything is accumulated in f32,
//     the output is f32.
//
// What bounds it on an H100: HBM bytes. A decode step reads every
// visited K/V row once per layer (2 * tokens * KV * Dh * 4 B for f32
// pools) for about 2 FLOP per byte, far below the card's ~20 FLOP/B
// f32 balance point.
//
// Design, simple first:
//   * one block per (batch row b, kv head, tile of 16 query rows); the
//     G = H / KV query heads that share a kv head sit in the same tile
//     (row = position * G + head-in-group), so each K/V row a tile
//     needs is read from the pool once for all G heads (the Pallas grid
//     (B, H, Pmax) re-reads it per query head);
//   * the block reads its own block table and positions and walks only
//     the kv positions its rows can see: [first row's p - window + 1,
//     last row's p], clipped to the table (positions are monotone within
//     a row), never all Pmax pages;
//   * keys go through shared memory 32 at a time, staged as f32 with
//     16-byte loads; each warp owns up to 4 query rows and keeps their
//     running m, l and o[Dh] in registers: lane j scores key j, then the
//     lanes split Dh for the P.V update.
// wgmma, TMA, pipelined loads and split-K over long tables are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes from a 16-byte aligned address, widened to f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DV = ceil(Dh / 32) rounded up to a power of two: the output columns a
// lane owns (d = lane + 32 * c).
template <typename QT, typename KVT, int DV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KVT* __restrict__ k_pages,
                       const KVT* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       float* __restrict__ out, int S, int H, int KV, int Dh,
                       int n_pages, int page, int pmax, int window,
                       float scale, int vec) {
  extern __shared__ float smem[];
  const int kstride = Dh + 1;               // padded: lane j reads row j
  float* k_s = smem;                        // [kKeys][Dh + 1]
  float* v_s = k_s + kKeys * kstride;       // [kKeys][Dh]
  float* q_s = v_s + kKeys * Dh;            // [kRows][Dh]
  __shared__ int pos_s[kRows];
  __shared__ long long base_s[kKeys];       // pool offset of each key, -1 = none

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, G * S - r0);
  const int* bt = block_tables + (size_t)b * pmax;
  const int* pos_b = positions + (size_t)b * S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int r = threadIdx.x; r < kRows; r += kThreads)
    pos_s[r] = r < n_rows ? pos_b[(r0 + r) / G] : 0;
  for (int i = threadIdx.x; i < kRows * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    float val = 0.f;
    if (r < n_rows) {
      const int row = r0 + r, si = row / G, h = kvh * G + row % G;
      val = to_f32(q[(((size_t)b * S + si) * H + h) * Dh + d]);
    }
    q_s[i] = val;
  }
  __syncthreads();

  // kv positions any row of this tile can keep (rows are in position
  // order): [q_lo - window + 1, q_hi], inside the table's Pmax * page.
  const int q_lo = pos_s[0];
  const int q_hi = pos_s[n_rows - 1];
  const int t_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_end = min(q_hi, pmax * page - 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][DV];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) o[i][c] = 0.f;
  }

  const size_t row_elems = (size_t)KV * Dh;
  for (int t0 = t_begin; t0 <= t_end; t0 += kKeys) {
    if (threadIdx.x < kKeys) {
      const int t = t0 + threadIdx.x;
      long long base = -1;
      if (t <= t_end) {
        // out-of-range page ids are clamped, as the reference's gathers
        // clamp them
        const int pid = min(max(bt[t / page], 0), n_pages - 1);
        base = (((long long)pid * page + t % page) * row_elems) +
               (long long)kvh * Dh;
      }
      base_s[threadIdx.x] = base;
    }
    __syncthreads();
    if (vec) {
      constexpr int VN = Vec16<KVT>::n;
      const int per_row = Dh / VN;
      for (int i = threadIdx.x; i < kKeys * per_row; i += kThreads) {
        const int j = i / per_row, c = (i % per_row) * VN;
        const long long base = base_s[j];
        float kv[VN], vv[VN];
        if (base >= 0) {
          Vec16<KVT>::load(k_pages + base + c, kv);
          Vec16<KVT>::load(v_pages + base + c, vv);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) kv[e] = vv[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          k_s[j * kstride + c + e] = kv[e];
          v_s[j * Dh + c + e] = vv[e];
        }
      }
    } else {
      for (int i = threadIdx.x; i < kKeys * Dh; i += kThreads) {
        const int j = i / Dh, d = i % Dh;
        const long long base = base_s[j];
        k_s[j * kstride + d] = base >= 0 ? to_f32(k_pages[base + d]) : 0.f;
        v_s[j * Dh + d] = base >= 0 ? to_f32(v_pages[base + d]) : 0.f;
      }
    }
    __syncthreads();

    const int t = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) continue;  // warp-uniform
      const int p = pos_s[r];
      bool keep = t <= p && t <= t_end;
      if (window > 0) keep = keep && t > p - window;
      float sc = kNegInf;
      if (keep) {
        const float* qr = q_s + r * Dh;
        const float* kr = k_s + lane * kstride;
        float acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        sc = acc * scale;
      }
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float pr = expf(sc - m_new);
      l[i] = l[i] * alpha + warp_sum(pr);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) o[i][c] *= alpha;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float* vr = v_s + j * Dh;
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          const int d = lane + 32 * c;
          if (d < Dh) o[i][c] = fmaf(pj, vr[d], o[i][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= n_rows) continue;
    const int row = r0 + r, si = row / G, h = kvh * G + row % G;
    const float li = fmaxf(l[i], 1e-30f);
    float* dst = out + (((size_t)b * S + si) * H + h) * Dh;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) dst[d] = o[i][c] / li;
    }
  }
}

size_t smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)kKeys * (Dh + 1) + (size_t)kKeys * Dh +
                          (size_t)kRows * Dh);
}

template <typename QT, typename KVT, int DV>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* positions, float* out,
                   int B, int S, int H, int KV, int Dh, int n_pages, int page,
                   int pmax, int window, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KVT, DV>;
  const size_t smem = smem_bytes(Dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int VN = Vec16<KVT>::n;
  const int vec = Dh % VN == 0 &&
                  reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const int G = H / KV;
  dim3 grid((G * S + kRows - 1) / kRows, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), block_tables, positions, out, S, H,
      KV, Dh, n_pages, page, pmax, window, scale, vec);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_dv(int dv, const void* q, const void* k_pages,
                        const void* v_pages, const int* block_tables,
                        const int* positions, float* out, int B, int S, int H,
                        int KV, int Dh, int n_pages, int page, int pmax,
                        int window, float scale, cudaStream_t stream) {
#define PA_LAUNCH(DV)                                                      \
  return launch<QT, KVT, DV>(q, k_pages, v_pages, block_tables, positions, \
                             out, B, S, H, KV, Dh, n_pages, page, pmax,    \
                             window, scale, stream)
  if (dv <= 1) PA_LAUNCH(1);
  if (dv <= 2) PA_LAUNCH(2);
  if (dv <= 4) PA_LAUNCH(4);
  PA_LAUNCH(8);
#undef PA_LAUNCH
}

}  // namespace

// C entry point, loaded with ctypes. q: (B, S, H, Dh) f32 or bf16
// (q_bf16); k_pages/v_pages: (n_pages, page, KV, Dh) f32 or bf16
// (kv_bf16); block_tables: (B, pmax) i32; positions: (B, S) i32; out:
// (B, S, H, Dh) f32. All contiguous. window <= 0 means none. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* positions, float* out, int B, int S,
    int H, int KV, int Dh, int n_pages, int page, int pmax, int window,
    float scale, int q_bf16, int kv_bf16, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || Dh < 1 ||
      Dh > kMaxHeadDim || page < 1 || pmax < 1 || n_pages < 1)
    return (int)cudaErrorInvalidValue;
  const int dv = (Dh + 31) / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                              \
  dv, q, k_pages, v_pages, block_tables, positions, out, B, S, H, KV, Dh,   \
      n_pages, page, pmax, window, scale, st
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = dispatch_dv<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
  else if (q_bf16)
    err = dispatch_dv<__nv_bfloat16, float>(PA_ARGS);
  else if (kv_bf16)
    err = dispatch_dv<float, __nv_bfloat16>(PA_ARGS);
  else
    err = dispatch_dv<float, float>(PA_ARGS);
#undef PA_ARGS
  return (int)err;
}
