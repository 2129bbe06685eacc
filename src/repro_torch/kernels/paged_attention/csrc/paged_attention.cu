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
// Two instances; the caller picks one per call (the C entry's `variant`):
//   * "rows" for few query rows per (lane, kv head): the engine's decode
//     steps go to its split path (paged_attention_split_kernel, below),
//     larger calls to its walk of many rows (paged_attention_kernel);
//   * "tile" (paged_attention_tile_kernel) for many, the engine's prefill
//     chunks: tensor-core tiles of 64 query rows (see its own comment
//     further down).
//
// What bounds it on an H100: HBM bytes. A decode step reads every
// visited K/V row once per layer (2 * tokens * KV * Dh * 4 B for f32
// pools) for about G / 2 FLOP per byte, far below the card's ~20 FLOP/B
// f32 balance point. A prefill chunk of 32 tokens does 32 x G times the
// work on the same bytes, which is why it gets the tensor cores.
//
// The rows instance's walk of many rows (calls of more than 16 rows per
// (lane, kv head), or a pool the split path's 4-element copies cannot
// read):
//   * one block per (batch row b, kv head, tile of 16 query rows); the
//     G = H / KV query heads that share a kv head sit in the same tile
//     (row = position * G + head-in-group), so each K/V row a tile
//     needs is read from the pool once for all G heads (the Pallas grid
//     (B, H, Pmax) re-reads it per query head);
//   * the block reads its own block table and positions and walks only
//     the kv positions its rows can see: [first row's p - window + 1,
//     last row's p], clipped to the table (positions are monotone within
//     a row), never all Pmax pages unless a row keeps no key (then the
//     whole table, as the plain version averages it);
//   * keys go through shared memory 32 at a time, staged as f32 with
//     16-byte loads; each warp owns up to 4 query rows and keeps their
//     running m, l and o[Dh] in registers: lane j scores key j, then the
//     lanes split Dh for the P.V update.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  // order): [q_lo - window + 1, q_hi], inside the table's Pmax * page. A
  // row that keeps no key at all (past the table, with a window) averages
  // V over the whole table, as the plain version's softmax over all -1e30
  // does, so such a tile walks it all; its other rows' masked keys are
  // wiped by their first kept key (alpha = 0).
  const int q_lo = pos_s[0];
  const int q_hi = pos_s[n_rows - 1];
  const int table_end = pmax * page - 1;
  const bool any_blind = window > 0 && q_hi - window + 1 > table_end;
  const int t_begin =
      window > 0 && !any_blind ? max(0, q_lo - window + 1) : 0;
  const int t_end = min(q_hi, table_end);

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
      // keys past the table count for no row (not even one that keeps none)
      const float pr = t <= t_end ? expf(sc - m_new) : 0.f;
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


// ---------------------------------------------------------------------------
// The tile instance: prefill chunks, many query rows per (lane, kv head)
// ---------------------------------------------------------------------------
//
// Same semantics as the rows instance (the header above). What bounds it
// at the engine's prefill chunk (8 lanes x 32 tokens at 256-287, G 4,
// Dh 128, f32 pool): the tensor cores' tf32 rate times the passes below,
// about as long as the bytes (7.5 us each on an H100); in practice the
// latency of each stage's chain (shared-memory loads, splits, mma, the
// softmax), with one block on an SM. Design:
//   * one block per (batch row b, kv head, tile of 64 query rows), rows
//     in the same order (row = position * G + head-in-group), so each
//     K/V row the block needs is read once for all 64: 4 tiles of 16
//     rows for mma.sync m16n8k8 (tf32 in, f32 sums), each taken by 2
//     warps that split every stage's keys in halves, keep their own
//     (m, l, o) and merge them at the end through shared memory (twice
//     the warps to hide the latency of each chain);
//   * f32 precision from the tf32 tensor cores ("3xTF32", CUTLASS's
//     OpMultiplyAddFastF32): x = big + small with big = tf32(x), small =
//     tf32(x - big), both rounded to nearest, ties away, and a.b =
//     big.big + big.small + small.big; the dropped small.small is about
//     2^-22 of |a||b|. A bf16 operand is exact in tf32 (small = 0) and
//     its pass is skipped: Q.K takes 3 passes with f32 q and pool, 2
//     with one of them bf16, 1 with both; P.V 3 with an f32 pool, 2 with
//     bf16 (P is f32);
//   * inside each 8-deep mma step the k order is permuted, alike in A
//     and B (logical k = t reads element 2t, k = t + 4 reads 2t + 1),
//     which leaves the sum as it is: a Q or K fragment is then one 8-byte
//     (f32) or 4-byte (bf16) load, and the Q.K accumulator of 8 keys IS
//     the P.V A fragment of those keys, with no shuffle;
//   * K and V go through a 2-stage ring of 32 keys, landed by 16-byte
//     cp.async (zero-filled past the walk) while the block computes the
//     other stage; each key's pool offset is computed once per stage, a
//     stage ahead. Rows are padded (Q and K by 8 elements, V by 16
//     bytes) so that every fragment load is free of bank conflicts. (A
//     deeper ring measured no faster: the loads are not what binds.)
//   * softmax in registers, in the FlashAttention-2 layout: a thread
//     holds 2 rows of its warp's tile, the row max takes 2 shuffles in
//     the quad, the row sum stays per thread until the end;
//   * the walk is the rows instance's: [first row's p - window + 1, last
//     row's p], clipped to the table; a warp skips its part of a stage
//     when none of its rows keeps a key there. A row that keeps no key
//     at all (past the table, with a window) averages V over the whole
//     table, as the plain version's softmax over all -1e30 does, so its
//     block walks it all;
//   * a grid of fewer blocks than half the SMs (gemma_2b's chunk: 8
//     lanes x 1 kv head x 4 row tiles = 32 blocks on 132 SMs) is split
//     over keys as well: n_split blocks share each (row tile, kv head,
//     lane), block i walking stages [i n / n_split, (i + 1) n / n_split)
//     of the block's n stages (n from the positions, on the device; the
//     wrapper's `tile_plan` picks n_split from shapes alone). Each writes
//     its rows' partial (m, l, unnormalised o), and the split path's
//     merge kernel (paged_attention_merge_kernel, further down) adds
//     them in order, with the same rule for masked-only and empty parts.
// Shared memory at Dh 128: 101 KB with an f32 pool, 68 KB with bf16; at
// Dh 256 197 KB and 131 KB (o then holds 128 floats a thread).

namespace tile {

constexpr int kRowWarps = 4;        // 16-row mma tiles per block
constexpr int kSplit = 2;           // warps per tile, each on its keys
constexpr int kThreads = kRowWarps * kSplit * 32;
constexpr int kRows = kRowWarps * 16;  // query rows per block
constexpr int kKeys = 32;           // keys per stage
constexpr int kPart = kKeys / kSplit;  // keys of a stage a warp takes
constexpr int kStages = 2;          // depth of the K/V ring

template <typename KVT, int DH>
struct Layout {
  static constexpr int QS = DH + 8;                       // f32 a q_s row
  static constexpr int KS = DH + 8;                       // KVT a k_s row
  static constexpr int VS = DH + 16 / (int)sizeof(KVT);   // KVT a v_s row
  static constexpr int VN = 16 / (int)sizeof(KVT);        // KVT a chunk
  static constexpr int CPR = DH / VN;                     // chunks a row
  static constexpr size_t q_bytes = sizeof(float) * kRows * QS;
  static constexpr size_t k_bytes = sizeof(KVT) * kKeys * KS;
  static constexpr size_t v_bytes = sizeof(KVT) * kKeys * VS;
  static constexpr size_t smem = q_bytes + kStages * (k_bytes + v_bytes);
};

// 16 bytes global -> shared, bypassing L1; `n` of them read, the rest
// zero-filled (n = 0: all zero)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as big + small, each a tf32 bit pattern; kExact (x holds a bf16
// value, exact in tf32): small = 0 and no rounding
template <bool kExact>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  if (kExact) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(small)
        : "f"(x - __uint_as_float(big)));
  }
}

// d += a . b on the tensor cores: a 16x8 tf32, b 8x8 tf32, d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// elements 2i and 2i + 1 of a row, widened to f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// pool offset (in elements) of kv position t, from its block-table
// entry; out-of-range page ids are clamped, as the reference's gathers
// clamp them
__device__ __forceinline__ long long pool_offset(int entry, int t, int page,
                                                 int n_pages,
                                                 long long row_elems,
                                                 long long head_off) {
  const int pid = min(max(entry, 0), n_pages - 1);
  return ((long long)pid * page + t % page) * row_elems + head_off;
}

// one stage's K and V rows into shared memory by 16-byte cp.async, a
// warp's copies along a row; a key without an offset (-1) lands as
// zeros
template <typename KVT, int DH>
__device__ __forceinline__ void issue_stage(KVT* kd, KVT* vd,
                                            const long long* base,
                                            const KVT* k_pages,
                                            const KVT* v_pages, int tid) {
  using L = Layout<KVT, DH>;
  for (int i = tid; i < kKeys * L::CPR; i += kThreads) {
    const int j = i / L::CPR, c = (i % L::CPR) * L::VN;
    const long long off = base[j] >= 0 ? base[j] + c : 0;
    const int n = base[j] >= 0 ? 16 : 0;
    cp_async16(kd + j * L::KS + c, k_pages + off, n);
    cp_async16(vd + j * L::VS + c, v_pages + off, n);
  }
}

template <typename QT, typename KVT, int DH>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_tile_kernel(const QT* __restrict__ q,
                            const KVT* __restrict__ k_pages,
                            const KVT* __restrict__ v_pages,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ positions,
                            float* __restrict__ out,
                            float* __restrict__ partial, int n_split, int S,
                            int H, int KV, int n_pages, int page, int pmax,
                            int window, float scale) {
  using L = Layout<KVT, DH>;
  constexpr bool kQExact = std::is_same<QT, __nv_bfloat16>::value;
  constexpr bool kKVExact = std::is_same<KVT, __nv_bfloat16>::value;
  constexpr int NT = DH / 8;  // 8-deep Q.K steps; 8-wide output tiles
  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* q_s = reinterpret_cast<float*>(tile_smem);         // [kRows][QS]
  KVT* k_s = reinterpret_cast<KVT*>(tile_smem + L::q_bytes);  // [st][kKeys][KS]
  KVT* v_s = reinterpret_cast<KVT*>(tile_smem + L::q_bytes +
                                    kStages * L::k_bytes);  // [st][kKeys][VS]
  __shared__ int pos_s[kRows];
  __shared__ long long base_s[kStages][kKeys];  // pool offset, -1 = none

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int split = blockIdx.x % n_split;
  const int r0 = blockIdx.x / n_split * kRows;
  const int n_rows = min(kRows, G * S - r0);
  const int* bt = block_tables + (size_t)b * pmax;
  const int* pos_b = positions + (size_t)b * S;
  const int tid = threadIdx.x;
  const int rw = (tid / 32) % kRowWarps;  // this warp's 16-row tile
  const int part = tid / 32 / kRowWarps;  // and its keys of a stage
  const int gid = (tid % 32) / 4;  // row in the 8-row half of the tile
  const int tig = tid % 4;         // thread in the quad

  // rows past n_rows take the last row's position: they widen no range
  for (int r = tid; r < kRows; r += kThreads)
    pos_s[r] = pos_b[(r0 + min(r, n_rows - 1)) / G];
  __syncthreads();

  const int table_end = pmax * page - 1;
  const int q_lo = pos_s[0];
  const int q_hi = pos_s[kRows - 1];
  const bool any_blind = window > 0 && q_hi - window + 1 > table_end;
  const int t_begin =
      window > 0 && !any_blind ? max(0, q_lo - window + 1) : 0;
  const int t_end = min(q_hi, table_end);
  const int n_all = t_end >= t_begin ? (t_end - t_begin) / kKeys + 1 : 0;
  // this block's stages of the walk: n_tiles of them from key t_first
  const int st0 = (int)((long long)split * n_all / n_split);
  const int n_tiles = (int)((long long)(split + 1) * n_all / n_split) - st0;
  const int t_first = t_begin + st0 * kKeys;
  // the partials of a split walk: [split][row][DH] o, then [split][row][2]
  // (m, l), rows in (lane, kv head, row) order
  const int R = G * S;
  const size_t rows_total = (size_t)gridDim.z * KV * R;
  const size_t row0 = ((size_t)b * KV + kvh) * R + r0;
  float* ml = partial + (size_t)n_split * rows_total * DH;
  if (n_split > 1 && n_tiles == 0) {  // an empty part: keeps nothing
    for (int r = tid; r < n_rows; r += kThreads) {
      float* dst = ml + ((size_t)split * rows_total + row0 + r) * 2;
      dst[0] = kNegInf;
      dst[1] = 0.f;
    }
    return;
  }

  const long long row_elems = (long long)KV * DH;
  const long long head_off = (long long)kvh * DH;
  // the offsets of the first kStages stages, then the copies of all but
  // the last of them, one commit group each
  for (int i = tid; i < kStages * kKeys; i += kThreads) {
    const int t = t_first + i;
    base_s[i / kKeys][i % kKeys] =
        t <= t_end
            ? pool_offset(bt[t / page], t, page, n_pages, row_elems, head_off)
            : -1;
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      issue_stage<KVT, DH>(k_s + st * kKeys * L::KS, v_s + st * kKeys * L::VS,
                           base_s[st], k_pages, v_pages, tid);
    cp_async_commit();
  }

  // q in f32, zero past n_rows, read while stage 0 lands: every 16-byte
  // load of a thread issued before the first is used
  {
    constexpr int QV = Vec16<QT>::n;     // elements a load
    constexpr int QCPR = DH / QV;        // loads a row
    constexpr int NQ = (kRows * QCPR + kThreads - 1) / kThreads;
    uint4 raw[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int i = tid + k * kThreads, r = i / QCPR, c = (i % QCPR) * QV;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows) {
        const int row = r0 + r, si = row / G, h = kvh * G + row % G;
        raw[k] = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * S + si) * H + h) * DH + c);
      }
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int i = tid + k * kThreads, r = i / QCPR, c = (i % QCPR) * QV;
      if (r >= kRows) break;
      float f[QV];
      Vec16<QT>::load(reinterpret_cast<const QT*>(&raw[k]), f);
#pragma unroll
      for (int e = 0; e < QV; e += 4)
        *reinterpret_cast<float4*>(q_s + r * L::QS + c + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }

  const int ra = rw * 16 + gid;  // this thread's two rows
  const int rb = ra + 8;
  const int pa = pos_s[ra];
  const int pb = pos_s[rb];
  const int w_lo = pos_s[rw * 16];
  const int w_hi = pos_s[rw * 16 + 15];
  const bool warp_live = rw * 16 < n_rows;
  const bool warp_blind = window > 0 && w_hi - window + 1 > table_end;

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % kStages;
    // the slot of stage it - 1 is free, the offsets of it + kStages - 1
    // are written
    __syncthreads();
    if (it + kStages - 1 < n_tiles) {
      const int ahead = (it + kStages - 1) % kStages;
      issue_stage<KVT, DH>(k_s + ahead * kKeys * L::KS,
                           v_s + ahead * kKeys * L::VS, base_s[ahead],
                           k_pages, v_pages, tid);
    }
    cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<kStages - 1>();
    __syncthreads();  // every thread's copies of this stage landed
    // the block-table entry of a key kStages stages ahead: loaded here,
    // used after this stage's compute, so that its latency hides
    const int t_next = t_first + (it + kStages) * kKeys + tid;
    const bool fetch = tid < kKeys && it + kStages < n_tiles;
    int entry = 0;
    if (fetch && t_next <= t_end) entry = bt[t_next / page];
    const int t0 = t_first + it * kKeys + part * kPart;
    // warp-uniform: a row of this warp keeps a key of its part of the
    // stage (or one keeps no key at all, which needs them all)
    if (warp_live && t0 <= w_hi && t0 <= t_end &&
        !(window > 0 && !warp_blind && t0 + kPart - 1 <= w_lo - window)) {
      const KVT* ks = k_s + (slot * kKeys + part * kPart) * L::KS;
      const KVT* vs = v_s + (slot * kKeys + part * kPart) * L::VS;

      // S = Q . K^T over this warp's kPart keys of the stage, NK tiles of
      // 8 keys; the compensation passes sum apart (more independent mma
      // chains). The Dh loop is unrolled by 4: unrolled in full, the
      // compiler takes up to 255 registers and the kernel runs slower.
      constexpr int NK = kPart / 8;
      float acc[NK][4], cor[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = cor[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < NT; ++kk) {
        const float2 xa = load_pair(q_s + ra * L::QS + 8 * kk + 2 * tig);
        const float2 xb = load_pair(q_s + rb * L::QS + 8 * kk + 2 * tig);
        uint32_t ab[4], as[4];
        split_tf32<kQExact>(xa.x, ab[0], as[0]);
        split_tf32<kQExact>(xb.x, ab[1], as[1]);
        split_tf32<kQExact>(xa.y, ab[2], as[2]);
        split_tf32<kQExact>(xb.y, ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 y = load_pair(ks + (8 * n + gid) * L::KS + 8 * kk +
                                     2 * tig);
          uint32_t b0, b1, s0, s1;
          split_tf32<kKVExact>(y.x, b0, s0);
          split_tf32<kKVExact>(y.y, b1, s1);
          if (!kKVExact) mma_tf32(cor[n], ab, s0, s1);
          if (!kQExact) mma_tf32(cor[n], as, b0, b1);
          mma_tf32(acc[n], ab, b0, b1);
        }
      }

      // mask, then the online softmax of rows ra (entries 0, 1 of each
      // accumulator) and rb (entries 2, 3); acc becomes P
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + 8 * n + 2 * tig + (e & 1);
          const int p = e < 2 ? pa : pb;
          const bool keep = t <= t_end && t <= p &&
                            (window <= 0 || t > p - window);
          const float x = acc[n][e] + cor[n][e];
          acc[n][e] = keep ? x * scale : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], acc[n][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + 8 * n + 2 * tig + (e & 1);
          // a key past the walk is absent, not masked: it adds nothing
          acc[n][e] = t <= t_end ? expf(acc[n][e] - m[e / 2]) : 0.f;
          sum[e / 2] += acc[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }

      // O += P . V: the 8 keys of acc[j] are the k of step j
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t pbig[4], psml[4];
        split_tf32<false>(acc[j][0], pbig[0], psml[0]);
        split_tf32<false>(acc[j][2], pbig[1], psml[1]);
        split_tf32<false>(acc[j][1], pbig[2], psml[2]);
        split_tf32<false>(acc[j][3], pbig[3], psml[3]);
        const KVT* v0 = vs + (8 * j + 2 * tig) * L::VS + gid;
        const KVT* v1 = v0 + L::VS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0, b1, s0, s1;
          split_tf32<kKVExact>(to_f32(v0[8 * nt]), b0, s0);
          split_tf32<kKVExact>(to_f32(v1[8 * nt]), b1, s1);
          if (!kKVExact) mma_tf32(o[nt], pbig, s0, s1);
          mma_tf32(o[nt], psml, b0, b1);
          mma_tf32(o[nt], pbig, b0, b1);
        }
      }
    }
    if (fetch)
      base_s[slot][tid] = t_next <= t_end
                              ? pool_offset(entry, t_next, page, n_pages,
                                            row_elems, head_off)
                              : -1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // the warps of a tile merge their (m, l, o) through shared memory,
  // which the stages no longer need, in halves: [value][thread of a tile]
  constexpr int kT = kRowWarps * 32;
  constexpr int NV = NT * 4 + 4;
  static_assert(sizeof(float) * NV * kT * (kSplit / 2) <= L::smem, "merge");
  float* merge = reinterpret_cast<float*>(tile_smem) + rw * 32 + tid % 32;
#pragma unroll
  for (int half = kSplit / 2; half > 0; half /= 2) {
    __syncthreads();
    if (part >= half && part < 2 * half) {
      float* dst = merge + (part - half) * NV * kT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(nt * 4 + e) * kT] = o[nt][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dst[(NT * 4 + i) * kT] = m[i];
        dst[(NT * 4 + 2 + i) * kT] = l[i];
      }
    }
    __syncthreads();
    if (part < half) {
      const float* src = merge + part * NV * kT;
      float a1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m2 = src[(NT * 4 + i) * kT];
        const float mm = fmaxf(m[i], m2);
        const float a0 = expf(m[i] - mm);
        a1[i] = expf(m2 - mm);
        l[i] = l[i] * a0 + src[(NT * 4 + 2 + i) * kT] * a1[i];
        m[i] = mm;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[nt][2 * i] *= a0;
          o[nt][2 * i + 1] *= a0;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nt][e] += a1[e / 2] * src[(nt * 4 + e) * kT];
    }
  }
  if (part != 0) return;
  // one split: the output; else the partial (m, l, unnormalised o)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i == 0 ? ra : rb;
    if (r >= n_rows) continue;
    float* dst;
    float li = 1.f;
    if (n_split == 1) {
      const int row = r0 + r, si = row / G, h = kvh * G + row % G;
      dst = out + (((size_t)b * S + si) * H + h) * DH;
      li = fmaxf(l[i], 1e-30f);
    } else {
      const size_t idx = (size_t)split * rows_total + row0 + r;
      dst = partial + idx * DH;
      if (tig == 0) {
        ml[idx * 2] = m[i];
        ml[idx * 2 + 1] = l[i];
      }
    }
    dst += 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(o[nt][2 * i] / li, o[nt][2 * i + 1] / li);
  }
}

}  // namespace tile

// ---------------------------------------------------------------------------
// The rows instance's split path: decode steps, few rows per (lane, kv head)
// ---------------------------------------------------------------------------
//
// Same semantics as the rows instance (the header above), for calls of
// R = G * S <= 16 query rows per (lane, kv head) (R <= 8 at Dh > 128):
// every decode step. What bounds it: the pool's bytes, each K/V row the
// lane's rows can see read once for all R rows (about R / 2 FLOP a byte
// of an f32 pool). Design (flash-decoding, a split over keys):
//   * grid (n_splits, KV, B): a block holds all R rows of one (lane, kv
//     head), row = position * G + head-in-group, so each K/V row is read
//     from the pool once for all G heads. It walks the i-th of n_splits
//     equal parts, rounded up to 32 keys, of its lane's key range (the
//     walk above, from its own positions on the device), so the split
//     count is a function of shapes alone (the wrapper's `split_plan`)
//     and a part past a short lane's range exits at once;
//   * warps split keys, not rows: warp w takes chunks w, w + 4, ... of 8
//     keys and keeps (m, l, o) of every row in registers (o: R x Dh / 32
//     floats a lane). Lane j + 8 u scores key j over the quarter u of Dh
//     (4-element groups u, u + 4, ...; K rows padded so that those reads
//     hit distinct banks), the quarters add by 2 shuffles; P.V splits Dh
//     over the lanes (column lane + 32 c), P read back from shared memory
//     four keys at a time;
//   * each warp's chunks land in a ring of 3 stages by cp.async (16 bytes
//     of an f32 pool, 8 of bf16; zero-filled past the part), so two
//     chunks are in flight while one is scored; a lane resolves its key's
//     page id a chunk before the copies that use it;
//   * the warps merge their (m, l, o) through shared memory, in order.
//     With one split the block writes the output; else it writes its
//     partial (m, l, unnormalised o) and paged_attention_merge_kernel,
//     one warp an output row, adds the splits in order 0..n-1 (no
//     atomics: the same bits every run): M = max m_i, L = sum l_i
//     e^(m_i - M), o = sum o_i e^(m_i - M) / max(L, 1e-30). A part that
//     holds only masked keys of a row gives (-1e30, its key count): beside
//     a kept key's m its weight is e^(-1e30 - M) = 0, beside other such
//     parts 1, so a row that keeps no key still averages V over the whole
//     table, as the sequential walk does; an empty part gives (-1e30, 0)
//     and adds nothing;
//   * f32 on the CUDA cores: the arithmetic is far below the bytes.

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 8;      // keys a warp stage; lane = key + 8 * quarter
constexpr int kStages = 3;    // depth of each warp's ring
constexpr int kMaxRows = 16;
constexpr int kRound = 32;    // a part's length is a multiple of this

// K row stride (elements): Dh padded to an odd number of 4-element groups
__host__ __device__ __forceinline__ int k_stride(int Dh) {
  return (Dh / 4) % 2 == 0 ? Dh + 4 : Dh + 8;
}

template <typename KVT>
size_t smem_bytes(int rm, int Dh) {
  return sizeof(KVT) * kWarps * kStages * kKeys * (k_stride(Dh) + Dh) +
         sizeof(float) * ((size_t)rm * Dh + (size_t)kWarps * rm * kKeys);
}

// 4 elements global -> shared (16 bytes of f32 bypassing L1, 8 of bf16),
// zeros when !in
template <typename KVT>
__device__ __forceinline__ void cp_async4(KVT* dst, const KVT* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (sizeof(KVT) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// RM: rows a block keeps state for (R <= RM); DV: output columns a lane
// owns (Dh <= 32 * DV)
template <typename KVT, int RM, int DV>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_split_kernel(const void* __restrict__ q, int q_bf16,
                             const KVT* __restrict__ k_pages,
                             const KVT* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ positions,
                             float* __restrict__ out, float* __restrict__ part,
                             int S, int H, int KV, int Dh, int n_pages,
                             int page, int pmax, int window, float scale) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int KS = k_stride(Dh);
  const int stage = kKeys * (KS + Dh);  // elements: K rows, then V rows
  KVT* ring = reinterpret_cast<KVT*>(split_smem);  // [warp][stage]
  float* q_s = reinterpret_cast<float*>(ring + kWarps * kStages * stage);
  float* p_s = q_s + RM * Dh;           // [warp][RM][kKeys]
  __shared__ int pos_s[RM];

  const int n_split = gridDim.x, split = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, R = G * S;
  const int rows_total = gridDim.z * KV * R;
  const int row0 = (b * KV + kvh) * R;  // the block's first partial row
  const int* bt = block_tables + (size_t)b * pmax;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = lane % kKeys, quarter = lane / kKeys;

  // rows past R take the last row's position (their state is never
  // written)
  if (threadIdx.x < RM)
    pos_s[threadIdx.x] = positions[(size_t)b * S + min((int)threadIdx.x, R - 1) / G];
  __syncthreads();

  // the walk [t_begin, t_end] of the rows instance, then this block's part
  const int q_lo = pos_s[0], q_hi = pos_s[R - 1];
  const int table_end = pmax * page - 1;
  const bool any_blind = window > 0 && q_hi - window + 1 > table_end;
  const int t_begin =
      window > 0 && !any_blind ? max(0, q_lo - window + 1) : 0;
  const int t_end = min(q_hi, table_end);
  const int len = ((t_end - t_begin + n_split) / n_split + kRound - 1) /
                  kRound * kRound;
  const int p0 = t_begin + split * len;
  const int p1 = min(p0 + len, t_end + 1);
  float* ml = part + (size_t)n_split * rows_total * Dh;  // [split][row][2]
  if (n_split > 1 && p0 >= p1) {  // an empty part: keeps nothing
    if (threadIdx.x < R) {
      float* dst = ml + ((size_t)split * rows_total + row0 + threadIdx.x) * 2;
      dst[0] = kNegInf;
      dst[1] = 0.f;
    }
    return;
  }

  // this warp's chunks of the part, through its own ring
  const int n_chunks = (p1 - p0 + kKeys - 1) / kKeys;
  const int n_mine =
      n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  KVT* my_ring = ring + warp * kStages * stage;
  const long long row_elems = (long long)KV * Dh;
  const long long head_off = (long long)kvh * Dh;
  const int G4 = Dh / 4;
  auto key_of = [&](int c) { return p0 + (warp + kWarps * c) * kKeys + key; };
  auto entry_of = [&](int c) {  // the block-table entry of this lane's key
    const int t = key_of(c);
    return t < p1 ? bt[t / page] : 0;
  };
  auto issue = [&](int c, int entry) {
    const int t = key_of(c);
    const bool in = t < p1;
    const long long base =
        in ? tile::pool_offset(entry, t, page, n_pages, row_elems, head_off)
           : 0;
    KVT* kd = my_ring + (c % kStages) * stage + key * KS;
    KVT* vd = my_ring + (c % kStages) * stage + kKeys * KS + key * Dh;
    for (int g = quarter; g < G4; g += 4) {
      cp_async4(kd + 4 * g, k_pages + base + 4 * g, in);
      cp_async4(vd + 4 * g, v_pages + base + 4 * g, in);
    }
  };
  int entry = n_mine > 0 ? entry_of(0) : 0;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_mine) {
      issue(c, entry);
      entry = c + 1 < n_mine ? entry_of(c + 1) : 0;
    }
    tile::cp_async_commit();
  }

  // q in f32, zero past R, read while the first chunks land
  for (int i = threadIdx.x; i < RM * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    float x = 0.f;
    if (r < R) {
      const size_t off =
          (((size_t)b * S + r / G) * H + kvh * G + r % G) * Dh + d;
      x = q_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(q)[off])
                 : static_cast<const float*>(q)[off];
    }
    q_s[i] = x;
  }
  __syncthreads();

  float m[RM], l[RM], o[RM][DV];  // l: this lane's key's share
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) o[r][c] = 0.f;
  }
  float* pw = p_s + warp * RM * kKeys;

  for (int j = 0; j < n_mine; ++j) {
    const int ahead = j + kStages - 1;
    if (ahead < n_mine) {
      issue(ahead, entry);
      // loaded now, used by the next chunk's copies
      entry = ahead + 1 < n_mine ? entry_of(ahead + 1) : 0;
    }
    tile::cp_async_commit();  // an empty group keeps the count uniform
    tile::cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of chunk j landed

    const KVT* ks = my_ring + (j % kStages) * stage;
    const KVT* vs = ks + kKeys * KS;
    const int t = key_of(j);
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    for (int g = quarter; g < G4; g += 4) {
      const float4 kk = load4(ks + key * KS + 4 * g);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + r * Dh + 4 * g);
        acc[r] = fmaf(qq.x, kk.x, acc[r]);
        acc[r] = fmaf(qq.y, kk.y, acc[r]);
        acc[r] = fmaf(qq.z, kk.z, acc[r]);
        acc[r] = fmaf(qq.w, kk.w, acc[r]);
      }
    }
    const bool present = t < p1;  // keys past the part count for no row
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
      const int p = pos_s[r];
      bool keep = present && t <= p;
      if (window > 0) keep = keep && t > p - window;
      const float sc = keep ? acc[r] * scale : kNegInf;
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float pr = present ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + pr;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) o[r][c] *= alpha;
      if (quarter == 0) pw[r * kKeys + key] = pr;
    }
    __syncwarp();
#pragma unroll
    for (int j4 = 0; j4 < kKeys / 4; ++j4) {
      float vv[4][DV];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < Dh ? to_f32(vs[(4 * j4 + jj) * Dh + d]) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(pw + r * kKeys + 4 * j4);
        const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < DV; ++c)
            o[r][c] = fmaf(pj[jj], vv[jj][c], o[r][c]);
      }
    }
    __syncwarp();  // the slot and pw are free for the next chunk
  }
  tile::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
  }

  // the warps' states into warp 0, in order, through the free rings:
  // [warp - 1][RM][Dh + 2]
  const int MS = Dh + 2;
  float* mrg = reinterpret_cast<float*>(split_smem);
  __syncthreads();
  if (warp > 0) {
    float* dst = mrg + (warp - 1) * RM * MS;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) dst[r * MS + d] = o[r][c];
      }
      if (lane == 0) {
        dst[r * MS + Dh] = m[r];
        dst[r * MS + Dh + 1] = l[r];
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    const float* src = mrg + (w - 1) * RM * MS;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      const float m2 = src[r * MS + Dh];
      const float mm = fmaxf(m[r], m2);
      const float a0 = expf(m[r] - mm), a1 = expf(m2 - mm);
      l[r] = l[r] * a0 + src[r * MS + Dh + 1] * a1;
      m[r] = mm;
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) o[r][c] = o[r][c] * a0 + a1 * src[r * MS + d];
      }
    }
  }

  // one split: the output; else the partial (m, l, unnormalised o)
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r >= R) break;
    float* dst;
    float li = 1.f;
    if (n_split == 1) {
      li = fmaxf(l[r], 1e-30f);
      dst = out + (((size_t)b * S + r / G) * H + kvh * G + r % G) * Dh;
    } else {
      const size_t idx = (size_t)split * rows_total + row0 + r;
      dst = part + idx * Dh;
      if (lane == 0) {
        ml[idx * 2] = m[r];
        ml[idx * 2 + 1] = l[r];
      }
    }
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) dst[d] = o[r][c] / li;
    }
  }
}

// the n_split partials of each output row, one warp a row: rows_total =
// B * KV * R rows in (b, kv head, row) order
template <int DV>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part,
                             float* __restrict__ out, int n_split,
                             int rows_total, int S, int H, int KV, int Dh) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_total) return;
  const int G = H / KV, R = G * S;
  const int b = row / (KV * R), kvh = row / R % KV, r = row % R;
  const float* ml = part + (size_t)n_split * rows_total * Dh;
  float M = kNegInf;
  for (int i = 0; i < n_split; ++i)
    M = fmaxf(M, ml[((size_t)i * rows_total + row) * 2]);
  float L = 0.f, o[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) o[c] = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const size_t idx = (size_t)i * rows_total + row;
    const float li = ml[idx * 2 + 1];
    if (li == 0.f) continue;  // an empty part: nothing kept, o never written
    const float w = expf(ml[idx * 2] - M);
    L += li * w;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) o[c] = fmaf(w, part[idx * Dh + d], o[c]);
    }
  }
  L = fmaxf(L, 1e-30f);
  float* dst = out + (((size_t)b * S + r / G) * H + kvh * G + r % G) * Dh;
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    const int d = lane + 32 * c;
    if (d < Dh) dst[d] = o[c] / L;
  }
}

// Shared memory above the default 48 KB is an opt-in per kernel and
// device; `allowed[device]` keeps the largest made, so that a decode step
// pays the driver call once.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <typename KVT, int RM, int DV>
cudaError_t launch(const void* q, int q_bf16, const void* k_pages,
                   const void* v_pages, const int* block_tables,
                   const int* positions, float* out, float* part, int n_split,
                   int B, int S, int H, int KV, int Dh, int n_pages, int page,
                   int pmax, int window, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_split_kernel<KVT, RM, DV>;
  static size_t allowed[kMaxDevices];  // this instance's opt-in, per device
  const size_t smem = smem_bytes<KVT>(RM, Dh);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      q, q_bf16, static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), block_tables, positions, out, part,
      S, H, KV, Dh, n_pages, page, pmax, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int rows_total = B * KV * (H / KV) * S;
  paged_attention_merge_kernel<DV>
      <<<(rows_total + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part, out, n_split, rows_total, S, H, KV, Dh);
  return cudaGetLastError();
}

// RM from the rows R (1, 4, 8 or 16), DV from Dh (2, 4 or 8; R <= 8 at
// DV 8, which the entry checks)
template <typename KVT>
cudaError_t dispatch(int R, const void* q, int q_bf16, const void* k_pages,
                     const void* v_pages, const int* block_tables,
                     const int* positions, float* out, float* part,
                     int n_split, int B, int S, int H, int KV, int Dh,
                     int n_pages, int page, int pmax, int window, float scale,
                     cudaStream_t stream) {
  const int dv = Dh <= 64 ? 2 : Dh <= 128 ? 4 : 8;
#define PA_SPLIT(RM, DV)                                                   \
  return launch<KVT, RM, DV>(q, q_bf16, k_pages, v_pages, block_tables,    \
                             positions, out, part, n_split, B, S, H, KV,  \
                             Dh, n_pages, page, pmax, window, scale,      \
                             stream)
#define PA_SPLIT_DV(RM)        \
  if (dv == 2) PA_SPLIT(RM, 2); \
  if (dv == 4) PA_SPLIT(RM, 4); \
  PA_SPLIT(RM, 8)
  if (R == 1) { PA_SPLIT_DV(1); }
  if (R <= 4) { PA_SPLIT_DV(4); }
  if (R <= 8) { PA_SPLIT_DV(8); }
  if (dv == 2) PA_SPLIT(16, 2);
  PA_SPLIT(16, 4);
#undef PA_SPLIT_DV
#undef PA_SPLIT
}

}  // namespace split

// The tile instance: n_split blocks a (row tile, kv head, lane), then,
// where n_split > 1, the split path's merge of their partials
template <typename QT, typename KVT, int DH>
cudaError_t launch_tile(const void* q, const void* k_pages,
                        const void* v_pages, const int* block_tables,
                        const int* positions, float* out, float* part,
                        int n_split, int B, int S, int H, int KV, int n_pages,
                        int page, int pmax, int window, float scale,
                        cudaStream_t stream) {
  auto kernel = tile::paged_attention_tile_kernel<QT, KVT, DH>;
  static size_t allowed[split::kMaxDevices];  // the opt-in, per device
  constexpr size_t smem = tile::Layout<KVT, DH>::smem;
  cudaError_t err = split::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  dim3 grid((G * S + tile::kRows - 1) / tile::kRows * n_split, KV, B);
  kernel<<<grid, tile::kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), block_tables, positions, out, part,
      n_split, S, H, KV, n_pages, page, pmax, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  constexpr int DV = DH <= 64 ? 2 : DH <= 128 ? 4 : 8;
  const int rows_total = B * H * S;
  split::paged_attention_merge_kernel<DV>
      <<<(rows_total + split::kWarps - 1) / split::kWarps, split::kThreads,
         0, stream>>>(part, out, n_split, rows_total, S, H, KV, DH);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_tile(int Dh, const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* positions, float* out, float* part,
                          int n_split, int B, int S, int H, int KV,
                          int n_pages, int page, int pmax, int window,
                          float scale, cudaStream_t stream) {
#define PA_TILE(DH)                                                        \
  return launch_tile<QT, KVT, DH>(q, k_pages, v_pages, block_tables,       \
                                  positions, out, part, n_split, B, S, H,  \
                                  KV, n_pages, page, pmax, window, scale,  \
                                  stream)
  switch (Dh) {
    case 16: PA_TILE(16);
    case 32: PA_TILE(32);
    case 64: PA_TILE(64);
    case 128: PA_TILE(128);
    case 256: PA_TILE(256);
    default: return cudaErrorInvalidValue;
  }
#undef PA_TILE
}

}  // namespace

// The C entry's arguments, one block: the wrapper mirrors it as a
// ctypes.Structure (`_Args` in paged_attention.py), fills the sizes once
// per call signature and writes only the pointers and the stream per
// call. `paged_attention_launch_args_bytes` gives its size, which the
// wrapper holds against its mirror's when it loads the library.
//
// q: (B, S, H, Dh) f32 or bf16 (q_bf16); k_pages/v_pages: (n_pages, page,
// KV, Dh) f32 or bf16 (kv_bf16); block_tables: (B, pmax) i32; positions:
// (B, S) i32; out: (B, S, H, Dh) f32. All contiguous. window <= 0 means
// none. variant: 0 the rows instance, 1 the tile instance (Dh 16, 32, 64,
// 128 or 256; q and the pools 16-byte aligned). n_splits: for the rows
// instance 0 its walk of many rows, n >= 1 its split path over n parts of
// each lane's keys (G * S <= 16, and <= 8 at Dh > 128; Dh a multiple of
// 4; the pools aligned to 4 elements); for the tile instance n >= 1
// blocks over the stages of each block's walk. `part` is a float
// workspace of n * B * H * S * (Dh + 2) when n > 1. The kernels launch on
// `stream`.
struct PagedAttentionArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* block_tables;
  const int* positions;
  float* out;
  float* part;
  void* stream;
  int B;
  int S;
  int H;
  int KV;
  int Dh;
  int n_pages;
  int page;
  int pmax;
  int window;
  float scale;
  int q_bf16;
  int kv_bf16;
  int variant;
  int n_splits;
};

extern "C" int paged_attention_launch_args_bytes() {
  return (int)sizeof(PagedAttentionArgs);
}

// C entry point, loaded with ctypes: launches the call `args` describes
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int paged_attention_launch(const PagedAttentionArgs* args) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const void* q = args->q;
  const void* k_pages = args->k_pages;
  const void* v_pages = args->v_pages;
  const int* block_tables = args->block_tables;
  const int* positions = args->positions;
  float* out = args->out;
  float* part = args->part;
  const int B = args->B, S = args->S, H = args->H, KV = args->KV,
            Dh = args->Dh, n_pages = args->n_pages, page = args->page,
            pmax = args->pmax, window = args->window;
  const float scale = args->scale;
  const int q_bf16 = args->q_bf16, kv_bf16 = args->kv_bf16,
            variant = args->variant, n_splits = args->n_splits;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || Dh < 1 ||
      Dh > kMaxHeadDim || page < 1 || pmax < 1 || n_pages < 1 ||
      (variant != 0 && variant != 1) || n_splits < 0 ||
      (variant == 1 && n_splits < 1) || (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(args->stream);
  if (variant == 0 && n_splits > 0) {
    const int R = H / KV * S;
    const uintptr_t align = kv_bf16 ? 8 : 16;
    if (R > split::kMaxRows || (R > 8 && Dh > 128) || Dh % 4 != 0 ||
        reinterpret_cast<uintptr_t>(k_pages) % align != 0 ||
        reinterpret_cast<uintptr_t>(v_pages) % align != 0 ||
        (n_splits > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
#define PA_ARGS                                                             \
  R, q, q_bf16, k_pages, v_pages, block_tables, positions, out, part,       \
      n_splits, B, S, H, KV, Dh, n_pages, page, pmax, window, scale, st
    cudaError_t err = kv_bf16 ? split::dispatch<__nv_bfloat16>(PA_ARGS)
                              : split::dispatch<float>(PA_ARGS);
#undef PA_ARGS
    return (int)err;
  }
  if (variant == 1) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
      return (int)cudaErrorInvalidValue;
#define PA_ARGS                                                              \
  Dh, q, k_pages, v_pages, block_tables, positions, out, part, n_splits, B, \
      S, H, KV, n_pages, page, pmax, window, scale, st
    cudaError_t err;
    if (q_bf16 && kv_bf16)
      err = dispatch_tile<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    else if (q_bf16)
      err = dispatch_tile<__nv_bfloat16, float>(PA_ARGS);
    else if (kv_bf16)
      err = dispatch_tile<float, __nv_bfloat16>(PA_ARGS);
    else
      err = dispatch_tile<float, float>(PA_ARGS);
#undef PA_ARGS
    return (int)err;
  }
  const int dv = (Dh + 31) / 32;
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
