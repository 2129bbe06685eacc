// Flash attention for Hopper (sm_90a): causal (with a query offset),
// optionally sliding-window, key-length masked, grouped-query attention
// over contiguous Q/K/V with an online LSE softmax.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (the Pallas TPU kernel) with the same function:
//   * query row r sits at key position r + q_offset and keeps key c when
//     c < kv_len and, if causal, c <= r + q_offset and, with a window W,
//     c > r + q_offset - W (q_offset = 0 is the Pallas kernel's top-left
//     `rows >= cols`; a decode step passes its cache index);
//   * Sq and Sk count as padded with zeros up to multiples of (bq, bk),
//     the Pallas kernel's tiles; the padding is never read: rows past Sq
//     are not computed and keys past Sk load as zeros;
//   * only the (bq, bk) tiles that the Pallas grid executes take part: a
//     K tile is skipped when it lies wholly above the diagonal, wholly
//     below the window, or wholly at or past kv_len for every row of the
//     query tile. The tiles a query tile visits form one run [lo, hi];
//     `nvis` counts, per query row, the tiles it executed;
//   * masked scores are NEG_INF = -1e30, the running (m, l, o) starts at
//     (-1e30, 0, 0) and the final l is clamped at 1e-30, so a row with
//     no visited tile gives o = 0 and a row whose visited keys are all
//     masked averages V uniformly, as the Pallas kernel does;
//   * query head h reads kv head h / (Hq / Hkv);
//   * q and K/V are f32 or bf16, widened to f32 on load (K/V optionally
//     rounded to bf16 first: the reference's `ck.astype(x.dtype)` of an
//     f32 cache, done in registers instead of a pass over the cache);
//     o and lse are f32.
//
// Two instances; the caller picks one per call (the C entry's `variant`):
//   * "rows", f32 on the CUDA cores, for any operand types: decode steps
//     (its split path, split::flash_attention_split_kernel further down)
//     and f32 operands (its walk of many rows, flash_attention_kernel);
//   * "tile" (tile::flash_attention_tile_kernel) for bf16 q and K/V that
//     are bf16 or rounded to it, D 16, 32, 64, 112, 128 or 256: prefills,
//     on the bf16 tensor cores (see its own comment further down).
//
// What bounds the rows instance on an H100: at a prefill, f32
// operations (4 * D per kept (query, key) pair: about 69 GFLOP for 8 x
// 32 heads x 1024 causal rows, D 128, against 67 TFLOP/s on the CUDA
// cores); at a decode step, the bytes of the cache (every K/V row up to
// kv_len read once, f32), which its split path reads once for a whole
// query group.
//
// The rows instance's walk of many rows (more than 16 query rows per
// (batch, kv head)), simple first (CUDA cores, f32):
//   * one block of 4 warps per (batch, query head, tile of BQ = 4 * R
//     query rows); element strides for q, k, v and o, so transposed
//     views of (B, S, H, D) tensors and of a dense cache run without
//     copies;
//   * keys go through shared memory 32 at a time with 16-byte loads, all
//     of a chunk's loads issued before the first is used; lane j scores
//     key j for the warp's R rows (Q rows read as
//     broadcasts, K rows padded by 4 floats so the 16-byte reads of a
//     quarter warp hit distinct banks); a chunk that no row of the block
//     visits is not loaded, a warp none of whose rows visits it skips it;
//   * each warp keeps m, l and its rows' o (each lane 4 columns per
//     128) in registers; probabilities go through shared memory, read
//     four keys at a time, for the P.V update.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;  // keys per chunk, one per lane
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* lse;
  float* nvis;
  int Hq, Hkv, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, kv_len, q_offset, bq, bk, nk;
  float scale;
  int q_bf16, kv_bf16, kv_round;
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The raw bits of four consecutive elements at p: f32 (16 bytes), or
// bf16 (8 bytes, in .x and .y) when bf16 != 0. Widened by `widen`.
__device__ __forceinline__ uint4 load_raw(const void* p, long long off,
                                          int bf16) {
  if (bf16) {
    const uint2 r = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + off);
    return make_uint4(r.x, r.y, 0u, 0u);
  }
  return *reinterpret_cast<const uint4*>(static_cast<const float*>(p) + off);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 widen(uint4 raw, int bf16, int round) {
  if (bf16) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float4 f = make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                         __uint_as_float(raw.z), __uint_as_float(raw.w));
  if (round)
    f = make_float4(round_bf16(f.x), round_bf16(f.y), round_bf16(f.z),
                    round_bf16(f.w));
  return f;
}

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

// The run [lo, hi] of K tiles that query tile qi visits (lo > hi: none),
// the Pallas kernel's block-skip predicate solved for the tile index.
__device__ __forceinline__ void tile_range(const Args& a, int qi, int& lo,
                                           int& hi) {
  const int qs = qi * a.bq + a.q_offset;
  hi = min(a.nk - 1, floordiv(a.kv_len - 1, a.bk));
  lo = 0;
  if (a.causal) {
    hi = min(hi, floordiv(qs + a.bq - 1, a.bk));
    if (a.window > 0)
      lo = max(0, floordiv(qs - a.window - a.bk + 1, a.bk) + 1);
  }
}

// The 16-byte groups of K (and of V) that one thread moves per chunk.
template <int NS>
constexpr int kLoads = kKeys * 32 * NS / kThreads;

// Issue the loads of chunk [c0, c0 + kKeys) into registers, raw (f32 or
// bf16 bits); keys at or past Sk read as zeros.
template <int NS>
__device__ __forceinline__ void fetch(const Args& a, long long k_base,
                                      long long v_base, int c0, uint4* kr,
                                      uint4* vr) {
  const int D4 = a.D / 4;
#pragma unroll
  for (int u = 0; u < kLoads<NS>; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int j = i / D4, c4 = i % D4, c = c0 + j;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (i < kKeys * D4 && c < a.Sk) {
      kk = load_raw(a.k, k_base + c * a.k_ss + 4 * c4, a.kv_bf16);
      vv = load_raw(a.v, v_base + c * a.v_ss + 4 * c4, a.kv_bf16);
    }
    kr[u] = kk;
    vr[u] = vv;
  }
}

// Widen the fetched chunk to f32 (rounding f32 K/V to bf16 first when
// asked) into the shared K (rows padded to D + 4) and V tiles.
template <int NS>
__device__ __forceinline__ void stash(const Args& a, const uint4* kr,
                                      const uint4* vr, float* k_s,
                                      float* v_s) {
  const int D4 = a.D / 4;
#pragma unroll
  for (int u = 0; u < kLoads<NS>; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kKeys * D4) {
      const int j = i / D4, c4 = i % D4;
      *reinterpret_cast<float4*>(k_s + j * (a.D + 4) + 4 * c4) =
          widen(kr[u], a.kv_bf16, a.kv_round);
      *reinterpret_cast<float4*>(v_s + j * a.D + 4 * c4) =
          widen(vr[u], a.kv_bf16, a.kv_round);
    }
  }
}

// R query rows per warp; NS 16-byte output slots per lane (D <= 128 * NS).
template <int R, int NS>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int BQ = kWarps * R;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D, D4 = a.D / 4, kstride = a.D + 4;
  float* q_s = smem;                   // [BQ][D]
  float* k_s = q_s + BQ * D;           // [kKeys][D + 4]
  float* v_s = k_s + kKeys * kstride;  // [kKeys][D]
  float* p_s = v_s + kKeys * D;        // [kWarps][R][kKeys]
  __shared__ int lo_s[BQ], hi_s[BQ], nvis_s[BQ];

  const int b = blockIdx.z, h = blockIdx.y;
  const int hkv = h / (a.Hq / a.Hkv);
  const int r0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_base = b * a.q_sb + h * a.q_sh;
  const long long k_base = b * a.k_sb + hkv * a.k_sh;
  const long long v_base = b * a.v_sb + hkv * a.v_sh;

#pragma unroll 4
  for (int i = threadIdx.x; i < BQ * D4; i += kThreads) {
    const int r = i / D4, c4 = i % D4, row = r0 + r;
    const uint4 raw = row < a.Sq
        ? load_raw(a.q, q_base + row * a.q_ss + 4 * c4, a.q_bf16)
        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<float4*>(q_s + r * D + 4 * c4) =
        widen(raw, a.q_bf16, 0);
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    int lo = 1, hi = 0;  // rows past Sq visit nothing
    if (r0 + r < a.Sq) tile_range(a, (r0 + r) / a.bq, lo, hi);
    lo_s[r] = lo;
    hi_s[r] = hi;
    nvis_s[r] = 0;
  }
  __syncthreads();

  // tile runs are monotone in the row, so the block's keys are
  // [first row's lo * bk, (last row's hi + 1) * bk)
  const int last = min(BQ, a.Sq - r0) - 1;
  const int c_begin = lo_s[0] * a.bk;
  const int c_end = min((hi_s[last] + 1) * a.bk, a.nk * a.bk);

  float m[R], l[R], o[R][NS][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][s][e] = 0.f;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += kKeys) {
    // does any row of the block visit a key of this chunk?
    int mine = 0;
    if (threadIdx.x < BQ) {
      const int lo = lo_s[threadIdx.x], hi = hi_s[threadIdx.x];
      mine = lo <= hi && lo * a.bk < c0 + kKeys && (hi + 1) * a.bk > c0;
    }
    if (!__syncthreads_or(mine)) continue;
    // global -> registers -> shared, every load of the chunk issued
    // before the first is used (also prefetching the next chunk during
    // this one's arithmetic measured no faster on an H100)
    uint4 kr[kLoads<NS>], vr[kLoads<NS>];
    fetch<NS>(a, k_base, v_base, c0, kr, vr);
    stash<NS>(a, kr, vr, k_s, v_s);
    __syncthreads();

    const int wr0 = warp * R;
    int warp_visits = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int lo = lo_s[wr0 + i], hi = hi_s[wr0 + i];
      warp_visits |= lo <= hi && lo * a.bk < c0 + kKeys && (hi + 1) * a.bk > c0;
    }
    if (warp_visits) {  // warp-uniform
      float acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
      const float* k_row = k_s + lane * kstride;
#pragma unroll 4
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 kk = *reinterpret_cast<const float4*>(k_row + 4 * d4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qq =
              *reinterpret_cast<const float4*>(q_s + (wr0 + i) * D + 4 * d4);
          acc[i] = fmaf(qq.x, kk.x, acc[i]);
          acc[i] = fmaf(qq.y, kk.y, acc[i]);
          acc[i] = fmaf(qq.z, kk.z, acc[i]);
          acc[i] = fmaf(qq.w, kk.w, acc[i]);
        }
      }

      const int c = c0 + lane;
      const int t = c / a.bk;
      float* pw = p_s + wr0 * kKeys;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = wr0 + i;
        const bool present = c < a.nk * a.bk && t >= lo_s[r] && t <= hi_s[r];
        const int pos = r0 + r + a.q_offset;
        bool keep = c < a.kv_len;
        if (a.causal) {
          keep = keep && c <= pos;
          if (a.window > 0) keep = keep && c > pos - a.window;
        }
        const float sc =
            present ? (keep ? acc[i] * a.scale : kNegInf) : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float alpha = expf(m[i] - m_new);
        const float p = expf(sc - m_new);
        l[i] = l[i] * alpha + warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][s][e] *= alpha;
        pw[i * kKeys + lane] = p;
        const unsigned starts =
            __ballot_sync(0xffffffffu, present && c % a.bk == 0);
        if (lane == 0) nvis_s[r] += __popc(starts);
      }
      __syncwarp();

#pragma unroll 2
      for (int j4 = 0; j4 < kKeys / 4; ++j4) {
        float4 vv[4][NS];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int slot = lane + 32 * s;
            vv[jj][s] = slot < D4 ? *reinterpret_cast<const float4*>(
                                        v_s + (4 * j4 + jj) * D + 4 * slot)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 pp =
              *reinterpret_cast<const float4*>(pw + i * kKeys + 4 * j4);
          const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              o[i][s][0] = fmaf(pj[jj], vv[jj][s].x, o[i][s][0]);
              o[i][s][1] = fmaf(pj[jj], vv[jj][s].y, o[i][s][1]);
              o[i][s][2] = fmaf(pj[jj], vv[jj][s].z, o[i][s][2]);
              o[i][s][3] = fmaf(pj[jj], vv[jj][s].w, o[i][s][3]);
            }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp * R + i, row = r0 + r;
    if (row >= a.Sq) continue;  // warp-uniform
    const float li = fmaxf(l[i], 1e-30f);
    float* dst = a.o + b * a.o_sb + h * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int slot = lane + 32 * s;
      if (slot < D4)
        *reinterpret_cast<float4*>(dst + 4 * slot) =
            make_float4(o[i][s][0] / li, o[i][s][1] / li, o[i][s][2] / li,
                        o[i][s][3] / li);
    }
    if (lane == 0) {
      const long long idx = ((long long)b * a.Hq + h) * a.Sq + row;
      a.lse[idx] = m[i] + logf(li);
      a.nvis[idx] = (float)nvis_s[r];
    }
  }
}

template <int R, int NS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int BQ = kWarps * R;
  auto kernel = flash_attention_kernel<R, NS>;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * a.D + (size_t)kKeys * (a.D + 4) +
                       (size_t)kKeys * a.D + (size_t)kWarps * R * kKeys);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Tiles of 8 query rows for a decode step, 32 for short chunks, 64
// otherwise.
template <int NS>
cudaError_t dispatch_rows(const Args& a, int B, cudaStream_t stream) {
  if (a.Sq <= 8) return launch<2, NS>(a, B, stream);
  if (a.Sq <= 32) return launch<8, NS>(a, B, stream);
  return launch<16, NS>(a, B, stream);
}


// ---------------------------------------------------------------------------
// The tile instance: prefills, bf16 operands on the tensor cores
// ---------------------------------------------------------------------------
//
// Same function as the rows instance (the header above), for bf16 q and
// K/V that are bf16 or rounded to it (`kv_round`), D 16, 32, 64, 112,
// 128 or 256.
// What bounds it at the static prefill (B 8, Hq 32, Hkv 8, D 128, 1024
// causal rows over an f32 cache): the bf16 tensor cores, Q.K in one pass
// and P.V in two, about 104 us on an H100; the bytes (q, the f32 K/V
// rows, the f32 o) take about 80 us. Design:
//   * one block of 8 warps per (batch, query head, 128 query rows), 16
//     rows a warp, the m of mma.sync m16n8k16 (bf16 in, f32 sums): each
//     K/V chunk is staged and converted once for 128 rows (64-row blocks
//     of 4 warps, two an SM, ran slower on an H100:
//     benchmarks/torch_flash_tile_ablation.py). The query tile is the
//     grid's slowest index, run in reverse, so the longest causal rows
//     of every head start first;
//   * Q.K in one bf16 pass: q is bf16 and K is bf16-valued, so each
//     product is exact and the sums are f32. Up to D 128 Q's A fragments
//     stay in registers for the whole walk, read once from global memory.
//     At D 256 they would take 64 registers a thread beside o's 128, past
//     the 255 a thread can have, so Q lands once in shared memory (128
//     rows padded like the buffers, by cp.async with the first chunk) and
//     each 16-deep step reads its fragment by ldmatrix; the chunks are
//     then 32 keys, so that Q, the staging area and the buffers fit;
//   * P.V in two bf16 passes: p = hi + lo, hi = bf16(p), lo = bf16(p -
//     hi), both rounded to nearest even, so |p - hi - lo| <= 2^-17 p;
//     V is bf16-valued, so each product is exact. The Q.K accumulator
//     of keys 16j..16j+15 is the A fragment of P.V's k-step j;
//   * the online softmax in registers, in the FlashAttention-2 layout and
//     in base 2 (the scale folded with log2 e, -1e30 scaled alike): a
//     thread holds 2 rows of its warp's tile, the row max takes 2
//     shuffles in the quad, the row sum stays per thread until the end;
//   * K and V move in chunks of 64 keys (32 at D 256). cp.async lands
//     the next chunk's raw rows (f32 or bf16, zeros past Sk) in a staging
//     area while the warps compute the current chunk from bf16 buffers;
//     then the block
//     converts the staging area into the buffers (round to nearest
//     even, the reference's `ck.astype(bf16)`), read by ldmatrix (K) and
//     ldmatrix.trans (V). Buffer rows are padded by 16 bytes so that the
//     8 rows of each ldmatrix phase hit 32 distinct banks;
//   * masks: a thread keeps, for each of its rows, the keys of the
//     Pallas tiles it visits (a key outside scores -inf) and the keys it
//     keeps (causal, window, kv_len; a visited key outside scores
//     -1e30). A warp whose rows all visit and keep every key of a chunk
//     skips the test. A row that keeps some key needs only the chunks
//     that hold one: its masked keys get p = 0 exactly (or are wiped by
//     alpha = 0 at its first kept key), so the other chunks are skipped
//     with no change to the result; a row that keeps none needs every
//     visited chunk (it averages V over them). A chunk no row of the
//     block needs is not loaded; a warp none of whose rows needs it
//     skips it.
// Shared memory at D 128: 98 KB with an f32 cache; one block an SM (216
// registers a thread). At D 112 the same layout (buffer rows of 240 B
// keep the ldmatrix phases on distinct banks): 88 KB. At D 256: 163 KB
// with an f32 cache (Q 66 KB, staging 64 KB, buffers 33 KB).

namespace tile {

constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kRows = kTileWarps * 16;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // -1e30 in base 2
constexpr int kNoKey = -(1 << 30);

template <typename KVT, int D>
struct Layout {
  static constexpr bool kQShared = D > 128;     // Q in shared memory
  static constexpr int kChunk = kQShared ? 32 : 64;  // keys per chunk
  static constexpr int BS = D + 8;  // bf16 a buffer (and Q) row
  static constexpr size_t stage_bytes = sizeof(KVT) * kChunk * D;  // a tensor
  static constexpr size_t buf_bytes = sizeof(__nv_bfloat16) * kChunk * BS;
  static constexpr size_t q_bytes =
      kQShared ? sizeof(__nv_bfloat16) * kRows * BS : 0;
  static constexpr size_t smem = 2 * stage_bytes + 2 * buf_bytes + q_bytes;
};

// 4 elements global -> shared (16 bytes of f32 bypassing L1, 8 of bf16);
// `n` bytes read, the rest zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as hi + lo, each a bf16 pair (x in the low half), both rounded
// to nearest even
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// The keys that row `row` visits ([v_lo, v_hi): the keys of its Pallas
// tiles [lo, hi]) and keeps ([k_lo, k_hi)); rows past Sq visit nothing
struct RowKeys {
  int v_lo, v_hi, k_lo, k_hi;
};

__device__ __forceinline__ RowKeys row_keys(const Args& a, int row) {
  RowKeys r{0, 0, kNoKey, a.kv_len};
  if (row < a.Sq) {
    int lo, hi;
    tile_range(a, row / a.bq, lo, hi);
    if (lo <= hi) {
      r.v_lo = lo * a.bk;
      r.v_hi = (hi + 1) * a.bk;
    }
  }
  const int pos = row + a.q_offset;
  if (a.causal) {
    r.k_hi = min(r.k_hi, pos + 1);
    if (a.window > 0) r.k_lo = pos - a.window + 1;
  }
  return r;
}

// the keys the row needs, [e_lo, e_hi): those it keeps of those it
// visits, or, keeping none, all it visits (formed where used, not kept:
// registers are scarce at D 256)
__device__ __forceinline__ void needed_keys(const RowKeys& r, int& e_lo,
                                            int& e_hi) {
  e_lo = max(r.v_lo, r.k_lo);
  e_hi = min(r.v_hi, r.k_hi);
  if (e_lo >= e_hi) {
    e_lo = r.v_lo;
    e_hi = r.v_hi;
  }
}

// whether the row needs a key of the chunk of C keys at c0
template <int C>
__device__ __forceinline__ bool needs(const RowKeys& r, int c0) {
  int e_lo, e_hi;
  needed_keys(r, e_lo, e_hi);
  return e_lo < e_hi && e_lo < c0 + C && e_hi > c0;
}

// every key of the chunk of C keys at c0 visited and kept
template <int C>
__device__ __forceinline__ bool inside(const RowKeys& r, int c0) {
  return r.v_lo <= c0 && r.v_hi >= c0 + C && r.k_lo <= c0 &&
         r.k_hi >= c0 + C;
}

// the raw K and V rows of chunk c0 into the staging area, by cp.async;
// keys at or past Sk land as zeros
template <typename KVT, int D>
__device__ __forceinline__ void issue_chunk(const Args& a, long long k_base,
                                            long long v_base, int c0,
                                            KVT* ks, KVT* vs, int tid) {
  constexpr int kBytes = 4 * (int)sizeof(KVT);
  constexpr int CPR = D / 4;  // copies a row
  constexpr int N = Layout<KVT, D>::kChunk * CPR / kTileThreads;
  const KVT* k = static_cast<const KVT*>(a.k);
  const KVT* v = static_cast<const KVT*>(a.v);
#pragma unroll 4
  for (int u = 0; u < N; ++u) {
    const int i = tid + u * kTileThreads, j = i / CPR, c = (i % CPR) * 4;
    const int key = c0 + j;
    const bool in = key < a.Sk;
    const long long ko = in ? k_base + key * a.k_ss + c : 0;
    const long long vo = in ? v_base + key * a.v_ss + c : 0;
    cp_async<kBytes>(ks + j * D + c, k + ko, in ? kBytes : 0);
    cp_async<kBytes>(vs + j * D + c, v + vo, in ? kBytes : 0);
  }
}

// a staged chunk of one tensor into its bf16 buffer
template <typename KVT, int D>
__device__ __forceinline__ void convert_chunk(const KVT* st,
                                              __nv_bfloat16* buf, int tid) {
  constexpr int BS = Layout<KVT, D>::BS;
  constexpr int GPR = D / 4;  // 4-element groups a row
  constexpr int N = Layout<KVT, D>::kChunk * GPR / kTileThreads;
  // 4 loads in flight a thread (2 at D 256): o, Q and the rest hold most
  // registers
  constexpr int kInFlight = Layout<KVT, D>::kQShared ? 2 : 4;
#pragma unroll (kInFlight)
  for (int u = 0; u < N; ++u) {
    const int i = tid + u * kTileThreads, j = i / GPR, c = (i % GPR) * 4;
    uint2 out;
    if constexpr (std::is_same<KVT, float>::value) {
      const float4 x = *reinterpret_cast<const float4*>(st + j * D + c);
      out = make_uint2(bf16x2_bits(__floats2bfloat162_rn(x.x, x.y)),
                       bf16x2_bits(__floats2bfloat162_rn(x.z, x.w)));
    } else {
      out = *reinterpret_cast<const uint2*>(st + j * D + c);
    }
    *reinterpret_cast<uint2*>(buf + j * BS + c) = out;
  }
}

template <typename KVT, int D>
__global__ void __launch_bounds__(kTileThreads, 1)
flash_attention_tile_kernel(const Args a) {
  using L = Layout<KVT, D>;
  constexpr int BS = L::BS;
  constexpr int kChunk = L::kChunk;
  constexpr int NT = D / 8;       // 8-wide output tiles
  constexpr int KS = D / 16;      // 16-deep Q.K steps
  constexpr int NK = kChunk / 8;  // 8-key score tiles of a chunk
  extern __shared__ __align__(16) unsigned char tile_smem[];
  KVT* k_st = reinterpret_cast<KVT*>(tile_smem);  // [kChunk][D], raw
  KVT* v_st = k_st + kChunk * D;
  __nv_bfloat16* k_buf =                          // [kChunk][BS], bf16
      reinterpret_cast<__nv_bfloat16*>(tile_smem + 2 * L::stage_bytes);
  __nv_bfloat16* v_buf = k_buf + kChunk * BS;
  __nv_bfloat16* q_s = v_buf + kChunk * BS;      // [kRows][BS] (kQShared)

  const int b = blockIdx.y, h = blockIdx.x;
  const int hkv = h / (a.Hq / a.Hkv);
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long k_base = b * a.k_sb + hkv * a.k_sh;
  const long long v_base = b * a.v_sb + hkv * a.v_sh;

  // the block's keys, as in the rows instance: tile runs are monotone in
  // the row, so they are [first row's lo * bk, (last row's hi + 1) * bk)
  const int last = min(kRows, a.Sq - r0) - 1;
  int lo, hi;
  tile_range(a, r0 / a.bq, lo, hi);
  const int c_begin = lo * a.bk;
  tile_range(a, (r0 + last) / a.bq, lo, hi);
  const int c_end = min((hi + 1) * a.bk, a.nk * a.bk);

  const int ra = r0 + warp * 16 + gid, rb = ra + 8;  // this thread's rows
  const RowKeys ka = row_keys(a, ra), kb = row_keys(a, rb);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.q_sb + h * a.q_sh;
  // Q's A fragments in registers (up to D 128): 4-byte loads (q rows are
  // 8-byte aligned views)
  uint32_t qf[L::kQShared ? 1 : KS][4];
  if constexpr (!L::kQShared) {
    const __nv_bfloat16* qa = q + ra * a.q_ss;
    const __nv_bfloat16* qb = qa + 8 * a.q_ss;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 16 * kk + 2 * tig;
      qf[kk][0] = ra < a.Sq ? *reinterpret_cast<const uint32_t*>(qa + c) : 0u;
      qf[kk][1] = rb < a.Sq ? *reinterpret_cast<const uint32_t*>(qb + c) : 0u;
      qf[kk][2] =
          ra < a.Sq ? *reinterpret_cast<const uint32_t*>(qa + c + 8) : 0u;
      qf[kk][3] =
          rb < a.Sq ? *reinterpret_cast<const uint32_t*>(qb + c + 8) : 0u;
    }
  }

  // this lane's ldmatrix row addresses: matrix mi = lane / 8, row lane % 8;
  // K: keys 8 (mi / 2) + row, dims 8 (mi % 2); V: keys 8 (mi % 2) + row,
  // dims 8 (mi / 2); Q (kQShared): rows 8 (mi % 2) + row of the warp's
  // 16, dims 8 (mi / 2), the A fragment's order
  const int mi = lane / 8, mr = lane % 8;
  const uint32_t k_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(k_buf)) +
      2u * ((8 * (mi / 2) + mr) * BS + 8 * (mi % 2));
  const uint32_t v_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(v_buf)) +
      2u * ((8 * (mi % 2) + mr) * BS + 8 * (mi / 2));
  const uint32_t q_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(q_s)) +
      2u * ((warp * 16 + 8 * (mi % 2) + mr) * BS + 8 * (mi / 2));

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf2, kNegInf2};
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums
  const float scale2 = a.scale * kLog2e;

  // the next chunk a row of the block needs after c (c_end: none), a
  // barrier per chunk tried; each thread tests its two rows
  auto next_needed = [&](int c) {
    bool more;
    do {
      c += kChunk;
      more = __syncthreads_or(
          c < c_end && (needs<kChunk>(ka, c) || needs<kChunk>(kb, c)));
    } while (!more && c < c_end);
    return more ? c : c_end;
  };
  int c0 = next_needed(c_begin - kChunk);
  if constexpr (L::kQShared) {
    // Q's rows into shared memory, zeros past Sq, landing with the first
    // chunk (8-byte copies: q rows are 8-byte aligned views)
    constexpr int GPR = D / 4;
#pragma unroll 4
    for (int i = tid; i < kRows * GPR; i += kTileThreads) {
      const int r = i / GPR, c = (i % GPR) * 4;
      const bool in = r0 + r < a.Sq;
      cp_async<8>(q_s + r * BS + c, q + (in ? (r0 + r) * a.q_ss + c : 0),
                  in ? 8 : 0);
    }
  }
  if (c0 < c_end) issue_chunk<KVT, D>(a, k_base, v_base, c0, k_st, v_st, tid);
  cp_async_commit();

  while (c0 < c_end) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 (and Q) landed; no warp reads the buffers
    convert_chunk<KVT, D>(k_st, k_buf, tid);
    convert_chunk<KVT, D>(v_st, v_buf, tid);
    // the search's first barrier also orders the conversion before the
    // reads of the buffers, and the reads of the staging area before the
    // next chunk's copies
    const int c1 = next_needed(c0);
    if (c1 < c_end)
      issue_chunk<KVT, D>(a, k_base, v_base, c1, k_st, v_st, tid);
    cp_async_commit();

    if (__any_sync(0xffffffffu,
                   needs<kChunk>(ka, c0) || needs<kChunk>(kb, c0))) {
      const bool full = __all_sync(
          0xffffffffu, inside<kChunk>(ka, c0) && inside<kChunk>(kb, c0));

      // S = Q . K^T over the chunk: NK tiles of 8 keys
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // a 16-deep step of Q.K with Q's A fragment qk
      auto qk_step = [&](int kk, const uint32_t (&qk)[4]) {
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(k_addr + 2u * (16 * np * BS + 16 * kk), kf);
          mma_bf16(s[2 * np], qk, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qk, kf[2], kf[3]);
        }
      };
      if constexpr (L::kQShared) {
        // unrolled by 8: in full (or by 2 or 4), ptxas spills beside o's
        // 128 registers a thread; by 8 it keeps all in 255
#pragma unroll 8
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qk[4];
          ldmatrix_x4(q_addr + 32u * kk, qk);
          qk_step(kk, qk);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) qk_step(kk, qf[kk]);
      }

      // scale and mask, then the online softmax of rows ra (entries 0, 1
      // of each tile) and rb (entries 2, 3); s becomes P
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (!full) {
            const RowKeys& r = e < 2 ? ka : kb;
            const int c = c0 + 8 * n + 2 * tig + (e & 1);
            x = c >= r.v_lo && c < r.v_hi
                    ? (c >= r.k_lo && c < r.k_hi ? x : kNegInf2)
                    : -INFINITY;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m[e / 2]);
          sum[e / 2] += s[n][e];
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

      // O += P . V in two passes, P = hi + lo; k-step j is keys 16j..16j+15
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t ph[4], pl[4];
        split_pair(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
        split_pair(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
        split_pair(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
        split_pair(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(v_addr + 2u * (16 * j * BS + 16 * np), vf);
          mma_bf16(o[2 * np], ph, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(o[2 * np], pl, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    c0 = c1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? ra : rb;
    if (row >= a.Sq) continue;
    float* dst = a.o + b * a.o_sb + h * a.o_sh + row * a.o_ss + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(o[nt][2 * i] / l[i], o[nt][2 * i + 1] / l[i]);
    if (tig == 0) {
      const RowKeys& r = i == 0 ? ka : kb;
      const long long idx = ((long long)b * a.Hq + h) * a.Sq + row;
      a.lse[idx] = m[i] * kLn2 + logf(l[i]);
      a.nvis[idx] = (float)((r.v_hi - r.v_lo) / a.bk);
    }
  }
}

template <typename KVT, int D>
cudaError_t launch_tile(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_attention_tile_kernel<KVT, D>;
  constexpr size_t smem = Layout<KVT, D>::smem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // the query tile slowest, so that the heaviest tiles of every head
  // start first
  dim3 grid(a.Hq, B, (a.Sq + kRows - 1) / kRows);
  kernel<<<grid, kTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename KVT>
cudaError_t dispatch_tile(const Args& a, int B, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_tile<KVT, 16>(a, B, stream);
    case 32: return launch_tile<KVT, 32>(a, B, stream);
    case 64: return launch_tile<KVT, 64>(a, B, stream);
    case 112: return launch_tile<KVT, 112>(a, B, stream);
    case 128: return launch_tile<KVT, 128>(a, B, stream);
    case 256: return launch_tile<KVT, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tile


// ---------------------------------------------------------------------------
// The rows instance's split path: decode steps, few rows per kv head
// ---------------------------------------------------------------------------
//
// Same function as the rows instance (the header above), for calls of
// R = G * Sq <= 16 query rows per (batch, kv head) (R <= 8 at D > 128):
// every decode step of the static path. What bounds it: the cache's
// bytes, each K/V row up to kv_len read once (f32: about R / 2 FLOP a
// byte). The walk of many rows has a block per query head, so it reads
// each K/V row G times; this path reads it once for all G. Design
// (flash-decoding, a split over keys):
//   * grid (n_splits, Hkv, B): a block holds all R rows of one (batch, kv
//     head), row = position * G + head-in-group. Its keys are the union
//     of its rows' needed keys, as the tile instance counts them (a row
//     that keeps a visited key needs the keys it keeps, one that keeps
//     none all it visits); it walks the i-th of n_splits equal parts of
//     them, rounded up to 32 keys. A key scores as in the walk: -1e30
//     where a visited tile's mask drops it, -inf outside the row's
//     visited tiles, so a part never turns an unvisited key into a
//     visited one; keys the block skips are, for every row, masked ones
//     beside a kept key (weight exactly 0) or unvisited;
//   * warps split keys, not rows: warp w takes chunks w, w + 4, ... of 8
//     keys and keeps (m, l, o) of every row in registers; lane j + 8 u
//     scores key j over the quarter u of D, the quarters add by 2
//     shuffles; P.V splits D over the lanes (column lane + 32 c);
//   * each warp's chunks land in a ring of 3 stages by cp.async (4
//     elements a copy: 16 bytes of f32, 8 of bf16; element strides, so
//     the static cache is read in place; zeros past the part and past
//     Sk), two chunks in flight while one is scored; K/V are rounded to
//     bf16 in registers where `kv_round` asks;
//   * the warps merge in shared memory, in order. With one split the
//     block writes o, lse and nvis; else its partial (m, l, unnormalised
//     o), and flash_attention_merge_kernel, one warp an output row, adds
//     the splits in order 0..n-1 (the same bits every run): M = max m_i,
//     L = sum l_i e^(m_i - M), o = sum o_i e^(m_i - M) / max(L, 1e-30),
//     lse = M + log(max(L, 1e-30)); nvis is the row's visited tiles. A
//     part of masked keys only gives (-1e30, its key count) and weighs 0
//     beside a kept key, 1 beside other such parts; a part of unvisited
//     keys only, or an empty one, gives (-1e30, 0) and adds nothing.

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 8;      // keys a warp stage; lane = key + 8 * quarter
constexpr int kStages = 3;    // depth of each warp's ring
constexpr int kMaxRows = 16;
constexpr int kRound = 32;    // a part's length is a multiple of this

// K row stride (elements): D padded to an odd number of 4-element groups
__host__ __device__ __forceinline__ int k_stride(int D) {
  return (D / 4) % 2 == 0 ? D + 4 : D + 8;
}

template <typename KVT>
size_t smem_bytes(int rm, int D) {
  return sizeof(KVT) * kWarps * kStages * kKeys * (k_stride(D) + D) +
         sizeof(float) * ((size_t)rm * D + (size_t)kWarps * rm * kKeys);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// RM: rows a block keeps state for (R <= RM); DV: output columns a lane
// owns (D <= 32 * DV). `part` holds the partials when gridDim.x > 1.
template <typename KVT, int RM, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_split_kernel(const Args a, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int D = a.D, KS = k_stride(D);
  const int stage = kKeys * (KS + D);  // elements: K rows, then V rows
  KVT* ring = reinterpret_cast<KVT*>(split_smem);  // [warp][stage]
  float* q_s = reinterpret_cast<float*>(ring + kWarps * kStages * stage);
  float* p_s = q_s + RM * D;            // [warp][RM][kKeys]
  __shared__ tile::RowKeys rk_s[RM];

  const int n_split = gridDim.x, split = blockIdx.x;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv, R = G * a.Sq;
  const int rows_total = gridDim.z * a.Hkv * R;
  const int row0 = (b * a.Hkv + hkv) * R;  // the block's first partial row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = lane % kKeys, quarter = lane / kKeys;

  // rows past R take the last row's query position (their state is never
  // written)
  if (threadIdx.x < RM)
    rk_s[threadIdx.x] = tile::row_keys(a, min((int)threadIdx.x, R - 1) / G);
  __syncthreads();

  // the block's keys [w0, w1), then this block's part of them
  int w0 = 1 << 30, w1 = 0;
  for (int r = 0; r < R; r += G) {  // one row a query position
    int e_lo, e_hi;
    tile::needed_keys(rk_s[r], e_lo, e_hi);
    if (e_lo < e_hi) {
      w0 = min(w0, e_lo);
      w1 = max(w1, e_hi);
    }
  }
  w0 = min(w0, w1);  // no row needs a key: an empty walk
  const int len = w1 > w0 ? ((w1 - w0 + n_split - 1) / n_split + kRound -
                             1) / kRound * kRound
                          : 0;
  const int p0 = w0 + split * len;
  const int p1 = min(p0 + len, w1);
  float* ml = part + (size_t)n_split * rows_total * D;  // [split][row][2]
  if (n_split > 1 && p0 >= p1) {  // an empty part: keeps nothing
    if (threadIdx.x < R) {
      float* dst = ml + ((size_t)split * rows_total + row0 + threadIdx.x) * 2;
      dst[0] = kNegInf;
      dst[1] = 0.f;
    }
    return;
  }

  // this warp's chunks of the part, through its own ring
  const int n_chunks = p1 > p0 ? (p1 - p0 + kKeys - 1) / kKeys : 0;
  const int n_mine =
      n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  KVT* my_ring = ring + warp * kStages * stage;
  const KVT* K = static_cast<const KVT*>(a.k);
  const KVT* V = static_cast<const KVT*>(a.v);
  const long long k_base = b * a.k_sb + hkv * a.k_sh;
  const long long v_base = b * a.v_sb + hkv * a.v_sh;
  const int G4 = D / 4;
  auto key_of = [&](int c) { return p0 + (warp + kWarps * c) * kKeys + key; };
  auto issue = [&](int c) {
    const int t = key_of(c);
    const bool in = t < p1 && t < a.Sk;
    const KVT* ksrc = K + (in ? k_base + t * a.k_ss : 0);
    const KVT* vsrc = V + (in ? v_base + t * a.v_ss : 0);
    KVT* kd = my_ring + (c % kStages) * stage + key * KS;
    KVT* vd = my_ring + (c % kStages) * stage + kKeys * KS + key * D;
    for (int g = quarter; g < G4; g += 4) {
      cp_async4(kd + 4 * g, ksrc + 4 * g, in);
      cp_async4(vd + 4 * g, vsrc + 4 * g, in);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_mine) issue(c);
    tile::cp_async_commit();
  }

  // q in f32, zero past R, read while the first chunks land
  for (int i = threadIdx.x; i < RM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < R) {
      const long long off = b * a.q_sb + (hkv * G + r % G) * a.q_sh +
                            (r / G) * a.q_ss + d;
      x = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
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
    if (j + kStages - 1 < n_mine) issue(j + kStages - 1);
    tile::cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of chunk j landed

    const KVT* ks = my_ring + (j % kStages) * stage;
    const KVT* vs = ks + kKeys * KS;
    const int t = key_of(j);
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    for (int g = quarter; g < G4; g += 4) {
      float4 kk = load4(ks + key * KS + 4 * g);
      if (a.kv_round)
        kk = make_float4(round_bf16(kk.x), round_bf16(kk.y),
                         round_bf16(kk.z), round_bf16(kk.w));
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + r * D + 4 * g);
        acc[r] = fmaf(qq.x, kk.x, acc[r]);
        acc[r] = fmaf(qq.y, kk.y, acc[r]);
        acc[r] = fmaf(qq.z, kk.z, acc[r]);
        acc[r] = fmaf(qq.w, kk.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
      const tile::RowKeys& k = rk_s[r];
      // keys past the part, or outside the row's visited tiles, count
      // for nothing
      const bool visited = t < p1 && t >= k.v_lo && t < k.v_hi;
      const bool keep = t >= k.k_lo && t < k.k_hi;
      const float sc =
          visited ? (keep ? acc[r] * a.scale : kNegInf) : -INFINITY;
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float pr = expf(sc - m_new);
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
          float x = d < D ? to_f32(vs[(4 * j4 + jj) * D + d]) : 0.f;
          if (a.kv_round) x = round_bf16(x);
          vv[jj][c] = x;
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
  tile::cp_async_wait_all();
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
  }

  // the warps' states into warp 0, in order, through the free rings:
  // [warp - 1][RM][D + 2]
  const int MS = D + 2;
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
        if (d < D) dst[r * MS + d] = o[r][c];
      }
      if (lane == 0) {
        dst[r * MS + D] = m[r];
        dst[r * MS + D + 1] = l[r];
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
      const float m2 = src[r * MS + D];
      const float mm = fmaxf(m[r], m2);
      const float a0 = expf(m[r] - mm), a1 = expf(m2 - mm);
      l[r] = l[r] * a0 + src[r * MS + D + 1] * a1;
      m[r] = mm;
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[r][c] = o[r][c] * a0 + a1 * src[r * MS + d];
      }
    }
  }

  // one split: o, lse and nvis; else the partial (m, l, unnormalised o)
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r >= R) break;
    const int s = r / G, h = hkv * G + r % G;
    float* dst;
    float li = 1.f;
    if (n_split == 1) {
      li = fmaxf(l[r], 1e-30f);
      dst = a.o + b * a.o_sb + h * a.o_sh + s * a.o_ss;
      if (lane == 0) {
        const long long idx = ((long long)b * a.Hq + h) * a.Sq + s;
        a.lse[idx] = m[r] + logf(li);
        a.nvis[idx] = (float)((rk_s[r].v_hi - rk_s[r].v_lo) / a.bk);
      }
    } else {
      const size_t idx = (size_t)split * rows_total + row0 + r;
      dst = part + idx * D;
      if (lane == 0) {
        ml[idx * 2] = m[r];
        ml[idx * 2 + 1] = l[r];
      }
    }
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = o[r][c] / li;
    }
  }
}

// the n_split partials of each output row, one warp a row: rows_total =
// B * Hkv * R rows in (batch, kv head, row) order
template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_merge_kernel(const Args a, const float* __restrict__ part,
                             int n_split, int rows_total) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_total) return;
  const int D = a.D, G = a.Hq / a.Hkv, R = G * a.Sq;
  const int b = row / (a.Hkv * R), hkv = row / R % a.Hkv, r = row % R;
  const int s = r / G, h = hkv * G + r % G;
  const float* ml = part + (size_t)n_split * rows_total * D;
  float M = kNegInf;
  for (int i = 0; i < n_split; ++i)
    M = fmaxf(M, ml[((size_t)i * rows_total + row) * 2]);
  float L = 0.f, o[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) o[c] = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const size_t idx = (size_t)i * rows_total + row;
    const float li = ml[idx * 2 + 1];
    if (li == 0.f) continue;  // nothing kept or visited: o never written
    const float w = expf(ml[idx * 2] - M);
    L += li * w;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[c] = fmaf(w, part[idx * D + d], o[c]);
    }
  }
  L = fmaxf(L, 1e-30f);
  float* dst = a.o + b * a.o_sb + h * a.o_sh + s * a.o_ss;
#pragma unroll
  for (int c = 0; c < DV; ++c) {
    const int d = lane + 32 * c;
    if (d < D) dst[d] = o[c] / L;
  }
  if (lane == 0) {
    const tile::RowKeys k = tile::row_keys(a, s);
    const long long idx = ((long long)b * a.Hq + h) * a.Sq + s;
    a.lse[idx] = M + logf(L);
    a.nvis[idx] = (float)((k.v_hi - k.v_lo) / a.bk);
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
cudaError_t launch(const Args& a, int B, float* part, int n_split,
                   cudaStream_t stream) {
  auto kernel = flash_attention_split_kernel<KVT, RM, DV>;
  static size_t allowed[kMaxDevices];  // this instance's opt-in, per device
  const size_t smem = smem_bytes<KVT>(RM, a.D);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, a.Hkv, B), kThreads, smem, stream>>>(a, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int rows_total = B * a.Hq * a.Sq;
  flash_attention_merge_kernel<DV>
      <<<(rows_total + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          a, part, n_split, rows_total);
  return cudaGetLastError();
}

// RM from the rows R (1, 4, 8 or 16), DV from D (2, 4 or 8; R <= 8 at DV
// 8, which the entry checks)
template <typename KVT>
cudaError_t dispatch(const Args& a, int B, float* part, int n_split,
                     cudaStream_t stream) {
  const int R = a.Hq / a.Hkv * a.Sq;
  const int dv = a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
#define FA_SPLIT(RM, DV) return launch<KVT, RM, DV>(a, B, part, n_split, stream)
#define FA_SPLIT_DV(RM)        \
  if (dv == 2) FA_SPLIT(RM, 2); \
  if (dv == 4) FA_SPLIT(RM, 4); \
  FA_SPLIT(RM, 8)
  if (R == 1) { FA_SPLIT_DV(1); }
  if (R <= 4) { FA_SPLIT_DV(4); }
  if (R <= 8) { FA_SPLIT_DV(8); }
  if (dv == 2) FA_SPLIT(16, 2);
  FA_SPLIT(16, 4);
#undef FA_SPLIT_DV
#undef FA_SPLIT
}

}  // namespace split

}  // namespace

// The C entry's arguments, one block: the wrapper mirrors it as a
// ctypes.Structure (`_Args` in flash_attention.py), fills the sizes,
// strides and masks once per call signature and writes only the pointers
// and the stream per call. `flash_attention_launch_args_bytes` gives its
// size, which the wrapper holds against its mirror's when it loads the
// library.
//
// q: (B, Hq, Sq, D), k and v: (B, Hkv, Sk, D), o: (B, Hq, Sq, D) f32,
// each given by its element strides over (batch, head, position) with
// unit stride over D, 16-byte (f32) or 8-byte (bf16) aligned rows; lse
// and nvis: contiguous (B, Hq, Sq) f32. q_bf16 / kv_bf16 select the input
// types, kv_round rounds f32 K/V to bf16. window <= 0 means none; 0 <=
// kv_len <= Sk. variant: 0 the rows instance, 1 the tile instance (bf16
// q, K/V bf16 or rounded to it, D 16, 32, 64, 112, 128 or 256). n_splits
// (rows instance only): 0 its walk of many rows; n >= 1 its split path
// over n parts of the keys (Hq / Hkv * Sq <= 16, and <= 8 at D > 128),
// with `part` a float workspace of n * B * Hq * Sq * (D + 2) when n > 1.
// The kernels launch on `stream`.
struct FlashAttentionArgs {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* lse;
  float* nvis;
  float* part;
  void* stream;
  int B;
  int Hq;
  int Hkv;
  int Sq;
  int Sk;
  int D;
  long long q_sb;
  long long q_sh;
  long long q_ss;
  long long k_sb;
  long long k_sh;
  long long k_ss;
  long long v_sb;
  long long v_sh;
  long long v_ss;
  long long o_sb;
  long long o_sh;
  long long o_ss;
  int causal;
  int window;
  int kv_len;
  int q_offset;
  int bq;
  int bk;
  float scale;
  int q_bf16;
  int kv_bf16;
  int kv_round;
  int variant;
  int n_splits;
};

extern "C" int flash_attention_launch_args_bytes() {
  return (int)sizeof(FlashAttentionArgs);
}

// C entry point, loaded with ctypes: launches the call `args` describes
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int flash_attention_launch(const FlashAttentionArgs* args) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const FlashAttentionArgs& c = *args;
  const int B = c.B, Hq = c.Hq, Hkv = c.Hkv, Sq = c.Sq, Sk = c.Sk, D = c.D,
            bq = c.bq, bk = c.bk, kv_len = c.kv_len, variant = c.variant,
            n_splits = c.n_splits;
  float* part = c.part;
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || D < 4 ||
      D % 4 != 0 || D > kMaxHeadDim || bq < 1 || bk < 1 || kv_len < 0 ||
      kv_len > Sk || (variant != 0 && variant != 1) || n_splits < 0 ||
      (variant == 1 && n_splits != 0))
    return (int)cudaErrorInvalidValue;
  Args a{c.q,      c.k,      c.v,        c.o,    c.lse,  c.nvis,
         Hq,       Hkv,      Sq,         Sk,     D,      c.q_sb,
         c.q_sh,   c.q_ss,   c.k_sb,     c.k_sh, c.k_ss, c.v_sb,
         c.v_sh,   c.v_ss,   c.o_sb,     c.o_sh, c.o_ss, c.causal,
         c.window, kv_len,   c.q_offset, bq,     bk,     (Sk + bk - 1) / bk,
         c.scale,  c.q_bf16, c.kv_bf16,  c.kv_round};
  const int q_bf16 = c.q_bf16, kv_bf16 = c.kv_bf16, kv_round = c.kv_round;
  cudaStream_t st = static_cast<cudaStream_t>(c.stream);
  if (n_splits > 0) {
    const int R = Hq / Hkv * Sq;
    if (R > split::kMaxRows || (R > 8 && D > 128) ||
        (n_splits > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    cudaError_t err =
        kv_bf16 ? split::dispatch<__nv_bfloat16>(a, B, part, n_splits, st)
                : split::dispatch<float>(a, B, part, n_splits, st);
    return (int)err;
  }
  if (variant == 1) {
    if (!q_bf16 || !(kv_bf16 || kv_round)) return (int)cudaErrorInvalidValue;
    cudaError_t err = kv_bf16 ? tile::dispatch_tile<__nv_bfloat16>(a, B, st)
                              : tile::dispatch_tile<float>(a, B, st);
    return (int)err;
  }
  cudaError_t err = D <= 128 ? dispatch_rows<1>(a, B, st)
                             : dispatch_rows<2>(a, B, st);
  return (int)err;
}
