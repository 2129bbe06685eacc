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
// What bounds it on an H100: at a prefill, f32 operations (4 * D per
// kept (query, key) pair: about 69 GFLOP for 8 x 32 heads x 1024 causal
// rows, D 128, against 67 TFLOP/s on the CUDA cores); at a decode step,
// the bytes of the cache (every K/V row up to kv_len read once, f32).
//
// Design, simple first (CUDA cores, f32; no wgmma, TMA or split-K yet):
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

}  // namespace

// C entry point, loaded with ctypes. q: (B, Hq, Sq, D), k and v:
// (B, Hkv, Sk, D), o: (B, Hq, Sq, D) f32, each given by its element
// strides over (batch, head, position) with unit stride over D, 16-byte
// (f32) or 8-byte (bf16) aligned rows; lse and nvis: contiguous
// (B, Hq, Sq) f32. q_bf16 / kv_bf16 select the input types, kv_round
// rounds f32 K/V to bf16. window <= 0 means none; 0 <= kv_len <= Sk.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, float* o, float* lse,
    float* nvis, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int kv_len, int q_offset, int bq, int bk,
    float scale, int q_bf16, int kv_bf16, int kv_round, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || D < 4 ||
      D % 4 != 0 || D > kMaxHeadDim || bq < 1 || bk < 1 || kv_len < 0 ||
      kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    o,    lse,  nvis,   Hq,     Hkv,    Sq,
         Sk,   D,    q_sb, q_sh, q_ss, k_sb,   k_sh,   k_ss,   v_sb,
         v_sh, v_ss, o_sb, o_sh, o_ss, causal, window, kv_len, q_offset,
         bq,   bk,   (Sk + bk - 1) / bk, scale, q_bf16, kv_bf16, kv_round};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = D <= 128 ? dispatch_rows<1>(a, B, st)
                             : dispatch_rows<2>(a, B, st);
  return (int)err;
}
