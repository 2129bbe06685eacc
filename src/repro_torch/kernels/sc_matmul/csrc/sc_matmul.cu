// The ARTEMIS MAC for Hopper (sm_90a): C = A x B over pre-quantized int8
// operands, A (M, K) and B (K, N) row-major, in three modes.
//
// Replaces repro/kernels/sc_matmul/sc_matmul.py::_sc_matmul_kernel (the
// Pallas TPU kernel, entry sc_matmul_quantized) and computes what the
// quantized core of repro/core/artemis_matmul.py computes, bit for bit:
//   int8         the exact int32 dot.
//   artemis_mxu  the value dot and the sign dot, both exact int32, then
//                (float(v) - rbar * float(s)) / 128 once on the full
//                sums (the Pallas kernel adds it block by block in f32).
//   artemis      per output and per MOMCAP group of acc_depth
//                consecutive k: the products floor(|a||b| / 128) of
//                positive and of negative sign summed exactly, each sum
//                read out to the level clamp(rint(x / delta), 0, levels)
//                with an IEEE f32 division (the Pallas kernel multiplies
//                by 1/delta), and acc + pos_level*delta - neg_level*delta
//                over the groups in order, in f32, with both products
//                fused into their add and subtract, as XLA compiles the
//                reference's scan body: acc = fma(-neg_level, delta,
//                fma(pos_level, delta, acc)). readout_bits < 0 reads out
//                ideally: acc = (acc + pos) - neg.
// Built without fast math, and every rounding step is an explicit _rn
// intrinsic, so nvcc neither fuses nor splits what the reference does.
//
// What bounds it on an H100, and what the design does about it:
//   int8, artemis_mxu: at decode (M = 8) the bytes of B (K * N) at
//     3.35 TB/s; at a prefill chunk (M = 256) the int8 operations, which
//     tensor cores would run at 1979 TOPS. This first version runs them
//     on the CUDA cores with __dp4a (4 int8 products per instruction)
//     from shared-memory tiles, B transposed into k-words as it is
//     loaded. Integer sums are exact in any order, so K is split over
//     blocks until the grid fills the card, and the partial sums meet
//     in int32 atomics; artemis_mxu finishes in a small epilogue kernel.
//   artemis: instruction issue. Every product is a multiply, a floor
//     and a signed accumulate that no tensor core does. Two columns
//     share one 32-bit register in 16-bit lanes, so one IMAD forms two
//     products; a shift and a mask floor both; one LOP3 against the
//     sign masks routes the negative ones: 3 integer instructions per
//     product. The group readout is a lookup in a shared-memory table
//     of the levels of all acc_depth * 127 + 1 possible sums, built once
//     per block with the exact f32 arithmetic. The f32 group scan is sequential
//     per output, so K cannot be split: small grids (decode) take small
//     tiles for more blocks.
// wgmma/mma.sync int8 tensor cores, TMA and pipelined loads, and an
// artemis split over K that scans the exact group sums in order later,
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kModeInt8 = 0;
constexpr int kModeMxu = 1;
constexpr int kModeArtemis = 2;
constexpr int kBK = 32;                      // k per shared-memory tile
constexpr int kMaxAccDepth = 128;            // 16-bit lanes, table size
constexpr uint32_t kLaneMask = 0x007F007Fu;  // one product per 16-bit lane

// T consecutive 32-bit words from shared memory (16-byte aligned when T
// is a multiple of 4, 8-byte aligned when it is even).
template <int T, typename W>
__device__ __forceinline__ void load_words(const W* p, W* out) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      out[i] = (W)v.x;
      out[i + 1] = (W)v.y;
      out[i + 2] = (W)v.z;
      out[i + 3] = (W)v.w;
    }
  } else if constexpr (T % 2 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      out[i] = (W)v.x;
      out[i + 1] = (W)v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) out[i] = p[i];
  }
}

// Per-byte sign of four packed int8: +1, 0 or -1 in each byte.
__device__ __forceinline__ int sign4(int w) {
  const unsigned gt = __vcmpgts4((unsigned)w, 0u);  // 0xff where > 0
  const unsigned lt = __vcmplts4((unsigned)w, 0u);  // 0xff where < 0
  return (int)__vsub4(lt, gt);
}

// ---------------------------------------------------------------------------
// int8 / artemis_mxu: __dp4a over k-words, K split over blockIdx.z
// ---------------------------------------------------------------------------

template <int BM, int BN, int TM, int TN, bool kSigns>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    dot_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int* __restrict__ value, int* __restrict__ sign, int M, int N,
               int K, int k_per_split) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int W = kBK / 4;  // k-words per tile
  __shared__ __align__(16) int As[W][BM];  // word w of row m: a[m][4w..4w+3]
  __shared__ __align__(16) int Bs[W][BN];  // word w of col n: b[4w..4w+3][n]
  __shared__ __align__(16) int Sa[kSigns ? W : 1][kSigns ? BM : 4];
  __shared__ __align__(16) int Sb[kSigns ? W : 1][kSigns ? BN : 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  int acc[TM][TN], sacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = sacc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int i = tid; i < BM * W; i += NT) {
      const int r = i / W, w = i % W;
      const int m = m0 + r, k = k0 + 4 * w;
      int v = 0;
      if (m < M && k < kend)
        v = __ldg(reinterpret_cast<const int*>(A + (size_t)m * K + k));
      As[w][r] = v;
      if constexpr (kSigns) Sa[w][r] = sign4(v);
    }
    for (int i = tid; i < W * (BN / 4); i += NT) {
      const int w = i / (BN / 4), c = i % (BN / 4);
      const int k = k0 + 4 * w, n = n0 + 4 * c;
      int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
      if (n < N && k < kend) {  // K and N are multiples of 4
        const int8_t* p = B + (size_t)k * N + n;
        r0 = __ldg(reinterpret_cast<const int*>(p));
        r1 = __ldg(reinterpret_cast<const int*>(p + N));
        r2 = __ldg(reinterpret_cast<const int*>(p + 2 * (size_t)N));
        r3 = __ldg(reinterpret_cast<const int*>(p + 3 * (size_t)N));
      }
      // 4x4 byte transpose: word j holds column n + j of rows k..k+3
      const int t0 = __byte_perm(r0, r1, 0x5140);
      const int t1 = __byte_perm(r0, r1, 0x7362);
      const int t2 = __byte_perm(r2, r3, 0x5140);
      const int t3 = __byte_perm(r2, r3, 0x7362);
      const int o[4] = {(int)__byte_perm(t0, t2, 0x5410),
                        (int)__byte_perm(t0, t2, 0x7632),
                        (int)__byte_perm(t1, t3, 0x5410),
                        (int)__byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Bs[w][4 * c + j] = o[j];
        if constexpr (kSigns) Sb[w][4 * c + j] = sign4(o[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int a[TM], b[TN];
      load_words<TM>(&As[w][ty * TM], a);
      load_words<TN>(&Bs[w][tx * TN], b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      if constexpr (kSigns) {
        load_words<TM>(&Sa[w][ty * TM], a);
        load_words<TN>(&Sb[w][tx * TN], b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            sacc[i][j] = __dp4a(a[i], b[j], sacc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      atomicAdd(value + (size_t)m * N + n, acc[i][j]);
      if constexpr (kSigns) atomicAdd(sign + (size_t)m * N + n, sacc[i][j]);
    }
  }
}

__global__ void mxu_epilogue(const int* __restrict__ value,
                             const int* __restrict__ sign,
                             float* __restrict__ out, size_t n, float rbar) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = __int2float_rn(value[i]);
    const float s = __int2float_rn(sign[i]);
    // (v - rbar * s) / 128; the division by 2^7 is exact
    out[i] = __fmul_rn(__fsub_rn(v, __fmul_rn(rbar, s)), 0.0078125f);
  }
}

// ---------------------------------------------------------------------------
// artemis: MOMCAP groups on the CUDA cores
// ---------------------------------------------------------------------------

// One group's NSC step: acc + pos_r - neg_r (levels times delta, fused).
__device__ __forceinline__ float readout_step(float acc, float pos, float neg,
                                              float delta, bool ideal) {
  if (ideal) return __fsub_rn(__fadd_rn(acc, pos), neg);
  return __fmaf_rn(-neg, delta, __fmaf_rn(pos, delta, acc));
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    artemis_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   float* __restrict__ out, int M, int N, int K,
                   int acc_depth, int readout_bits, float levels,
                   float delta) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int BP = BN / 2, TP = TN / 2;  // column pairs: block, thread
  __shared__ __align__(16) uint32_t Am[kBK][BM];  // |a|
  __shared__ __align__(16) uint32_t An[kBK][BM];  // kLaneMask where a < 0
  __shared__ __align__(16) uint32_t Bm[kBK][BP];  // |b0| | |b1| << 16
  __shared__ __align__(16) uint32_t Bn[kBK][BP];  // 0x7f per lane with b < 0
  extern __shared__ float table[];  // level of each group sum 0..full scale

  const int tid = threadIdx.x;
  const int full_scale = acc_depth * 127;
  const bool ideal = readout_bits < 0;
  for (int x = tid; x <= full_scale; x += NT) {
    const float v = __int2float_rn(x);
    table[x] = ideal ? v
                     : fminf(fmaxf(rintf(__fdiv_rn(v, delta)), 0.0f), levels);
  }  // published by the first tile's __syncthreads

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // per column pair, two 16-bit lanes: the group's sum of all products
  // and of the negative ones (positive = all - negative)
  uint32_t tot[TM][TP], neg[TM][TP];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TP; ++j) tot[i][j] = neg[i][j] = 0u;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  int left = acc_depth;  // products left in the current group
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += NT) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      const int a = (m < M && k < K) ? (int)A[(size_t)m * K + k] : 0;
      Am[kk][r] = (uint32_t)abs(a);
      An[kk][r] = a < 0 ? kLaneMask : 0u;
    }
    for (int i = tid; i < kBK * BP; i += NT) {
      const int kk = i / BP, p = i % BP;
      const int k = k0 + kk, n = n0 + 2 * p;
      int b0 = 0, b1 = 0;
      if (k < K && n < N) {  // N is even
        const char2 v = *reinterpret_cast<const char2*>(B + (size_t)k * N + n);
        b0 = v.x;
        b1 = v.y;
      }
      Bm[kk][p] = (uint32_t)abs(b0) | ((uint32_t)abs(b1) << 16);
      Bn[kk][p] = (b0 < 0 ? 0x7Fu : 0u) | (b1 < 0 ? 0x7F0000u : 0u);
    }
    __syncthreads();
    const int kt = min(kBK, K - k0);
    for (int kk = 0; kk < kt; ++kk) {
      uint32_t am[TM], an[TM], bm[TP], bn[TP];
      load_words<TM>(&Am[kk][ty * TM], am);
      load_words<TM>(&An[kk][ty * TM], an);
      load_words<TP>(&Bm[kk][tx * TP], bm);
      load_words<TP>(&Bn[kk][tx * TP], bn);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          // two products, 14 bits each, in their lanes; >> 7 floors both
          // (the low lane takes 7 stray bits of the high one, masked off)
          const uint32_t y = (am[i] * bm[j]) >> 7;
          tot[i][j] += y & kLaneMask;
          neg[i][j] += y & (an[i] ^ bn[j]);
        }
      if (--left == 0) {  // the group is complete: read it out
        left = acc_depth;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) {
            const uint32_t n_lo = neg[i][j] & 0xFFFFu, n_hi = neg[i][j] >> 16;
            const uint32_t p_lo = (tot[i][j] & 0xFFFFu) - n_lo;
            const uint32_t p_hi = (tot[i][j] >> 16) - n_hi;
            acc[i][2 * j] = readout_step(acc[i][2 * j], table[p_lo],
                                         table[n_lo], delta, ideal);
            acc[i][2 * j + 1] = readout_step(acc[i][2 * j + 1], table[p_hi],
                                             table[n_hi], delta, ideal);
            tot[i][j] = neg[i][j] = 0u;
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }
int clamp_int(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

template <int BM, int BN, int TM, int TN>
cudaError_t launch_artemis(const int8_t* A, const int8_t* B, float* out,
                           int M, int N, int K, int acc_depth,
                           int readout_bits, float levels, float delta,
                           cudaStream_t st) {
  auto kernel = artemis_kernel<BM, BN, TM, TN>;
  const int smem = (acc_depth * 127 + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(N, BN), cdiv(M, BM));
  kernel<<<grid, (BM / TM) * (BN / TN), smem, st>>>(
      A, B, out, M, N, K, acc_depth, readout_bits, levels, delta);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN, bool kSigns>
cudaError_t launch_dot(const int8_t* A, const int8_t* B, int* value,
                       int* sign, int M, int N, int K, int sms,
                       cudaStream_t st) {
  const int gx = cdiv(N, BN), gy = cdiv(M, BM);
  const int tiles = cdiv(K, kBK);
  // split K until the grid covers the card twice; splits own whole tiles
  const int splits = clamp_int(cdiv(2 * sms, gx * gy), 1, tiles);
  const int k_per_split = cdiv(tiles, splits) * kBK;
  dim3 grid(gx, gy, cdiv(K, k_per_split));
  dot_kernel<BM, BN, TM, TN, kSigns><<<grid, (BM / TM) * (BN / TN), 0, st>>>(
      A, B, value, sign, M, N, K, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. A: (M, K) int8, B: (K, N) int8, both
// contiguous and 16-byte aligned, N a multiple of 4; K a multiple of 4
// (int8, artemis_mxu) or of acc_depth (artemis). out: (M, N) int32 for
// int8, f32 otherwise. scratch: 2 * M * N int32 for artemis_mxu (unused
// otherwise). readout_bits < 0 means ideal readout; levels = 2^bits - 1
// and delta = acc_depth * 127 / levels rounded to f32 by the caller.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sc_matmul_launch(const void* A, const void* B, void* out,
                                void* scratch, int M, int N, int K, int mode,
                                int acc_depth, int readout_bits, float levels,
                                float delta, float rbar, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms();
  // the 64 x 128 tiles where they fill the card twice, else small tiles
  const bool large = cdiv(M, 64) * cdiv(N, 128) >= 2 * sms;

  if (mode == kModeArtemis) {
    if (acc_depth < 1 || acc_depth > kMaxAccDepth || K % acc_depth != 0)
      return (int)cudaErrorInvalidValue;
    float* o = static_cast<float*>(out);
    if (large)
      return (int)launch_artemis<64, 128, 8, 8>(
          a, b, o, M, N, K, acc_depth, readout_bits, levels, delta, st);
    return (int)launch_artemis<8, 32, 2, 4>(a, b, o, M, N, K, acc_depth,
                                            readout_bits, levels, delta, st);
  }
  if ((mode != kModeInt8 && mode != kModeMxu) || K % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)M * N;
  const bool mxu = mode == kModeMxu;
  int* value = mxu ? static_cast<int*>(scratch) : static_cast<int*>(out);
  int* sign = mxu ? value + mn : nullptr;
  cudaError_t err = cudaMemsetAsync(value, 0, (mxu ? 2 : 1) * mn * sizeof(int),
                                    st);
  if (err != cudaSuccess) return (int)err;
  if (mxu) {
    err = large ? launch_dot<64, 128, 8, 8, true>(a, b, value, sign, M, N, K,
                                                 sms, st)
                : launch_dot<16, 64, 4, 4, true>(a, b, value, sign, M, N, K,
                                                 sms, st);
    if (err != cudaSuccess) return (int)err;
    const int blocks = mn >= 4096 * 256 ? 4096 : (int)((mn + 255) / 256);
    mxu_epilogue<<<blocks, 256, 0, st>>>(value, sign, static_cast<float*>(out),
                                         mn, rbar);
    return (int)cudaGetLastError();
  }
  err = large ? launch_dot<64, 128, 8, 8, false>(a, b, value, nullptr, M, N, K,
                                                 sms, st)
              : launch_dot<16, 64, 4, 4, false>(a, b, value, nullptr, M, N, K,
                                                sms, st);
  return (int)err;
}
