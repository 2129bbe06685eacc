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
//   int8, artemis_mxu: the bytes of the operands at 3.35 TB/s at every
//     shape the serve paths launch: at decode (M = 8) B alone; at a
//     prefill chunk (M = 256) B too, since the int8 operations take less
//     time at the tensor cores' 1979 TOPS (13.0 us against 19.1 us of
//     bytes at K x N = 4096 x 12288). The dot runs on the int8 tensor
//     cores (mma.sync m16n8k32, fragments by ldmatrix), fed by a ring of
//     3-4 stages of 128-deep A and B tiles that cp.async lands while the
//     tensor cores work on the oldest, so at decode every SM keeps 96 KB
//     of B in flight. B is (K, N), n contiguous, and the s8 .col fragment
//     needs 4 consecutive k of a column, which ldmatrix cannot transpose
//     for bytes: ldmatrix.trans reads 16-bit column pairs of the k rows
//     4t, 4t + 1 and 4t + 2, 4t + 3, and two byte permutes split them into
//     the fragments of the even and of the odd columns, so B goes from
//     shared memory to the tensor cores once, untransposed. M pads to
//     16-row tiles at decode. Integer sums are exact in any order, so K is
//     split over blocks where that makes the waves of blocks end sooner,
//     and the partial sums meet in int32 atomics (an unsplit tile is
//     stored); either way each warp writes whole rows from a tile staged
//     in shared memory. artemis_mxu runs the bytewise signs through a
//     second accumulator (A's from a tile signed once per stage, B's from
//     its fragments) and finishes in a small epilogue kernel.
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
// Later work: wgmma with TMA and a producer warp for the dot, and an
// artemis split over K that scans the exact group sums in order.

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

// ---------------------------------------------------------------------------
// int8 / artemis_mxu: mma.sync m16n8k32 on the int8 tensor cores, operands
// streamed through a ring of cp.async stages, K split over blockIdx.z
// ---------------------------------------------------------------------------

constexpr int kKGranule = 32;  // the wrapper pads K to one mma's depth
constexpr int kNGranule = 16;  // and N to one 16-byte copy
constexpr int kTK = 128;       // k per stage: 8 chunks of 16 bytes a row
constexpr int kTN = 128;       // n per block: 8 chunks of 16 bytes a row
constexpr int kMaxDevices = 64;
// int32 row stride of the epilogue's tile in shared memory: 16 words of
// padding put rows g and g + 1 in opposite bank halves
constexpr int kOutStride = kTN + 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each); lane l
// gives the address of row l % 8 of matrix l / 8. Lane 4g + t receives
// row g, elements 2t and 2t + 1; with .trans, rows 2t and 2t + 1 of
// element column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Per-byte sign of four packed int8 (+1, 0 or -1 in each byte): prmt's
// sign-replicating selectors (0x8-0xB) give 0xFF in each negative byte;
// bit 7 of (u & 0x7F..) + 0x7F.. is set in each byte whose low 7 bits are
// not all 0, which in a byte that is not negative makes it positive.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t u) {
  uint32_t neg;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(neg) : "r"(u));
  const uint32_t low = (u & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  return neg | ((low >> 7) & 0x01010101u);
}

// Shared-memory stages, rows of 128 bytes (8 chunks of 16) as cp.async
// lands them, chunks XOR-swizzled so that no ldmatrix has a bank conflict:
//   A (BM x kTK, k contiguous): chunk c of row m at c ^ (m & 7); ldmatrix
//     reads 8 consecutive rows at one chunk.
//   B (kTK x kTN, n contiguous): chunk c of row k at c ^ b_swizzle(k);
//     ldmatrix.trans reads the 8 rows {0, 1, 4, 5, 8, 9, 12, 13} (+ 2,
//     + 16) of a 16-row group at one chunk.
// The s8 .col B fragment wants 4 consecutive k of one column in a register,
// and ldmatrix transposes only 16-bit elements. So the B stage is read
// with .trans from the rows k = 4t, 4t + 1 (one matrix) and 4t + 2, 4t + 3
// (another): lane 4g + t holds columns 2g and 2g + 1 of those rows, and
// two byte permutes give the even column's 4 consecutive k and the odd
// one's. Each 16-column chunk is thus two mma tiles, of the even and the
// odd columns; no pass over shared memory transposes B.
__device__ __forceinline__ int a_swizzle(int m) { return m & 7; }
__device__ __forceinline__ int b_swizzle(int k) {
  return (k & 1) | ((k >> 1) & 6);
}

// One block: a BM x kTN output tile over the k range of its split, WM x
// WN warps, each a (BM / WM) x (kTN / WN) tile of 16 x 8 mma tiles. Stage
// t + STAGES - 1 is copied while stage t goes to the tensor cores. kSigns
// runs the sign dot through a second accumulator: A's signs from a shared
// tile that each thread fills from the chunks it copied (once per block),
// B's from its fragments (once per warp row; the sign is bytewise, so it
// commutes with the fragment layout).
template <int BM, int WM, int WN, int STAGES, bool kSigns>
__global__ void __launch_bounds__(WM * WN * 32, kSigns && BM > 64 ? 1 : 2)
    mma_dot_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   int* __restrict__ value, int* __restrict__ sign, int M,
                   int N, int K, int k_per_split) {
  constexpr int kWarps = WM * WN, kThreads = 32 * kWarps;
  constexpr int WTM = BM / WM, WTN = kTN / WN;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;    // mma tiles per warp
  static_assert(MT >= 1 && NT % 2 == 0, "whole 16-column chunks");
  constexpr int A_BYTES = BM * kTK, B_BYTES = kTK * kTN;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static_assert(BM * kOutStride * 4 <= STAGES * STAGE_BYTES,
                "the epilogue's tile fits the stages");
  extern __shared__ __align__(128) uint8_t smem[];
  // kSigns: two A tiles after the stages hold the signs of A at stages t
  // and t - 1 (t % 2), laid out as the stage's A
  uint8_t* const sign_a = smem + STAGES * STAGE_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int tiles = (kend - kbeg + kTK - 1) / kTK;
  const uint32_t base = smem_addr(smem);

  // K and N are multiples of 32 and 16: a 16-byte chunk is all in or all out
  auto load_stage = [&](int stage, int t) {
    const int k0 = kbeg + t * kTK;
    const uint32_t as = base + stage * STAGE_BYTES, bs = as + A_BYTES;
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const int m = m0 + r, k = k0 + 16 * c;
      const bool in = m < M && k < kend;
      cp_async16(as + r * kTK + 16 * (c ^ a_swizzle(r)),
                 in ? A + (size_t)m * K + k : A, in);
    }
    for (int i = tid; i < kTK * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const int k = k0 + r, n = n0 + 16 * c;
      const bool in = k < kend && n < N;
      cp_async16(bs + r * kTN + 16 * (c ^ b_swizzle(r)),
                 in ? B + (size_t)k * N + n : B, in);
    }
  };

  int acc[MT][NT][4], sacc[kSigns ? MT : 1][kSigns ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (kSigns) sacc[i][j][e] = 0;
      }

  // this lane's ldmatrix rows: A row (m) and B row (k) within a 16 x 32
  // and a 32 x 16 fragment group, and the chunk half it reads
  const int a_row = wm * WTM + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_half = lane >> 4;
  const int b_row = 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1) +
                    16 * (lane >> 4);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load_stage(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    if constexpr (kSigns) {
      // the signs of the A chunks this thread copied, into sign tile t % 2
      // (last read at tile t - 2)
      const uint8_t* as = smem + (t % STAGES) * STAGE_BYTES;
      uint8_t* sa = sign_a + (t & 1) * A_BYTES;
      for (int i = tid; i < BM * 8; i += kThreads) {
        const int off = (i >> 3) * kTK + 16 * ((i & 7) ^ a_swizzle(i >> 3));
        const uint4 v = *reinterpret_cast<const uint4*>(as + off);
        *reinterpret_cast<uint4*>(sa + off) =
            make_uint4(sign_bytes(v.x), sign_bytes(v.y), sign_bytes(v.z),
                       sign_bytes(v.w));
      }
    }
    __syncthreads();  // everyone's landed (and signed); tile t - 1 consumed
    if (t + STAGES - 1 < tiles)
      load_stage((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();

    const uint32_t as = base + (t % STAGES) * STAGE_BYTES, bs = as + A_BYTES;
    const uint32_t sas = smem_addr(sign_a) + (t & 1) * A_BYTES;
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // a0..a3: rows +0 / +8 at chunk 2kk, then at chunk 2kk + 1
        const int r = a_row + 16 * i;
        ldmatrix_x4(as + r * kTK + 16 * ((2 * kk + a_half) ^ a_swizzle(r)),
                    a[i]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // rows 4t, 4t+1 | 4t+2, 4t+3 of k 0-15, then of k 16-31, at the
        // 16-column chunk of tiles j (even columns) and j + 1 (odd)
        const int k = 32 * kk + b_row;
        const int c = (wn * WTN + 8 * j) / 16;
        uint32_t f[4];
        ldmatrix_x4_trans(bs + k * kTN + 16 * (c ^ b_swizzle(k)), f);
        b[j][0] = __byte_perm(f[0], f[1], 0x6420);
        b[j][1] = __byte_perm(f[2], f[3], 0x6420);
        b[j + 1][0] = __byte_perm(f[0], f[1], 0x7531);
        b[j + 1][1] = __byte_perm(f[2], f[3], 0x7531);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
      if constexpr (kSigns) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = a_row + 16 * i;
          ldmatrix_x4(sas + r * kTK + 16 * ((2 * kk + a_half) ^ a_swizzle(r)),
                      a[i]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) b[j][e] = sign_bytes(b[j][e]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(sacc[i][j], a[i], b[j]);
      }
    }
  }

  // Epilogue through shared memory (the stages are free now), so that every
  // warp writes whole rows: with one split, 16-byte stores; with several,
  // int32 atomics on consecutive addresses. Fragment c0, c1 holds row g,
  // mma columns 2t, 2t + 1 and c2, c3 row g + 8; column x of tile j is
  // column 16 (j / 2) + 2x + j % 2 of the warp, so tiles 2p and 2p + 1
  // give each lane 4 consecutive columns. The value plane, then (kSigns)
  // the sign plane.
  cp_async_wait<0>();
  int* const tile = reinterpret_cast<int*>(smem);
  const bool split = gridDim.z > 1;
  auto write_plane = [&](const int (&v)[MT][NT][4], int* out) {
    __syncthreads();  // shared memory free: the last stage, or last plane
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * WTM + 16 * i + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          const int col = wn * WTN + 8 * j + 4 * (lane & 3);
          *reinterpret_cast<int4*>(tile + r * kOutStride + col) =
              make_int4(v[i][j][2 * h], v[i][j + 1][2 * h],
                        v[i][j][2 * h + 1], v[i][j + 1][2 * h + 1]);
        }
      }
    __syncthreads();
    for (int r = warp; r < BM; r += kWarps) {
      const int m = m0 + r;
      if (m >= M) break;
      int* row = out + (size_t)m * N + n0;
      const int* src = tile + r * kOutStride;
      if (!split) {  // N is a multiple of 16: 4 columns all in or all out
        if (n0 + 4 * lane < N)
          *reinterpret_cast<int4*>(row + 4 * lane) =
              *reinterpret_cast<const int4*>(src + 4 * lane);
      } else {
#pragma unroll
        for (int q = 0; q < kTN / 32; ++q)
          if (n0 + lane + 32 * q < N)
            atomicAdd(row + lane + 32 * q, src[lane + 32 * q]);
      }
    }
  };
  write_plane(acc, value);
  if constexpr (kSigns) write_plane(sacc, sign);
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

// The K split (whole stages per split) whose waves of blocks end soonest:
// a block takes its stages plus about kSplitCost stages of prologue and
// epilogue, and `slots` blocks run at once. Ties go to fewer splits (fewer
// atomics).
constexpr int kSplitCost = 2;
int choose_splits(int blocks, int tiles, int slots) {
  int best = 1, best_cost = 0;
  for (int s = 1; s <= tiles; ++s) {
    const int per = cdiv(tiles, s);
    if (cdiv(tiles, per) != s) continue;  // the same split as a smaller s
    const int cost = cdiv(blocks * s, slots) * (per + kSplitCost);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <int BM, int WM, int WN, int STAGES, bool kSigns>
cudaError_t launch_mma_dot(const int8_t* A, const int8_t* B, int* value,
                           int* sign, int M, int N, int K, int dev, int sms,
                           cudaStream_t st) {
  auto kernel = mma_dot_kernel<BM, WM, WN, STAGES, kSigns>;
  constexpr int threads = WM * WN * 32;
  constexpr int smem =
      STAGES * (BM * kTK + kTK * kTN) + (kSigns ? 2 * BM * kTK : 0);
  // set up once per device: the shared-memory opt-in, then the blocks
  // that fit one SM
  static int per_sm[kMaxDevices] = {};
  if (!per_sm[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm[dev] < 1) return cudaErrorInvalidConfiguration;
  }
  const int gm = cdiv(M, BM), gn = cdiv(N, kTN);
  const int tiles = cdiv(K, kTK);
  const int splits = choose_splits(gm * gn, tiles, per_sm[dev] * sms);
  const int k_per_split = cdiv(tiles, splits) * kTK;
  // m fastest: the blocks that share a B tile run side by side (L2)
  dim3 grid(gm, gn, cdiv(K, k_per_split));
  if (grid.z > 1) {  // the splits meet in atomics on zeros
    const cudaError_t err = cudaMemsetAsync(
        value, 0, (kSigns ? 2 : 1) * (size_t)M * N * sizeof(int), st);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(A, B, value, sign, M, N, K,
                                      k_per_split);
  return cudaGetLastError();
}

// At decode (M <= 32) 16-row tiles, 8 warps side by side over 128 columns,
// four 18 KB stages; above, 128-row tiles, 2 x 4 warps of 64 x 32, three
// 32 KB stages. Two blocks to an SM, but one for artemis_mxu above decode,
// whose two accumulators take about 200 registers a thread.
template <bool kSigns>
cudaError_t launch_int_dot(const int8_t* A, const int8_t* B, int* value,
                           int* sign, int M, int N, int K, int dev, int sms,
                           cudaStream_t st) {
  if (M <= 32)
    return launch_mma_dot<16, 1, 8, 4, kSigns>(A, B, value, sign, M, N, K,
                                               dev, sms, st);
  return launch_mma_dot<128, 2, 4, 3, kSigns>(A, B, value, sign, M, N, K, dev,
                                              sms, st);
}

}  // namespace

// C entry point, loaded with ctypes. A: (M, K) int8, B: (K, N) int8, both
// contiguous and 16-byte aligned. int8, artemis_mxu: K a multiple of 32 and N
// of 16 (whole mma depths, whole 16-byte copies); artemis: K a multiple of
// acc_depth and N of 4. out: (M, N) int32 for int8, f32 otherwise. scratch:
// 2 * M * N int32 for artemis_mxu (unused otherwise). readout_bits < 0 means
// ideal readout; levels = 2^bits - 1 and delta = acc_depth * 127 / levels
// rounded to f32 by the caller. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
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
  if ((mode != kModeInt8 && mode != kModeMxu) || K % kKGranule != 0 ||
      N % kNGranule != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  const size_t mn = (size_t)M * N;
  const bool mxu = mode == kModeMxu;
  int* value = mxu ? static_cast<int*>(scratch) : static_cast<int*>(out);
  int* sign = mxu ? value + mn : nullptr;
  if (mxu) {
    const cudaError_t err = launch_int_dot<true>(a, b, value, sign, M, N, K, dev, sms, st);
    if (err != cudaSuccess) return (int)err;
    const int blocks = mn >= 4096 * 256 ? 4096 : (int)((mn + 255) / 256);
    mxu_epilogue<<<blocks, 256, 0, st>>>(value, sign, static_cast<float*>(out),
                                         mn, rbar);
    return (int)cudaGetLastError();
  }
  return (int)launch_int_dot<false>(a, b, value, nullptr, M, N, K, dev, sms,
                                    st);
}
