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
//     and a signed accumulate that no tensor core does. Two columns share
//     one 32-bit register in 16-bit lanes and A's magnitude is doubled, so
//     one IMAD forms two products, one PRMT floors both (the lanes' high
//     bytes), one LOP3 against the sign masks routes the negative ones,
//     and the sums take an IADD3 for two k of negative ones and an IMAD a
//     k of all ones: 2.25 integer instructions a product, 1.25 of them on
//     the integer ALU pipe that bounds the loop, the IMADs on the FMA pipe.
//     Each MOMCAP group's sums are exact integers, so any warp or block may
//     form any group's sums in any order: K is split over the slices
//     (warps) of a block and, at decode, over blocks, and only the readouts
//     and the f32 scan run in group order, per output. A block stages a
//     window of consecutive groups (A and B by 16-byte cp.async, the next
//     window landing while this one is in use), each slice forms one
//     group's sums, and then either the block scans the window's sums from
//     shared memory in order (M > 16), or (decode) every group's sums go
//     to scratch and a second, small kernel scans them, so that even N =
//     1024 fills the card. The readout is a lookup in a table of the
//     levels of all acc_depth * 128 + 1 possible sums, built once per
//     device by the wrapper with the exact f32 arithmetic.
// Later work: wgmma with TMA and a producer warp for the dot.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kModeInt8 = 0;
constexpr int kModeMxu = 1;
constexpr int kModeArtemis = 2;
constexpr int kMaxAccDepth = 128;  // 16-bit lanes, table size

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

// 0xFF in each negative byte of four packed int8, 0 elsewhere: prmt's
// sign-replicating selectors (0x8-0xB)
__device__ __forceinline__ uint32_t negative_bytes(uint32_t u) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(r) : "r"(u));
  return r;
}

// Per-byte sign of four packed int8 (+1, 0 or -1 in each byte): bit 7 of
// (u & 0x7F..) + 0x7F.. is set in each byte whose low 7 bits are not all
// 0, which in a byte that is not negative makes it positive.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t u) {
  const uint32_t neg = negative_bytes(u);
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
// artemis: MOMCAP groups on the CUDA cores, K split over warps and blocks
// ---------------------------------------------------------------------------

constexpr int kArtTile = 8;         // a thread's outputs: 8 rows x 8 columns
constexpr int kArtKGranule = 16;    // the wrapper pads K to 16-byte A rows
constexpr int kArtMaxWindow = 160;  // k rows a block stages per window
constexpr int kArtSplitMaxM = 16;   // M up to which the groups' sums meet
                                    // in scratch (else in shared memory)

// Two products floor(|a||b| / 128) at once. am = 2|a| (at most 256) and
// bm = |b0| | |b1| << 16 (each at most 128), so am * bm = 2|a||b0| +
// (2|a||b1| << 16) with both halves below 2^16 and no carry between them,
// and the floors are the halves' high bytes: (x >> 8) & 0x00FF00FF, one
// PRMT. Eight bits of floor hold 128 * 128 / 128 = 128.
__device__ __forceinline__ uint32_t floor_pair(uint32_t am, uint32_t bm) {
  return __byte_perm(am * bm, 0u, 0x4341);
}

// One word of B (int8 columns c..c+3 of one k) as the column pairs (c,
// c+2) and (c+1, c+3): magnitudes in 16-bit lanes, and masks that are
// 0xFF in the low byte of each lane whose column is negative.
__device__ __forceinline__ void b_pairs(uint32_t x, uint32_t& m02,
                                        uint32_t& m13, uint32_t& n02,
                                        uint32_t& n13) {
  const uint32_t s = negative_bytes(x);
  // |b| bytewise, ~b + 1 where negative: -128 gives 0x80, no carry out
  const uint32_t mag = (x ^ s) + (s & 0x01010101u);
  m02 = __byte_perm(mag, 0u, 0x4240);
  m13 = __byte_perm(mag, 0u, 0x4341);
  n02 = s;       // bytes 0 and 2: columns c and c + 2
  n13 = s >> 8;  // bytes 0 and 2: columns c + 1 and c + 3
}

// One group's NSC step: acc + pos_r - neg_r (levels times delta, fused).
__device__ __forceinline__ float readout_step(float acc, float pos, float neg,
                                              float delta, bool ideal) {
  if (ideal) return __fsub_rn(__fadd_rn(acc, pos), neg);
  return __fmaf_rn(-neg, delta, __fmaf_rn(pos, delta, acc));
}

// k rows kk (and kk + 1 when kTwo) of a thread's 8 x 8 tile: tot gathers
// every floor product, neg the ones of negative sign, both in the 16-bit
// lanes of the column pairs (a group sums to at most 128 * 128). neg adds
// two k at once (one IADD3); tot adds each k with an IMAD by `one` (1 at
// run time, so not folded into an add), which issues on the FMA pipe
// beside the IMAD of the products, sparing the integer ALU pipe (PRMT,
// LOP3, IADD3) that bounds the loop.
template <bool kTwo, int BM, int BN>
__device__ __forceinline__ void artemis_rows(const uint8_t* br,
                                             const uint32_t* am_p,
                                             const uint32_t* an_p,
                                             uint32_t one,
                                             uint32_t (&tot)[kArtTile][4],
                                             uint32_t (&neg)[kArtTile][4]) {
  constexpr int NK = kTwo ? 2 : 1;
  uint32_t am[NK][kArtTile], an[NK][kArtTile], bm[NK][4], bn[NK][4];
#pragma unroll
  for (int q = 0; q < NK; ++q) {
    const uint2 b = *reinterpret_cast<const uint2*>(br + q * BN);
    b_pairs(b.x, bm[q][0], bm[q][1], bn[q][0], bn[q][1]);
    b_pairs(b.y, bm[q][2], bm[q][3], bn[q][2], bn[q][3]);
    load_words<kArtTile>(am_p + q * BM, am[q]);
    load_words<kArtTile>(an_p + q * BM, an[q]);
  }
#pragma unroll
  for (int i = 0; i < kArtTile; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t y0 = floor_pair(am[0][i], bm[0][j]);
      tot[i][j] = y0 * one + tot[i][j];
      if constexpr (kTwo) {
        const uint32_t y1 = floor_pair(am[1][i], bm[1][j]);
        tot[i][j] = y1 * one + tot[i][j];
        neg[i][j] += (y0 & (an[0][i] ^ bn[0][j])) +
                     (y1 & (an[1][i] ^ bn[1][j]));
      } else {
        neg[i][j] += y0 & (an[0][i] ^ bn[0][j]);
      }
    }
}

// Shared memory of a block at a window of wk k rows, in bytes, each part
// a multiple of 16: two raw A tiles and two raw B tiles (cp.async lands
// window w + 1 while window w is in use), A as words, then, for the scan
// in the block, a window's group sums and the readout table.
struct ArtLayout {
  int a_stride, a_raw, b_raw, a_words, sums, table, bytes;
  __host__ __device__ ArtLayout(int bm, int bn, int ks, int wk, int table_len,
                                bool split) {
    a_stride = (wk + 15) / 16 * 16 + 16;  // the window from a 16-byte start
    a_raw = 0;
    b_raw = a_raw + 2 * bm * a_stride;
    a_words = b_raw + 2 * wk * bn;
    sums = a_words + 2 * wk * bm * 4;
    table = sums + (split ? 0 : ks * bm * bn * 4);
    bytes = table + (split ? 0 : (table_len * 4 + 15) / 16 * 16);
  }
};

// Each block: a BM x BN output tile (RM x CN threads a slice, 8 x 8
// outputs each) over the groups of its split (blockIdx.z), in windows of
// `slices` consecutive groups, one group per slice of KS. A slice forms
// its group's exact sums; they are integers, so the slices may form them
// in any order. Then only the readouts and the f32 scan run in group
// order: kSplit writes every group's sums (pos | neg << 16 per output) to
// `sums` ((groups, M, N)) for artemis_scan_kernel; otherwise the block
// itself scans each window's sums from shared memory, in order, after a
// barrier.
template <int RM, int CN, int KS, bool kSplit>
__global__ void __launch_bounds__(KS * RM * CN)
    artemis_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   float* __restrict__ out, uint32_t* __restrict__ sums,
                   const float* __restrict__ table, int M, int N, int K,
                   int depth, int slices, int groups_per_split, float delta,
                   int ideal, uint32_t one) {
  constexpr int T0 = RM * CN, T = KS * T0;
  constexpr int BM = kArtTile * RM, BN = kArtTile * CN;
  constexpr int kPer = kSplit ? 1 : BM * BN / T;  // outputs a thread scans
  static_assert(T0 % 32 == 0 && (BM * BN) % T == 0, "whole warps, outputs");
  const int groups = (K + depth - 1) / depth;
  const int wk = slices * depth;
  const int table_len = depth * 128 + 1;
  const ArtLayout lay(BM, BN, KS, wk, table_len, kSplit);
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* const a_mag = reinterpret_cast<uint32_t*>(smem + lay.a_words);
  uint32_t* const a_neg = a_mag + wk * BM;
  uint32_t* const s_sums = reinterpret_cast<uint32_t*>(smem + lay.sums);
  float* const s_table = reinterpret_cast<float*>(smem + lay.table);

  const int tid = threadIdx.x;
  const int slice = tid / T0, rm = (tid % T0) / CN, cn = tid % CN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const int windows = (g_end - g_begin + slices - 1) / slices;
  if (!kSplit)  // published by the first window's barriers
    for (int i = tid; i < table_len; i += T) s_table[i] = table[i];

  // window w's raw tiles: A rows from the 16-byte boundary at or before
  // its first k, B rows whole; K and N are multiples of 16, so a 16-byte
  // chunk is all in or all out (zero-filled: the ragged last group)
  auto stage = [&](int w) {
    const int k0 = (g_begin + w * slices) * depth, a0 = k0 & ~15;
    const uint32_t as =
        smem_addr(smem + lay.a_raw) + (w & 1) * BM * lay.a_stride;
    const int a_chunks = lay.a_stride / 16;
    for (int i = tid; i < BM * a_chunks; i += T) {
      const int r = i / a_chunks, c = i % a_chunks;
      const int m = m0 + r, k = a0 + 16 * c;
      const bool in = m < M && k < K;
      cp_async16(as + r * lay.a_stride + 16 * c,
                 in ? A + (size_t)m * K + k : A, in);
    }
    const uint32_t bs = smem_addr(smem + lay.b_raw) + (w & 1) * wk * BN;
    for (int i = tid; i < wk * (BN / 16); i += T) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int k = k0 + r, n = n0 + 16 * c;
      const bool in = k < K && n < N;
      cp_async16(bs + r * BN + 16 * c, in ? B + (size_t)k * N + n : B, in);
    }
  };

  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = 0.0f;

  stage(0);
  cp_async_commit();
  for (int w = 0; w < windows; ++w) {
    if (w + 1 < windows) stage(w + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of window w landed
    __syncthreads();     // everyone's; window w - 1 is consumed
    {  // A as words, [k][m]: 2|a| and the sign mask, once per block
      const int k0 = (g_begin + w * slices) * depth;
      const uint8_t* ar =
          smem + lay.a_raw + (w & 1) * BM * lay.a_stride + (k0 & 15);
      for (int i = tid; i < wk * BM; i += T) {
        const int a = static_cast<int8_t>(ar[(i % BM) * lay.a_stride + i / BM]);
        a_mag[i] = 2u * static_cast<uint32_t>(abs(a));
        a_neg[i] = a < 0 ? 0xFFFFFFFFu : 0u;
      }
    }
    __syncthreads();
    const int g = g_begin + w * slices + slice;
    if (slice < slices && g < g_end) {
      uint32_t tot[kArtTile][4], neg[kArtTile][4];
#pragma unroll
      for (int i = 0; i < kArtTile; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[i][j] = neg[i][j] = 0u;
      const uint8_t* br =
          smem + lay.b_raw + (w & 1) * wk * BN + kArtTile * cn;
      const int kb = slice * depth, ke = kb + depth;
      int kk = kb;
      for (; kk + 1 < ke; kk += 2)
        artemis_rows<true, BM, BN>(br + kk * BN, a_mag + kk * BM + 8 * rm,
                                   a_neg + kk * BM + 8 * rm, one, tot, neg);
      if (kk < ke)
        artemis_rows<false, BM, BN>(br + kk * BN, a_mag + kk * BM + 8 * rm,
                                    a_neg + kk * BM + 8 * rm, one, tot, neg);
      // one word per output, pos | neg << 16, in column order: pair j
      // holds columns (c, c + 2) or (c + 1, c + 3) of its 4-column word
#pragma unroll
      for (int i = 0; i < kArtTile; ++i) {
        const int r = kArtTile * rm + i;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t pos = tot[i][j] - neg[i][j];
          lo[j] = __byte_perm(pos, neg[i][j], 0x5410);
          hi[j] = __byte_perm(pos, neg[i][j], 0x7632);
        }
        uint4* dst;
        if constexpr (kSplit) {
          if (m0 + r >= M || n0 + kArtTile * cn >= N) continue;
          dst = reinterpret_cast<uint4*>(
              sums + ((size_t)g * M + m0 + r) * N + n0 + kArtTile * cn);
        } else {
          dst = reinterpret_cast<uint4*>(s_sums + (slice * BM + r) * BN +
                                         kArtTile * cn);
        }
        dst[0] = make_uint4(lo[0], lo[1], hi[0], hi[1]);
        dst[1] = make_uint4(lo[2], lo[3], hi[2], hi[3]);
      }
    }
    __syncthreads();  // the raw tiles are free; the window's sums are in
    if constexpr (!kSplit) {
      // the scan, in group order: slice s holds group g_begin + w *
      // slices + s. Every lookup first, then the FMA chain
      const int here = min(slices, g_end - (g_begin + w * slices));
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        float pl[KS], nl[KS];
#pragma unroll
        for (int s = 0; s < KS; ++s)
          if (s < here) {
            const uint32_t v = s_sums[s * BM * BN + tid + T * q];
            pl[s] = s_table[v & 0xFFFFu];
            nl[s] = s_table[v >> 16];
          }
#pragma unroll
        for (int s = 0; s < KS; ++s)
          if (s < here)
            acc[q] = readout_step(acc[q], pl[s], nl[s], delta, ideal != 0);
      }
    }
  }
  if constexpr (!kSplit) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int o = tid + T * q, m = m0 + o / BN, n = n0 + o % BN;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[q];
    }
  }
}

// The scan of kSplit: one output a thread, 256 a block; the groups'
// sums ((groups, M, N), so a group's 256 words are contiguous) land in
// shared memory kScanChunk groups at a time through a ring of cp.async
// stages, and each thread reads its output's sums out in group order.
constexpr int kScanThreads = 256, kScanChunk = 32, kScanStages = 3;

__host__ __device__ constexpr int scan_table_bytes(int table_len) {
  return (table_len * 4 + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kScanThreads)
    artemis_scan_kernel(const uint32_t* __restrict__ sums,
                        const float* __restrict__ table,
                        float* __restrict__ out, int mn, int groups,
                        int table_len, float delta, int ideal) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* const s_table = reinterpret_cast<float*>(smem);
  uint32_t* const ring =
      reinterpret_cast<uint32_t*>(smem + scan_table_bytes(table_len));
  const int tid = threadIdx.x, o0 = blockIdx.x * kScanThreads;
  for (int i = tid; i < table_len; i += kScanThreads) s_table[i] = table[i];
  const int chunks = (groups + kScanChunk - 1) / kScanChunk;
  auto stage = [&](int c) {  // M * N is a multiple of 16
    const uint32_t dst =
        smem_addr(ring) + (c % kScanStages) * kScanChunk * kScanThreads * 4;
    for (int i = tid; i < kScanChunk * kScanThreads / 4; i += kScanThreads) {
      const int r = i / (kScanThreads / 4), q = i % (kScanThreads / 4);
      const int g = c * kScanChunk + r, o = o0 + 4 * q;
      const bool in = g < groups && o < mn;
      cp_async16(dst + (r * kScanThreads + 4 * q) * 4,
                 in ? sums + (size_t)g * mn + o : sums, in);
    }
  };
#pragma unroll
  for (int c = 0; c < kScanStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kScanStages - 2>();  // chunk c landed (this thread's)
    __syncthreads();                   // everyone's; chunk c - 1 consumed
    if (c + kScanStages - 1 < chunks) stage(c + kScanStages - 1);
    cp_async_commit();
    const uint32_t* rw =
        ring + (c % kScanStages) * kScanChunk * kScanThreads + tid;
    const int n = min(kScanChunk, groups - c * kScanChunk);
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
      const uint32_t v = rw[r * kScanThreads];
      acc = readout_step(acc, s_table[v & 0xFFFFu], s_table[v >> 16], delta,
                         ideal != 0);
    }
  }
  if (o0 + tid < mn) out[o0 + tid] = acc;
}

int num_sms(int dev) {
  static int n[kMaxDevices] = {};
  if (!n[dev] && (cudaDeviceGetAttribute(&n[dev],
                                         cudaDevAttrMultiProcessorCount,
                                         dev) != cudaSuccess ||
                  n[dev] < 1))
    n[dev] = 132;
  return n[dev];
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// Groups a window stages: as many as fit kArtMaxWindow k rows, at most KS.
int artemis_slices(int ks, int depth) {
  return std::min(ks, std::max(1, kArtMaxWindow / depth));
}

// At decode (M <= kArtSplitMaxM) 8 x 256 tiles, 4 single-warp slices a
// block, K split over blocks so that the waves of blocks end soonest, the
// sums meeting in scratch for artemis_scan_kernel; above, 32 x 64 tiles,
// 4 or 8 single-warp slices a block, each block scanning its own sums.
template <int RM, int CN, int KS, bool kSplit>
cudaError_t launch_artemis(const int8_t* A, const int8_t* B, float* out,
                           uint32_t* sums, const float* table, int M, int N,
                           int K, int depth, float delta, int ideal, int dev,
                           int sms, cudaStream_t st) {
  auto kernel = artemis_kernel<RM, CN, KS, kSplit>;
  constexpr int T = KS * RM * CN, BM = kArtTile * RM, BN = kArtTile * CN;
  const int slices = artemis_slices(KS, depth);
  const int groups = cdiv(K, depth), table_len = depth * 128 + 1;
  const ArtLayout lay(BM, BN, KS, slices * depth, table_len, kSplit);
  // set up once per device: the shared-memory opt-ins; once per depth the
  // blocks that fit one SM
  static bool ready[kMaxDevices] = {};
  static int per_sm[kMaxDevices][kMaxAccDepth + 1] = {};
  cudaError_t err = cudaSuccess;
  if (!ready[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess && kSplit)
      err = cudaFuncSetAttribute(artemis_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  int& fit = per_sm[dev][depth];
  if (!fit) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, T,
                                                        lay.bytes);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  const int gn = cdiv(N, BN), gm = cdiv(M, BM);
  int per_split = groups;
  if (kSplit) {
    const int windows = cdiv(groups, slices);
    per_split = cdiv(windows, choose_splits(gn * gm, windows, fit * sms)) *
                slices;
  }
  dim3 grid(gn, gm, cdiv(groups, per_split));
  kernel<<<grid, T, lay.bytes, st>>>(A, B, out, sums, table, M, N, K, depth,
                                     slices, per_split, delta, ideal, 1u);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kSplit) return err;
  const int scan_smem = scan_table_bytes(table_len) +
                        kScanStages * kScanChunk * kScanThreads * 4;
  artemis_scan_kernel<<<cdiv(M * N, kScanThreads), kScanThreads, scan_smem,
                        st>>>(sums, table, out, M * N, groups, table_len,
                              delta, ideal);
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes. A: (M, K) int8, B: (K, N) int8, both
// contiguous and 16-byte aligned, N a multiple of 16 (whole 16-byte
// copies); K a multiple of 32 for int8 and artemis_mxu (whole mma depths)
// and of 16 for artemis (the kernel zero-fills its ragged last group).
// out: (M, N) int32 for int8, f32 otherwise. scratch:
// sc_matmul_scratch_bytes(...) bytes (unused when 0). table (artemis):
// acc_depth * 128 + 1 f32 levels, clamp(rint(x / delta), 0, levels) for
// each possible group sum x, or x itself for readout_bits < 0 (ideal
// readout); delta = acc_depth * 127 / levels rounded to f32 by the caller.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" long long sc_matmul_scratch_bytes(int M, int N, int K, int mode,
                                             int acc_depth) {
  if (mode == kModeMxu) return 2LL * M * N * (long long)sizeof(int);
  if (mode == kModeArtemis && M <= kArtSplitMaxM && acc_depth >= 1)
    return (long long)cdiv(K, acc_depth) * M * N * (long long)sizeof(uint32_t);
  return 0;
}

extern "C" int sc_matmul_launch(const void* A, const void* B, void* out,
                                void* scratch, const void* table, int M,
                                int N, int K, int mode, int acc_depth,
                                int readout_bits, float delta, float rbar,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % kNGranule != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms(dev);

  if (mode == kModeArtemis) {
    if (acc_depth < 1 || acc_depth > kMaxAccDepth || K % kArtKGranule != 0 ||
        table == nullptr || (M <= kArtSplitMaxM && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    float* o = static_cast<float*>(out);
    const float* t = static_cast<const float*>(table);
    const int ideal = readout_bits < 0;
    if (M <= kArtSplitMaxM)
      return (int)launch_artemis<1, 32, 4, true>(
          a, b, o, static_cast<uint32_t*>(scratch), t, M, N, K, acc_depth,
          delta, ideal, dev, sms, st);
    // 4 slices a block (78 KB at depth 20: two blocks share an SM and
    // overlap their barriers) where that fills the card twice, else 8
    if (cdiv(M, 32) * cdiv(N, 64) >= 2 * sms)
      return (int)launch_artemis<4, 8, 4, false>(a, b, o, nullptr, t, M, N,
                                                 K, acc_depth, delta, ideal,
                                                 dev, sms, st);
    return (int)launch_artemis<4, 8, 8, false>(a, b, o, nullptr, t, M, N, K,
                                               acc_depth, delta, ideal, dev,
                                               sms, st);
  }
  if ((mode != kModeInt8 && mode != kModeMxu) || K % kKGranule != 0)
    return (int)cudaErrorInvalidValue;
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
