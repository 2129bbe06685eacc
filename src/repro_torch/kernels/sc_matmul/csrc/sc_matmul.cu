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
//     form any group's sums in any order; only the readouts and the f32
//     scan run in group order, per output. At decode (M <= 16) K is split
//     over the slices (warps) of a block and over blocks: a block stages a
//     window of consecutive groups (A and B by 16-byte cp.async, the next
//     window landing while this one is in use), each slice forms one
//     group's sums, every group's sums go to scratch, and a second, small
//     kernel scans them, so that even N = 1024 fills the card. Above, a
//     warp owns an output tile and walks all of K in order, staging its own
//     windows, and reads each group out of its registers where the group
//     ends: no sums through shared memory, no barrier between a group's
//     products and its readout (artemis_tile_kernel). Where that gives too
//     few warps, K is split over blocks too, and the groups' levels, as
//     bytes, go to scratch for a scan. The readout is a lookup in a table of
//     the levels of all acc_depth * 128 + 1 possible sums, built once per
//     device by the wrapper with the exact f32 arithmetic.
// Later work: wgmma with TMA and a producer warp for the dot.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>

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
// artemis: MOMCAP groups on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kArtTile = 8;         // a decode thread's outputs: 8 x 8
constexpr int kArtKGranule = 16;    // the wrapper pads K to 16-byte A rows
constexpr int kArtMaxWindow = 160;  // k rows a decode block stages a window
constexpr int kArtSplitMaxM = 16;   // M up to which the groups' sums meet
                                    // in scratch (else a warp walks all K)

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

// k rows kk (and kk + 1 when kTwo) of a thread's R x C tile: B's row at
// br (C bytes, the next row b_stride on), A's words at am_p / an_p (R
// each, the next row a_stride on). tot gathers every floor product, neg
// the ones of negative sign, both in the 16-bit lanes of the column pairs
// (word j: columns (c, c + 2) of its 4-column word c for even j, (c + 1,
// c + 3) for odd; a group sums to at most 128 * 128). neg adds two k at
// once (one IADD3); tot adds each k with an IMAD by `one` (1 at run time,
// so not folded into an add), which issues on the FMA pipe beside the
// IMAD of the products, sparing the integer ALU pipe (PRMT, LOP3, IADD3)
// that bounds the loop.
template <bool kTwo, int R, int C>
__device__ __forceinline__ void artemis_rows(const uint8_t* br, int b_stride,
                                             const uint32_t* am_p,
                                             const uint32_t* an_p,
                                             int a_stride, uint32_t one,
                                             uint32_t (&tot)[R][C / 2],
                                             uint32_t (&neg)[R][C / 2]) {
  static_assert(C % 4 == 0, "whole 4-column words of B");
  constexpr int NK = kTwo ? 2 : 1, W = C / 2;
  uint32_t am[NK][R], an[NK][R], bm[NK][W], bn[NK][W];
#pragma unroll
  for (int q = 0; q < NK; ++q) {
    uint32_t b[C / 4];
    load_words<C / 4>(reinterpret_cast<const uint32_t*>(br + q * b_stride),
                      b);
#pragma unroll
    for (int x = 0; x < C / 4; ++x)
      b_pairs(b[x], bm[q][2 * x], bm[q][2 * x + 1], bn[q][2 * x],
              bn[q][2 * x + 1]);
    load_words<R>(am_p + q * a_stride, am[q]);
    load_words<R>(an_p + q * a_stride, an[q]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) {
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

// Shared memory of a decode block at a window of wk k rows, in bytes, each
// part a multiple of 16: two raw A tiles and two raw B tiles (cp.async
// lands window w + 1 while window w is in use), then A as words.
struct ArtLayout {
  int a_stride, a_raw, b_raw, a_words, bytes;
  __host__ __device__ ArtLayout(int bm, int bn, int wk) {
    a_stride = (wk + 15) / 16 * 16 + 16;  // the window from a 16-byte start
    a_raw = 0;
    b_raw = a_raw + 2 * bm * a_stride;
    a_words = b_raw + 2 * wk * bn;
    bytes = a_words + 2 * wk * bm * 4;
  }
};

// Decode (M <= kArtSplitMaxM). Each block: a BM x BN output tile (RM x CN
// threads a slice, 8 x 8 outputs each) over the groups of its split
// (blockIdx.z), in windows of `slices` consecutive groups, one group per
// slice of KS. A slice forms its group's exact sums; they are integers, so
// the slices and blocks may form them in any order. Every group's sums
// (pos | neg << 16 per output) go to `sums` ((groups, M, N)), and
// artemis_scan_kernel reads them out and scans them in group order.
template <int RM, int CN, int KS>
__global__ void __launch_bounds__(KS * RM * CN)
    artemis_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   uint32_t* __restrict__ sums, int M, int N, int K,
                   int depth, int slices, int groups_per_split, uint32_t one) {
  constexpr int T0 = RM * CN, T = KS * T0;
  constexpr int BM = kArtTile * RM, BN = kArtTile * CN;
  static_assert(T0 % 32 == 0, "whole warps");
  const int groups = (K + depth - 1) / depth;
  const int wk = slices * depth;
  const ArtLayout lay(BM, BN, wk);
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* const a_mag = reinterpret_cast<uint32_t*>(smem + lay.a_words);
  uint32_t* const a_neg = a_mag + wk * BM;

  const int tid = threadIdx.x;
  const int slice = tid / T0, rm = (tid % T0) / CN, cn = tid % CN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const int windows = (g_end - g_begin + slices - 1) / slices;

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
        artemis_rows<true, kArtTile, kArtTile>(
            br + kk * BN, BN, a_mag + kk * BM + 8 * rm,
            a_neg + kk * BM + 8 * rm, BM, one, tot, neg);
      if (kk < ke)
        artemis_rows<false, kArtTile, kArtTile>(
            br + kk * BN, BN, a_mag + kk * BM + 8 * rm,
            a_neg + kk * BM + 8 * rm, BM, one, tot, neg);
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
        if (m0 + r >= M || n0 + kArtTile * cn >= N) continue;
        uint4* const dst = reinterpret_cast<uint4*>(
            sums + ((size_t)g * M + m0 + r) * N + n0 + kArtTile * cn);
        dst[0] = make_uint4(lo[0], lo[1], hi[0], hi[1]);
        dst[1] = make_uint4(lo[2], lo[3], hi[2], hi[3]);
      }
    }
    __syncthreads();  // the raw tiles are free
  }
}

// The scan at decode: one output a thread, 256 a block; the groups'
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

// ---------------------------------------------------------------------------
// artemis above decode (M > kArtSplitMaxM): a warp a tile, all of K in order
// ---------------------------------------------------------------------------
//
// Each warp owns a (4R) x (8C) output tile (4 x 8 threads, R x C outputs
// each) and walks all of K in order, kTileWK k rows a window that it
// stages itself: A's rows and B's rows by 16-byte cp.async into two raw
// buffers (window w + 1 lands while w is in use), then A's window as
// words (2|a| and the mask of a < 0, [k][row]) converted by the lanes that
// copied it. Only __syncwarp orders a warp's lanes; no warp waits for
// another. At the end of each MOMCAP group a thread reads its outputs'
// two sums out of its 16-bit lanes into its f32 accumulators, in group
// order (readout_step), and starts the next group from zero: no group's
// sums leave its registers. The warps of a block share nothing but, where
// the readout looks levels up, the table. Where the output has too few
// tiles to give the card's schedulers two warps each, K is split over
// blocks too (kSplit): each part's warp writes its groups' levels as
// bytes, and artemis_level_scan_kernel reads them out in group order, as
// the decode scan does; where a level can pass 255 (past 8 bits, or the
// ideal readout) it writes the groups' sums, as the decode kernel does,
// and artemis_scan_kernel looks their levels up.
constexpr int kTileWarps = 4;               // warps a block
constexpr int kTileWK = 32;                 // k rows a window
constexpr int kTileAStride = kTileWK + 16;  // a raw A row, bytes: 8 rows at
                                            // one chunk hit 8 bank groups
// How a group sum becomes its level: the sum itself (readout_bits < 0),
// or the table's level, looked up in shared memory (computing it in
// registers, min(rint(RN(x * RN(1 / delta))), levels) where that equals
// the table for every sum of the depth, took more time on an H100).
// kReadTable4: the same lookup with tot's lanes kept at 4x their sums
// (artemis_rows' `one` = 4) and neg's scaled at the readout, so that a
// lane is its level's byte offset in the table (one instruction a lane,
// not two); a lane then holds up to 4 * 128 * depth, so depth <= 127.
// Taken by 8 x 4 tiles, where it saved 2 % on an H100; at 8 x 8 it cost
// 1 %.
constexpr int kReadIdeal = 0;
constexpr int kReadTable = 1;
constexpr int kReadTable4 = 2;

template <int R, int C>
struct TileLayout {  // one warp's shared memory, bytes
  static constexpr int kRows = 4 * R, kCols = 8 * C;
  static constexpr int kARaw = 0;  // [2][kRows][kTileAStride] int8
  static constexpr int kBRaw = kARaw + 2 * kRows * kTileAStride;
  static constexpr int kAMag = kBRaw + 2 * kTileWK * kCols;  // [k][row] u32
  static constexpr int kANeg = kAMag + kTileWK * kRows * 4;
  static constexpr int kBytes = kANeg + kTileWK * kRows * 4;
  static_assert(kCols % 16 == 0 && kBytes % 16 == 0, "16-byte chunks");
};

// Lane h (0 low, 1 high) of a word of 16-bit sums as an exact f32: the
// lane as the mantissa of 2^23 + x, less 2^23 (a PRMT and an FADD).
__device__ __forceinline__ float lane_f32(uint32_t w, int h) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(w, 0x4B000000u, h ? 0x7432 : 0x7410)),
      8388608.0f);
}

template <int kRead>
__device__ __forceinline__ float tile_level(uint32_t w, int h,
                                            const float* s_table) {
  if constexpr (kRead == kReadTable4)
    return *reinterpret_cast<const float*>(
        reinterpret_cast<const uint8_t*>(s_table) +
        (h ? w >> 16 : w & 0xFFFFu));
  else if constexpr (kRead == kReadTable)
    return s_table[h ? w >> 16 : w & 0xFFFFu];
  else
    return lane_f32(w, h);
}

// The end of group g where K is split (8 x 8 tiles): each output's two
// levels stored at levels[g][m][n] as a u8 pair, or where `wide` its two
// sums as a u16 pair, pos | neg << 16, the decode kernel's words (a level
// past 16 bits would not fit 16 bits); word j of row i holds columns
// (c, c + 2) or (c + 1, c + 3) of its 4-column word. The lanes are zeroed
// for the next group. s_levels holds the table's levels as integers.
template <int R, int C, int kRead>
__device__ __forceinline__ void tile_store_levels(
    uint32_t (&tot)[R][C / 2], uint32_t (&neg)[R][C / 2],
    const uint32_t* s_levels, uint8_t* levels, int g, int m, int n, int M,
    int N, bool wide) {
  static_assert(C == 8, "a row's 8 outputs: one or two 16-byte stores");
  uint32_t v[R][C];  // pl | nl << 8, or ps | ns << 16 where wide
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const uint32_t pos = tot[i][j] - neg[i][j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t ps = h ? pos >> 16 : pos & 0xFFFFu;
        const uint32_t ns = h ? neg[i][j] >> 16 : neg[i][j] & 0xFFFFu;
        v[i][4 * (j / 2) + (j % 2) + 2 * h] =
            kRead == kReadIdeal || wide ? ps | ns << 16
                                        : s_levels[ps] | s_levels[ns] << 8;
      }
      tot[i][j] = neg[i][j] = 0u;
    }
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (m + i >= M) break;
    const size_t o = ((size_t)g * M + m + i) * N + n;
    if (wide) {
      uint4* const dst = reinterpret_cast<uint4*>(levels + 4 * o);
#pragma unroll
      for (int c = 0; c < C / 4; ++c)
        dst[c] = make_uint4(v[i][4 * c], v[i][4 * c + 1], v[i][4 * c + 2],
                            v[i][4 * c + 3]);
    } else {
      *reinterpret_cast<uint4*>(levels + 2 * o) =
          make_uint4(v[i][0] | v[i][1] << 16, v[i][2] | v[i][3] << 16,
                     v[i][4] | v[i][5] << 16, v[i][6] | v[i][7] << 16);
    }
  }
}

// The end of a group: each output's two sums read out into its
// accumulator, in group order, and the lanes zeroed for the next group.
template <int R, int C, int kRead>
__device__ __forceinline__ void tile_readout(uint32_t (&tot)[R][C / 2],
                                             uint32_t (&neg)[R][C / 2],
                                             float (&acc)[R][C],
                                             const float* s_table,
                                             float delta) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const uint32_t ng = kRead == kReadTable4 ? neg[i][j] << 2 : neg[i][j];
      const uint32_t pos = tot[i][j] - ng;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a = acc[i][4 * (j / 2) + (j % 2) + 2 * h];
        a = readout_step(a, tile_level<kRead>(pos, h, s_table),
                         tile_level<kRead>(ng, h, s_table), delta,
                         kRead == kReadIdeal);
      }
      tot[i][j] = neg[i][j] = 0u;
    }
}

// kSplit: blockIdx.y is the part of K, groups_per_split whole groups from
// a 16-byte boundary, and the levels go to `levels`.
template <int R, int C, int kRead, bool kSplit>
__global__ void __launch_bounds__(kTileWarps * 32)
    artemis_tile_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ B, float* __restrict__ out,
                        uint8_t* __restrict__ levels,
                        const float* __restrict__ table, int M, int N, int K,
                        int depth, int tiles_m, int tiles,
                        int groups_per_split, float delta, int wide,
                        uint32_t one) {
  using L = TileLayout<R, C>;
  constexpr int W = C / 2, kAChunks = L::kRows * (kTileWK / 16),
                kBChunks = kTileWK * L::kCols / 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const int table_len = depth * 128 + 1;
  const int table_bytes =
      kRead != kReadIdeal ? scan_table_bytes(table_len) : 0;
  const float* const s_table = reinterpret_cast<const float*>(smem);
  const uint32_t* const s_levels = reinterpret_cast<const uint32_t*>(smem);
  if constexpr (kRead != kReadIdeal) {
    for (int i = threadIdx.x; i < table_len; i += blockDim.x) {
      if constexpr (kSplit)  // the levels as integers (exact: < 2^24)
        reinterpret_cast<uint32_t*>(smem)[i] = __float2uint_rn(table[i]);
      else
        reinterpret_cast<float*>(smem)[i] = table[i];
    }
    __syncthreads();  // once, before any warp's first readout
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kTileWarps + warp;
  if (tile >= tiles) return;
  uint8_t* const ws = smem + table_bytes + warp * L::kBytes;
  uint32_t* const a_mag = reinterpret_cast<uint32_t*>(ws + L::kAMag);
  uint32_t* const a_neg = reinterpret_cast<uint32_t*>(ws + L::kANeg);
  // m fastest: the warps that share a tile's columns of B run side by side
  const int m0 = (tile % tiles_m) * L::kRows, n0 = (tile / tiles_m) * L::kCols;
  const int rm = lane >> 3, cn = lane & 7;
  // this part's k rows: whole groups, zero-filled past K
  const int groups = (K + depth - 1) / depth;
  const int g_begin = kSplit ? blockIdx.y * groups_per_split : 0;
  const int g_end = kSplit ? min(groups, g_begin + groups_per_split) : groups;
  const int kbeg = g_begin * depth, kend = g_end * depth;
  const int windows = (kend - kbeg + kTileWK - 1) / kTileWK;

  // window w's raw rows; K and N are multiples of 16, so a 16-byte chunk
  // is all in or all out (zero-filled: the ragged last group)
  auto stage = [&](int w) {
    const int k0 = kbeg + w * kTileWK;
    const uint32_t as =
        smem_addr(ws + L::kARaw) + (w & 1) * L::kRows * kTileAStride;
#pragma unroll
    for (int t = 0; t < (kAChunks + 31) / 32; ++t) {
      const int i = lane + 32 * t, r = i % L::kRows, c = i / L::kRows;
      const int m = m0 + r, k = k0 + 16 * c;
      const bool in = i < kAChunks && m < M && k < K;
      if (i < kAChunks)
        cp_async16(as + r * kTileAStride + 16 * c,
                   in ? A + (size_t)m * K + k : A, in);
    }
    const uint32_t bs =
        smem_addr(ws + L::kBRaw) + (w & 1) * kTileWK * L::kCols;
#pragma unroll
    for (int t = 0; t < kBChunks / 32; ++t) {
      const int i = lane + 32 * t;
      const int r = i / (L::kCols / 16), c = i % (L::kCols / 16);
      const int k = k0 + r, n = n0 + 16 * c;
      const bool in = k < K && n < N;
      cp_async16(bs + r * L::kCols + 16 * c, in ? B + (size_t)k * N + n : B,
                 in);
    }
  };
  static_assert(kBChunks % 32 == 0, "whole warps of B chunks");

  // A's window as words [k][row]: each lane converts the 16 bytes (16 k of
  // one row) it copied, rows running over the lanes
  auto convert = [&](int w) {
    const uint8_t* const ar = ws + L::kARaw + (w & 1) * L::kRows * kTileAStride;
#pragma unroll
    for (int t = 0; t < (kAChunks + 31) / 32; ++t) {
      const int i = lane + 32 * t, r = i % L::kRows, c = i / L::kRows;
      if (i >= kAChunks) break;
      const uint4 v =
          *reinterpret_cast<const uint4*>(ar + r * kTileAStride + 16 * c);
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t s = negative_bytes(x[q]);
        const uint32_t mag = (x[q] ^ s) + (s & 0x01010101u);  // |a| bytewise
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = 16 * c + 4 * q + b;
          a_mag[kk * L::kRows + r] = __byte_perm(mag, 0u, 0x4440 + b) << 1;
          a_neg[kk * L::kRows + r] = __byte_perm(s, 0u, 0x1111 * b);
        }
      }
    }
  };

  float acc[R][C];
  uint32_t tot[R][W], neg[R][W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
#pragma unroll
    for (int j = 0; j < W; ++j) tot[i][j] = neg[i][j] = 0u;
  }
  int gend = kbeg + depth;  // the end of the group being summed, ahead
  stage(0);
  cp_async_commit();
  for (int w = 0; w < windows; ++w) {
    __syncwarp();  // every lane is done with window w - 1's raw buffer
    if (w + 1 < windows) stage(w + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies of window w landed
    __syncwarp();        // every lane's; window w - 1's words are consumed
    convert(w);
    __syncwarp();
    const int k0 = kbeg + w * kTileWK, wend = min(kTileWK, kend - k0);
    const uint8_t* const br =
        ws + L::kBRaw + (w & 1) * kTileWK * L::kCols + C * cn;
    const uint32_t* const am_p = a_mag + R * rm;
    const uint32_t* const an_p = a_neg + R * rm;
    int kk = 0;
    while (kk < wend) {
      const int stop = min(wend, gend - k0);
      for (; kk + 1 < stop; kk += 2)
        artemis_rows<true, R, C>(br + kk * L::kCols, L::kCols,
                                 am_p + kk * L::kRows, an_p + kk * L::kRows,
                                 L::kRows, one, tot, neg);
      if (kk < stop) {
        artemis_rows<false, R, C>(br + kk * L::kCols, L::kCols,
                                  am_p + kk * L::kRows, an_p + kk * L::kRows,
                                  L::kRows, one, tot, neg);
        ++kk;
      }
      if (k0 + kk == gend) {
        if constexpr (kSplit)
          tile_store_levels<R, C, kRead>(tot, neg, s_levels, levels,
                                         gend / depth - 1, m0 + R * rm,
                                         n0 + C * cn, M, N, wide != 0);
        else
          tile_readout<R, C, kRead>(tot, neg, acc, s_table, delta);
        gend += depth;
      }
    }
  }
  // N is a multiple of 16: a thread's C columns are all in or all out
  const int n = n0 + C * cn;
  if (kSplit || n >= N) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + R * rm + i;
    if (m >= M) break;
    float4* const dst = reinterpret_cast<float4*>(out + (size_t)m * N + n);
#pragma unroll
    for (int c = 0; c < C / 4; ++c)
      dst[c] = make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                           acc[i][4 * c + 3]);
  }
}

// kSplit's scan of u8 level pairs: one output a thread, its groups'
// levels read in group order, each level as an exact f32. (Four outputs a
// thread, 8 or 16 bytes a load, kept fewer loads in flight and took 1.8x
// as long on an H100.)
__global__ void __launch_bounds__(kScanThreads)
    artemis_level_scan_kernel(const uint8_t* __restrict__ levels,
                              float* __restrict__ out, int mn, int groups,
                              float delta) {
  const int o = blockIdx.x * kScanThreads + threadIdx.x;
  if (o >= mn) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) {
    const uint32_t v = __ldg(
        reinterpret_cast<const unsigned short*>(levels) + (size_t)g * mn + o);
    const float pl = __fsub_rn(
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440)), 8388608.0f);
    const float nl = __fsub_rn(
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441)), 8388608.0f);
    acc = readout_step(acc, pl, nl, delta, false);
  }
  out[o] = acc;
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

// artemis_scan_kernel over (groups, M, N) words of sums, pos | neg << 16,
// the table in shared memory (opted in once per device).
cudaError_t launch_artemis_scan(const uint32_t* sums, const float* table,
                                float* out, int mn, int groups, int depth,
                                float delta, int ideal, int dev,
                                cudaStream_t st) {
  static bool ready[kMaxDevices] = {};
  if (!ready[dev]) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(artemis_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int table_len = depth * 128 + 1;
  const int smem = scan_table_bytes(table_len) +
                   kScanStages * kScanChunk * kScanThreads * 4;
  artemis_scan_kernel<<<cdiv(mn, kScanThreads), kScanThreads, smem, st>>>(
      sums, table, out, mn, groups, table_len, delta, ideal);
  return cudaGetLastError();
}

// Decode (M <= kArtSplitMaxM): 8 x 256 tiles, 4 single-warp slices a
// block, K split over blocks so that the waves of blocks end soonest, the
// sums meeting in scratch for artemis_scan_kernel.
template <int RM, int CN, int KS>
cudaError_t launch_artemis_split(const int8_t* A, const int8_t* B, float* out,
                                 uint32_t* sums, const float* table, int M,
                                 int N, int K, int depth, float delta,
                                 int ideal, int dev, int sms,
                                 cudaStream_t st) {
  auto kernel = artemis_kernel<RM, CN, KS>;
  constexpr int T = KS * RM * CN, BM = kArtTile * RM, BN = kArtTile * CN;
  const int slices = artemis_slices(KS, depth);
  const int groups = cdiv(K, depth);
  const ArtLayout lay(BM, BN, slices * depth);
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
  const int windows = cdiv(groups, slices);
  const int per_split =
      cdiv(windows, choose_splits(gn * gm, windows, fit * sms)) * slices;
  dim3 grid(gn, gm, cdiv(groups, per_split));
  kernel<<<grid, T, lay.bytes, st>>>(A, B, sums, M, N, K, depth, slices,
                                     per_split, 1u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_artemis_scan(sums, table, out, M * N, groups, depth, delta,
                             ideal, dev, st);
}

// The plan of the path above decode, from the shapes alone (so that
// sc_matmul_scratch_bytes sizes the split's levels without a device):
// 8 x 8 outputs a thread, the fewest instructions a product, where that
// gives kTileFillWarps warps (two a scheduler on an H100's 132 SMs, near
// enough); else 8 x 4 where that gives half as many (8 x 4 and smaller
// tiles read more shared memory a product, so no smaller tile pays);
// else 8 x 8 with K split over blocks, whole groups a part from a 16-byte
// boundary, into as many parts as give kTileFillWarps warps.
constexpr int kTileFillWarps = 1024;
struct TilePlan {
  int shape, splits, groups_per_split;
};
TilePlan artemis_tile_plan(int M, int N, int K, int depth) {
  const int t88 = cdiv(M, 32) * cdiv(N, 64);
  if (t88 >= kTileFillWarps) return {88, 1, 0};
  if (cdiv(M, 32) * cdiv(N, 32) >= kTileFillWarps / 2) return {84, 1, 0};
  const int groups = cdiv(K, depth), unit = 16 / std::gcd(depth, 16);
  const int per =
      cdiv(cdiv(groups, cdiv(kTileFillWarps, t88)), unit) * unit;
  if (per >= groups) return {88, 1, 0};
  return {88, cdiv(groups, per), per};
}

// The split's levels: a u16 pair per output and group, the wide sums (u8
// level pairs, half of it, where no level passes 255).
long long artemis_levels_bytes(int M, int N, int K, int depth) {
  const TilePlan plan = artemis_tile_plan(M, N, K, depth);
  return plan.splits > 1 ? 4LL * cdiv(K, depth) * M * N : 0;
}

template <int R, int C, int kRead, bool kSplit>
cudaError_t launch_artemis_tile(const int8_t* A, const int8_t* B, float* out,
                                uint8_t* levels, const float* table, int M,
                                int N, int K, int depth, float delta,
                                const TilePlan& plan, int wide, int dev,
                                cudaStream_t st) {
  auto kernel = artemis_tile_kernel<R, C, kRead, kSplit>;
  using L = TileLayout<R, C>;
  const int smem = (kRead != kReadIdeal ? scan_table_bytes(depth * 128 + 1)
                                        : 0) +
                   kTileWarps * L::kBytes;
  static bool ready[kMaxDevices] = {};  // the shared-memory opt-in
  if (!ready[dev]) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int tiles_m = cdiv(M, L::kRows), tiles = tiles_m * cdiv(N, L::kCols);
  const dim3 grid(cdiv(tiles, kTileWarps), plan.splits);
  kernel<<<grid, kTileWarps * 32, smem, st>>>(
      A, B, out, levels, table, M, N, K, depth, tiles_m, tiles,
      plan.groups_per_split, delta, wide, kRead == kReadTable4 ? 4u : 1u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !kSplit) return err;
  const int groups = cdiv(K, depth);
  if (wide)
    return launch_artemis_scan(reinterpret_cast<const uint32_t*>(levels),
                               table, out, M * N, groups, depth, delta,
                               kRead == kReadIdeal, dev, st);
  artemis_level_scan_kernel<<<cdiv(M * N, kScanThreads), kScanThreads, 0,
                              st>>>(levels, out, M * N, groups, delta);
  return cudaGetLastError();
}

template <int kRead>
cudaError_t launch_artemis_tiles(const int8_t* A, const int8_t* B, float* out,
                                 uint8_t* levels, const float* table, int M,
                                 int N, int K, int depth, float delta,
                                 int readout_bits, int dev, cudaStream_t st) {
  const TilePlan plan = artemis_tile_plan(M, N, K, depth);
  // a level passes 255 only past 8 bits, or ideally (the sum itself):
  // there the split hands the scan the sums
  const int wide = kRead == kReadIdeal || readout_bits > 8;
  if (plan.splits > 1)
    return levels == nullptr
               ? cudaErrorInvalidValue
               : launch_artemis_tile<8, 8, kRead, true>(
                     A, B, out, levels, table, M, N, K, depth, delta, plan,
                     wide, dev, st);
  // 8 x 4 tiles read the table with lanes at 4x where a lane holds
  // 4 * 128 * depth
  if (plan.shape == 84 && kRead == kReadTable && depth < kMaxAccDepth)
    return launch_artemis_tile<8, 4, kReadTable4, false>(
        A, B, out, nullptr, table, M, N, K, depth, delta, plan, wide, dev,
        st);
  if (plan.shape == 84)
    return launch_artemis_tile<8, 4, kRead, false>(
        A, B, out, nullptr, table, M, N, K, depth, delta, plan, wide, dev,
        st);
  return launch_artemis_tile<8, 8, kRead, false>(
      A, B, out, nullptr, table, M, N, K, depth, delta, plan, wide, dev, st);
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
//
// The wrapper hands a call over as one packed block, ScMatmulArgs, which
// it mirrors as a ctypes.Structure (`_Args` in sc_matmul.py), fills once
// per call signature and of which it writes only the pointers and the
// stream per call; `sc_matmul_launch_args_bytes` gives its size, which the
// wrapper holds against its mirror's when it loads the library.
struct ScMatmulArgs {
  const void* A;
  const void* B;
  void* out;
  void* scratch;
  const void* table;
  void* stream;
  int M;
  int N;
  int K;
  int mode;
  int acc_depth;
  int readout_bits;
  float delta;
  float rbar;
};

extern "C" int sc_matmul_launch_args_bytes() {
  return (int)sizeof(ScMatmulArgs);
}

extern "C" long long sc_matmul_scratch_bytes(int M, int N, int K, int mode,
                                             int acc_depth) {
  if (mode == kModeMxu) return 2LL * M * N * (long long)sizeof(int);
  if (mode == kModeArtemis && M <= kArtSplitMaxM && acc_depth >= 1)
    return (long long)cdiv(K, acc_depth) * M * N * (long long)sizeof(uint32_t);
  if (mode == kModeArtemis && acc_depth >= 1 && acc_depth <= kMaxAccDepth)
    return artemis_levels_bytes(M, N, K, acc_depth);
  return 0;
}

static int mac_launch(const void* A, const void* B, void* out,
                      void* scratch, const void* table, int M, int N, int K,
                      int mode, int acc_depth, int readout_bits, float delta,
                      float rbar, void* stream) {
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
      return (int)launch_artemis_split<1, 32, 4>(
          a, b, o, static_cast<uint32_t*>(scratch), t, M, N, K, acc_depth,
          delta, ideal, dev, sms, st);
    uint8_t* const lv = static_cast<uint8_t*>(scratch);
    if (ideal)
      return (int)launch_artemis_tiles<kReadIdeal>(
          a, b, o, lv, t, M, N, K, acc_depth, delta, readout_bits, dev, st);
    return (int)launch_artemis_tiles<kReadTable>(
        a, b, o, lv, t, M, N, K, acc_depth, delta, readout_bits, dev, st);
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

extern "C" int sc_matmul_launch(const ScMatmulArgs* args) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  return mac_launch(args->A, args->B, args->out, args->scratch, args->table,
                    args->M, args->N, args->K, args->mode, args->acc_depth,
                    args->readout_bits, args->delta, args->rbar,
                    args->stream);
}

// ---------------------------------------------------------------------------
// sc_quantize: the symmetric int8 quantization in front of the MAC
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel. The reference quantizes both operands inside
// the jitted float entry of its Pallas kernel (repro/kernels/sc_matmul/
// ops.py, through repro/core/quantization.py's quant_scale and quantize),
// where XLA fuses the chain into a pass or two; run as eager torch ops it
// is ten passes over a weight. This kernel computes what the port's
// core.quantization.quant_scale and quantize compute on the f32 of x, bit
// for bit:
//   m = max |x| over a group, ordered as torch.amax orders it (NaN above
//       inf: the bits of |x| compared as unsigned integers);
//   scale = max(m, 1e-8) / 127, NaN kept, an IEEE division (__fdiv_rn);
//   q = clamp(rint(x / scale), -127, 127), NaN to 0, as int8, the
//       quotient that of a true division (`quantize_one` divides only
//       where a product by the reciprocal cannot decide the integer).
// x is (O, R, I) contiguous, bf16 (exact in f32) or f32, and a group is the
// R elements of one (o, i): I = 1 for a scale per tensor (O = 1), per lane
// (O lanes) or per row (O rows), I > 1 for one per trailing index (a
// weight's per-column scale). A given absmax (one f32) takes the place of
// the reduction: one group, whose max is given, and no reduction launched.
//
// What bounds it: bytes. The function reads x once and writes q once (3
// bytes a bf16 element); the kernels read x twice and write q once, 5
// bytes, less what the second pass finds in the 50 MB L2: its blocks run
// in the first pass's reverse order and each walks its chunk from the end,
// so it starts on what the first pass read last, and it stores q with
// streaming stores that leave x's lines in L2. The reduction has two
// stages and no atomics: each block of the first pass reduces its chunk of
// a group to one max in `part`; each block of the second reduces its
// group's chunk maxima (from L2) to the scale, then quantizes its own
// chunk. Where the rows align a thread loads 16 bytes at a time, kUnroll
// loads in flight before it uses one.

namespace quant {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads a thread has in flight

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

// element i of x as f32
template <bool kBf16>
__device__ __forceinline__ float load1(const void* x, long long i) {
  if constexpr (kBf16)
    return bf16_bits_to_f32(static_cast<const uint16_t*>(x)[i]);
  else
    return static_cast<const float*>(x)[i];
}

// the elements of 16 bytes of x as f32: 8 bf16 or 4 f32
template <bool kBf16>
constexpr int kVec = kBf16 ? 8 : 4;

template <bool kBf16>
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         float (&v)[kVec<kBf16>]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kBf16) {
      v[2 * j] = bf16_bits_to_f32(w[j] & 0xFFFFu);
      v[2 * j + 1] = bf16_bits_to_f32(w[j] >> 16);
    } else {
      v[j] = __uint_as_float(w[j]);
    }
  }
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// the scale of a group whose max |x| is m: torch.clamp_min(m, 1e-8) / 127
// (a NaN compares false and stays)
__device__ __forceinline__ float scale_of(float m) {
  if (m < 1e-8f) m = 1e-8f;
  return __fdiv_rn(m, 127.0f);
}

// x quantized with scale s, rcp = RN(1 / s): rint(RN(x / s)) clamped to
// +-127, NaN to 0, as torch computes it, with a true division only where
// it can decide. y = RN(x * rcp) is within 3 * 2^-24 |x / s| of RN(x / s)
// (each is one or two roundings of the exact quotient), under 2.3e-5 while
// |y| < 128, so where y lies more than 1e-4 from every half-integer both
// round to the same integer; nearer one (a tie among them), past 128 or
// NaN, the division decides. _rn intrinsics: nvcc fuses none of them.
__device__ __forceinline__ int8_t quantize_one(float x, float s, float rcp) {
  const float y = __fmul_rn(x, rcp);
  const float ry = rintf(y);
  // |y - rint(y)|, exact (the two are within a factor of 2 or rint(y) is 0)
  const float d = fabsf(__fsub_rn(y, ry));
  float t = fabsf(y) < 128.0f && fabsf(d - 0.5f) > 1e-4f
                ? ry
                : rintf(__fdiv_rn(x, s));
  t = t < -127.0f ? -127.0f : (t > 127.0f ? 127.0f : t);
  return t != t ? int8_t(0) : static_cast<int8_t>(static_cast<int>(t));
}

__device__ __forceinline__ uint32_t pack4(const int8_t* t) {
  return (uint32_t)(uint8_t)t[0] | (uint32_t)(uint8_t)t[1] << 8 |
         (uint32_t)(uint8_t)t[2] << 16 | (uint32_t)(uint8_t)t[3] << 24;
}

// the int8 of 16 bytes of x to q, with a streaming store (evict first:
// x's lines stay in L2 for the rest of the pass)
template <bool kBf16>
__device__ __forceinline__ void quantize16(const uint4& raw, float s,
                                           float rcp, int8_t* q) {
  float v[kVec<kBf16>];
  int8_t t[kVec<kBf16>];
  unpack16<kBf16>(raw, v);
#pragma unroll
  for (int j = 0; j < kVec<kBf16>; ++j) t[j] = quantize_one(v[j], s, rcp);
  if constexpr (kBf16)
    __stcs(reinterpret_cast<uint2*>(q), make_uint2(pack4(t), pack4(t + 4)));
  else
    __stcs(reinterpret_cast<unsigned int*>(q), pack4(t));
}

// the block's max of m (every thread gets it); called once a kernel
__device__ __forceinline__ uint32_t block_max(uint32_t m) {
  __shared__ uint32_t warp_max[kThreads / 32];
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  return warp_max[0];
}

// I == 1: block (o, c) of the first pass takes elements [c * chunk, (c +
// 1) * chunk) of row o, and writes its max to part[c * O + o]. kVec16:
// the rows and chunks are whole 16 bytes and x is 16-byte aligned, so a
// thread loads 16 bytes at a time, kUnroll loads at once.
template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    sc_quantize_absmax_rows_kernel(const void* __restrict__ x,
                                   uint32_t* __restrict__ part, long long O,
                                   long long R, long long chunk, int chunks) {
  const long long o = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const long long r0 = o * R + c * chunk;
  const long long n = min(R - c * chunk, chunk);
  uint32_t m = 0;
  if constexpr (kVec16) {
    constexpr int V = kVec<kBf16>;
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + r0 * (kBf16 ? 2 : 4));
    const long long nv = n / V;
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nv; i += kUnroll * kThreads) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = p[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[V];
        unpack16<kBf16>(raw[u], v);
#pragma unroll
        for (int j = 0; j < V; ++j) m = max(m, abs_bits(v[j]));
      }
    }
    for (; i < nv; i += kThreads) {
      float v[V];
      unpack16<kBf16>(p[i], v);
#pragma unroll
      for (int j = 0; j < V; ++j) m = max(m, abs_bits(v[j]));
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads)
      m = max(m, abs_bits(load1<kBf16>(x, r0 + i)));
  }
  m = block_max(m);
  if (threadIdx.x == 0) part[(long long)c * O + o] = m;
}

// The second pass: block (o, c) reduces row o's chunk maxima (or takes
// the given absmax) to the scale, writes it (chunk 0), and quantizes its
// chunk. The blocks run in the first pass's reverse order and each walks
// its chunk from the end, so it starts on what the first pass read last,
// which L2 still holds.
template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    sc_quantize_rows_kernel(const void* __restrict__ x,
                            const uint32_t* __restrict__ part,
                            const float* __restrict__ given,
                            int8_t* __restrict__ q, float* __restrict__ scale,
                            long long O, long long R, long long chunk,
                            int chunks) {
  const long long b = gridDim.x - 1 - (long long)blockIdx.x;
  const long long o = b / chunks;
  const int c = b % chunks;
  float m;
  if (given != nullptr) {
    m = *given;
  } else {
    uint32_t bits = 0;
    for (int k = threadIdx.x; k < chunks; k += kThreads)
      bits = max(bits, part[(long long)k * O + o]);
    m = __uint_as_float(block_max(bits));
  }
  const float s = scale_of(m), rcp = __frcp_rn(s);
  if (c == 0 && threadIdx.x == 0) scale[o] = s;
  const long long r0 = o * R + c * chunk;
  const long long n = min(R - c * chunk, chunk);
  if constexpr (kVec16) {
    constexpr int V = kVec<kBf16>;
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + r0 * (kBf16 ? 2 : 4));
    int8_t* qr = q + r0;
    const long long nv = n / V;
    // vector nv - 1 - i, i counting up: the chunk from its end
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nv; i += kUnroll * kThreads) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = p[nv - 1 - i - u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        quantize16<kBf16>(raw[u], s, rcp,
                          qr + (nv - 1 - i - u * kThreads) * V);
    }
    for (; i < nv; i += kThreads)
      quantize16<kBf16>(p[nv - 1 - i], s, rcp, qr + (nv - 1 - i) * V);
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads)
      q[r0 + i] = quantize_one(load1<kBf16>(x, r0 + i), s, rcp);
  }
}

// I > 1: block (o, c, tile) takes rows [c * chunk, (c + 1) * chunk) of
// the kThreads columns of its tile, a thread a column (neighbouring
// threads on neighbouring addresses)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    sc_quantize_absmax_cols_kernel(const void* __restrict__ x,
                                   uint32_t* __restrict__ part, long long O,
                                   long long R, long long I, long long chunk,
                                   int chunks, int tiles) {
  long long b = blockIdx.x;
  const int tile = b % tiles;
  b /= tiles;
  const int c = b % chunks;
  const long long o = b / chunks;
  const long long i = (long long)tile * kThreads + threadIdx.x;
  if (i >= I) return;
  const long long r1 = min(R, (c + 1) * chunk);
  uint32_t m = 0;
  for (long long r = c * chunk; r < r1; ++r)
    m = max(m, abs_bits(load1<kBf16>(x, (o * R + r) * I + i)));
  part[((long long)c * O + o) * I + i] = m;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    sc_quantize_cols_kernel(const void* __restrict__ x,
                            const uint32_t* __restrict__ part,
                            int8_t* __restrict__ q, float* __restrict__ scale,
                            long long O, long long R, long long I,
                            long long chunk, int chunks, int tiles) {
  long long b = blockIdx.x;
  const int tile = b % tiles;
  b /= tiles;
  const int c = b % chunks;
  const long long o = b / chunks;
  const long long i = (long long)tile * kThreads + threadIdx.x;
  if (i >= I) return;
  uint32_t bits = 0;
  for (int k = 0; k < chunks; ++k)
    bits = max(bits, part[((long long)k * O + o) * I + i]);
  const float s = scale_of(__uint_as_float(bits)), rcp = __frcp_rn(s);
  if (c == 0) scale[o * I + i] = s;
  const long long r1 = min(R, (c + 1) * chunk);
  for (long long r = c * chunk; r < r1; ++r) {
    const long long e = (o * R + r) * I + i;
    q[e] = quantize_one(load1<kBf16>(x, e), s, rcp);
  }
}

template <bool kBf16, bool kVec16>
cudaError_t launch_rows(const void* x, uint32_t* part, const float* given,
                        int8_t* q, float* scale, long long O, long long R,
                        long long chunk, int chunks, cudaStream_t st) {
  const unsigned blocks = (unsigned)(O * chunks);
  if (given == nullptr) {
    sc_quantize_absmax_rows_kernel<kBf16, kVec16>
        <<<blocks, kThreads, 0, st>>>(x, part, O, R, chunk, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sc_quantize_rows_kernel<kBf16, kVec16><<<blocks, kThreads, 0, st>>>(
      x, part, given, q, scale, O, R, chunk, chunks);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_quantize(const void* x, uint32_t* part,
                            const float* given, int8_t* q, float* scale,
                            long long O, long long R, long long I,
                            long long chunk, int chunks, cudaStream_t st) {
  constexpr int V = kVec<kBf16>;
  if (I == 1) {
    const bool whole = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % V == 0 &&
                       R % V == 0 && chunk % V == 0;
    return whole ? launch_rows<kBf16, true>(x, part, given, q, scale, O, R,
                                            chunk, chunks, st)
                 : launch_rows<kBf16, false>(x, part, given, q, scale, O, R,
                                             chunk, chunks, st);
  }
  const int tiles = (int)((I + kThreads - 1) / kThreads);
  const unsigned blocks = (unsigned)(O * chunks * tiles);
  sc_quantize_absmax_cols_kernel<kBf16><<<blocks, kThreads, 0, st>>>(
      x, part, O, R, I, chunk, chunks, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sc_quantize_cols_kernel<kBf16><<<blocks, kThreads, 0, st>>>(
      x, part, q, scale, O, R, I, chunk, chunks, tiles);
  return cudaGetLastError();
}

}  // namespace quant

// C entry point of the quantization, loaded with ctypes and handed one
// packed block (`_Args` in quantize.py mirrors it, checked against
// `sc_quantize_launch_args_bytes` at load). x: (outer, reduce, inner)
// contiguous, bf16 (x_bf16) or f32; q: the same shape, int8; scale:
// (outer, inner) f32. Each group's reduce elements are cut into `chunks`
// chunks of `chunk` (the last one ragged); part: chunks * outer * inner
// uint32 of scratch. absmax: a given f32 absmax of the whole tensor
// (outer = inner = 1), or null; part is then unused. Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.
struct ScQuantizeArgs {
  const void* x;
  const float* absmax;
  void* q;
  float* scale;
  void* part;
  void* stream;
  long long outer;
  long long reduce;
  long long inner;
  long long chunk;
  int chunks;
  int x_bf16;
};

extern "C" int sc_quantize_launch_args_bytes() {
  return (int)sizeof(ScQuantizeArgs);
}

extern "C" int sc_quantize_launch(const ScQuantizeArgs* args) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const long long O = args->outer, R = args->reduce, I = args->inner,
                  chunk = args->chunk;
  const int chunks = args->chunks;
  const long long tiles = (I + quant::kThreads - 1) / quant::kThreads;
  if (args->x == nullptr || args->q == nullptr || args->scale == nullptr ||
      O < 1 || R < 1 || I < 1 || chunks < 1 || chunk < 1 ||
      (chunks - 1) * chunk >= R || chunks * chunk < R ||
      O * chunks * tiles > 0x7FFFFFFFLL ||
      (args->absmax != nullptr && (O != 1 || I != 1)) ||
      (args->absmax == nullptr && args->part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(args->stream);
  uint32_t* part = static_cast<uint32_t*>(args->part);
  int8_t* q = static_cast<int8_t*>(args->q);
  return (int)(args->x_bf16
                   ? quant::launch_quantize<true>(args->x, part, args->absmax,
                                                  q, args->scale, O, R, I,
                                                  chunk, chunks, st)
                   : quant::launch_quantize<false>(args->x, part,
                                                   args->absmax, q,
                                                   args->scale, O, R, I,
                                                   chunk, chunks, st));
}
