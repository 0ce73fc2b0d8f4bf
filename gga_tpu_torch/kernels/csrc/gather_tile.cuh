// Device helpers shared by the gather-GEMM kernels (gather_gemm.cu and
// gather_gemm_dw.cu), for Hopper (sm_90a).
//
// - cp.async copies (16 bytes, or 8 or 4 for rows that are not 16-byte
//   multiples) into shared memory with zero-fill, so a missed row (index
//   -1), a row past Q and the columns that pad a width up to the MMA size
//   arrive as zeros without a branch around the copy;
// - tile loaders built on them: rows gathered through an index list, and
//   a dense [rows, cols] window of a row-major matrix, at most 128
//   columns;
// - ldmatrix (plain and transposed), movmatrix and mma.sync m16n8k16
//   bf16 -> f32;
// - the f32 kernels' tile loaders (gathered rows, dense windows) in
//   16-byte chunks of 4 floats, the split of an f32 operand into TF32
//   parts and mma.sync m16n8k8 tf32 -> f32, from which the f32 kernels
//   build 3xTF32 products;
// - on the host, a cached count of the blocks that fit on the card.
//
// Every bf16 tile lives in shared memory in its natural row-major layout
// with a row pitch of (width + 8) bf16: consecutive rows then start 16 bytes
// apart modulo 128, so the eight row addresses of one ldmatrix phase hit
// eight different 16-byte bank groups. An operand needed "transposed" by
// the MMA is read with ldmatrix .trans; no element is ever stored
// transposed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace gga {

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) global -> shared, asynchronously; zeros when !valid
// (src is then not read, but must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES),
                    "r"(valid ? BYTES : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The copy loops below are issue-bound at the wide stages, so they are
// written for few instructions a copy: a thread keeps one column of CPT
// 16-byte chunks (CH such columns cover a row, 8 CPT CH >= width) and
// walks the rows tid / CH, + THREADS / CH, ...: one index read and one
// address a row, no division. Rows that are not 16-byte multiples take
// narrower copies, element by element.

// dst[r][0, width) = src[row_of(r)][c0, c0 + width) for r < nrows, zeros
// where row_of(r) < 0 (a miss) and past column C. Indices are < R (the
// callers check them when they load them). width is a multiple of 16 and
// at most 128, c0 a multiple of 128; src rows are C wide.
template <int THREADS, int CH, int CPT, typename RowOf>
__device__ __forceinline__ void gather_rows_16(
    bf16* dst, int ld, int nrows, RowOf row_of,
    const bf16* __restrict__ src, int C, int c0, int width, int tid) {
  static_assert(THREADS % CH == 0 && (CPT == 1 || CPT == 2), "layout");
  const int c = (tid % CH) * 8 * CPT;
  if (c >= width) return;
  const bool col0 = c0 + c < C;
  const bool col1 = c0 + c + 8 < C;
  const bf16* col = src + c0 + c;
  for (int r = tid / CH; r < nrows; r += THREADS / CH) {
    const int s = row_of(r);
    const bf16* row = col + static_cast<size_t>(s < 0 ? 0 : s) * C;
    bf16* d = dst + r * ld + c;
    cp_async<16>(d, s >= 0 && col0 ? row : src, s >= 0 && col0);
    if (CPT == 2) {
      cp_async<16>(d + 8, s >= 0 && col1 ? row + 8 : src, s >= 0 && col1);
    }
  }
}

// Copies of EPC elements (C % EPC == 0).
template <int THREADS, int EPC, typename RowOf>
__device__ __forceinline__ void gather_rows_v(
    bf16* dst, int ld, int nrows, RowOf row_of,
    const bf16* __restrict__ src, int C, int c0, int width, int tid) {
  const int chunks = width / EPC;
  for (int e = tid; e < nrows * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * EPC;
    const int s = row_of(r);
    const bool ok = s >= 0 && c0 + c < C;
    cp_async<EPC * 2>(dst + r * ld + c,
                      ok ? src + static_cast<size_t>(s) * C + c0 + c : src,
                      ok);
  }
}

// The widest copy that divides a row of C elements: 16 bytes, else 8, 4;
// odd C by scalar loads, which have landed by the next __syncthreads.
template <int THREADS, typename RowOf>
__device__ __forceinline__ void gather_rows_async(
    bf16* dst, int ld, int nrows, RowOf row_of,
    const bf16* __restrict__ src, int C, int c0, int width, int tid) {
  if (width > 128) __trap();  // wider tiles are split by the callers
  if ((C & 7) == 0) {
    if (width <= 32) {
      gather_rows_16<THREADS, 4, 1>(dst, ld, nrows, row_of, src, C, c0,
                                    width, tid);
    } else if (width <= 64) {
      gather_rows_16<THREADS, 4, 2>(dst, ld, nrows, row_of, src, C, c0,
                                    width, tid);
    } else {
      gather_rows_16<THREADS, 8, 2>(dst, ld, nrows, row_of, src, C, c0,
                                    width, tid);
    }
  } else if ((C & 3) == 0) {
    gather_rows_v<THREADS, 4>(dst, ld, nrows, row_of, src, C, c0, width,
                              tid);
  } else if ((C & 1) == 0) {
    gather_rows_v<THREADS, 2>(dst, ld, nrows, row_of, src, C, c0, width,
                              tid);
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < nrows * width; e += THREADS) {
      const int r = e / width;
      const int c = e - r * width;
      const int s = row_of(r);
      dst[r * ld + c] = s >= 0 && c0 + c < C
                            ? src[static_cast<size_t>(s) * C + c0 + c]
                            : zero;
    }
  }
}

// dst[r][0, width) = src[(r0 + r) * stride + n0 + c] for r < nrows, zeros
// where r0 + r >= nr or n0 + c >= nc. width is a multiple of 16 and at
// most 128, n0 a multiple of 128, nc <= stride.
template <int THREADS, int CH, int CPT>
__device__ __forceinline__ void copy_tile_16(
    bf16* dst, int ld, int nrows, int width, const bf16* __restrict__ src,
    int stride, int r0, int nr, int n0, int nc, int tid) {
  static_assert(THREADS % CH == 0 && (CPT == 1 || CPT == 2), "layout");
  const int c = (tid % CH) * 8 * CPT;
  if (c >= width) return;
  const bool col0 = n0 + c < nc;
  const bool col1 = n0 + c + 8 < nc;
  const bf16* col = src + static_cast<size_t>(r0) * stride + n0 + c;
  for (int r = tid / CH; r < nrows; r += THREADS / CH) {
    const bool in = r0 + r < nr;
    const bf16* row = col + static_cast<size_t>(in ? r : 0) * stride;
    bf16* d = dst + r * ld + c;
    cp_async<16>(d, in && col0 ? row : src, in && col0);
    if (CPT == 2) cp_async<16>(d + 8, in && col1 ? row + 8 : src, in && col1);
  }
}

// Copies of EPC elements (stride % EPC == 0).
template <int THREADS, int EPC>
__device__ __forceinline__ void copy_tile_v(
    bf16* dst, int ld, int nrows, int width, const bf16* __restrict__ src,
    int stride, int r0, int nr, int n0, int nc, int tid) {
  const int chunks = width / EPC;
  for (int e = tid; e < nrows * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * EPC;
    const bool ok = r0 + r < nr && n0 + c < nc;
    cp_async<EPC * 2>(
        dst + r * ld + c,
        ok ? src + static_cast<size_t>(r0 + r) * stride + n0 + c : src, ok);
  }
}

template <int THREADS>
__device__ __forceinline__ void copy_tile_async(
    bf16* dst, int ld, int nrows, int width, const bf16* __restrict__ src,
    int stride, int r0, int nr, int n0, int nc, int tid) {
  if (width > 128) __trap();  // wider tiles are split by the callers
  if ((stride & 7) == 0) {
    if (width <= 32) {
      copy_tile_16<THREADS, 4, 1>(dst, ld, nrows, width, src, stride, r0, nr,
                                  n0, nc, tid);
    } else if (width <= 64) {
      copy_tile_16<THREADS, 4, 2>(dst, ld, nrows, width, src, stride, r0, nr,
                                  n0, nc, tid);
    } else {
      copy_tile_16<THREADS, 8, 2>(dst, ld, nrows, width, src, stride, r0, nr,
                                  n0, nc, tid);
    }
  } else if ((stride & 3) == 0) {
    copy_tile_v<THREADS, 4>(dst, ld, nrows, width, src, stride, r0, nr, n0,
                            nc, tid);
  } else if ((stride & 1) == 0) {
    copy_tile_v<THREADS, 2>(dst, ld, nrows, width, src, stride, r0, nr, n0,
                            nc, tid);
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < nrows * width; e += THREADS) {
      const int r = e / width;
      const int c = e - r * width;
      dst[r * ld + c] =
          r0 + r < nr && n0 + c < nc
              ? src[static_cast<size_t>(r0 + r) * stride + n0 + c]
              : zero;
    }
  }
}

// ---- f32 tiles (3xTF32 on the tensor cores; FFMA at C and D <= 32) -------
// Row-major like the bf16 tiles, with a row pitch a multiple of 4 floats so
// that each row starts 16-byte aligned. A thread copies one 16-byte chunk
// (4 floats) of a row at a time, neighbouring threads the neighbouring
// chunks of one row; rows whose width is not a multiple of 4 floats are
// copied a float at a time.

// dst[r][0, WIDTH) = src[row_of(r)][c0, c0 + WIDTH) for r < nrows, zeros
// where row_of(r) < 0 (a miss) and past column C. WIDTH is a multiple of
// 4, c0 a multiple of WIDTH; src rows are C wide.
template <int THREADS, int WIDTH, typename RowOf>
__device__ __forceinline__ void gather_rows_f32(
    float* dst, int ld, int nrows, RowOf row_of,
    const float* __restrict__ src, int C, int c0, int tid) {
  static_assert(WIDTH % 4 == 0, "16-byte chunks");
  if ((C & 3) == 0) {
    constexpr int CH = WIDTH / 4;
    for (int e = tid; e < nrows * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e - r * CH) * 4;
      const int s = row_of(r);
      const bool ok = s >= 0 && c0 + c < C;
      cp_async<16>(dst + r * ld + c,
                   ok ? src + static_cast<size_t>(s) * C + c0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < nrows * WIDTH; e += THREADS) {
      const int r = e / WIDTH;
      const int c = e - r * WIDTH;
      const int s = row_of(r);
      const bool ok = s >= 0 && c0 + c < C;
      cp_async<4>(dst + r * ld + c,
                  ok ? src + static_cast<size_t>(s) * C + c0 + c : src, ok);
    }
  }
}

// dst[r][0, WIDTH) = src[(r0 + r) * stride + n0 + c] for r < nrows, zeros
// where r0 + r >= nr or n0 + c >= stride. n0 is a multiple of 4.
template <int THREADS, int WIDTH>
__device__ __forceinline__ void copy_tile_f32(
    float* dst, int ld, int nrows, const float* __restrict__ src, int stride,
    int r0, int nr, int n0, int tid) {
  static_assert(WIDTH % 4 == 0, "16-byte chunks");
  if ((stride & 3) == 0) {
    constexpr int CH = WIDTH / 4;
    for (int e = tid; e < nrows * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e - r * CH) * 4;
      const bool ok = r0 + r < nr && n0 + c < stride;
      cp_async<16>(dst + r * ld + c,
                   ok ? src + static_cast<size_t>(r0 + r) * stride + n0 + c
                      : src,
                   ok);
    }
  } else {
    for (int e = tid; e < nrows * WIDTH; e += THREADS) {
      const int r = e / WIDTH;
      const int c = e - r * WIDTH;
      const bool ok = r0 + r < nr && n0 + c < stride;
      cp_async<4>(dst + r * ld + c,
                  ok ? src + static_cast<size_t>(r0 + r) * stride + n0 + c
                     : src,
                  ok);
    }
  }
}

// ---- 3xTF32 -----------------------------------------------------------------
// An f32 operand x is split into TF32 parts, x = hi + lo: hi is x
// truncated to TF32 (its 13 low mantissa bits cleared: one instruction,
// never rounded up to inf) and lo = x - hi (exact in f32), of which the
// tensor core reads the top 19 bits, as it reads every TF32 operand. A
// product is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 sums.
// What is lost, each of the sign of ab: lo_a lo_b (below 2^-20 |ab|) and
// the bits of lo_a, lo_b below TF32 (below 2^-20 |ab| each), so a product
// is within 3 * 2^-20 of ab and the sum keeps f32 accuracy. Rounding lo
// to nearest (cvt.rna) instead measured 16 % slower at 128 -> 128
// (f32_ablations.py): the conversion runs at a fraction of the FP32 rate.
// Non-finite x (hi not finite): lo = 0, and the cross terms take hx = 0 in
// place of hi (hx = hi for finite x), so that inf times an exact TF32
// value (whose lo is 0) stays inf instead of becoming inf * 0 = NaN, and a
// finite operand never gives a NaN. (A NaN whose payload lies only in the
// 13 low bits reads as inf.) Those three instructions an element cost
// 11 % at 128 -> 128 (f32_ablations.py); checking each pipeline item's
// tiles for a non-finite value to skip them measured slower still.
struct Tf32x3 {
  uint32_t hi, lo, hx;
};

__device__ __forceinline__ Tf32x3 split_tf32(float x) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  const float hf = __uint_as_float(h);
  const bool finite = fabsf(hf) < __int_as_float(0x7f800000);
  Tf32x3 s;
  s.hi = h;
  s.lo = finite ? __float_as_uint(x - hf) : 0u;
  s.hx = finite ? h : 0u;
  return s;
}

// d += a @ b for one m16n8k8 tile, tf32 in, f32 accumulate. Fragments
// (PTX ISA; g = lane / 4, t = lane % 4): a[0] row g, column t; a[1] row
// g + 8, column t; a[2] row g, column t + 4; a[3] row g + 8, column t + 4;
// b0 row t, b1 row t + 4 of column g; d as for m16n8k16.
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a @ b in 3xTF32: the two cross terms, then hi_a hi_b. The tensor
// core's f32 accumulation truncates, so a chain of MMAs over a whole sum
// drifts toward zero (past the 1e-5 of max|plain| gate at 64 -> 64 on the
// card, where FFMA stays near 1e-6): the callers keep d for a short chain (one
// pipeline item, at most 4 k-steps) started from zero and add it to their
// running sums with f32 adds, which round to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const Tf32x3 (&a)[4],
                                           const Tf32x3 (&b)[2]) {
  mma_1688(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hx, b[1].hx);
  mma_1688(d, a[0].hx, a[1].hx, a[2].hx, a[3].hx, b[0].lo, b[1].lo);
  mma_1688(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The split A fragments of a 16 (m) x 8 (k) f32 tile at p. Row-major
// ([m][k], pitch ld, ld % 32 == 4 for conflict-free reads) or, with
// TRANS, stored [k][m] (ld % 32 == 8).
template <bool TRANS>
__device__ __forceinline__ void load_a_f32(Tf32x3 (&a)[4], const float* p,
                                           int ld, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = g + 8 * (i & 1);
    const int k = t + 4 * (i >> 1);
    a[i] = split_tf32(TRANS ? p[k * ld + m] : p[m * ld + k]);
  }
}

// The split B fragments of an 8 (k) x 8 (n) f32 tile stored [k][n] at p
// (pitch ld, ld % 32 == 8 for conflict-free reads).
__device__ __forceinline__ void load_b_f32(Tf32x3 (&b)[2], const float* p,
                                           int ld, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  b[0] = split_tf32(p[t * ld + g]);
  b[1] = split_tf32(p[(t + 4) * ld + g]);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i. Plain: lane l receives row l/4, columns 2(l%4), +1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Transposed: lane l receives rows 2(l%4), +1 of column l/4 of each.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The 8x8 b16 matrix whose plain fragment (lane l: row l/4, columns
// 2(l%4), +1) is x, transposed: lane l receives row l/4 of the transpose.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// d += a @ b for one m16n8k16 tile, bf16 in, f32 accumulate. Fragments
// (PTX ISA): a[i] holds row g (+8 for i = 1, 3), columns 2t, 2t+1 (+8 for
// i = 2, 3); b0 rows 2t, 2t+1 and b1 rows 2t+8, 2t+9 of column g; d[0..1]
// row g, columns 2t, 2t+1, d[2..3] row g+8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of a 16 x 16 tile stored row-major (rows m, columns k) at
// p with pitch ld: lane l addresses row l % 16, column 8 (l / 16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int lane) {
  ldsm_x4(a, p + (lane & 15) * ld + ((lane >> 4) << 3));
}

// A fragments of a 16 (m) x 16 (k) tile stored transposed, row-major as
// [k][m] at p with pitch ld: matrix i = (k half i / 2, m half i % 2).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* p,
                                         int ld, int lane) {
  ldsm_x4_t(a, p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                   (((lane >> 3) & 1) << 3));
}

// B fragments of two 8-column tiles of a 16 (k) x 16 (n) tile stored
// row-major as [k][n] at p with pitch ld: b[0], b[1] for columns 0-7,
// b[2], b[3] for columns 8-15.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const bf16* p,
                                            int ld, int lane) {
  ldsm_x4_t(b, p + (lane & 15) * ld + ((lane >> 4) << 3));
}

// Blocks of kernel fn (threads each, smem bytes of dynamic shared memory)
// that fit on the current device at once; the first call per (fn, device)
// also lifts fn's shared-memory limit to the card's. Cached: the runtime
// queries take longer than launching a small kernel.
inline cudaError_t card_blocks(const void* fn, int threads, int smem,
                               int* blocks) {
  struct Entry {
    const void* fn;
    int dev, threads, smem, blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool lifted = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn != fn || e.dev != dev) continue;
    lifted = true;
    if (e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  if (!lifted) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, smem)) != cudaSuccess) {
    return err;
  }
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (used < 64) cache[used++] = Entry{fn, dev, threads, smem, *blocks};
  return cudaSuccess;
}

}  // namespace gga
