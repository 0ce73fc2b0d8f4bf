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
//   16-byte chunks of 4 floats;
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

// ---- f32 tiles (the f32 kernels multiply with FFMA, not the MMA) -----------
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

// Element j (0-3, known at compile time after unrolling) of v.
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
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
