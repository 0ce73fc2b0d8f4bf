// Masked row gather for Hopper (sm_90a), in two layouts.
//
//   gather_rows:   out[m, :]    = idx[m] >= 0 ? src[idx[m], :] : 0     src [N, C], idx [M]
//   gather_rows_t: out[k, :, q] = nmap[k, q] >= 0 ? src[nmap[k, q], :] : 0
//                                                                   src [R, C], nmap [K, Q]
//
// Any element type of 2 or 4 bytes (bf16, f32); the copy is bitwise. An
// index past the source rows stops the kernel (__trap).
//
// gather_rows replaces gga_tpu/ops/pallas/gather_rows.py: gather_rows_pallas
// (kernel _kernel), gather_rows_unroll (_kernel_unroll) and gather_rows_vec
// (_kernel_vec), three TPU variants of out[m] = src[idx[m]], here with the
// -1 -> zero row contract of gga_tpu's _rb_gather (ops/sparse.py:1467).
// It serves the strided conv's input gradient: dout rows gathered through
// the compact backward map bwd_d. The TPU kernels keep src resident in VMEM
// and copy one row per loop step; here each thread copies one 16-byte chunk
// (or the widest unit that divides the row), so a warp moves 512 bytes of
// rows per instruction and consecutive threads touch consecutive bytes of a
// row.
//
// gather_rows_t replaces window_gather.py:_window_gather_t (kernel _kernel,
// via window_gather_t): the same gather, stored transposed [K, C, Q]. The
// TPU kernel's wide-row window, one-hot selection and overflow fallback are
// artefacts of the TPU's layout and do not carry over. The design:
// - A block owns (k, TQ consecutive q) and all of C. It reads its TQ
//   indices once, then, per pass over at most 256 bytes of each row, brings
//   the gathered rows into a shared tile by 16-byte cp.async with zero-fill
//   (no load is issued for a miss), or by the widest copy that divides a
//   row (8, 4 or 2 bytes) where rows are not 16-byte multiples (C = 3, 4,
//   6). TQ is 128 at rows of 256 bytes and grows as rows narrow, up to
//   1024, so that a tile holds 32 KB.
// - The tile's 16-byte chunks are swizzled: chunk j of tile row t lies at
//   chunk (t * pitch + j) ^ ((t / 8) % 8). One shared load of a warp reads
//   the 4 words of one chunk column in one row of each of 8 row groups
//   (rows 8 m + i, m = 0 .. 7); the swizzle puts the 8 rows on 8
//   different 16-byte bank groups, so the transposed read has no bank
//   conflict.
// - A thread turns 8 words (rows t .. t + 7 of one word column) into 8
//   consecutive q of 2 channels (bf16) or of 1 channel (f32) and stores
//   them 16 bytes at a time: a warp's store covers 4 output rows x 128
//   contiguous bytes.
// - Where Q * esize % 16 != 0, output rows start at alternating
//   alignments: the stores then take the widest width that divides
//   Q * esize (8, 4 or 2 bytes). The last q group of a row that Q cuts
//   stores element by element.
//
// What bounds both on an H100: bytes. Each output byte is written once and
// each gathered row read once (rows gathered several times come from L2);
// there is no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_tile.cuh"

namespace {

// one thread per VEC-sized unit of a row; rows are `units` units long
template <typename VEC>
__global__ void gather_rows_kernel(const VEC* __restrict__ src,
                                   const int* __restrict__ idx,
                                   VEC* __restrict__ out, int N, int M,
                                   int units) {
  const long long total = static_cast<long long>(M) * units;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(e / units);
    const int u = static_cast<int>(e - static_cast<long long>(m) * units);
    const int r = idx[m];
    if (r >= N) __trap();  // an index past the source rows is a caller bug
    VEC v{};  // zeros for a miss
    if (r >= 0) v = src[static_cast<size_t>(r) * units + u];
    out[e] = v;
  }
}

constexpr int T_THREADS = 256;
constexpr int PASS_BYTES = 256;  // bytes of each gathered row per pass
constexpr int MAX_TQ = 1024;     // q rows of a tile, at most

// 16-byte chunk of the tile that holds chunk j of tile row t (pitch 1 << lp
// chunks)
__device__ __forceinline__ int tile_chunk(int t, int j, int lp) {
  return ((t << lp) | j) ^ ((t >> 3) & 7);
}

// Bytes [0, n) of the words v to dst: 16 bytes at a time where n is all of
// them and the row allows it (step == 16), else in pieces of step (8, 4 or
// 2) bytes.
template <int NW>
__device__ __forceinline__ void store_words(char* dst,
                                            const uint32_t (&v)[NW], int n,
                                            int step) {
  if (n == 4 * NW && step == 16) {
#pragma unroll
    for (int i = 0; i < NW; i += 4) {
      *reinterpret_cast<uint4*>(dst + 4 * i) =
          make_uint4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
    return;
  }
  for (int o = 0; o < n; o += step) {
    const int i = o >> 2;
    if (step == 8) {
      *reinterpret_cast<uint2*>(dst + o) = make_uint2(v[i], v[i + 1]);
    } else if (step == 4) {
      *reinterpret_cast<uint32_t*>(dst + o) = v[i];
    } else {
      *reinterpret_cast<uint16_t*>(dst + o) =
          static_cast<uint16_t>(v[i] >> (8 * (o & 2)));
    }
  }
}

// E-byte elements, rows copied U bytes at a time; a block is
// (blockIdx.x: q tile of 1 << lq, blockIdx.y: k); sw = the widest store
// (16, 8, 4, 2 bytes) that divides Q * E.
template <int E, int U>
__global__ void __launch_bounds__(T_THREADS)
gather_rows_t_kernel(const char* __restrict__ src, const int* __restrict__ nmap,
                     char* __restrict__ out, int R, int C, int Q, int lq,
                     int lp, int sw) {
  extern __shared__ uint4 tile_mem[];
  __shared__ int rows[MAX_TQ];
  char* tile = reinterpret_cast<char*>(tile_mem);
  const int tq = 1 << lq;
  const int k = blockIdx.y;
  const int q0 = blockIdx.x << lq;
  const int tid = threadIdx.x;
  const int* nk = nmap + static_cast<size_t>(k) * Q;
  for (int t = tid; t < tq; t += T_THREADS) {
    int r = -1;
    if (q0 + t < Q) {
      r = nk[q0 + t];
      if (r >= R) __trap();  // an index past the source rows is a caller bug
    }
    rows[t] = r;
  }
  __syncthreads();

  const int row_bytes = C * E;
  for (int b0 = 0; b0 < row_bytes; b0 += PASS_BYTES) {
    const int nb = min(PASS_BYTES, row_bytes - b0);
    // gathered rows [tq, nb bytes] into the tile, zeros for misses
    if constexpr (U == 16) {
      const int j = tid & ((1 << lp) - 1);  // a fixed chunk column
      if (j * 16 < nb) {
        for (int t = tid >> lp; t < tq; t += T_THREADS >> lp) {
          const int r = rows[t];
          const char* s =
              src + static_cast<size_t>(max(r, 0)) * row_bytes + b0 + j * 16;
          gga::cp_async<16>(tile + tile_chunk(t, j, lp) * 16,
                            r >= 0 ? s : src, r >= 0);
        }
      }
    } else {
      const int units = nb / U;
      for (int e = tid; e < tq * units; e += T_THREADS) {
        const int t = e / units;
        const int b = (e - t * units) * U;
        const int r = rows[t];
        char* d = tile + tile_chunk(t, b >> 4, lp) * 16 + (b & 15);
        const char* s =
            src + static_cast<size_t>(max(r, 0)) * row_bytes + b0 + b;
        if constexpr (U == 2) {
          *reinterpret_cast<uint16_t*>(d) =
              r >= 0 ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
        } else {
          gga::cp_async<U>(d, r >= 0 ? s : src, r >= 0);
        }
      }
    }
    gga::cp_async_commit();
    gga::cp_async_wait<0>();
    __syncthreads();

    // transposed stores. Unit u: lanes bits 0-2 pick the q group's low
    // bits (m), bits 3-4 the word of a chunk (w), then the q group's high
    // bits, then the chunk (j).
    const int nwords = (nb + 3) >> 2;
    const int units = ((nb + 15) >> 4) << (lq - 1);
    for (int u = tid; u < units; u += T_THREADS) {
      const int w = (u >> 3) & 3;
      const int m = (u & 7) | (((u >> 5) & ((1 << (lq - 6)) - 1)) << 3);
      const int j = u >> (lq - 1);
      const int wc = 4 * j + w;
      const int q = q0 + 8 * m;
      const int nq = min(8, Q - q);
      if (wc >= nwords || nq <= 0) continue;
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = *reinterpret_cast<const uint32_t*>(
            tile + tile_chunk(8 * m + i, j, lp) * 16 + w * 4);
      }
      const int c = (b0 + 4 * wc) / E;
      const int step = nq == 8 ? sw : E;
      char* d = out + ((static_cast<size_t>(k) * C + c) * Q + q) * E;
      if constexpr (E == 2) {
        uint32_t lo[4], hi[4];  // channel c, channel c + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = __byte_perm(v[2 * i], v[2 * i + 1], 0x5410);
          hi[i] = __byte_perm(v[2 * i], v[2 * i + 1], 0x7632);
        }
        store_words(d, lo, nq * 2, step);
        if (c + 1 < C) {
          store_words(d + static_cast<size_t>(Q) * 2, hi, nq * 2, step);
        }
      } else {
        store_words(d, v, nq * 4, step);
      }
    }
    __syncthreads();  // the next pass refills the tile
  }
}

template <typename VEC>
int launch_rows(const void* src, const void* idx, void* out, int N, int M,
                int row_bytes, cudaStream_t s) {
  const int units = row_bytes / static_cast<int>(sizeof(VEC));
  const long long total = static_cast<long long>(M) * units;
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  gather_rows_kernel<VEC><<<static_cast<int>(blocks), 256, 0, s>>>(
      static_cast<const VEC*>(src), static_cast<const int*>(idx),
      static_cast<VEC*>(out), N, M, units);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int U>
int launch_rows_t_by(const void* src, const void* nmap, void* out, int R,
                     int C, int K, int Q, cudaStream_t s) {
  // pitch of a tile row: the chunks of one pass, rounded up to a power of
  // two; as many q rows as make 32 KB, at most MAX_TQ
  const int pass = C * E < PASS_BYTES ? C * E : PASS_BYTES;
  int lp = 0;
  while ((16 << lp) < pass) ++lp;
  const int lq = lp == 0 ? 10 : 11 - lp;
  const int qb = Q * E;
  const int sw = qb % 16 == 0 ? 16 : qb % 8 == 0 ? 8 : qb % 4 == 0 ? 4 : 2;
  const dim3 grid((Q + (1 << lq) - 1) >> lq, K);
  const size_t smem = static_cast<size_t>(16) << (lq + lp);
  gather_rows_t_kernel<E, U><<<grid, T_THREADS, smem, s>>>(
      static_cast<const char*>(src), static_cast<const int*>(nmap),
      static_cast<char*>(out), R, C, Q, lq, lp, sw);
  return static_cast<int>(cudaGetLastError());
}

// rows copied by the widest unit that divides them
template <int E>
int launch_rows_t(const void* src, const void* nmap, void* out, int R, int C,
                  int K, int Q, cudaStream_t s) {
  const int row_bytes = C * E;
  if (row_bytes % 16 == 0) {
    return launch_rows_t_by<E, 16>(src, nmap, out, R, C, K, Q, s);
  }
  if (row_bytes % 8 == 0) {
    return launch_rows_t_by<E, 8>(src, nmap, out, R, C, K, Q, s);
  }
  if constexpr (E == 2) {
    if (row_bytes % 4 != 0) {
      return launch_rows_t_by<2, 2>(src, nmap, out, R, C, K, Q, s);
    }
  }
  return launch_rows_t_by<E, 4>(src, nmap, out, R, C, K, Q, s);
}

}  // namespace

// src [N, C] of elem_bytes-wide elements (2 or 4), idx [M] -> out [M, C].
// The caller guarantees 16-byte aligned src and out.
extern "C" int gga_gather_rows(const void* src, const void* idx, void* out,
                               int N, int M, int C, int elem_bytes,
                               void* stream) {
  if (M <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = C * elem_bytes;
  if (row_bytes % 16 == 0) return launch_rows<uint4>(src, idx, out, N, M, row_bytes, s);
  if (row_bytes % 8 == 0) return launch_rows<uint2>(src, idx, out, N, M, row_bytes, s);
  if (row_bytes % 4 == 0) return launch_rows<uint32_t>(src, idx, out, N, M, row_bytes, s);
  return launch_rows<uint16_t>(src, idx, out, N, M, row_bytes, s);
}

// src [R, C] of elem_bytes-wide elements (2 or 4), nmap [K, Q] -> out [K, C, Q].
extern "C" int gga_gather_rows_t(const void* src, const void* nmap, void* out,
                                 int R, int C, int K, int Q, int elem_bytes,
                                 void* stream) {
  if (K <= 0 || C <= 0 || Q <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch_rows_t<2>(src, nmap, out, R, C, K, Q, s);
  if (elem_bytes == 4) return launch_rows_t<4>(src, nmap, out, R, C, K, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
