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
// artefacts of the TPU's layout and do not carry over. A block stages a
// [32 q, 32 c] tile in shared memory and writes it out transposed, so both
// the row reads (along c) and the stores (along q) are coalesced.
//
// What bounds both on an H100: bytes. Each output byte is written once and
// each gathered row read once (rows gathered several times come from L2);
// there is no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int TT = 32;  // transposed tile: 32 q by 32 c
constexpr int TR = 8;   // thread rows of a 32 x 8 block

template <typename T>
__global__ void gather_rows_t_kernel(const T* __restrict__ src,
                                     const int* __restrict__ nmap,
                                     T* __restrict__ out, int R, int C, int Q) {
  __shared__ T tile[TT][TT + 1];
  __shared__ int rows[TT];
  const int k = blockIdx.z;
  const int q0 = blockIdx.x * TT;
  const int c0 = blockIdx.y * TT;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  if (ty == 0) {
    int r = -1;
    if (q0 + tx < Q) {
      r = nmap[static_cast<size_t>(k) * Q + q0 + tx];
      if (r >= R) __trap();
    }
    rows[tx] = r;
  }
  __syncthreads();
  // read: lane tx walks c along one gathered row
  for (int i = ty; i < TT; i += TR) {
    const int r = rows[i];
    T v = T(0);
    if (r >= 0 && c0 + tx < C) v = src[static_cast<size_t>(r) * C + c0 + tx];
    tile[i][tx] = v;
  }
  __syncthreads();
  // write: lane tx walks q along one output row out[k, c, :]
  for (int i = ty; i < TT; i += TR) {
    const int c = c0 + i;
    if (c < C && q0 + tx < Q) {
      out[(static_cast<size_t>(k) * C + c) * Q + q0 + tx] = tile[tx][i];
    }
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

template <typename T>
int launch_rows_t(const void* src, const void* nmap, void* out, int R, int C,
                  int K, int Q, cudaStream_t s) {
  const dim3 grid((Q + TT - 1) / TT, (C + TT - 1) / TT, K);
  gather_rows_t_kernel<T><<<grid, dim3(TT, TR), 0, s>>>(
      static_cast<const T*>(src), static_cast<const int*>(nmap),
      static_cast<T*>(out), R, C, Q);
  return static_cast<int>(cudaGetLastError());
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
  if (elem_bytes == 2) return launch_rows_t<uint16_t>(src, nmap, out, R, C, K, Q, s);
  if (elem_bytes == 4) return launch_rows_t<uint32_t>(src, nmap, out, R, C, K, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
