// Weight gradient of the gather-GEMM sparse convolution, for Hopper (sm_90a).
//
//   dW[k, c, d] = sum_q  [nmap[k, q] >= 0] * features[nmap[k, q], c] * dout[q, d]
//
// features [R, C] bf16, nmap [K, Q] int32 (-1 = miss), dout [Q, D] bf16,
// dW [K, C, D] f32. Products are summed in f32.
//
// Replaces gga_tpu/ops/pallas/window_gather.py:_window_dw (the TPU kernel
// _dw_kernel). It computes the weight gradient of every submanifold conv
// (nmap = the stage's neighbor map) and of every strided conv (nmap = the
// rulebook's forward map). The TPU kernel carries acc[k] across a
// sequential (K, q-block) grid; blocks here run in no order, so Q is split
// over blocks instead: each block owns one offset k, one [64, BN] tile of
// (c, d) and a contiguous range of q, and writes its partial sum to an f32
// scratch [splits, K, C, D]. A second kernel adds the splits in a fixed
// order, so the result does not change from run to run (no atomics).
//
// What bounds it on an H100: the work is 2 * hits * C * D flops against
// the gathered feature rows and the dout rows (hits * C * 2 + K * Q * D * 2
// bytes read through L2) plus the scratch round trip. At the encoder's
// widths (C, D <= 128) that is below the ~295 flop/byte the tensor cores
// need, so it is bound by memory traffic. The design keeps the [K, Q, C]
// gathered intermediate of the plain version out of device memory and
// skips a 64-row tile whose indices are all misses (most tiles at stage 0).
//
// Simple first design, one block of four warps per (split, k, c-tile,
// d-tile):
//   for each 64-row tile of q in the split:
//     load the tile's 64 indices; skip the tile if all miss
//     gather the hit rows of features, transposed, into shared memory
//     (Ft[c][q], zeros for misses and for c past C up to the MMA size)
//     stage dout's tile transposed (Dt[d][q])
//     mma.sync m16n8k16 bf16 -> f32: warp w owns c rows 16w..16w+15
//   write the [64, BN] partial tile to the scratch.
// No wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per tile (the reduction depth)
constexpr int BC = 64;        // c rows per block: four warps of 16
constexpr int THREADS = 128;
constexpr int LDQ = BQ + 8;   // shared row pitch: rows start on other banks
constexpr int TARGET_BLOCKS = 1056;  // 8 per SM on 132 SMs
constexpr int MAX_SPLITS = 128;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// 8-wide MMA column tiles per block for output width D
__host__ __forceinline__ int nt_for(int D) {
  return D <= 16 ? 2 : D <= 32 ? 4 : D <= 64 ? 8 : 16;
}

__host__ int splits_for(int K, int C, int D, int Q) {
  const int tiles = K * ceil_div(C, BC) * ceil_div(D, 8 * nt_for(D));
  int s = ceil_div(TARGET_BLOCKS, tiles > 0 ? tiles : 1);
  const int nqt = ceil_div(Q, BQ);
  if (s > nqt) s = nqt;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  return s < 1 ? 1 : s;
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ nmap,
          const __nv_bfloat16* __restrict__ dout, float* __restrict__ part,
          int R, int C, int K, int Q, int D, int splits) {
  constexpr int BN = NT * 8;
  __shared__ __align__(16) __nv_bfloat16 Ft[BC * LDQ];
  __shared__ __align__(16) __nv_bfloat16 Dt[BN * LDQ];
  __shared__ int rows[BQ];

  const int split = blockIdx.x;
  const int k = blockIdx.y;
  const int ctiles = ceil_div(C, BC);
  const int c0 = (blockIdx.z % ctiles) * BC;
  const int n0 = (blockIdx.z / ctiles) * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  const int c_act = min(BC, C - c0);          // live c rows of this block
  const int c_fill = ceil_div(c_act, 16) * 16;  // rows the MMAs read
  const bool mma_warp = warp * 16 < c_fill;

  const int nqt = ceil_div(Q, BQ);
  const int qt_begin = static_cast<int>(static_cast<long long>(nqt) * split / splits);
  const int qt_end = static_cast<int>(static_cast<long long>(nqt) * (split + 1) / splits);

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's MMAs are done with the tiles
    int any = 0;
    if (tid < BQ) {
      const int q = q0 + tid;
      int r = -1;
      if (q < Q) {
        r = nmap[static_cast<size_t>(k) * Q + q];
        if (r >= R) __trap();  // an index past the feature rows is a caller bug
      }
      rows[tid] = r;
      any = r >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // uniform: every thread skips

    // features, transposed: Ft[c][q] = F[rows[q], c0 + c] (64-bit offsets)
    if ((C & 7) == 0) {
      for (int e = tid; e < (c_fill >> 3) * BQ; e += THREADS) {
        const int q = e & (BQ - 1);
        const int c = (e / BQ) << 3;
        const int src = rows[q];
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (src >= 0 && c < c_act) {
          v = *reinterpret_cast<const uint4*>(
              feat + static_cast<size_t>(src) * C + c0 + c);
        }
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) Ft[(c + j) * LDQ + q] = h[j];
      }
    } else {  // rows not 16-byte multiples (C = 4): scalar loads
      for (int e = tid; e < c_fill * BQ; e += THREADS) {
        const int q = e & (BQ - 1);
        const int c = e / BQ;
        const int src = rows[q];
        __nv_bfloat16 v = zero;
        if (src >= 0 && c < c_act) v = feat[static_cast<size_t>(src) * C + c0 + c];
        Ft[c * LDQ + q] = v;
      }
    }
    // dout, transposed: Dt[d][q] = dout[q0 + q, n0 + d]
    if ((D & 7) == 0) {
      for (int e = tid; e < NT * BQ; e += THREADS) {
        const int q = e & (BQ - 1);
        const int d = (e / BQ) << 3;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + q < Q && n0 + d < D) {
          v = *reinterpret_cast<const uint4*>(
              dout + static_cast<size_t>(q0 + q) * D + n0 + d);
        }
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) Dt[(d + j) * LDQ + q] = h[j];
      }
    } else {
      for (int e = tid; e < BN * BQ; e += THREADS) {
        const int q = e & (BQ - 1);
        const int d = e / BQ;
        __nv_bfloat16 v = zero;
        if (q0 + q < Q && n0 + d < D) v = dout[static_cast<size_t>(q0 + q) * D + n0 + d];
        Dt[d * LDQ + q] = v;
      }
    }
    __syncthreads();

    // A = Ft (rows c, depth q), B = Dt (columns d, depth q); fragment
    // layouts of mma.m16n8k16 as in gather_gemm.cu
    if (mma_warp) {
      const __nv_bfloat16* a0 = Ft + (warp * 16 + g) * LDQ + 2 * t;
      const __nv_bfloat16* a1 = a0 + 8 * LDQ;
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        uint32_t a[4];
        a[0] = lds32(a0 + kk);
        a[1] = lds32(a1 + kk);
        a[2] = lds32(a0 + kk + 8);
        a[3] = lds32(a1 + kk + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* b = Dt + (nt * 8 + g) * LDQ + kk + 2 * t;
          mma_16816(acc[nt], a, lds32(b), lds32(b + 8));
        }
      }
    }
  }

  // every block writes its whole tile (zeros where no q hit), so the
  // reduction can add all splits
  if (!mma_warp) return;
  float* base = part + (static_cast<size_t>(split) * K + k) * C * D;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + warp * 16 + g + 8 * h;
      if (c >= C) continue;
      float* o = base + static_cast<size_t>(c) * D + col;
      if (col < D) o[0] = acc[nt][2 * h];
      if (col + 1 < D) o[1] = acc[nt][2 * h + 1];
    }
  }
}

// out[i] = sum over splits of part[s, i], in split order
__global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                              int n, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += part[static_cast<size_t>(j) * n + i];
    out[i] = s;
  }
}

template <int NT>
int launch(const void* feat, const void* nmap, const void* dout, float* part,
           float* out, int R, int C, int K, int Q, int D, int splits,
           cudaStream_t stream) {
  const int tiles = ceil_div(C, BC) * ceil_div(D, NT * 8);
  const dim3 grid(splits, K, tiles);
  dw_kernel<NT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const int*>(nmap),
      static_cast<const __nv_bfloat16*>(dout), part, R, C, K, Q, D, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * C * D;
  int blocks = ceil_div(n, 256);
  if (blocks > 4096) blocks = 4096;
  reduce_splits<<<blocks, 256, 0, stream>>>(part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of Q splits for these sizes: the caller allocates the scratch
// [splits, K, C, D] f32.
extern "C" int gga_gather_gemm_dw_splits(int K, int C, int D, int Q) {
  return splits_for(K, C, D, Q);
}

// Returns the cudaError_t of the launches (0 = launched). part must hold
// splits * K * C * D floats, splits from gga_gather_gemm_dw_splits.
extern "C" int gga_gather_gemm_dw_bf16(const void* feat, const void* nmap,
                                       const void* dout, void* part, void* out,
                                       int R, int C, int K, int Q, int D,
                                       int splits, void* stream) {
  if (K <= 0 || C <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  switch (nt_for(D)) {
    case 2: return launch<2>(feat, nmap, dout, p, o, R, C, K, Q, D, splits, s);
    case 4: return launch<4>(feat, nmap, dout, p, o, R, C, K, Q, D, splits, s);
    case 8: return launch<8>(feat, nmap, dout, p, o, R, C, K, Q, D, splits, s);
    default: return launch<16>(feat, nmap, dout, p, o, R, C, K, Q, D, splits, s);
  }
}
