// Gaussian heatmap targets for Hopper (sm_90a), all maps of a step in one
// launch.
//
//   out[g, y, x] = max(0, max over objects j of map g with valid[g, j] and
//                         |x - cx| <= r, |y - cy| <= r of
//                         exp(-((x - cx)^2 + (y - cy)^2) / (2 sigma^2 + 1e-12)))
//   sigma = (2 r + 1) / 6,   (cx, cy) = centers[g, j], r = radii[g, j]
//
// centers [G, M, 2] int32 (x, y), radii [G, M] int32, valid [G, M] bool,
// out [G, H, W] f32.
//
// Replaces gga_tpu/ops/pallas/heatmap.py:render_heatmap_pallas (kernel
// _kernel), which renders one [H, W] map per call, a tile of 8 rows per grid
// step, with a loop over objects that skips those whose window misses the
// tile. Here one launch renders every (scene, task, class) map of a train
// step: a block owns one (map, 8-row tile), culls the map's objects against
// its rows in shared memory, and max-accumulates the survivors into a
// shared [8, W] tile that is written once.
//
// The arithmetic follows heatmap.py:43-46 operation by operation, in f32,
// with each multiply, add and divide rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no contraction into fma) and the accurate expf.
// Build it without --use_fast_math: at an object's centre the value must be
// exactly 1.0 (expf(-0) = 1), because the focal loss counts heatmap == 1.0.
//
// What bounds it on an H100: the output write (G * H * W * 4 bytes) and the
// launch; each pixel evaluates only the few objects whose window covers its
// rows, so the exps are far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // rows per block, as the TPU kernel's tile
constexpr int THREADS = 256;   // also the objects culled per pass

__global__ void __launch_bounds__(THREADS)
heatmap_kernel(const int* __restrict__ centers, const int* __restrict__ radii,
               const uint8_t* __restrict__ valid, float* __restrict__ out,
               int M, int H, int W) {
  extern __shared__ float acc[];  // [TH, W]
  __shared__ int lx[THREADS], ly[THREADS], lr[THREADS];
  __shared__ float lden[THREADS];
  __shared__ int count;

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * TH;
  const int tid = threadIdx.x;
  const int rows = min(TH, H - row0);
  const int npix = rows * W;
  for (int p = tid; p < npix; p += THREADS) acc[p] = 0.f;

  const int* cg = centers + static_cast<size_t>(g) * M * 2;
  const int* rg = radii + static_cast<size_t>(g) * M;
  const uint8_t* vg = valid + static_cast<size_t>(g) * M;

  for (int j0 = 0; j0 < M; j0 += THREADS) {
    if (tid == 0) count = 0;
    __syncthreads();
    const int j = j0 + tid;
    if (j < M && vg[j]) {
      const int cy = cg[2 * j + 1];
      const int r = rg[j];
      // tile culling, as heatmap.py:36-37
      if (cy + r >= row0 && cy - r < row0 + TH) {
        const int slot = atomicAdd(&count, 1);
        lx[slot] = cg[2 * j];
        ly[slot] = cy;
        lr[slot] = r;
        const float sigma = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, static_cast<float>(r)), 1.f), 6.f);
        lden[slot] = __fadd_rn(__fmul_rn(__fmul_rn(2.f, sigma), sigma), 1e-12f);
      }
    }
    __syncthreads();
    const int n = count;
    for (int p = tid; p < npix; p += THREADS) {
      const int y = row0 + p / W;
      const int x = p - (p / W) * W;
      float a = acc[p];
      for (int i = 0; i < n; ++i) {
        const int dx = x - lx[i];
        const int dy = y - ly[i];
        const int r = lr[i];
        if (abs(dx) <= r && abs(dy) <= r) {
          const float d2 = __fadd_rn(__fmul_rn(static_cast<float>(dx), static_cast<float>(dx)),
                                     __fmul_rn(static_cast<float>(dy), static_cast<float>(dy)));
          const float e = expf(__fdiv_rn(-d2, lden[i]));
          a = fmaxf(a, e);
        }
      }
      acc[p] = a;
    }
    __syncthreads();  // the list is rebuilt by the next pass
  }
  float* og = out + (static_cast<size_t>(g) * H + row0) * W;
  for (int p = tid; p < npix; p += THREADS) og[p] = acc[p];
}

}  // namespace

// Dynamic shared memory one block needs for map width W.
extern "C" int gga_heatmap_smem_bytes(int W) {
  return TH * W * static_cast<int>(sizeof(float));
}

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gga_render_heatmap(const void* centers, const void* radii,
                                  const void* valid, void* out, int G, int M,
                                  int H, int W, void* stream) {
  if (G <= 0 || H <= 0 || W <= 0) return 0;
  const size_t smem = static_cast<size_t>(TH) * W * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        heatmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((H + TH - 1) / TH, G);
  heatmap_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(centers), static_cast<const int*>(radii),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), M, H, W);
  return static_cast<int>(cudaGetLastError());
}
