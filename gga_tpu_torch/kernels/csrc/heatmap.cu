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
// step, with a loop over all object slots that skips those whose window
// misses the tile. Here one launch renders every (scene, task, class) map of
// a train step.
//
// What bounds it on an H100: the output write (G * H * W * 4 bytes; 3.4 MB,
// about 1 us, for a step's 24 maps of 200 x 176) and, below that, the launch
// itself. A map holds a handful of live objects among hundreds of padded
// slots, and an object's window covers a few of its rows, so culling and
// the exps are small beside the write.
//
// The design:
// - A block owns one band of BAND rows of one map: a step's 24 maps of 200
//   rows are 312 blocks, all resident at once on the card's 132 SMs.
// - It culls once: two warps read the map's valid flags as 16-byte vectors
//   (16 slots a lane), load centre and radius of the valid slots, keep those
//   whose window meets the band, and compact them in slot order into a
//   shared list by a popc prefix over warp ballots, with no atomics. Each
//   survivor's denominator is computed there, once.
// - A band with survivors draws only their windows, clipped to the band
//   and the map: one thread a pixel of a window, max-combined into a shared
//   tile of the band by an integer atomicMax. The values are >= 0, so their
//   bits order as the floats do. Scanning every pixel of the band against
//   the survivors instead is issue-bound: it took several microseconds.
// - A band is one contiguous span of the output, and the tile holds it in
//   the output's 16-byte groups: each thread stores groups of 4 pixels as
//   one float4, zeros straight from registers where nothing was drawn. The
//   groups cut by the band's two ends (W % 4 != 0) store pixel by pixel.
// - Past ROUND slots the list is rebuilt for the next ROUND slots and drawn
//   into the same tile.
//
// The arithmetic follows heatmap.py:43-46 operation by operation, in f32,
// with each multiply, add and divide rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no contraction into fma) and the accurate expf.
// Build it without --use_fast_math: at an object's centre the value must be
// exactly 1.0 (expf(-0) = 1), because the focal loss counts heatmap == 1.0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BAND = 16;          // rows per block
constexpr int THREADS = 256;
constexpr int CULL_WARPS = 2;     // warps that cull, 16 slots a lane
constexpr int ROUND = CULL_WARPS * 32 * 16;  // slots culled per round

struct Obj {
  int cx, cy, r;
  float den;
};

// 2 sigma^2 + 1e-12, sigma = (2 r + 1) / 6
__device__ __forceinline__ float denominator(int r) {
  const float sigma =
      __fdiv_rn(__fadd_rn(__fmul_rn(2.f, static_cast<float>(r)), 1.f), 6.f);
  return __fadd_rn(__fmul_rn(__fmul_rn(2.f, sigma), sigma), 1e-12f);
}

__device__ __forceinline__ float gaussian(int dx, int dy, float den) {
  const float fx = static_cast<float>(dx), fy = static_cast<float>(dy);
  const float d2 = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
  return expf(__fdiv_rn(-d2, den));
}

// at most 85 registers a thread, so that 3 blocks share an SM and a step's
// 312 blocks run in one wave
__global__ void __launch_bounds__(THREADS, 3)
heatmap_kernel(const int* __restrict__ centers, const int* __restrict__ radii,
               const uint8_t* __restrict__ valid, float* __restrict__ out,
               int M, int H, int W) {
  extern __shared__ float4 tile4[];  // the band's groups of 4 pixels
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ Obj list[ROUND];
  __shared__ int warp_n[CULL_WARPS];

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BAND;
  const int rows = min(BAND, H - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int* cg = centers + static_cast<size_t>(g) * M * 2;
  const int* rg = radii + static_cast<size_t>(g) * M;
  // the map's valid flags, read as the aligned 16-byte vectors that cover
  // them: vector v holds slots 16 v - lead .. 16 v - lead + 15
  const uint8_t* vg = valid + static_cast<size_t>(g) * M;
  const uintptr_t va = reinterpret_cast<uintptr_t>(vg);
  const uint4* vv = reinterpret_cast<const uint4*>(va & ~uintptr_t(15));
  const int lead = static_cast<int>(va & 15);
  const int nvec = M > 0 ? (lead + M + 15) / 16 : 0;

  // the band is pixels e0 .. e0 + npix - 1 of the flat output, taken in
  // groups of 4 from the 16-byte boundary a0 at or below e0; the tile holds
  // the same groups, so pixel p of the band is tile[p + e0 - a0]
  const int e0 = (g * H + row0) * W;
  const int npix = rows * W;
  const int a0 = e0 & ~3;
  const int ngroups = (e0 + npix - a0 + 3) >> 2;
  bool drawn = false;  // some survivor was drawn (block-uniform)
  // zero the tile while the cull's loads are in flight; the cull's first
  // __syncthreads publishes it
  if (nvec > 0) {
    for (int i = tid; i < ngroups; i += THREADS) {
      reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int v0 = 0; v0 < nvec; v0 += ROUND / 16) {
    // --- cull this round's slots against the band's rows
    uint32_t keep = 0;  // bit b: slot 16 v + b - lead survives
    int pre = 0;        // survivors of the lanes before this one
    int cx[16], cy[16], rr[16];
    if (warp < CULL_WARPS) {
      const int v = v0 + tid;
      if (v < nvec) {
        const uint4 bits = vv[v];
        const uint32_t word[4] = {bits.x, bits.y, bits.z, bits.w};
        uint32_t live = 0;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int s = 16 * v + b - lead;
          if (((word[b >> 2] >> (8 * (b & 3))) & 0xff) && s >= 0 && s < M) {
            live |= 1u << b;
          }
        }
        if (live) {
          // all 16 slots' loads issued together, not one after another
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int s = min(max(16 * v + b - lead, 0), M - 1);
            cx[b] = cg[2 * s];
            cy[b] = cg[2 * s + 1];
            rr[b] = rg[s];
          }
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (((live >> b) & 1) && cy[b] + rr[b] >= row0 &&
                cy[b] - rr[b] < row0 + rows) {
              keep |= 1u << b;
            }
          }
        }
      }
      // exclusive prefix of the survivor counts over the warp's lanes, by
      // ballots of the count's five bits
      const int n = __popc(keep);
      const uint32_t below = (1u << lane) - 1;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        pre += __popc(__ballot_sync(0xffffffffu, (n >> k) & 1) & below) << k;
      }
      if (lane == 31) warp_n[warp] = pre + n;
    }
    __syncthreads();
    if (warp < CULL_WARPS) {
      for (int w = 0; w < warp; ++w) pre += warp_n[w];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if ((keep >> b) & 1) {
          list[pre++] = Obj{cx[b], cy[b], rr[b], denominator(rr[b])};
        }
      }
    }
    int nobj = 0;
#pragma unroll
    for (int w = 0; w < CULL_WARPS; ++w) nobj += warp_n[w];

    // --- draw the survivors' windows, clipped to the band and the map,
    // into the tile: one thread a pixel, max by an integer atomicMax
    // (the values are >= 0, so their bits order as the floats)
    if (nobj > 0) {
      drawn = true;
      __syncthreads();  // the list
      for (int j = 0; j < nobj; ++j) {
        const Obj o = list[j];
        const int xa = max(o.cx - o.r, 0), xb = min(o.cx + o.r, W - 1);
        const int ya = max(o.cy - o.r, row0);
        const int yb = min(o.cy + o.r, row0 + rows - 1);
        const int ww = xb - xa + 1;
        if (ww <= 0 || yb < ya) continue;
        // q / ww by a float reciprocal: exact, as (q + 0.5) / ww lies at
        // least 0.5 / ww from an integer and q < 16 ww
        const float inv = 1.f / static_cast<float>(ww);
        for (int q = tid; q < ww * (yb - ya + 1); q += THREADS) {
          const int dy =
              static_cast<int>((static_cast<float>(q) + 0.5f) * inv);
          const int x = xa + q - dy * ww, y = ya + dy;
          const float val = gaussian(x - o.cx, y - o.cy, o.den);
          atomicMax(reinterpret_cast<int*>(tile) +
                        (y - row0) * W + x + (e0 - a0),
                    __float_as_int(val));
        }
      }
    }
    __syncthreads();  // the list and counts are rebuilt by the next round
  }

  // --- store the band: the tile, or zeros where nothing was drawn; the
  // groups cut by the band's two ends store pixel by pixel
  for (int gi = tid; gi < ngroups; gi += THREADS) {
    const int e = a0 + 4 * gi;
    const float4 v = drawn ? reinterpret_cast<const float4*>(tile)[gi]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const int p0 = e - e0;  // band pixel of the group's first element
    if (p0 >= 0 && p0 + 4 <= npix) {
      *reinterpret_cast<float4*>(out + e) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p0 + i >= 0 && p0 + i < npix) out[e + i] = vs[i];
      }
    }
  }
}

}  // namespace

// Dynamic shared memory one block needs for map width W: the band's groups
// of 4 pixels, one more for a band that does not start on a group.
extern "C" int gga_heatmap_smem_bytes(int W) {
  return ((BAND * W + 3) / 4 + 1) * static_cast<int>(sizeof(float4));
}

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gga_render_heatmap(const void* centers, const void* radii,
                                  const void* valid, void* out, int G, int M,
                                  int H, int W, void* stream) {
  if (G <= 0 || H <= 0 || W <= 0) return 0;
  const int smem = gga_heatmap_smem_bytes(W);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        heatmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((H + BAND - 1) / BAND, G);
  heatmap_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(centers), static_cast<const int*>(radii),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), M, H, W);
  return static_cast<int>(cudaGetLastError());
}
