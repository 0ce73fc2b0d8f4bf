// Fused gather-GEMM sparse convolution for Hopper (sm_90a).
//
//   out[q, :] = sum_k  [nmap[k, q] >= 0] * features[nmap[k, q], :] @ weights[k]
//
// features [R, C] bf16, nmap [K, Q] int32 (-1 = miss), weights [K, C, D]
// bf16, out [Q, D] bf16. The sum runs in f32 and is rounded to bf16 once.
// An f32 entry (gga_gather_gemm_conv_f32, the "f32 path" at the end) takes
// f32 features and weights and writes f32, with FFMA products and sums.
//
// Replaces gga_tpu/ops/pallas/window_gather.py:_window_conv (the TPU
// kernel _conv_kernel). It computes the forward of every submanifold conv
// (nmap = the stage's neighbor map), of every strided conv (nmap = the
// rulebook's forward map) and the input gradient of every submanifold
// conv (same map, weights flipped over k and transposed). The TPU
// kernel's wide-row view, one-hot window selection and overflow fallback
// are not carried over: the kernel reads its own indices and gathers the
// rows it needs straight from device memory.
//
// What bounds it on an H100. The work is 2 * hits * C * D flops against
// the gathered rows (hits * C * 2 bytes, from L2: each row is gathered by
// up to K outputs), the weights and one [Q, D] write. At the encoder's
// widths the flops bound sits below the bytes bound (per stage-3 forward
// 0.18 ms of tensor-core time against 0.28 ms of device memory), so the
// kernel is bound by memory, and in practice by the latency and the rate
// of the row gathers: every output row is a chain of K dependent gathers.
// The earlier design ran that chain as K serial round trips (load
// indices, vote, gather, stage W[k] with 2-byte transposed stores, MMA)
// with no copy in flight during the MMAs. Two paths replace it.
//
// Narrow path (C and D <= 32, even: conv_input and stages 0-1, forward and
// input gradient). W of all K offsets stays resident in shared memory
// (<= 69 KB), loaded once per persistent block in its natural [C, D]
// layout. Each warp then owns 16 output rows at a time and needs no
// barrier: for a chunk of offsets it loads the A fragments of mma.sync
// m16n8k16 straight from the gathered feature rows into registers (4-byte
// loads; zeros for misses and the C padding) while the next chunk's
// indices load, then runs the MMAs with B fragments from the resident W by
// ldmatrix .trans.
// An offset that no row of the warp hits is skipped. With a few hundred
// such independent chains per SM the gather latency is hidden by
// parallelism instead of by a ring.
//
// Tile path (everything else: C or D >= 64 and odd widths), one block per
// tile of BM output rows and BN <= 128 output columns:
//   1. Indices once: the block copies its whole [K, BM] index tile with
//      cp.async in one round trip (an index >= R traps) and lists the
//      offsets with at least one hit. An all-miss tile writes zeros.
//   2. A ring of cp.async stages: pipeline item i is (live offset, C chunk
//      of <= 128 columns). Its rows are gathered by 16-byte cp.async with
//      zero-fill (misses, C padding; 8- or 4-byte copies for rows that are
//      not 16-byte multiples) and its W[k] tile is copied in its natural
//      [C, D] layout, while the MMAs of item i - 2 run. Three stages, or
//      two where that lets two blocks share an SM (64 -> 128). The copy
//      loops and the ring's positions are written for few instructions:
//      at the wide stages the kernel is bound by issuing them as much as
//      by the L2 gathers.
//   3. mma.sync m16n8k16 bf16 -> f32, A by ldmatrix, B by ldmatrix .trans
//      from the row-major W tile: no transposed staging anywhere. Warps
//      tile 32 x BN / 2 (BN >= 64) or 16 x BN.
//   4. The [BM, BN] result is rounded to bf16 once, staged in shared
//      memory and written with 16-byte stores.
// mma.sync rather than wgmma: the tensor-core time at full rate (0.18 ms a
// forward) is below the memory time, and the measured kernels run at 8-16 %
// of the bytes bound at the wide stages, paced by issuing the ring's copies
// and its ldmatrix and MMA work one after the other; at 128 -> 128 the
// MMAs are about half of that, where wgmma would be the next step.
// D wider than 128 is split over blockIdx.y; C wider than 128 takes several
// items per offset. Offsets into features, nmap and W are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_tile.cuh"

namespace {

using namespace gga;

constexpr int MAX_SMEM = 232448;  // per block, H100

// ---- narrow path ----------------------------------------------------------

constexpr int N_WARPS = 8;
constexpr int N_THREADS = 32 * N_WARPS;

__host__ inline int narrow_smem(int K, int kp, int bn) {
  return K * kp * (bn + 8) * 2;
}

// KP = C padded to 16 (16 or 32), BN = D padded to 16 (16 or 32)
template <int KP, int BN>
__global__ void __launch_bounds__(N_THREADS)
conv_narrow(const bf16* __restrict__ feat, const int* __restrict__ nmap,
            const bf16* __restrict__ w, bf16* __restrict__ out, int R, int C,
            int K, int Q, int D) {
  constexpr int LDB = BN + 8;
  constexpr int KS = KP / 16;  // MMA k steps per offset
  constexpr int NT = BN / 8;
  constexpr int KC = KP == 16 ? 9 : 3;  // offsets a warp holds at once
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wres = reinterpret_cast<bf16*>(smem);  // [K][KP][LDB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int k = 0; k < K; ++k) {  // zeros past C and D
    copy_tile_async<N_THREADS>(wres + k * KP * LDB, LDB, KP, BN,
                               w + static_cast<size_t>(k) * C * D, D, 0, C, 0,
                               D, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The warp walks (16-row tile, chunk of KC offsets) positions; the
  // indices of the next position load while the current one's rows are
  // gathered and multiplied.
  const int tiles = ceil_div(Q, 16);
  const int stride = gridDim.x * N_WARPS;
  auto load_idx = [&](int tile, int k0, int (&xa)[KC], int (&xb)[KC]) {
    const int qa = tile * 16 + g;  // fragment rows g and g + 8
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const size_t base = static_cast<size_t>(k0 + j) * Q;
      const bool ok = tile < tiles && k0 + j < K;
      xa[j] = ok && qa < Q ? __ldg(nmap + base + qa) : -1;
      xb[j] = ok && qa + 8 < Q ? __ldg(nmap + base + qa + 8) : -1;
    }
  };
  int tile = blockIdx.x * N_WARPS + warp;
  int k0 = 0;
  int ia[KC], ib[KC];
  load_idx(tile, k0, ia, ib);
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  while (tile < tiles) {
    int next_tile = tile, next_k0 = k0 + KC;
    if (next_k0 >= K) {
      next_tile += stride;
      next_k0 = 0;
    }
    int na[KC], nb[KC];
    load_idx(next_tile, next_k0, na, nb);

    // a[j][s]: rows g / g + 8, columns 16 s + 2 t (+ 8), zeros past C
    uint32_t a[KC][KS][4];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (ia[j] >= R || ib[j] >= R) __trap();  // a caller bug
      const uint32_t* ra = reinterpret_cast<const uint32_t*>(
          feat + static_cast<size_t>(ia[j] < 0 ? 0 : ia[j]) * C);
      const uint32_t* rb = reinterpret_cast<const uint32_t*>(
          feat + static_cast<size_t>(ib[j] < 0 ? 0 : ib[j]) * C);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c = 16 * s + 2 * t;
        a[j][s][0] = ia[j] >= 0 && c < C ? __ldg(ra + c / 2) : 0u;
        a[j][s][1] = ib[j] >= 0 && c < C ? __ldg(rb + c / 2) : 0u;
        a[j][s][2] = ia[j] >= 0 && c + 8 < C ? __ldg(ra + c / 2 + 4) : 0u;
        a[j][s][3] = ib[j] >= 0 && c + 8 < C ? __ldg(rb + c / 2 + 4) : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (!__any_sync(0xffffffffu, ia[j] >= 0 || ib[j] >= 0)) continue;
      const bf16* wk = wres + (k0 + j) * KP * LDB;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          load_b_pair(b, wk + 16 * s * LDB + np * 16, LDB, lane);
          mma_16816(acc[2 * np], a[j][s], b[0], b[1]);
          mma_16816(acc[2 * np + 1], a[j][s], b[2], b[3]);
        }
      }
    }

    if (next_k0 == 0) {
      // the tile is done: round once; rows g and g + 8, columns 8 nt + 2 t
      // (D is even)
      const int qa = tile * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < D && qa < Q) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(qa) * D + col) =
              __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        }
        if (col < D && qa + 8 < Q) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(qa + 8) * D + col) =
              __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
        }
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      }
    }
    tile = next_tile;
    k0 = next_k0;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      ia[j] = na[j];
      ib[j] = nb[j];
    }
  }
}

template <int KP, int BN>
int launch_narrow(const void* feat, const void* nmap, const void* w, void* out,
                  int R, int C, int K, int Q, int D, cudaStream_t stream) {
  const auto kern = conv_narrow<KP, BN>;
  const int smem = narrow_smem(K, KP, BN);
  int fit = 0;
  const cudaError_t err = card_blocks(reinterpret_cast<const void*>(kern),
                                      N_THREADS, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = ceil_div(ceil_div(Q, 16), N_WARPS);
  if (blocks > fit) blocks = fit;  // persistent: one wave
  kern<<<blocks, N_THREADS, smem, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const int*>(nmap),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), R, C, K, Q, D);
  return static_cast<int>(cudaGetLastError());
}

// ---- tile path ------------------------------------------------------------

constexpr int CK = 128;  // input columns per pipeline item

// Shared memory: [K][BM] indices, K flags, K + 1 live-list entries, then
// the ring.
__host__ __device__ inline int head_bytes(int K, int bm) {
  return ((K * bm + 2 * K + 1) * 4 + 15) & ~15;
}

struct Plan {
  int bm;      // output rows per tile: 16 per warp
  int bn;      // output columns per block
  int stages;  // ring depth
  int smem;    // bytes
};

__host__ __device__ inline int stage_elems(int bm, int ck, int bn) {
  return bm * (ck + 8) + ck * (bn + 8);
}

__host__ inline int smem_for(int K, int C, int bm, int bn, int stages) {
  const int cp = round16(C);
  const int ck = cp < CK ? cp : CK;
  int ring = stages * stage_elems(bm, ck, bn);
  if (ring < bm * (bn + 8)) ring = bm * (bn + 8);  // the epilogue's staging
  return head_bytes(K, bm) + ring * 2;
}

__host__ inline Plan plan_for(int K, int C, int D) {
  Plan p;
  p.bn = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  p.bm = p.bn <= 32 ? 64 : 128;
  // three stages, or two where only two let a second block share the SM
  const int three = smem_for(K, C, p.bm, p.bn, 3);
  const int two = smem_for(K, C, p.bm, p.bn, 2);
  p.stages = three > MAX_SMEM || (three > MAX_SMEM / 2 && two <= MAX_SMEM / 2)
                 ? 2 : 3;
  p.smem = p.stages == 3 ? three : two;
  return p;
}

// at most stages - 2 groups in flight
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages >= 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// The [K, BM] indices of output rows q0 .. q0 + BM - 1 into idx, by
// cp.async in one round trip (rows past Q set to -1; an index >= R traps),
// and the offsets with at least one hit listed in live[0, live[K]).
template <int BM, int THREADS>
__device__ __forceinline__ void load_tile_indices(
    int* idx, int* flag, int* live, const int* __restrict__ nmap, int R,
    int K, int Q, int q0, int tid) {
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // rows past Q arrive as 0 and are set to -1 after the copy
  for (int k = tid; k < K; k += THREADS) flag[k] = 0;
  if ((Q & 3) == 0 && (reinterpret_cast<uintptr_t>(nmap) & 15) == 0) {
    for (int e = tid; e < K * BM / 4; e += THREADS) {
      const int k = e / (BM / 4);
      const int m = (e - k * (BM / 4)) * 4;
      const bool ok = q0 + m < Q;  // Q % 4 == 0: whole chunks in or out
      cp_async<16>(idx + k * BM + m,
                   ok ? nmap + static_cast<size_t>(k) * Q + q0 + m : nmap, ok);
    }
  } else {
    for (int e = tid; e < K * BM; e += THREADS) {
      const int k = e / BM;
      const int q = q0 + (e & (BM - 1));
      cp_async<4>(idx + e, q < Q ? nmap + static_cast<size_t>(k) * Q + q : nmap,
                  q < Q);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < K * BM; e += THREADS) {
    const int r = q0 + (e & (BM - 1)) < Q ? idx[e] : -1;
    if (r >= R) __trap();  // an index past the feature rows is a caller bug
    if (r >= 0) flag[e / BM] = 1;
    idx[e] = r;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool on = k0 + lane < K && flag[k0 + lane];
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      if (on) live[n + __popc(bits & ((1u << lane) - 1u))] = k0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) live[K] = n;
  }
  __syncthreads();
}

template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
conv_tile(const bf16* __restrict__ feat, const int* __restrict__ nmap,
          const bf16* __restrict__ w, bf16* __restrict__ out, int R, int C,
          int K, int Q, int D, int stages) {
  constexpr int WARPS = BM / 16;
  constexpr int THREADS = 32 * WARPS;
  constexpr int WN = BN >= 64 ? 2 : 1;   // warps along the columns
  constexpr int WM = WARPS / WN;         // warps along the rows
  constexpr int MT = BM / (16 * WM);     // 16-row MMA tiles per warp
  constexpr int NT = BN / (8 * WN);      // 8-column MMA tiles per warp
  constexpr int LDB = BN + 8;
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8 columns");

  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = round16(C);
  const int ck = cp < CK ? cp : CK;
  const int nck = ceil_div(cp, CK);      // pipeline items per offset
  const int lda = ck + 8;
  int* idx = reinterpret_cast<int*>(smem);  // [K][BM]
  int* flag = idx + K * BM;                 // [K]
  int* live = flag + K;                     // [K] live offsets, then count
  bf16* ring = reinterpret_cast<bf16*>(smem + head_bytes(K, BM));
  const int a_elems = BM * lda;
  const int stage = stage_elems(BM, ck, BN);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (warp / WN) * MT * 16;  // warp's first row in the tile
  const int col0 = (warp % WN) * NT * 8;   // warp's first column
  const int q0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // 1. the tile's indices of all offsets and its live offsets
  load_tile_indices<BM, THREADS>(idx, flag, live, nmap, R, K, Q, q0, tid);
  const int items = live[K] * nck;

  // 2-3. the ring: item it = (live offset it / nck, C chunk it % nck), in
  // ring slot it % stages; positions advance by counting, not dividing
  int p_it = 0, p_li = 0, p_ci = 0, p_slot = 0;  // the next item to copy
  auto issue = [&]() {
    if (p_it < items) {
      const int k = live[p_li];
      const int c0 = p_ci * CK;
      const int cw = min(ck, cp - c0);
      bf16* a = ring + p_slot * stage;
      const int* rows = idx + k * BM;
      gather_rows_async<THREADS>(
          a, lda, BM, [rows](int r) { return rows[r]; }, feat, C, c0, cw,
          tid);
      copy_tile_async<THREADS>(a + a_elems, LDB, cw, BN,
                               w + static_cast<size_t>(k) * C * D, D, c0, C,
                               n0, D, tid);
    }
    cp_async_commit();
    ++p_it;
    if (++p_ci == nck) {
      p_ci = 0;
      ++p_li;
    }
    if (++p_slot == stages) p_slot = 0;
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int s = 0; s < stages - 1; ++s) issue();
  int ci = 0, slot = 0;  // the item being multiplied
  for (int it = 0; it < items; ++it) {
    wait_ring(stages);  // item it has landed for this thread
    __syncthreads();    // ... for every thread; item it - 1's MMAs are done
    issue();
    const int cw = min(ck, cp - ci * CK);
    const bf16* a_t = ring + slot * stage + row0 * lda;
    const bf16* b_t = ring + slot * stage + a_elems + col0;
    if (++ci == nck) ci = 0;
    if (++slot == stages) slot = 0;
    for (int kk = 0; kk < cw; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        load_a(a[mt], a_t + mt * 16 * lda + kk, lda, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        load_b_pair(b, b_t + kk * LDB + np * 16, LDB, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // 4. round once, stage [BM][BN] in the ring, 16-byte stores
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bf16* o = ring + (row0 + mt * 16 + g) * LDB + col0 + nt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * LDB) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  if ((D & 7) == 0) {
    constexpr int CH = BN / 8;
    for (int e = tid; e < BM * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e - r * CH) * 8;
      if (q0 + r < Q && n0 + c < D) {
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(q0 + r) * D + n0 +
                                  c) =
            *reinterpret_cast<const uint4*>(ring + r * LDB + c);
      }
    }
  } else {
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e - r * BN;
      if (q0 + r < Q && n0 + c < D) {
        out[static_cast<size_t>(q0 + r) * D + n0 + c] = ring[r * LDB + c];
      }
    }
  }
}

template <int BM, int BN>
int launch_tile(const Plan& p, const void* feat, const void* nmap,
                const void* w, void* out, int R, int C, int K, int Q, int D,
                cudaStream_t stream) {
  const auto kern = conv_tile<BM, BN>;
  int fit = 0;  // lifts the kernel's shared-memory limit on first use
  const cudaError_t err = card_blocks(reinterpret_cast<const void*>(kern),
                                      2 * BM, p.smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(ceil_div(Q, BM), ceil_div(D, BN)), 2 * BM, p.smem, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const int*>(nmap),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), R, C, K, Q, D,
      p.stages);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32 path ---------------------------------------------------------------
// f32 features and weights, an f32 sum and an f32 output: every product
// and sum an FFMA on the CUDA cores, so f32 means f32 (no TF32).
//
// What bounds it on an H100. In f32 the work, 2 * hits * C * D flops at
// 67 TFLOP/s, takes longer than the bytes (the bf16 counts doubled) at
// 3.35 TB/s: the kernel is bound by the FFMA rate. One design covers all
// widths: a block of 256 threads owns BM output rows and BN <= 128 output
// columns, loads its [K, BM] index tile and its live offsets once (as the
// bf16 tile path), and walks the pipeline items (live offset, 32-column
// chunk of C) through a two-stage cp.async ring: the gathered rows [BM,
// 32] (16-byte copies, zeros for misses and past C; 4-byte copies where C
// is not a multiple of 4) and the W[k] chunk [32, BN], both row-major,
// while the previous item's products run. Each thread keeps a TM x TN
// register tile of sums (rows ty + i * TY, columns 4 tx + j and, for
// TN = 8, BN / 2 + 4 tx + j) and per 4 input columns reads TM float4 of A
// and 4 * TN / 4 float4 of B from shared memory for 4 * TM * TN FFMAs. The
// miss rows of a live offset are multiplied as zeros: the bound does not
// count them.
constexpr int F_CK = 32;  // input columns per pipeline item
constexpr int F_THREADS = 256;

template <int BN, int TM, int TN>
struct F32Tile {
  static constexpr int TX = BN / TN;         // threads along the columns
  static constexpr int TY = F_THREADS / TX;  // threads along the rows
  static constexpr int BM = TY * TM;         // output rows of a block
  static constexpr int LDA = F_CK + 4;
  static constexpr int LDB = BN + 4;
  static constexpr int STAGE = BM * LDA + F_CK * LDB;  // floats
  static_assert(TN == 4 || TN == 8, "B is read as one or two float4");
};

template <int BN, int TM, int TN>
__host__ inline int f32_smem(int K) {
  using T = F32Tile<BN, TM, TN>;
  return head_bytes(K, T::BM) + 2 * T::STAGE * 4;
}

template <int BN, int TM, int TN>
__global__ void __launch_bounds__(F_THREADS)
conv_f32(const float* __restrict__ feat, const int* __restrict__ nmap,
         const float* __restrict__ w, float* __restrict__ out, int R, int C,
         int K, int Q, int D) {
  using T = F32Tile<BN, TM, TN>;
  constexpr int BM = T::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx = reinterpret_cast<int*>(smem);  // [K][BM]
  int* flag = idx + K * BM;                 // [K]
  int* live = flag + K;                     // [K] live offsets, then count
  float* ring = reinterpret_cast<float*>(smem + head_bytes(K, BM));

  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const int q0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nck = ceil_div(C, F_CK);  // pipeline items per offset

  load_tile_indices<BM, F_THREADS>(idx, flag, live, nmap, R, K, Q, q0, tid);
  const int items = live[K] * nck;

  // item it = (live offset it / nck, C chunk it % nck) in slot it % 2
  auto issue = [&](int it) {
    if (it < items) {
      const int k = live[it / nck];
      const int c0 = (it % nck) * F_CK;
      float* a = ring + (it & 1) * T::STAGE;
      const int* rows = idx + k * BM;
      gather_rows_f32<F_THREADS, F_CK>(
          a, T::LDA, BM, [rows](int r) { return rows[r]; }, feat, C, c0,
          tid);
      copy_tile_f32<F_THREADS, BN>(a + BM * T::LDA, T::LDB, F_CK,
                                   w + static_cast<size_t>(k) * C * D, D, c0,
                                   C, n0, tid);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  issue(0);
  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();  // item it has landed for this thread
    __syncthreads();     // ... for every thread; item it - 1's sums are done
    issue(it + 1);
    const int c0 = (it % nck) * F_CK;
    const int cw = min(F_CK, (C - c0 + 3) & ~3);  // zeros past C
    const float* a = ring + (it & 1) * T::STAGE + ty * T::LDA;
    const float* b = ring + (it & 1) * T::STAGE + BM * T::LDA + 4 * tx;
    for (int kk = 0; kk < cw; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + i * T::TY * T::LDA + kk);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* brow = b + (kk + j) * T::LDB;
        float bv[TN];
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
        if constexpr (TN == 8) {
          const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
          bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane_of(av[i], j);
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(x, bv[n], acc[i][n]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows ty + i * TY, columns 4 tx (+ BN / 2) + 0..3
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + ty + i * T::TY;
    if (q >= Q) continue;
    float* orow = out + static_cast<size_t>(q) * D;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + 4 * tx + h * (BN / 2);
      if ((D & 3) == 0 && n < D) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < D) orow[n + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

template <int BN, int TM, int TN>
int launch_f32(const void* feat, const void* nmap, const void* w, void* out,
               int R, int C, int K, int Q, int D, cudaStream_t stream) {
  using T = F32Tile<BN, TM, TN>;
  const auto kern = conv_f32<BN, TM, TN>;
  const int smem = f32_smem<BN, TM, TN>(K);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;  // lifts the kernel's shared-memory limit on first use
  const cudaError_t err = card_blocks(reinterpret_cast<const void*>(kern),
                                      F_THREADS, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(ceil_div(Q, T::BM), ceil_div(D, BN)), F_THREADS, smem,
         stream>>>(static_cast<const float*>(feat),
                   static_cast<const int*>(nmap),
                   static_cast<const float*>(w), static_cast<float*>(out), R,
                   C, K, Q, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block needs for input width C at K = 27 and the widest
// column split, so the caller can refuse what the card cannot hold.
extern "C" int gga_gather_gemm_smem_bytes(int C) {
  return plan_for(27, C, 128).smem;
}

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gga_gather_gemm_conv_bf16(const void* feat, const void* nmap,
                                         const void* w, void* out, int R,
                                         int C, int K, int Q, int D,
                                         void* stream) {
  if (Q <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32 && C % 2 == 0 && D <= 32 && D % 2 == 0 &&
      narrow_smem(K, round16(C), round16(D)) <= MAX_SMEM / 2) {
    if (C <= 16) {
      return D <= 16 ? launch_narrow<16, 16>(feat, nmap, w, out, R, C, K, Q, D, s)
                     : launch_narrow<16, 32>(feat, nmap, w, out, R, C, K, Q, D, s);
    }
    return D <= 16 ? launch_narrow<32, 16>(feat, nmap, w, out, R, C, K, Q, D, s)
                   : launch_narrow<32, 32>(feat, nmap, w, out, R, C, K, Q, D, s);
  }
  const Plan p = plan_for(K, C, D);
  if (p.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.bn) {
    case 16: return launch_tile<64, 16>(p, feat, nmap, w, out, R, C, K, Q, D, s);
    case 32: return launch_tile<64, 32>(p, feat, nmap, w, out, R, C, K, Q, D, s);
    case 64: return launch_tile<128, 64>(p, feat, nmap, w, out, R, C, K, Q, D, s);
    default: return launch_tile<128, 128>(p, feat, nmap, w, out, R, C, K, Q, D, s);
  }
}

// Shared memory a block of the f32 kernel needs at K = 27 for input width
// C: the f32 tiles are 32 input columns wide whatever C, so the most of
// any output width (the 256-row tiles of D <= 16).
extern "C" int gga_gather_gemm_smem_bytes_f32(int C) {
  (void)C;
  return f32_smem<16, 4, 4>(27);
}

// f32 features, weights and output. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int gga_gather_gemm_conv_f32(const void* feat, const void* nmap,
                                        const void* w, void* out, int R,
                                        int C, int K, int Q, int D,
                                        void* stream) {
  if (Q <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_f32<16, 4, 4>(feat, nmap, w, out, R, C, K, Q, D, s);
  if (D <= 32) return launch_f32<32, 4, 4>(feat, nmap, w, out, R, C, K, Q, D, s);
  if (D <= 64) return launch_f32<64, 8, 4>(feat, nmap, w, out, R, C, K, Q, D, s);
  return launch_f32<128, 8, 8>(feat, nmap, w, out, R, C, K, Q, D, s);
}
