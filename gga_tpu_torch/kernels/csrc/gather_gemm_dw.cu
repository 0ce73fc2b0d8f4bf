// Weight gradient of the gather-GEMM sparse convolution, for Hopper (sm_90a).
//
//   dW[k, c, d] = sum_q  [nmap[k, q] >= 0] * features[nmap[k, q], c] * dout[q, d]
//
// features [R, C] bf16, nmap [K, Q] int32 (-1 = miss), dout [Q, D] bf16,
// dW [K, C, D] f32. Products are summed in f32. An f32 entry
// (gga_gather_gemm_dw_f32, the "f32 path" at the end) takes f32 features
// and dout, with FFMA products and sums.
//
// Replaces gga_tpu/ops/pallas/window_gather.py:_window_dw (the TPU kernel
// _dw_kernel). It computes the weight gradient of every submanifold conv
// (nmap = the stage's neighbor map) and of every strided conv (nmap = the
// rulebook's forward map). The TPU kernel carries acc[k] across a
// sequential (K, q-block) grid; blocks here run in no order, so Q is split
// into contiguous ranges ("splits"), each block writes its partial sums to
// an f32 scratch [splits, K, C, D], and a second kernel adds the splits in
// a fixed order: the same inputs give the same bits on every call, with no
// atomics.
//
// What bounds it on an H100. The work is 2 * hits * C * D flops against
// the gathered feature rows and the dout rows (hits * C * 2 + Q * D * 2
// bytes through L2), below the ~295 flop/byte the tensor cores need, so it
// is bound by memory and, at the narrow stages, by latency. The earlier
// design gave each block one offset k: every dout tile was fetched again
// by all K offsets' blocks, each q tile was a serial load-vote-gather-MMA
// round trip, both operands were transposed into shared memory with 2-byte
// stores, and at C = 4, 16 and 32 a 64-row c tile left 3 or 2 of 4 warps
// without MMAs.
//
// This design has two paths, chosen by width. The narrow path (C and D
// <= 32, even) is described above dw_narrow. The tile path, per block of
// eight warps:
//   - A block owns a group of kg offsets, a c slab and a d slab (<= 128
//     each) and a contiguous range of q tiles of bq rows. Its warps own
//     disjoint warp tiles (offset, 16*MT rows of c, 8*NT columns of d),
//     dealt round-robin, and each keeps its sums in registers (at most 64
//     f32 a thread). kg is as large as the registers and a ring of 64-row
//     q tiles (else 32) at two blocks an SM allow: 4 at 32 -> 64, 2 at
//     64 -> 64, 1 at 64 -> 128 and 128 -> 128. So a dout tile is staged
//     once per q tile for kg offsets. At the first three, half the warps
//     hold no warp tile and only issue copies; giving every warp a tile
//     (more offsets, 32-row q tiles) measured slower at 32 -> 64 and
//     64 -> 128 and within a few percent at 64 -> 64.
//   - Indices once per chunk: the block copies the [kg, chunk * bq]
//     indices of as many q tiles as 16 KB holds in one cp.async round trip
//     (an index >= R traps) and lists the tiles any of its offsets hits;
//     a tile nobody hits (the padding rows of stages 2-3) is not loaded.
//   - A ring of three cp.async stages over the listed tiles: tile j + 2's
//     feature rows (16-byte cp.async, narrower for rows that are not
//     16-byte multiples, zero-fill for misses, rows past Q and the c
//     padding) and its dout rows are in flight while the warps run tile
//     j's MMAs.
//   - Operands stay in their natural row-major layouts: gathered rows
//     [q][c] feed the MMA's A (c x q) through ldmatrix .trans, dout [q][d]
//     its B (q x d) the same way. No transposed staging.
//   - A warp skips the MMAs of an offset that has no hit in the tile (a
//     flag per offset and tile, set by a vote when the indices load).
//   - Few instructions a copy and a tile: the copy loops keep a column per
//     thread and the warp tiles are worked out once (the loops are
//     issue-bound at the wide stages).
//   - mma.sync m16n8k16 bf16 -> f32 (the flops bound is 0.18 ms per step
//     against 0.28 ms of memory; gathers set the pace).
// The split count aims at four blocks per SM slot, capped so the scratch
// stays within 16 MB; it is written once and read once by the ordered
// reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_tile.cuh"

namespace {

using namespace gga;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;          // data ring: two q tiles in flight
constexpr int SLAB = 128;          // widest c or d range of one block
constexpr int ACC_MAX = 64;        // f32 sums a thread keeps
constexpr int IDX_MAX = 16 * 1024; // bytes of indices a block holds at once
constexpr int TWO_BLOCKS = 113 * 1024;  // smem that lets two blocks share an SM
constexpr int MAX_SMEM = 232448;
constexpr int WAVES = 4;           // blocks per SM slot the splits aim for
constexpr int MAX_SPLITS = 256;
constexpr long long SCRATCH_MAX = 16ll << 20;  // bytes of split partials

struct Plan {
  int narrow;        // the narrow path (C and D <= 32, even)
  int mt, nt;        // warp tile: mt 16-row c tiles x nt 8-column d tiles
  int ct, dt;        // padded c and d widths of a block
  int kg, groups;    // offsets per block, offset groups
  int cslabs, dslabs;
  int bq;            // q rows per tile
  int chunk;         // q tiles whose indices a block holds at once
  int splits;
  int smem;
};

__host__ __device__ inline int ring_elems(int kg, int bq, int ct, int dt) {
  return STAGES * (kg * bq * (ct + 8) + bq * (dt + 8));
}

// indices [kg][chunk * bq], chunk flags, per-offset tile flags
// [kg][chunk], the live list and its count, then the ring
__host__ __device__ inline int head_bytes(int kg, int bq, int chunk) {
  return ((kg * chunk * bq + 2 * chunk + kg * chunk + 1) * 4 + 15) & ~15;
}

template <int MT, int NT>
constexpr int wt_of() {
  return ACC_MAX / (MT * NT * 4);
}

template <int MT, int NT, int WT>
__global__ void __launch_bounds__(THREADS, 2)
dw_kernel(const bf16* __restrict__ feat, const int* __restrict__ nmap,
          const bf16* __restrict__ dout, float* __restrict__ part, int R,
          int C, int K, int Q, int D, Plan p) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8 columns");
  extern __shared__ __align__(128) unsigned char smem[];
  const int bq = p.bq;  // 32 or 64
  const int bq_log = bq == 64 ? 6 : 5;
  const int kg = p.kg;
  const int pitch = p.chunk * bq;  // indices of one offset in a chunk
  const int ldg = p.ct + 8;
  const int ldd = p.dt + 8;
  int* idx = reinterpret_cast<int*>(smem);  // [kg][pitch]
  int* flag = idx + kg * pitch;             // [chunk]
  int* kflag = flag + p.chunk;              // [kg][chunk] tile hit by offset
  int* live = kflag + kg * p.chunk;         // [chunk] live tiles, then count
  bf16* ring = reinterpret_cast<bf16*>(smem + head_bytes(kg, bq, p.chunk));
  const int g_elems = kg * bq * ldg;     // gathered rows [kg][bq][ldg]
  const int stage = g_elems + bq * ldd;  // then dout rows [bq][ldd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int split = blockIdx.x;
  const int k0 = blockIdx.y * kg;
  const int kn = min(kg, K - k0);
  const int c0 = (blockIdx.z % p.cslabs) * SLAB;
  const int n0 = (blockIdx.z / p.cslabs) * SLAB;
  const int cwt = p.ct / (16 * MT);
  const int dwt = p.dt / (8 * NT);
  const int per_k = cwt * dwt;
  const int tiles = kn * per_k;  // warp tiles of the block
  const int nqt = ceil_div(Q, bq);
  const int t0 = static_cast<int>(static_cast<long long>(nqt) * split / p.splits);
  const int n = static_cast<int>(static_cast<long long>(nqt) * (split + 1) /
                                 p.splits) - t0;
  const bool vec_idx =
      (Q & 3) == 0 && (reinterpret_cast<uintptr_t>(nmap) & 15) == 0;

  int wk[WT], wcb[WT], wdb[WT];  // the warp's tiles: offset, c and d block
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    const int jt = warp + WARPS * w;
    wk[w] = jt < tiles ? jt / per_k : -1;
    wcb[w] = (jt / dwt) % cwt;
    wdb[w] = jt % dwt;
  }
  float acc[WT][MT][NT][4];
#pragma unroll
  for (int w = 0; w < WT; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[w][i][j][0] = acc[w][i][j][1] = acc[w][i][j][2] =
            acc[w][i][j][3] = 0.f;

  for (int ch0 = 0; ch0 < n; ch0 += p.chunk) {
    const int cn = min(p.chunk, n - ch0);  // q tiles of this chunk
    const int cq0 = (t0 + ch0) * bq;       // its first q row
    // 1. the chunk's indices of the block's offsets, by cp.async in one
    //    round trip (entries past Q arrive as 0 and are set to -1 below),
    //    and the list of its q tiles that any of them hits
    for (int i = tid; i < cn; i += THREADS) flag[i] = 0;
    for (int i = tid; i < kn * p.chunk; i += THREADS) kflag[i] = 0;
    if (vec_idx) {
      const int row4 = cn * bq / 4;
      for (int e = tid; e < kn * row4; e += THREADS) {
        const int kk = e / row4;
        const int m = (e - kk * row4) * 4;
        const bool ok = cq0 + m < Q;  // Q % 4 == 0: whole chunks in or out
        cp_async<16>(idx + kk * pitch + m,
                     ok ? nmap + static_cast<size_t>(k0 + kk) * Q + cq0 + m
                        : nmap,
                     ok);
      }
    } else {
      for (int e = tid; e < kn * cn * bq; e += THREADS) {
        const int kk = e / (cn * bq);
        const int m = e - kk * cn * bq;
        const bool ok = cq0 + m < Q;
        cp_async<4>(idx + kk * pitch + m,
                    ok ? nmap + static_cast<size_t>(k0 + kk) * Q + cq0 + m
                       : nmap,
                    ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < kn * cn * bq; e += THREADS) {
      const int kk = e / (cn * bq);
      const int m = e - kk * cn * bq;
      const int r = cq0 + m < Q ? idx[kk * pitch + m] : -1;
      if (r >= R) __trap();  // an index past the feature rows is a caller bug
      idx[kk * pitch + m] = r;
      // a warp's 32 entries lie in one q tile of one offset (bq >= 32)
      if (__any_sync(0xffffffffu, r >= 0) && lane == 0) {
        flag[m >> bq_log] = 1;
        kflag[kk * p.chunk + (m >> bq_log)] = 1;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int nl = 0;
      for (int i0 = 0; i0 < cn; i0 += 32) {
        const bool on = i0 + lane < cn && flag[i0 + lane];
        const unsigned bits = __ballot_sync(0xffffffffu, on);
        if (on) live[nl + __popc(bits & ((1u << lane) - 1u))] = i0 + lane;
        nl += __popc(bits);
      }
      if (lane == 0) live[p.chunk] = nl;
    }
    __syncthreads();
    const int items = live[p.chunk];

    // 2. the ring over the live tiles: feature rows and dout rows of item
    //    j + 2 are copied while the MMAs of item j run
    auto issue = [&](int j) {
      if (j < items) {
        const int tl = live[j];  // tile within the chunk
        const int q0 = cq0 + tl * bq;
        const int qn = min(bq, Q - q0);
        const int* rows = idx + tl * bq;
        bf16* gs = ring + (j % STAGES) * stage;
        gather_rows_async<THREADS>(
            gs, ldg, kn * bq,
            [&](int r) {  // row m of offset kk's tile; bq = 2^bq_log
              const int m = r & (bq - 1);
              return m < qn ? rows[(r >> bq_log) * pitch + m] : -1;
            },
            feat, C, c0, p.ct, tid);
        copy_tile_async<THREADS>(gs + g_elems, ldd, bq, p.dt, dout, D, q0, Q,
                                 n0, D, tid);
      }
      cp_async_commit();
    };
    for (int j = 0; j < STAGES - 1; ++j) issue(j);
    for (int j = 0; j < items; ++j) {
      cp_async_wait<STAGES - 2>();  // item j has landed for this thread
      __syncthreads();  // ... for every thread; item j - 1's MMAs are done
      issue(j + STAGES - 1);
      const int tl = live[j];
      const int qn = min(bq, Q - (cq0 + tl * bq));
      const bf16* gs = ring + (j % STAGES) * stage;
      const bf16* ds = gs + g_elems;
#pragma unroll
      for (int w = 0; w < WT; ++w) {
        const int kk = wk[w];
        if (kk < 0) break;
        if (!kflag[kk * p.chunk + tl]) continue;  // no hit of kk in the tile
        const int cb = wcb[w];
        const int db = wdb[w];
        const bf16* a_t = gs + kk * bq * ldg + cb * MT * 16;
        const bf16* b_t = ds + db * NT * 8;
        for (int s = 0; s < qn; s += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            load_a_t(a[mt], a_t + s * ldg + mt * 16, ldg, lane);
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            load_b_pair(b, b_t + s * ldd + np * 16, ldd, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_16816(acc[w][mt][2 * np], a[mt], b[0], b[1]);
              mma_16816(acc[w][mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring, indices and list are free for the next chunk
  }

  // every warp tile is written (zeros where nothing hit), so the
  // reduction can add all splits
  float* base = part + static_cast<size_t>(split) * K * C * D;
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    const int jt = warp + WARPS * w;
    if (jt >= tiles) break;
    const int k = k0 + jt / per_k;
    const int cb = (jt / dwt) % cwt;
    const int db = jt % dwt;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = n0 + db * NT * 8 + nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + cb * MT * 16 + mt * 16 + g + 8 * h;
          if (c >= C) continue;
          float* o = base + (static_cast<size_t>(k) * C + c) * D + d;
          if (d + 1 < D && (D & 1) == 0) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[w][mt][nt][2 * h], acc[w][mt][nt][2 * h + 1]);
          } else {
            if (d < D) o[0] = acc[w][mt][nt][2 * h];
            if (d + 1 < D) o[1] = acc[w][mt][nt][2 * h + 1];
          }
        }
      }
    }
  }
}

// Narrow path (C and D <= 32, even: conv_input and the stage 0-1 convs).
// A block owns KW offsets and a range of 16-row q steps, dealt to
// its warps in turn; a warp needs no barrier and no shared memory until
// its sums are done. It loads the dout rows and the gathered feature rows
// of a step straight into registers (4-byte loads, rows q along lanes) and
// transposes each 8x8 block with movmatrix into the MMA's fragments (A =
// features^T, c x q; B = dout, q x d), while the next step's indices load.
// At the end the eight warps' sums are added in warp order in shared
// memory and written once as the block's partial.
template <int CP, int DP>  // C and D padded to 16
__global__ void __launch_bounds__(THREADS)
dw_narrow(const bf16* __restrict__ feat, const int* __restrict__ nmap,
          const bf16* __restrict__ dout, float* __restrict__ part, int R,
          int C, int K, int Q, int D, int splits) {
  constexpr int CS = CP / 16;  // 16-row c tiles
  constexpr int NT = DP / 8;   // 8-column d tiles
  constexpr int KW = ACC_MAX / (CS * NT * 4);  // offsets: 2 to 8
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][KW][CP][DP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int split = blockIdx.x;
  const int k0 = blockIdx.y * KW;
  const int kn = min(KW, K - k0);
  const int steps = ceil_div(Q, 16);
  const int s0 = static_cast<int>(static_cast<long long>(steps) * split / splits);
  const int s1 = static_cast<int>(static_cast<long long>(steps) * (split + 1) /
                                  splits);

  auto load_idx = [&](int st, int (&xa)[KW], int (&xb)[KW]) {
    const int qa = st * 16 + g;  // rows g and g + 8 of the step
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const size_t base = static_cast<size_t>(k0 + j) * Q;
      const bool ok = st < s1 && j < kn;
      xa[j] = ok && qa < Q ? __ldg(nmap + base + qa) : -1;
      xb[j] = ok && qa + 8 < Q ? __ldg(nmap + base + qa + 8) : -1;
    }
  };

  float acc[KW][CS][NT][4];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int cs = 0; cs < CS; ++cs)
#pragma unroll
      for (int i = 0; i < NT; ++i)
        acc[j][cs][i][0] = acc[j][cs][i][1] = acc[j][cs][i][2] =
            acc[j][cs][i][3] = 0.f;

  int st = s0 + warp;
  int ia[KW], ib[KW];
  load_idx(st, ia, ib);
  while (st < s1) {
    int na[KW], nb[KW];
    load_idx(st + WARPS, na, nb);
    const int qa = st * 16 + g;
    const int qb = qa + 8;
    // B = dout (q x d): b[nt][h] from rows q0 + 8 h .. + 7, columns 8 nt ..
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + 2 * t;
      const uint32_t xa =
          qa < Q && c < D ? __ldg(reinterpret_cast<const uint32_t*>(
                                dout + static_cast<size_t>(qa) * D + c))
                          : 0u;
      const uint32_t xb =
          qb < Q && c < D ? __ldg(reinterpret_cast<const uint32_t*>(
                                dout + static_cast<size_t>(qb) * D + c))
                          : 0u;
      b[nt][0] = movmatrix_t(xa);
      b[nt][1] = movmatrix_t(xb);
    }
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      if (ia[j] >= R || ib[j] >= R) __trap();  // a caller bug
      if (!__any_sync(0xffffffffu, ia[j] >= 0 || ib[j] >= 0)) continue;
      // A = features^T (c x q): plain fragments of rows qa / qb, columns
      // 2 t (+ 8), transposed
      const uint32_t* ra = reinterpret_cast<const uint32_t*>(
          feat + static_cast<size_t>(ia[j] < 0 ? 0 : ia[j]) * C);
      const uint32_t* rb = reinterpret_cast<const uint32_t*>(
          feat + static_cast<size_t>(ib[j] < 0 ? 0 : ib[j]) * C);
#pragma unroll
      for (int cs = 0; cs < CS; ++cs) {
        const int c = 16 * cs + 2 * t;
        uint32_t a[4];
        a[0] = movmatrix_t(ia[j] >= 0 && c < C ? __ldg(ra + c / 2) : 0u);
        a[1] = movmatrix_t(ia[j] >= 0 && c + 8 < C ? __ldg(ra + c / 2 + 4)
                                                   : 0u);
        a[2] = movmatrix_t(ib[j] >= 0 && c < C ? __ldg(rb + c / 2) : 0u);
        a[3] = movmatrix_t(ib[j] >= 0 && c + 8 < C ? __ldg(rb + c / 2 + 4)
                                                   : 0u);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(acc[j][cs][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    st += WARPS;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      ia[j] = na[j];
      ib[j] = nb[j];
    }
  }

  // the warps' sums, added in warp order: rows c = 16 cs + g (+ 8),
  // columns d = 8 nt + 2 t (+ 1)
  float* mine = red + warp * KW * CP * DP;
#pragma unroll
  for (int j = 0; j < KW; ++j) {
#pragma unroll
    for (int cs = 0; cs < CS; ++cs) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o =
              mine + (j * CP + 16 * cs + g + 8 * h) * DP + 8 * nt + 2 * t;
          o[0] = acc[j][cs][nt][2 * h];
          o[1] = acc[j][cs][nt][2 * h + 1];
        }
      }
    }
  }
  __syncthreads();
  float* base = part + static_cast<size_t>(split) * K * C * D;
  for (int e = tid; e < kn * CP * DP; e += THREADS) {
    const int j = e / (CP * DP);
    const int c = (e / DP) % CP;
    const int d = e % DP;
    if (c >= C || d >= D) continue;
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += red[w * KW * CP * DP + e];
    base[(static_cast<size_t>(k0 + j) * C + c) * D + d] = sum;
  }
}

// out[i] = sum over splits of part[s, i], in split order; four entries a
// thread (n % 4 == 0, as K * C * D is at the encoder's widths), else one
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int n, int splits) {
  if ((n & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
         i += gridDim.x * blockDim.x) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < splits; ++j) {
        const float4 v = p4[static_cast<size_t>(j) * (n / 4) + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    }
    return;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += part[static_cast<size_t>(j) * n + i];
    out[i] = s;
  }
}

using Kernel = void (*)(const bf16*, const int*, const bf16*, float*, int,
                        int, int, int, int, Plan);

template <int MT, int NT>
Kernel kernel_of() {
  return dw_kernel<MT, NT, wt_of<MT, NT>()>;
}

Kernel kernel_for(const Plan& p) {
  if (p.mt == 1) {
    return p.nt == 2 ? kernel_of<1, 2>() : p.nt == 4 ? kernel_of<1, 4>()
                                                     : kernel_of<1, 8>();
  }
  return p.nt == 2 ? kernel_of<2, 2>() : p.nt == 4 ? kernel_of<2, 4>()
                                                   : kernel_of<2, 8>();
}

using NarrowKernel = void (*)(const bf16*, const int*, const bf16*, float*,
                             int, int, int, int, int, int);

NarrowKernel narrow_for(const Plan& p) {
  if (p.mt == 1) return p.nt == 2 ? dw_narrow<16, 16> : dw_narrow<16, 32>;
  return p.nt == 2 ? dw_narrow<32, 16> : dw_narrow<32, 32>;
}

// Q splits: the wanted count, at most one per q tile, MAX_SPLITS and as
// many as keep the partials within SCRATCH_MAX.
int splits_for(int want, int qtiles, int K, int C, int D) {
  const long long per = 4ll * K * C * D;
  long long s = want;
  if (s > qtiles) s = qtiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s * per > SCRATCH_MAX) s = SCRATCH_MAX / per;
  return s < 1 ? 1 : static_cast<int>(s);
}

// The block shape, ring size and split count for these sizes; sets the
// kernel's shared-memory limit. Returns a cudaError_t.
int plan_for(int K, int C, int D, int Q, Plan* out) {
  Plan p;
  p.narrow = C <= 32 && C % 2 == 0 && D <= 32 && D % 2 == 0;
  if (p.narrow) {
    p.mt = C <= 16 ? 1 : 2;
    p.nt = D <= 16 ? 2 : 4;
    p.kg = ACC_MAX / (p.mt * p.nt * 4);
    p.groups = ceil_div(K, p.kg);
    p.cslabs = p.dslabs = 1;
    p.smem = WARPS * p.kg * (16 * p.mt) * (8 * p.nt) * 4;
    int blocks = 0;
    const cudaError_t err = card_blocks(
        reinterpret_cast<const void*>(narrow_for(p)), THREADS, p.smem,
        &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.splits = splits_for(ceil_div(WAVES * blocks, p.groups),
                          ceil_div(Q, 16), K, C, D);
    *out = p;
    return 0;
  }
  const int cw = round16(C < SLAB ? C : SLAB);
  const int dw = round16(D < SLAB ? D : SLAB);
  p.mt = cw >= 32 ? 2 : 1;
  p.nt = dw >= 64 ? 8 : dw >= 32 ? 4 : 2;
  p.ct = ceil_div(cw, 16 * p.mt) * 16 * p.mt;
  p.dt = ceil_div(dw, 8 * p.nt) * 8 * p.nt;
  const int per_k = (p.ct / (16 * p.mt)) * (p.dt / (8 * p.nt));
  const int wt = ACC_MAX / (p.mt * p.nt * 4);
  p.cslabs = ceil_div(C, SLAB);
  p.dslabs = ceil_div(D, SLAB);
  // offsets per block: as many as the registers hold and as let the ring
  // (of 64-row q tiles, else 32) and the indices fit two blocks an SM
  const int ring_max = TWO_BLOCKS - IDX_MAX;
  p.bq = ring_elems(1, 64, p.ct, p.dt) * 2 <= ring_max ? 64 : 32;
  for (int kg_max = WARPS * wt / per_k; ; --kg_max) {
    p.groups = ceil_div(K, kg_max > 1 ? kg_max : 1);
    p.kg = ceil_div(K, p.groups);
    if (kg_max <= 1 || ring_elems(p.kg, p.bq, p.ct, p.dt) * 2 <= ring_max) {
      break;
    }
  }
  p.chunk = IDX_MAX / (p.kg * p.bq * 4);
  if (p.chunk < 1) p.chunk = 1;
  p.smem = head_bytes(p.kg, p.bq, p.chunk) +
           ring_elems(p.kg, p.bq, p.ct, p.dt) * 2;
  if (p.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);

  int blocks = 0;
  const cudaError_t err = card_blocks(reinterpret_cast<const void*>(
                                          kernel_for(p)),
                                      THREADS, p.smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.splits = splits_for(
      ceil_div(WAVES * blocks, p.groups * p.cslabs * p.dslabs),
      ceil_div(Q, p.bq), K, C, D);
  *out = p;
  return 0;
}

// ---- f32 path ---------------------------------------------------------------
// f32 features and dout, FFMA products and f32 sums (no TF32). Like the
// conv's f32 path it is bound by the FFMA rate (2 * hits * C * D flops at
// 67 TFLOP/s against the bf16 byte counts doubled). A block of 256 threads
// owns kg offsets, a c slab of CS and a d slab of DS columns (16, 32, 64
// or 128: C and D padded up, wider ones split over blockIdx.z) and a
// contiguous range of 32-row q tiles, its split. Each thread keeps a
// TM x TN register tile of the sums of one offset (8 x 8 where the slab
// is 64 or 128 wide, else 4 x 4; rows 4 cb + i and, for TM = 8, CS / 2 +
// 4 cb + i, columns likewise), so kg = 256 / ((CS / TM) (DS / TN))
// offsets share each dout tile. A two-stage cp.async ring brings the next
// tile's gathered rows [kg][32][CS] (zeros for misses, rows past Q and
// columns past C) and its dout rows [32][DS] while the current tile's
// products run, TM * TN FFMAs per (TM + TN) / 4 float4 reads from shared
// memory. A thread copies the same rows of every tile, so it loads their
// indices into registers a tile ahead (an index >= R traps); rows whose
// width is not a multiple of 4 floats are copied a float at a time, each
// copy reading its index. An offset with no hit in a tile skips it: a flag
// per ring slot and offset holds the number of the last tile that hit it,
// so flags need no clearing. Partials go to the scratch and reduce_splits
// adds them in split order, as on the bf16 path: the same inputs give the
// same bits.
constexpr int F_BQ = 32;     // q rows per tile
constexpr int F_SLAB = 128;  // widest c or d slab of a block

__host__ __device__ constexpr int f32_tile(int slab) {
  return slab >= 64 ? 8 : 4;
}

__host__ __device__ inline int f32_stage(int kg, int cs, int ds) {
  return kg * F_BQ * (cs + 4) + F_BQ * (ds + 4);  // floats
}

// hit flags [2][kg], then the ring
__host__ __device__ inline int f32_head(int kg) {
  return (2 * kg * 4 + 15) & ~15;
}

template <int CS, int DS>
__global__ void __launch_bounds__(THREADS)
dw_f32(const float* __restrict__ feat, const int* __restrict__ nmap,
       const float* __restrict__ dout, float* __restrict__ part, int R,
       int C, int K, int Q, int D, int kg, int splits) {
  constexpr int TM = f32_tile(CS);
  constexpr int TN = f32_tile(DS);
  constexpr int DQ = DS / TN;
  constexpr int TPO = (CS / TM) * DQ;  // threads per offset
  constexpr int LDG = CS + 4;
  constexpr int LDD = DS + 4;
  constexpr int CH = CS / 4;            // 16-byte chunks of a gathered row
  constexpr int RSTEP = THREADS / CH;   // rows one pass of the copy covers
  constexpr int RPT = (THREADS / TPO * F_BQ + RSTEP - 1) / RSTEP;  // passes
  extern __shared__ __align__(128) unsigned char smem[];
  int* hit = reinterpret_cast<int*>(smem);  // [2][kg]
  float* ring = reinterpret_cast<float*>(smem + f32_head(kg));
  const int g_elems = kg * F_BQ * LDG;
  const int stage = g_elems + F_BQ * LDD;

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int k0 = blockIdx.y * kg;
  const int kn = min(kg, K - k0);
  const int rows = kn * F_BQ;  // gathered rows of a tile
  const int cslabs = ceil_div(C, F_SLAB);
  const int c0 = (blockIdx.z % cslabs) * F_SLAB;
  const int n0 = (blockIdx.z / cslabs) * F_SLAB;
  const int kk = tid / TPO;  // this thread's offset in the group
  const int cb = (tid % TPO) / DQ;
  const int db = tid % DQ;
  const int cc = (tid % CH) * 4;  // this thread's column of the copies
  const bool vec = (C & 3) == 0;
  const int nqt = ceil_div(Q, F_BQ);
  const int t0 = static_cast<int>(static_cast<long long>(nqt) * split / splits);
  const int t1 =
      static_cast<int>(static_cast<long long>(nqt) * (split + 1) / splits);

  for (int i = tid; i < 2 * kg; i += THREADS) hit[i] = 0;
  __syncthreads();

  // the indices of this thread's rows tid / CH + i * RSTEP of tile t
  auto load_idx = [&](int t, int (&x)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tid / CH + i * RSTEP;
      const int j = r / F_BQ;
      const int q = t * F_BQ + r - j * F_BQ;
      x[i] = vec && t < t1 && r < rows && q < Q
                 ? __ldg(nmap + static_cast<size_t>(k0 + j) * Q + q)
                 : -1;
    }
  };
  auto issue = [&](int t, const int (&x)[RPT]) {
    if (t < t1) {
      const int q0 = t * F_BQ;
      int* flags = hit + ((t - t0) & 1) * kg;
      float* gs = ring + ((t - t0) & 1) * stage;
      if (vec) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = tid / CH + i * RSTEP;
          if (r >= rows) break;
          const int s = x[i];
          if (s >= R) __trap();  // an index past the feature rows
          if (s >= 0 && cc == 0) flags[r / F_BQ] = t + 1;
          const bool ok = s >= 0 && c0 + cc < C;
          cp_async<16>(gs + r * LDG + cc,
                       ok ? feat + static_cast<size_t>(s) * C + c0 + cc
                          : feat,
                       ok);
        }
      } else {
        gather_rows_f32<THREADS, CS>(
            gs, LDG, rows,
            [&](int r) {  // row m of offset j's tile
              const int j = r / F_BQ;
              const int q = q0 + r - j * F_BQ;
              const int s = q < Q
                  ? __ldg(nmap + static_cast<size_t>(k0 + j) * Q + q) : -1;
              if (s >= R) __trap();
              if (s >= 0) flags[j] = t + 1;
              return s;
            },
            feat, C, c0, tid);
      }
      copy_tile_f32<THREADS, DS>(gs + g_elems, LDD, F_BQ, dout, D, q0, Q, n0,
                                 tid);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int cur[RPT], nxt[RPT];
  load_idx(t0, cur);
  issue(t0, cur);
  load_idx(t0 + 1, cur);
  for (int t = t0; t < t1; ++t) {
    load_idx(t + 2, nxt);  // in flight during tile t's products
    cp_async_wait<0>();    // tile t has landed for this thread
    __syncthreads();       // ... for every thread; tile t - 1's sums are done
    issue(t + 1, cur);
#pragma unroll
    for (int i = 0; i < RPT; ++i) cur[i] = nxt[i];
    const int slot = (t - t0) & 1;
    if (kk >= kn || hit[slot * kg + kk] != t + 1) continue;
    const float* a = ring + slot * stage + kk * F_BQ * LDG + 4 * cb;
    const float* b = ring + slot * stage + g_elems + 4 * db;
#pragma unroll 4
    for (int q = 0; q < F_BQ; ++q) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + q * LDG + h * (CS / 2));
        av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z,
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(b + q * LDD + h * (DS / 2));
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z,
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // every (offset, c, d) of the block is written, zeros where nothing
  // hit, so the reduction can add all splits
  if (kk >= kn) return;
  float* base = part + (static_cast<size_t>(split) * K + k0 + kk) * C * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + (i / 4) * (CS / 2) + 4 * cb + i % 4;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = n0 + (j / 4) * (DS / 2) + 4 * db + j % 4;
      if (d < D) base[static_cast<size_t>(c) * D + d] = acc[i][j];
    }
  }
}

using F32Kernel = void (*)(const float*, const int*, const float*, float*,
                           int, int, int, int, int, int, int);

template <int CS>
F32Kernel f32_kernel_d(int ds) {
  return ds == 16 ? dw_f32<CS, 16> : ds == 32 ? dw_f32<CS, 32>
       : ds == 64 ? dw_f32<CS, 64> : dw_f32<CS, 128>;
}

struct F32Plan {
  F32Kernel kern;
  int kg;      // offsets per block
  int groups;  // offset groups
  int slabs;   // (c slab, d slab) pairs
  int splits;
  int smem;
};

inline int f32_slab(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : F_SLAB;
}

// The f32 block shape and split count for these sizes; sets the kernel's
// shared-memory limit. Returns a cudaError_t.
int f32_plan(int K, int C, int D, int Q, F32Plan* out) {
  F32Plan p;
  const int cs = f32_slab(C);
  const int ds = f32_slab(D);
  p.kern = cs == 16 ? f32_kernel_d<16>(ds) : cs == 32 ? f32_kernel_d<32>(ds)
         : cs == 64 ? f32_kernel_d<64>(ds) : f32_kernel_d<128>(ds);
  const int kg_max = THREADS / ((cs / f32_tile(cs)) * (ds / f32_tile(ds)));
  p.groups = ceil_div(K, kg_max);
  p.kg = ceil_div(K, p.groups);
  p.slabs = ceil_div(C, F_SLAB) * ceil_div(D, F_SLAB);
  p.smem = f32_head(p.kg) + 2 * f32_stage(p.kg, cs, ds) * 4;
  if (p.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = card_blocks(reinterpret_cast<const void*>(p.kern),
                                      THREADS, p.smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.splits = splits_for(ceil_div(WAVES * blocks, p.groups * p.slabs),
                        ceil_div(Q, F_BQ), K, C, D);
  *out = p;
  return 0;
}

}  // namespace

// Number of Q splits for these sizes (< 1 if the sizes cannot be
// launched): the caller allocates the scratch [splits, K, C, D] f32.
extern "C" int gga_gather_gemm_dw_splits(int K, int C, int D, int Q) {
  if (K <= 0 || C <= 0 || D <= 0) return 1;
  Plan p;
  return plan_for(K, C, D, Q, &p) == 0 ? p.splits : -1;
}

// Returns the cudaError_t of the launches (0 = launched). part must hold
// splits * K * C * D floats, splits from gga_gather_gemm_dw_splits.
extern "C" int gga_gather_gemm_dw_bf16(const void* feat, const void* nmap,
                                       const void* dout, void* part, void* out,
                                       int R, int C, int K, int Q, int D,
                                       int splits, void* stream) {
  if (K <= 0 || C <= 0 || D <= 0) return 0;
  Plan p;
  int err = plan_for(K, C, D, Q, &p);
  if (err != 0) return err;
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_f = static_cast<float*>(part);
  const dim3 grid(p.splits, p.groups, p.cslabs * p.dslabs);
  if (p.narrow) {
    const auto kern = narrow_for(p);
    kern<<<grid, THREADS, p.smem, s>>>(
        static_cast<const bf16*>(feat), static_cast<const int*>(nmap),
        static_cast<const bf16*>(dout), part_f, R, C, K, Q, D, p.splits);
  } else {
    const Kernel kern = kernel_for(p);
    kern<<<grid, THREADS, p.smem, s>>>(
        static_cast<const bf16*>(feat), static_cast<const int*>(nmap),
        static_cast<const bf16*>(dout), part_f, R, C, K, Q, D, p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = K * C * D;
  int blocks = ceil_div(n, 256);
  if (blocks > 4096) blocks = 4096;
  reduce_splits<<<blocks, 256, 0, s>>>(part_f, static_cast<float*>(out), n,
                                       p.splits);
  return static_cast<int>(cudaGetLastError());
}

// The f32 path's split count for these sizes (< 1 if they cannot be
// launched): the caller allocates the scratch [splits, K, C, D] f32.
extern "C" int gga_gather_gemm_dw_splits_f32(int K, int C, int D, int Q) {
  if (K <= 0 || C <= 0 || D <= 0) return 1;
  F32Plan p;
  return f32_plan(K, C, D, Q, &p) == 0 ? p.splits : -1;
}

// f32 features and dout. Returns the cudaError_t of the launches (0 =
// launched). part must hold splits * K * C * D floats, splits from
// gga_gather_gemm_dw_splits_f32.
extern "C" int gga_gather_gemm_dw_f32(const void* feat, const void* nmap,
                                      const void* dout, void* part, void* out,
                                      int R, int C, int K, int Q, int D,
                                      int splits, void* stream) {
  if (K <= 0 || C <= 0 || D <= 0) return 0;
  F32Plan p;
  int err = f32_plan(K, C, D, Q, &p);
  if (err != 0) return err;
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_f = static_cast<float*>(part);
  p.kern<<<dim3(p.splits, p.groups, p.slabs), THREADS, p.smem, s>>>(
      static_cast<const float*>(feat), static_cast<const int*>(nmap),
      static_cast<const float*>(dout), part_f, R, C, K, Q, D, p.kg,
      p.splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = K * C * D;
  int blocks = ceil_div(n, 256);
  if (blocks > 4096) blocks = 4096;
  reduce_splits<<<blocks, 256, 0, s>>>(part_f, static_cast<float*>(out), n,
                                       p.splits);
  return static_cast<int>(cudaGetLastError());
}
