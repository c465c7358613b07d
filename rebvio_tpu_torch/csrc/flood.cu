// K1: jump flood of the nearest-keyline attribute field, one cooperative
// launch; and K1b: the same flood seeded from the keyline table, seeding
// included, one cooperative launch.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::_att_flood (the flood over the
// row-stacked seed regions built by distance_field.seed_stack_dense) and
// rebvio_tpu/ops/pallas_kernels.py::att_field_pallas (the [K] -> [n, 8]
// row scatter of the keyline table, then the same flood).
//
// Bound on the H100: bytes.  At the parity geometry (field 240x376, field
// search range 20 -> steps 16, 8, 4, 2, 1, 1) the least traffic is one
// read of the [5*(rows+PAD), cols] f32 seed stack (1.9 MB) and one write
// of the [8, rows*cols] f32 field (2.9 MB): ~1.4 us at 3.35 TB/s.  The
// first port issued two stack copies and seven launches (one per step and
// a finishing pass), each a full pass over the 5-plane stack: launch gaps
// and stack traffic, 25x the bound.  K1b reads the keyline table (pos,
// grad, use: 272 KB at K = 16000) and writes the field: ~0.9 us.  Its
// first port was four device operations: a memset of the winner
// plane, the winner scatter, a kernel writing the whole seed stack, then
// K1's flood reading it back.
//
// Semantics (_att_flood's, exactly): candidate (dy, dx) of cell (y, x)
// reads cell (y - dy, x - dx) of the WHOLE stack (pltpu.roll == jnp.roll),
// rows modulo 5*(rows+PAD), columns modulo cols; candidates in the order dy
// outer, dx inner over (-s, 0, s), (0, 0) skipped, accepted only if strictly
// closer than the running best, which starts at the cell's own d2; d2 in
// f32 with round-to-nearest intrinsics and no FMA contraction (the build's
// --fmad=false), so ties resolve as in the reference.  Pad rows are never
// written, and PAD >= every step, so a candidate row outside [0, rows) is a
// pad row of the INPUT stack: below the data the region's own sentinels,
// above it the previous region's (plane 0 wraps to plane 4's pad), which
// gives the rotated sentinel (0, BIG, BIG, -1, 0).  K1 reads both from the
// stack itself, so its flood stays exact whatever the pad rows hold; K1b,
// whose stack has sentinel pad rows, synthesises them.
//
// Design: one cooperative launch (blocks capped at the co-resident limit).
//   * Seeds: a policy the flood is written over (StackSeeds for K1,
//     TableSeeds for K1b) gives the seed (sy, sx) and the source code src
//     of any cell of the virtual grid [-PAD, rows + PAD) x cols, and the
//     finish's (id, gx, gy) of a src.  K1's src is the int32 index of the
//     virtual cell the values came from, read back from the stack at the
//     finish.  K1b's src is the winning keyline's index (-1: the region's
//     own sentinel, -2: the rotated one), its seed pos[src] / scale and its
//     gradient grad[src]: no stack is written or read.
//   * K1b's seeding (phase 0, before the flood, on the grid that floods):
//     a grid-stride pass sets the winner plane to -1, grid sync; one thread
//     a keyline does atomicMax(winner[cell], k) for a kept keyline whose
//     cell (seed_cell.cuh, as seed_scatter.cu) lies in the field, grid sync.
//     Integer max is order-free: the largest kept index wins a cell and the
//     whole row comes from it, as the sequential scatter leaves it.
//   * State: per cell (sy, sx) as one float2 and src.  The values always
//     move together, so the finish gathers id, gx, gy at src: 12 bytes a
//     cell move instead of 20.  No copies; no pad rows in the state.
//   * Long steps (those before the tile schedule, 16 and 8 at the parity
//     field): full-grid passes over the L2-resident state, ping-pong between
//     two buffers read past L1, a grid sync after each; a cell's nine loads
//     are issued before its comparisons; grid-stride over the cells.
//   * Short steps (the tail whose sum, the halo, is at most kHaloMax: 4, 2,
//     1, 1): each block loads a 16x16 tile plus the halo into shared memory
//     once and runs them there with overlapped tiling: step s updates the
//     tile grown by the sum of the steps after it, whose candidates lie
//     within s of it and are already final for that step.  Halo rows follow
//     the rule above, columns wrap.  The steps ping-pong between two shared
//     buffers, one barrier each; a step's cells are spread over the threads
//     in raster order, and the winner is kept as its shared-memory offset,
//     whose values are copied once.  The block then writes the eight output
//     planes of its tile; grid-stride over tiles.  16x16 and not 32x32
//     tiles: the steps are bound by instruction issue, and 32x32 tiles at
//     the parity field leave 96 blocks of 8 warps to run them.
// The wrapper (ops/kernels.py::flood_schedule) computes the split and
// passes the steps; any search range runs.
//
// Lanes: the launch floods B independent fields (K1: [B, 5*(rows+PAD),
// cols] stacks; K1b: B tables of K keylines; into [B, 8, rows*cols]; what
// torch.func.vmap of the step hands K1, as jax.vmap of a pallas_call adds a
// grid axis).  The long steps stride over the B*rows*cols cells and the
// short steps over the B*tiles tiles of all lanes, so one grid sync serves
// every lane; a cell's arithmetic and candidate order do not depend on B,
// so each lane gives the bits of a launch of its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "seed_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;
constexpr int kHaloMax = 8;                       // ops/kernels.py FLOOD_HALO_MAX
constexpr int kSide = kTile + 2 * kHaloMax;       // 32
constexpr int kTx = 32, kTy = kThreads / kTx;     // the tile load's 32 x 8 threads
constexpr int kRowsPer = (kSide + kTy - 1) / kTy; // 4
static_assert(kSide <= kTx, "a tile row with its halo is loaded by one warp");
constexpr int kMaxSteps = 32;
constexpr float kBig = 1e9f;

struct Geom {
  int rows, cols, pad, Rp, SR, n, tiles_x, ntiles, B;
  float r2, scale;
};

struct Schedule {
  int n_global, n_tile, halo;
  int steps[kMaxSteps];
};

struct State {
  float2* xy;    // (sy, sx)
  int* src;
};

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float dist2(float y, float x, float sy, float sx) {
  float a = __fsub_rn(y, sy);
  float b = __fsub_rn(x, sx);
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}


// K1's seeds: the row-stacked region stack.  src is the virtual cell the
// values came from; the finish reads id, gx, gy back from the stack there.
struct StackSeeds {
  const float* stacks;    // B lanes of [5*(rows+PAD), cols]

  __device__ __forceinline__ const float* lane(const Geom& g, int ln) const {
    return stacks + (size_t)ln * g.SR * g.cols;
  }
  // (sy, sx) at virtual row yv, column c (yv in [-PAD, rows + PAD): rows
  // above 0 wrap to the stack's end for plane 0)
  __device__ __forceinline__ float2 xy(const Geom& g, int ln, int yv, int c) const {
    const float* st = lane(g, ln);
    const int r0 = yv < 0 ? yv + g.SR : yv;
    return make_float2(__ldcg(st + (size_t)r0 * g.cols + c),
                       __ldcg(st + (size_t)(g.Rp + yv) * g.cols + c));
  }
  __device__ __forceinline__ int src(const Geom& g, int, int yv, int c) const {
    return (yv + g.pad) * g.cols + c;
  }
  __device__ __forceinline__ float at(const Geom& g, int ln, int r, int yv, int c) const {
    int row = r * g.Rp + yv;
    if (row < 0) row += g.SR;
    return __ldg(&lane(g, ln)[(size_t)row * g.cols + c]);
  }
  __device__ __forceinline__ void attrs(const Geom& g, int ln, int s, float& id, float& gx,
                                        float& gy) const {
    const int yv = s / g.cols - g.pad, c = s - (s / g.cols) * g.cols;
    id = at(g, ln, 2, yv, c);
    gx = at(g, ln, 3, yv, c);
    gy = at(g, ln, 4, yv, c);
  }
};

// K1b's seeds: the winner plane and the keyline table, for the stack that
// att_field_pallas scatters (data cells: the winner's (py, px, id, gx, gy)
// or (BIG, BIG, -1, 0, 0); pad rows: that sentinel, read above row 0 as the
// previous region's pad, (0, BIG, BIG, -1, 0)).  src is the winner's
// keyline index, kOwn or kRotated.
constexpr int kOwn = -1, kRotated = -2;

struct TableSeeds {
  const int* winner;      // B lanes of [rows*cols]: largest kept index per cell, -1
  const float* pos;       // B lanes of [K, 2] (x, y), image units
  const float* grad;      // B lanes of [K, 2]
  int K;
  float inv_s;

  __device__ __forceinline__ int src(const Geom& g, int ln, int yv, int c) const {
    if (yv < 0) return kRotated;
    if (yv >= g.rows) return kOwn;
    return __ldcg(winner + (size_t)ln * g.n + yv * g.cols + c);   // written by this launch
  }
  __device__ __forceinline__ float2 xy(const Geom& g, int ln, int yv, int c) const {
    const int w = src(g, ln, yv, c);
    if (w == kRotated) return make_float2(0.0f, kBig);
    if (w < 0) return make_float2(kBig, kBig);
    const float* p = pos + 2 * ((size_t)ln * K + w);
    return make_float2(__fmul_rn(__ldg(p + 1), inv_s), __fmul_rn(__ldg(p), inv_s));
  }
  __device__ __forceinline__ void attrs(const Geom&, int ln, int s, float& id, float& gx,
                                        float& gy) const {
    if (s >= 0) {
      const float* gr = grad + 2 * ((size_t)ln * K + s);
      id = (float)s;                    // exact below 2^24
      gx = __ldg(gr);
      gy = __ldg(gr + 1);
    } else {
      id = s == kRotated ? kBig : -1.0f;
      gx = s == kRotated ? -1.0f : 0.0f;
      gy = 0.0f;
    }
  }
};

// One long step over every cell: reads `in` (or the seeds on the first
// step), writes `out`; the nine loads of a cell are issued before its
// comparisons.
template <class Seeds>
__device__ void global_pass(const Seeds& S, State in_all, bool from_seeds, State out,
                            const Geom& g, int s) {
  const int sm = s % g.cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.B * g.n;
       i += gridDim.x * blockDim.x) {
    // lane ln's cell ci; the lane's state
    const int ln = i / g.n, ci = i - ln * g.n;
    const State in{in_all.xy + (size_t)ln * g.n, in_all.src + (size_t)ln * g.n};
    const int y = ci / g.cols, x = ci - (ci / g.cols) * g.cols;
    const float yf = (float)y, xf = (float)x;
    int cm = x + sm;
    if (cm >= g.cols) cm -= g.cols;
    int cp = x - sm;
    if (cp < 0) cp += g.cols;
    const int cc[3] = {cm, x, cp};                 // columns of dx = -s, 0, s
    float2 cand[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int yv = y - (q / 3 - 1) * s, c = cc[q % 3];
      cand[q] = (from_seeds || yv < 0 || yv >= g.rows) ? S.xy(g, ln, yv, c)
                                                        : __ldcg(in.xy + yv * g.cols + c);
    }
    float2 b = cand[4];
    float best = dist2(yf, xf, b.x, b.y);
    int wq = 4;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (q == 4) continue;
      const float cd2 = dist2(yf, xf, cand[q].x, cand[q].y);
      if (cd2 < best) {
        best = cd2;
        b = cand[q];
        wq = q;
      }
    }
    const int wy = y - (wq / 3 - 1) * s;
    const int wc = wq % 3 == 0 ? cm : (wq % 3 == 1 ? x : cp);
    const int src = (from_seeds || wy < 0 || wy >= g.rows) ? S.src(g, ln, wy, wc)
                                                          : __ldcg(in.src + wy * g.cols + wc);
    __stcg(out.xy + i, b);
    __stcg(out.src + i, src);
  }
}

// The eight output planes of cell (y, x) from its final state.
template <class Seeds>
__device__ __forceinline__ void finish(const Seeds& S, const Geom& g, int ln,
                                       float* __restrict__ out, int y, int x, float2 xy,
                                       int src) {
  float id, gx, gy;
  S.attrs(g, ln, src, id, gx, gy);
  const float d2 = dist2((float)y, (float)x, xy.x, xy.y);
  const int n = g.n, i = y * g.cols + x;
  out[i] = 0.0f;
  out[n + i] = d2;
  out[2 * n + i] = (d2 <= g.r2) ? id : -1.0f;
  out[3 * n + i] = gx;
  out[4 * n + i] = gy;
  out[5 * n + i] = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  out[6 * n + i] = __fmul_rn(xy.y, g.scale);
  out[7 * n + i] = __fmul_rn(xy.x, g.scale);
}

// The flood from the seeds S: long steps, then the tiles' short steps and
// the planes.  Run by every thread of a cooperative launch.
template <class Seeds>
__device__ void flood(const Seeds& S, float* buf, float* __restrict__ outs, const Geom& g,
                      const Schedule& sc) {
  __shared__ float2 s_xy[2][kSide * kSide];
  __shared__ int s_src[2][kSide * kSide];
  const int n = g.B * g.n;     // cells of all lanes
  // buf: (sy, sx) of both buffers first (8-byte aligned), then both src
  // planes; each buffer holds the B lanes' cells one lane after another
  float2* xy = reinterpret_cast<float2*>(buf);
  int* srcs = reinterpret_cast<int*>(buf + 4 * (size_t)n);
  const State s0{xy, srcs}, s1{xy + n, srcs + n};

  // ---- long steps: pass k writes s0 (k even) or s1 (k odd) from the other
  if (sc.n_global > 0) {
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < sc.n_global; ++k) {
      global_pass(S, (k & 1) ? s0 : s1, k == 0, (k & 1) ? s1 : s0, g, sc.steps[k]);
      grid.sync();
    }
  }
  const bool from_seeds = sc.n_global == 0;
  const State in_all = (sc.n_global & 1) ? s0 : s1;

  // ---- short steps on tiles in shared memory (ping-pong), then the planes
  const int H = sc.halo;
  const int side = kTile + 2 * H;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  for (int tb = blockIdx.x; tb < g.B * g.ntiles; tb += gridDim.x) {
    // lane ln's tile t: the lane's state and output planes
    const int ln = tb / g.ntiles, t = tb - ln * g.ntiles;
    const State in{in_all.xy + (size_t)ln * g.n, in_all.src + (size_t)ln * g.n};
    float* out = outs + (size_t)ln * 8 * g.n;
    const int y0 = (t / g.tiles_x) * kTile, x0 = (t - (t / g.tiles_x) * g.tiles_x) * kTile;
    if (tx < side) {
      const int c = wrap(x0 - H + tx, g.cols);
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const int i = ty + r * kTy;
        if (i < side) {
          const int yv = y0 - H + i;
          float2 v;
          int src;
          if (!from_seeds && yv >= 0 && yv < g.rows) {
            v = __ldcg(in.xy + yv * g.cols + c);
            src = __ldcg(in.src + yv * g.cols + c);
          } else if (yv >= -g.pad && yv < g.rows + g.pad) {
            v = S.xy(g, ln, yv, c);
            src = S.src(g, ln, yv, c);
          } else {  // below the last tile's pad: read only by cells that are never updated
            v = make_float2(kBig, kBig);
            src = -1;
          }
          s_xy[0][i * kSide + tx] = v;
          s_src[0][i * kSide + tx] = src;
        }
      }
    }
    __syncthreads();
    int m = H, cur = 0;
    for (int k = 0; k < sc.n_tile; ++k) {
      const int s = sc.steps[sc.n_global + k];
      m -= s;                                   // this step updates the tile grown by m
      const int lo = H - m, ext = kTile + 2 * m;
      const float2* rxy = s_xy[cur];
      const int* rsrc = s_src[cur];
      // the region's ext x ext cells in raster order over the block's
      // threads; row = floor((e + 0.5) / ext) is exact in float (e < 2^10)
      const float inv_ext = 1.0f / (float)ext;
      for (int e = threadIdx.x; e < ext * ext; e += kThreads) {
        const int ri = __float2int_rz(((float)e + 0.5f) * inv_ext);
        const int i = lo + ri, j = lo + e - ri * ext;
        const int o = i * kSide + j;
        const int yv = y0 - H + i;
        int wo = o;
        if (yv >= 0 && yv < g.rows) {
          const float yf = (float)yv, xf = (float)wrap(x0 - H + j, g.cols);
          const float2 own = rxy[o];
          float best = dist2(yf, xf, own.x, own.y);
#pragma unroll
          for (int iy = -1; iy <= 1; ++iy) {
#pragma unroll
            for (int ix = -1; ix <= 1; ++ix) {
              if (iy == 0 && ix == 0) continue;
              const int co = o - iy * s * kSide - ix * s;
              const float2 cv = rxy[co];
              const float cd2 = dist2(yf, xf, cv.x, cv.y);
              if (cd2 < best) {
                best = cd2;
                wo = co;
              }
            }
          }
        }
        s_xy[cur ^ 1][o] = rxy[wo];
        s_src[cur ^ 1][o] = rsrc[wo];
      }
      cur ^= 1;
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int i = e / kTile, j = e - (e / kTile) * kTile;
      const int y = y0 + i, x = x0 + j;
      if (y < g.rows && x < g.cols) {
        const int o = (H + i) * kSide + H + j;
        finish(S, g, ln, out, y, x, s_xy[cur][o], s_src[cur][o]);
      }
    }
    __syncthreads();                            // before the next tile's load
  }
}

__global__ void __launch_bounds__(kThreads)
    att_flood_kernel(const float* __restrict__ stacks, float* buf, float* __restrict__ outs,
                     Geom g, Schedule sc) {
  flood(StackSeeds{stacks}, buf, outs, g, sc);
}

// K1b: phase 0 seeds the winner plane on the grid that then floods.
__global__ void __launch_bounds__(kThreads)
    att_field_kernel(const float* __restrict__ pos, const float* __restrict__ grad,
                     const unsigned char* __restrict__ use, int K, float inv_s, int* winner,
                     float* buf, float* __restrict__ outs, Geom g, Schedule sc) {
  cg::grid_group grid = cg::this_grid();
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  for (int i = t0; i < g.B * g.n; i += nt) winner[i] = -1;
  grid.sync();
  for (int i = t0; i < g.B * K; i += nt) {
    const int ln = i / K;
    int cell;
    if (use[i] && seed_cell(pos + 2 * (size_t)i, inv_s, g.rows, g.cols, cell))
      atomicMax(winner + (size_t)ln * g.n + cell, i - ln * K);
  }
  grid.sync();
  flood(TableSeeds{winner, pos, grad, K, inv_s}, buf, outs, g, sc);
}

// The launch geometry of either flood, checked: Geom, Schedule and the
// block count; cudaSuccess or cudaErrorInvalidValue.
int plan(int B, int rows, int cols, int pad, int search_range, float scale, const int* steps,
         int n_global, int n_tile, int halo, int max_blocks, Geom& g, Schedule& sc,
         int& blocks) {
  if (n_global < 0 || n_tile < 1 || n_global + n_tile > kMaxSteps || halo > kHaloMax ||
      halo > pad || rows < 1 || cols < 1 || max_blocks < 1 || B < 1 ||
      (long long)B * rows * cols * 3 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  sc.n_global = n_global;
  sc.n_tile = n_tile;
  sc.halo = halo;
  int sum = 0;
  for (int k = 0; k < n_global + n_tile; ++k) {
    if (steps[k] < 1 || steps[k] > pad) return (int)cudaErrorInvalidValue;
    sc.steps[k] = steps[k];
    if (k >= n_global) sum += steps[k];
  }
  if (sum != halo) return (int)cudaErrorInvalidValue;
  const int tiles_x = (cols + kTile - 1) / kTile;
  const int ntiles = ((rows + kTile - 1) / kTile) * tiles_x;
  g = Geom{rows, cols, pad, rows + pad, 5 * (rows + pad), rows * cols, tiles_x, ntiles, B,
           (float)(search_range * search_range), scale};
  blocks = (B * g.n + kThreads - 1) / kThreads;
  if (blocks < B * ntiles) blocks = B * ntiles;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)cudaSuccess;
}

// The most blocks of `kernel` that can be co-resident on the current
// device (the cooperative launch's limit), -1 if the query fails.
int max_blocks_of(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

}  // namespace

extern "C" int rk_att_flood_max_blocks() {
  return max_blocks_of((const void*)att_flood_kernel);
}

extern "C" int rk_att_field_max_blocks() {
  return max_blocks_of((const void*)att_field_kernel);
}

// stack: B lanes of [5*(rows+PAD), cols]; out: B lanes of [8, rows*cols];
// steps: host array of n_global long steps then n_tile short steps (whose
// sum is halo); state: 2 x 3 x B*rows*cols words of scratch; max_blocks: the
// co-resident limit (rk_att_flood_max_blocks).
extern "C" int rk_att_flood(const float* stack, float* state, float* out, int B, int rows,
                            int cols, int pad, int search_range, float scale, const int* steps,
                            int n_global, int n_tile, int halo, int max_blocks,
                            void* stream_ptr) {
  Geom g;
  Schedule sc;
  int blocks;
  const int err = plan(B, rows, cols, pad, search_range, scale, steps, n_global, n_tile, halo,
                       max_blocks, g, sc, blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&stack, &state, &out, &g, &sc};
  return (int)cudaLaunchCooperativeKernel((const void*)att_flood_kernel, dim3(blocks),
                                          dim3(kThreads), args, 0, (cudaStream_t)stream_ptr);
}

// K1b: pos, grad B lanes of [K, 2] f32, use B lanes of [K] bytes; inv_s
// float32(1/scale); scratch: 7 x B*rows*cols words (the flood's state,
// then the int32 winner plane); out: B lanes of [8, rows*cols]; the rest as
// rk_att_flood's (pad: the plain version's stack's, which bounds the steps);
// max_blocks from rk_att_field_max_blocks.
extern "C" int rk_att_field(const float* pos, const float* grad, const unsigned char* use,
                            int K, float inv_s, float* scratch, float* out, int B, int rows,
                            int cols, int pad, int search_range, float scale, const int* steps,
                            int n_global, int n_tile, int halo, int max_blocks,
                            void* stream_ptr) {
  Geom g;
  Schedule sc;
  int blocks;
  const int err = plan(B, rows, cols, pad, search_range, scale, steps, n_global, n_tile, halo,
                       max_blocks, g, sc, blocks);
  if (err != cudaSuccess) return err;
  if (K < 0 || K >= (1 << 24) || (long long)B * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int* winner = reinterpret_cast<int*>(scratch + 6 * (size_t)B * g.n);
  void* args[] = {&pos, &grad, &use, &K, &inv_s, &winner, &scratch, &out, &g, &sc};
  return (int)cudaLaunchCooperativeKernel((const void*)att_field_kernel, dim3(blocks),
                                          dim3(kThreads), args, 0, (cudaStream_t)stream_ptr);
}
