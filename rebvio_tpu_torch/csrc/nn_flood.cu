// K7: id-only jump flood of the nearest-keyline field, one thread-block
// cluster.
//
// Replaces rebvio_tpu/ops/pallas_kernels.py::nn_field_pallas.  The seeds
// come from csrc/seed_scatter.cu's winner plane (largest kept keyline index
// per cell, the sequential scatter's last writer).
//
// Semantics (the Pallas body's, exactly): three [rows, cols] planes (id, sy,
// sx) and the running best distance, each rolled on its own (rows wrap
// modulo rows, columns modulo cols), the state UPDATED after every
// direction: 8 * len(steps) dependent full-field passes (48 at field search
// range 20: steps 16, 8, 4, 2, 1, 1), dy outer, dx inner over (-s, 0, s),
// (0, 0) skipped; a candidate is taken only if strictly closer, d2 = (y -
// sy)^2 + (x - sx)^2 in float32 with round-to-nearest intrinsics and no FMA
// contraction; the radius gate comes last.
//
// Bound on the H100: operations, barely.  The least traffic is the keyline
// table read once and the int32 field written once (0.5 MB, 0.15 us at
// 3.35 TB/s); the 48 passes do about 7 float32 operations per cell each
// (30 MFLOP, 0.45 us at 67 TFLOP/s).  The first port made 50 launches, one
// per pass, each ~2 us of launch and drain.  Within one step of size s a
// cell's inputs reach 3s away, so a tiled design's halo would be 96 cells,
// and a grid sync costs about as much as a launch.
//
// Design: ONE cluster of C CTAs (16, non-portable, or 8), rows split over
// the CTAs in contiguous blocks of R = ceil(rows / C) (the last CTAs may own
// fewer, or none).
//   * Shared state is the cell's id alone: a cell's (sy, sx) is always the
//     position of the keyline it holds (the seed takes pos[w], a candidate
//     moves id, sy, sx together), so it is gathered as pos[id]: from a copy
//     of the keyline table in each CTA's shared memory where it fits (the
//     240x376 field at 16000 keylines), else through __ldg.
//   * best, and the cell's id, are read only by its owner: they live in
//     registers.  Each thread owns the same cells on every pass: in one
//     column, every H-th row of its CTA (H threads a column, up to RT rows
//     a thread, a compile-time count: 4, 8, 16 or 32), so a pass's source
//     column is computed once.
//   * The ids ping-pong between two buffers in each CTA's shared memory.
//     Pass p reads cell (y - dy, x - dx) from buffer p&1 of the CTA that
//     owns that row (distributed shared memory: ld.shared::cluster at the
//     row's cluster address, from a table built once with mapa), writes its
//     own cells to buffer (p+1)&1, then cluster.sync(): 48 cluster barriers
//     in place of 48 launches.  The last pass's barrier is the one before
//     any CTA exits (no remote read may outlive its owner); the finish reads
//     only the CTA's own buffer.
//   * Every shared-memory address is formed from the shared array itself,
//     so accesses stay in the shared space (no generic loads, no pointer
//     array in local memory).
// The seed read (nn_init) and the radius gate (nn_finish) of the first
// port fold into the same kernel: a call is the seeding plus this launch.
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; tools/jfa_ab.py): a
// cluster barrier costs ~0.9 us, about what the launch it replaces cost,
// and one cluster holds only 16 SMs, so at the 240x376 field each of the 48
// dependent passes takes ~2.4 us, bound by the barrier and by latency on
// those 16 SMs, not by memory (PERF.md, PR 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float BIG = 1e9f;

__device__ __forceinline__ float dist2(float y, float x, float sy, float sx) {
  float a = __fsub_rn(y, sy);
  float b = __fsub_rn(x, sx);
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ int load_cluster(unsigned addr) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Launch bounds of the RT-row instantiation (ops/kernels.py NN_RT), so that
// best[RT], the ids and a chunk's loads stay in registers (at RT = 32, the
// full-resolution field, some spill)
#define NN_MAX_THREADS(RT) ((RT) <= 4 ? 1024 : ((RT) <= 8 ? 768 : ((RT) <= 16 ? 384 : 768)))

template <int RT, bool POS_SMEM>
__global__ void __launch_bounds__(NN_MAX_THREADS(RT))
    nn_cluster_kernel(const float* __restrict__ pos, const int* __restrict__ winner, int K,
                      int rows, int cols, int R, int search_range, int* __restrict__ out) {
  // a pass handles a thread's rows in chunks of B: the chunk's remote reads,
  // then its keyline gathers, then its compares and writes, so the loads of
  // a chunk are in flight together
  constexpr int B = RT < 4 ? RT : 4;
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int Tc = (cols + 31) & ~31;                // threads per column group
  const int H = blockDim.x / Tc;                   // threads per column
  const int x = threadIdx.x % Tc;                  // the thread's column
  const int h = threadIdx.x / Tc;                  // its rows: h, h + H, ...
  const bool col_ok = x < cols;
  const int ncap = R * cols;                       // buffer stride, the same in every CTA
  const int r0 = rank * R;
  const int nrows = max(0, min(R, rows - r0));     // the CTA's own rows
  const float fx = (float)x, fy0 = (float)(r0 + h);
  // smem: ids buffer 0 and 1 [ncap each], then per buffer a row table (the
  // cluster address of each field row in its owner's buffer), then pos
  unsigned* rowaddr = (unsigned*)(smem + 2 * ncap);
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int q = r / R;
    const unsigned off = base + 4u * (unsigned)((r - q * R) * cols);
    rowaddr[r] = map_rank(off, q);
    rowaddr[rows + r] = map_rank(off + 4u * ncap, q);
  }
  float2* spos = (float2*)(smem + 2 * ncap + 2 * rows);
  if (POS_SMEM)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      spos[k] = make_float2(__ldg(pos + 2 * k), __ldg(pos + 2 * k + 1));

  // seed: the winner plane; best = the seed's own distance; the cell's id
  // kept in a register as well
  float best[RT];
  int idr[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int i = h + H * k;
    best[k] = BIG;
    idr[k] = -1;
    if (col_ok && i < nrows) {
      const int id = winner[(r0 + i) * cols + x];
      if (id >= 0)
        best[k] = dist2(fy0 + (float)(H * k), fx, __ldg(pos + 2 * id + 1), __ldg(pos + 2 * id));
      idr[k] = id;
      smem[i * cols + x] = id;
    }
  }
  cluster.sync();                                  // seeds, row tables, pos visible

  int p = 0;
  int s = 1;
  while (2 * s < search_range) s *= 2;
  for (bool extra = false;;) {
    for (int iy = -1; iy <= 1; ++iy) {
      for (int ix = -1; ix <= 1; ++ix) {
        if (iy == 0 && ix == 0) continue;
        // shifts taken modulo the field, so one add wraps a source index
        const int dyw = ((iy * s) % rows + rows) % rows;
        int sx = x - ((ix * s) % cols + cols) % cols;
        sx += sx < 0 ? cols : 0;
        int* nxt = smem + ((p & 1) ? 0 : ncap);
        const unsigned* src_row = rowaddr + ((p & 1) ? rows : 0);
        if (col_ok) {
#pragma unroll
          for (int k0 = 0; k0 < RT; k0 += B) {
            int cid[B];
            float cy[B], cx[B];
#pragma unroll
            for (int j = 0; j < B; ++j) {
              const int i = h + H * (k0 + j);
              cid[j] = -1;
              if (i < nrows) {
                int sy = r0 + i - dyw;
                sy += sy < 0 ? rows : 0;
                cid[j] = load_cluster(src_row[sy] + 4u * (unsigned)sx);
              }
            }
#pragma unroll
            for (int j = 0; j < B; ++j) {
              if (cid[j] >= 0) {
                if (POS_SMEM) {
                  const float2 q = spos[cid[j]];
                  cx[j] = q.x;
                  cy[j] = q.y;
                } else {
                  cx[j] = __ldg(pos + 2 * cid[j]);
                  cy[j] = __ldg(pos + 2 * cid[j] + 1);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < B; ++j) {
              const int i = h + H * (k0 + j);
              if (i < nrows) {
                // an empty candidate (id < 0) has distance BIG, never below a
                // best that is a real d2 or BIG itself
                if (cid[j] >= 0) {
                  const float cd2 = dist2(fy0 + (float)(H * (k0 + j)), fx, cy[j], cx[j]);
                  if (cd2 < best[k0 + j]) {
                    best[k0 + j] = cd2;
                    idr[k0 + j] = cid[j];
                  }
                }
                nxt[i * cols + x] = idr[k0 + j];
              }
            }
          }
        }
        cluster.sync();
        ++p;
      }
    }
    if (s > 1) {
      s /= 2;
    } else if (!extra) {
      extra = true;  // the extra refinement pass at step 1 (JFA+1)
    } else {
      break;
    }
  }

  // radius gate on the thread's own cells (their ids are in idr)
  const float r2 = (float)(search_range * search_range);
  if (col_ok) {
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int i = h + H * k;
      if (i < nrows) out[(r0 + i) * cols + x] = best[k] <= r2 ? idr[k] : -1;
    }
  }
}

using KernelFn = void (*)(const float*, const int*, int, int, int, int, int, int*);

KernelFn kernel_for(int rt, int pos_smem) {
  switch (rt * 2 + (pos_smem ? 1 : 0)) {
    case 8: return nn_cluster_kernel<4, false>;
    case 9: return nn_cluster_kernel<4, true>;
    case 16: return nn_cluster_kernel<8, false>;
    case 17: return nn_cluster_kernel<8, true>;
    case 32: return nn_cluster_kernel<16, false>;
    case 33: return nn_cluster_kernel<16, true>;
    case 64: return nn_cluster_kernel<32, false>;
    case 65: return nn_cluster_kernel<32, true>;
    default: return nullptr;
  }
}

cudaError_t prepare(KernelFn fn, int smem) {
  cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int C, int T, int smem,
            cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

// How many clusters of C CTAs (T threads, up to rt rows each, pos in shared
// memory or not, smem bytes of dynamic shared memory) the current device can
// hold at once; 0 if none (the cluster size cannot launch), a negative
// cudaError if the query fails.
extern "C" int rk_nn_cluster_occupancy(int C, int T, int rt, int pos_smem, int smem) {
  KernelFn fn = kernel_for(rt, pos_smem);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, C, T, smem, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return 0;
  }
  return n;
}

// pos [K, 2] in field units, winner [rows*cols] from rk_seed_winner, out
// [rows*cols] int32; the plan (C, R, T, rt, pos_smem, smem) from
// ops/kernels.py's nn_cluster_plan, checked by rk_nn_cluster_occupancy.
extern "C" int rk_nn_cluster(const float* pos, const int* winner, int* out, int K, int rows,
                             int cols, int search_range, int C, int R, int T, int rt,
                             int pos_smem, int smem, void* stream_ptr) {
  KernelFn fn = kernel_for(rt, pos_smem);
  const int Tc = (cols + 31) & ~31;
  if (fn == nullptr || rows < 1 || cols < 1 || C < 1 || C > 16 || R * C < rows ||
      T % Tc != 0 || (T / Tc) * rt < R || T > NN_MAX_THREADS(rt) ||
      (long)smem < 8L * R * cols + 8L * rows + (pos_smem ? 8L * K : 0L))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, C, T, smem, (cudaStream_t)stream_ptr);
  return (int)cudaLaunchKernelEx(&cfg, fn, pos, winner, K, rows, cols, R, search_range, out);
}
