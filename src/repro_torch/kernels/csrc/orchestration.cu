// Hand-written Hopper (sm_90a) kernels for the serving tick's two
// orchestration steps, with a plain C interface bound from Python through
// ctypes (repro_torch/kernels/orchestration.py).  Every entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the wrapper can raise on
// a refused launch.
//
// queue_admit
//   Replaces the TPU kernel repro/kernels/orchestration.py
//   queue_admit_pallas (body _queue_admit_kernel).  That kernel builds an
//   (A, A) same-cell rank mask and serialises its ring stores in a
//   fori_loop; at the serving deployment's bursts (A ~ 40k lanes) the
//   mask alone is 1.6e9 comparisons, so it is not carried over.
//   What bounds it: bytes would (~13 bytes a lane plus the admitted ring
//   slots, well under a microsecond of HBM time), but the stable
//   same-cell rank is a dependency along the lanes: one block walking
//   the burst tile after tile would leave 131 of 132 SMs idle.
//   Design: a stable counting sort's ranks, computed in three launches
//   after one memset, with no atomics whose order shows in the result:
//     1. queue_admit_kernel_rank: one CTA per tile of 1,024 lanes.  A lane
//        counts the earlier valid lanes of its cell in the tile (earlier
//        warps by a warp-uniform scan of the tile's cell ids in shared
//        memory, its own warp with __match_any_sync) and stores that
//        in-tile rank; the warp's last lane of each cell raises the
//        tile's count of the cell, in a zeroed (tiles, C) table, to its
//        rank + 1 (atomicMax, so the order does not matter).
//     2. queue_admit_kernel_cells: one thread per cell walks the tiles in
//        order and replaces each non-zero count with the cell's queue
//        position before that tile, q_len0 + the counts of earlier tiles;
//        it also writes q_len = q_len0 + the admitted count, which the
//        lanes no longer need.
//     3. queue_admit_kernel_lanes: one thread per lane: position = the
//        tile's entry for its cell + its in-tile rank; admit iff
//        position < Q, at ring slot (head + position) % Q.
//   So the rank is the sequential loop's FIFO rank for any lane order, and
//   admission, ring slots and q_len are the sequential loop's exactly; the
//   admitted stores cannot collide, so they go out in parallel.  The
//   table costs (tiles x C) int32 of memset and of reads, ~10 MB at the
//   deployment.  The rings and q_len are updated in place: the TPU body
//   copied the whole (C, Q) ring every tick (33.5 MB at C = 65,536,
//   Q = 64).
//
// group_occupancy
//   Replaces repro/kernels/orchestration.py group_occupancy_pallas (body
//   _group_occupancy_kernel): out[i] = sum_j own[j] * [g_j == g_i].  The
//   TPU form is an O(C^2) membership-mask matvec shaped for the MXU.
//   What bounds it here: bytes (it reads own and groups and writes out,
//   12 bytes a cell) and, at C = 65,536, the launch latency of its passes.
//   Design: O(C) segment sum — zero a (C,) totals scratch, scatter with
//   atomicAdd, gather.  For int32 counts (the engine's only input) the
//   result is exact and deterministic; for float32 the atomic order
//   varies from run to run, so it agrees with a sequential sum only to
//   float32 rounding of each group's partial sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAdmitTile = 1024;
constexpr int kGroupBlock = 256;

__device__ __forceinline__ int clamp_cell(int c, int n_cells) {
  return min(max(c, 0), n_cells - 1);
}

// in-tile ranks, and each tile's count of each of its cells
__global__ void __launch_bounds__(kAdmitTile)
queue_admit_kernel_rank(const int32_t* __restrict__ cell,
                        const bool* __restrict__ valid,
                        int32_t* __restrict__ tile_count,
                        int32_t* __restrict__ lane_rank, int n_cells,
                        int n_lanes) {
  __shared__ __align__(16) int32_t s_cell[kAdmitTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp_base = tid & ~31;
  const int i = blockIdx.x * kAdmitTile + tid;
  const bool v = i < n_lanes && valid[i];
  const int c = v ? clamp_cell(cell[i], n_cells) : -1;
  s_cell[tid] = c;
  __syncthreads();
  // earlier lanes of the same cell: in earlier warps of the tile by a
  // warp-uniform scan of shared memory (broadcast 16-byte reads), in this
  // warp by matching lane values
  int r = 0;
  const int4* s4 = reinterpret_cast<const int4*>(s_cell);
  for (int j = 0; j < warp_base / 4; ++j) {
    const int4 q = s4[j];
    r += (q.x == c) + (q.y == c) + (q.z == c) + (q.w == c);
  }
  const unsigned same = __match_any_sync(0xffffffffu, c);
  r += __popc(same & ((1u << lane) - 1u));
  if (v) {
    lane_rank[i] = r;
    if (31 - __clz(same) == lane)  // the warp's last lane of this cell
      atomicMax(tile_count + static_cast<int64_t>(blockIdx.x) * n_cells + c,
                r + 1);
  }
}

// per cell: each tile's count becomes the cell's queue position before
// that tile; q_len takes the admitted lanes
__global__ void __launch_bounds__(kGroupBlock)
queue_admit_kernel_cells(int32_t* __restrict__ tile_count,
                         int32_t* __restrict__ q_len, int n_cells,
                         int n_tiles, int q_cap) {
  constexpr int kBatch = 8;  // tiles whose loads are issued together
  const int c = blockIdx.x * kGroupBlock + threadIdx.x;
  if (c >= n_cells) return;
  const int len0 = q_len[c];
  int run = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kBatch) {
    int n[kBatch];
#pragma unroll
    for (int x = 0; x < kBatch; ++x)
      n[x] = t0 + x < n_tiles
                 ? tile_count[static_cast<int64_t>(t0 + x) * n_cells + c]
                 : 0;
#pragma unroll
    for (int x = 0; x < kBatch; ++x) {
      if (n[x]) {
        tile_count[static_cast<int64_t>(t0 + x) * n_cells + c] = len0 + run;
        run += n[x];
      }
    }
  }
  if (run) q_len[c] = len0 + max(0, min(run, q_cap - len0));
}

// per lane: admission and the ring store
__global__ void __launch_bounds__(kAdmitTile)
queue_admit_kernel_lanes(int32_t* __restrict__ q_ids,
                         const int32_t* __restrict__ q_head,
                         const int32_t* __restrict__ rid,
                         const int32_t* __restrict__ cell,
                         const bool* __restrict__ valid,
                         bool* __restrict__ admitted,
                         const int32_t* __restrict__ tile_count,
                         const int32_t* __restrict__ lane_rank, int n_cells,
                         int q_cap, int n_lanes) {
  const int i = blockIdx.x * kAdmitTile + threadIdx.x;
  if (i >= n_lanes) return;
  bool ok = false;
  if (valid[i]) {
    const int c = clamp_cell(cell[i], n_cells);
    const int pos =
        tile_count[static_cast<int64_t>(blockIdx.x) * n_cells + c] +
        lane_rank[i];
    ok = pos < q_cap;
    if (ok) {
      const int slot = (q_head[c] + pos) % q_cap;
      q_ids[static_cast<int64_t>(c) * q_cap + slot] = rid[i];
    }
  }
  admitted[i] = ok;
}

template <typename T>
__global__ void __launch_bounds__(kGroupBlock)
group_scatter_kernel(const T* __restrict__ own,
                     const int32_t* __restrict__ groups,
                     T* __restrict__ totals, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int g = groups[i];
    if (g >= 0 && g < n) atomicAdd(totals + g, own[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGroupBlock)
group_gather_kernel(const int32_t* __restrict__ groups,
                    const T* __restrict__ totals, T* __restrict__ out,
                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int g = groups[i];
    out[i] = (g >= 0 && g < n) ? totals[g] : T(0);
  }
}

template <typename T>
int group_occupancy_launch(const void* own, const void* groups,
                           void* totals, void* out, int n, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(totals, 0, sizeof(T) * static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kGroupBlock - 1) / kGroupBlock;
  group_scatter_kernel<T><<<blocks, kGroupBlock, 0, s>>>(
      static_cast<const T*>(own), static_cast<const int32_t*>(groups),
      static_cast<T*>(totals), n);
  group_gather_kernel<T><<<blocks, kGroupBlock, 0, s>>>(
      static_cast<const int32_t*>(groups), static_cast<const T*>(totals),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scratch: (ceil(A / 1024) * C + A) int32; the tile table is zeroed here
int queue_admit(void* q_ids, const void* q_head, void* q_len,
                const void* rid, const void* cell, const void* valid,
                void* admitted, void* scratch, int n_cells, int q_cap,
                int n_lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_lanes + kAdmitTile - 1) / kAdmitTile;
  int32_t* tile_count = static_cast<int32_t*>(scratch);
  int32_t* lane_rank =
      tile_count + static_cast<int64_t>(n_tiles) * n_cells;
  err = cudaMemsetAsync(tile_count, 0,
                        sizeof(int32_t) * static_cast<size_t>(n_tiles) *
                            static_cast<size_t>(n_cells), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  queue_admit_kernel_rank<<<n_tiles, kAdmitTile, 0, s>>>(
      static_cast<const int32_t*>(cell), static_cast<const bool*>(valid),
      tile_count, lane_rank, n_cells, n_lanes);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  queue_admit_kernel_cells<<<(n_cells + kGroupBlock - 1) / kGroupBlock,
                             kGroupBlock, 0, s>>>(
      tile_count, static_cast<int32_t*>(q_len), n_cells, n_tiles, q_cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  queue_admit_kernel_lanes<<<n_tiles, kAdmitTile, 0, s>>>(
      static_cast<int32_t*>(q_ids), static_cast<const int32_t*>(q_head),
      static_cast<const int32_t*>(rid), static_cast<const int32_t*>(cell),
      static_cast<const bool*>(valid), static_cast<bool*>(admitted),
      tile_count, lane_rank, n_cells, q_cap, n_lanes);
  return static_cast<int>(cudaGetLastError());
}

int group_occupancy_i32(const void* own, const void* groups, void* totals,
                        void* out, int n, int device, void* stream) {
  return group_occupancy_launch<int32_t>(own, groups, totals, out, n, device,
                                         stream);
}

int group_occupancy_f32(const void* own, const void* groups, void* totals,
                        void* out, int n, int device, void* stream) {
  return group_occupancy_launch<float>(own, groups, totals, out, n, device,
                                       stream);
}

}  // extern "C"
