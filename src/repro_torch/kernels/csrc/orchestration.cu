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
//   What bounds it here: bytes would (own and groups read, out written,
//   12 bytes a cell: 0.24 us at C = 65,536), so one launch's latency and
//   the chain of dependent loads inside it do.
//   Design: one launch over a group index the wrapper builds once per
//   deployment (repro_torch.kernels.orchestration.group_index).  The index
//   sorts the cells by group, cuts them into tiles of at most 1,024 on
//   group boundaries, and gives tile b the slots [1024 b, 1024 (b + 1)):
//   each slot's cell (slot_cell, -1 for padding) and its place r in its
//   group's run in the tile with the run's length n (slot_seg = r << 16 |
//   n).  group_occupancy_kernel runs one CTA per tile: a thread loads its
//   slot's cell and seg (one coalesced round trip, with no search of the
//   tile), then own[cell] into shared memory; the CTA sums each run in a
//   tree whose stride doubles (at stride d, r adds r + d when r is a
//   multiple of 2d), and each member writes its run's total.  No memset, no
//   scratch to zero, no atomics: each group is summed in one fixed order,
//   so int32 is exact and float32 repeats bit for bit from launch to
//   launch (group_occupancy_tree in the wrapper's module is that order in
//   plain PyTorch).  A group larger than a tile gets whole tiles of its
//   own, 1,024 entries from its start; their CTAs write tile sums, and
//   group_combine_kernel sums those in the same tree and writes the total
//   to the members, so the order is the one tree over the whole group.
//   The index decides once whether a call takes that second launch.
//   Bytes: slot_cell and slot_seg besides own and out, 16 a cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAdmitTile = 1024;
constexpr int kCellBlock = 256;
constexpr int kGroupTile = 1024;

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
__global__ void __launch_bounds__(kCellBlock)
queue_admit_kernel_cells(int32_t* __restrict__ tile_count,
                         int32_t* __restrict__ q_len, int n_cells,
                         int n_tiles, int q_cap) {
  constexpr int kBatch = 8;  // tiles whose loads are issued together
  const int c = blockIdx.x * kCellBlock + threadIdx.x;
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

// s[0] += s[1], s[2] += s[3], ..., then at stride 2, 4, ...: the sum of
// s[0, n) lands in s[0].  Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ void tree_sum(T* s, int n, int t) {
  for (int d = 1; d < n; d *= 2) {
    if ((t & (2 * d - 1)) == 0 && t + d < n) s[t] += s[t + d];
    __syncthreads();
  }
}

// one CTA per tile: each group's total to its members, or the tile sum of
// a group that spans tiles
template <typename T>
__global__ void __launch_bounds__(kGroupTile)
group_occupancy_kernel(const T* __restrict__ own,
                       const int32_t* __restrict__ slot_cell,
                       const int32_t* __restrict__ slot_seg,
                       const int32_t* __restrict__ tile_chunk,
                       T* __restrict__ out, T* __restrict__ partial,
                       int span) {
  __shared__ T s_val[kGroupTile];
  const int t = threadIdx.x;
  const int k = blockIdx.x * kGroupTile + t;
  const int cell = slot_cell[k];  // -1 for padding
  const int seg = slot_seg[k];
  const bool spans = tile_chunk[2 * blockIdx.x] >= 0;
  s_val[t] = cell >= 0 ? own[cell] : T(0);
  __syncthreads();
  // rel: the member's place in its group's run in the tile, len the run's
  // length (0 for padding, which adds nothing and is never added)
  const int rel = seg >> 16, len = seg & 0xffff;
  for (int d = 1; d < span; d *= 2) {
    if ((rel & (2 * d - 1)) == 0 && rel + d < len) s_val[t] += s_val[t + d];
    __syncthreads();
  }
  if (spans) {
    if (t == 0) partial[blockIdx.x] = s_val[0];
  } else if (cell >= 0) {
    out[cell] = s_val[t - rel];
  }
}

// one CTA per tile of a group that spans tiles: the group's tile sums in
// the same tree (in blocks of kGroupTile sums, then over the blocks,
// which is the one tree: the blocks start at multiples of a power of two)
template <typename T>
__global__ void __launch_bounds__(kGroupTile)
group_combine_kernel(const int32_t* __restrict__ slot_cell,
                     const int32_t* __restrict__ tile_chunk,
                     const T* __restrict__ partial, T* __restrict__ out) {
  const int first_tile = tile_chunk[2 * blockIdx.x];
  const int m = tile_chunk[2 * blockIdx.x + 1];
  if (first_tile < 0) return;
  __shared__ T s_val[kGroupTile];
  __shared__ T s_blk[kGroupTile];
  const int t = threadIdx.x;
  const int cell = slot_cell[blockIdx.x * kGroupTile + t];
  const int n_blk = (m + kGroupTile - 1) / kGroupTile;
  for (int b = 0; b < n_blk; ++b) {
    const int n = min(kGroupTile, m - b * kGroupTile);
    if (t < n) s_val[t] = partial[first_tile + b * kGroupTile + t];
    __syncthreads();
    tree_sum(s_val, n, t);
    if (t == 0) s_blk[b] = s_val[0];
    __syncthreads();
  }
  tree_sum(s_blk, n_blk, t);
  if (cell >= 0) out[cell] = s_blk[0];
}

template <typename T>
int group_occupancy_launch(const void* own, const void* slot_cell,
                           const void* slot_seg, const void* tile_chunk,
                           void* out, void* partial, int n_tiles, int span,
                           int combine, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sc = static_cast<const int32_t*>(slot_cell);
  const int32_t* tc = static_cast<const int32_t*>(tile_chunk);
  group_occupancy_kernel<T><<<n_tiles, kGroupTile, 0, s>>>(
      static_cast<const T*>(own), sc, static_cast<const int32_t*>(slot_seg),
      tc, static_cast<T*>(out), static_cast<T*>(partial), span);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (combine)
    group_combine_kernel<T><<<n_tiles, kGroupTile, 0, s>>>(
        sc, tc, static_cast<const T*>(partial), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

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
  queue_admit_kernel_cells<<<(n_cells + kCellBlock - 1) / kCellBlock,
                             kCellBlock, 0, s>>>(
      tile_count, static_cast<int32_t*>(q_len), n_cells, n_tiles, q_cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  queue_admit_kernel_lanes<<<n_tiles, kAdmitTile, 0, s>>>(
      static_cast<int32_t*>(q_ids), static_cast<const int32_t*>(q_head),
      static_cast<const int32_t*>(rid), static_cast<const int32_t*>(cell),
      static_cast<const bool*>(valid), static_cast<bool*>(admitted),
      tile_count, lane_rank, n_cells, q_cap, n_lanes);
  return static_cast<int>(cudaGetLastError());
}

// slot_cell, slot_seg: (n_tiles * 1024) int32; tile_chunk: (n_tiles, 2)
// int32; partial: (n_tiles) of the value type when combine, else unused
int group_occupancy_i32(const void* own, const void* slot_cell,
                        const void* slot_seg, const void* tile_chunk,
                        void* out, void* partial, int n_tiles, int span,
                        int combine, int device, void* stream) {
  return group_occupancy_launch<int32_t>(own, slot_cell, slot_seg, tile_chunk,
                                         out, partial, n_tiles, span, combine,
                                         device, stream);
}

int group_occupancy_f32(const void* own, const void* slot_cell,
                        const void* slot_seg, const void* tile_chunk,
                        void* out, void* partial, int n_tiles, int span,
                        int combine, int device, void* stream) {
  return group_occupancy_launch<float>(own, slot_cell, slot_seg, tile_chunk,
                                       out, partial, n_tiles, span, combine,
                                       device, stream);
}

// one empty kernel: what a launch costs with nothing to do
int empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
