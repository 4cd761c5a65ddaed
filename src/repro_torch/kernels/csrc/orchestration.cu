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
//   What bounds it here: the stable same-cell rank is a sequential
//   dependency along the lanes, and this first version keeps it in one
//   block, so it is bound by one SM's integer issue rate (the in-tile
//   count is O(TILE) per lane), not by bytes (it moves ~13 bytes a lane
//   plus the admitted ring slots, well under a microsecond of HBM time).
//   Design: one block of TILE threads walks the lanes in shared-memory
//   tiles.  Inside a tile each thread counts the earlier valid lanes of
//   its cell — those of earlier warps by a warp-uniform scan of the
//   tile's cell ids, those of its own warp with __match_any_sync; across
//   tiles a per-cell running count in a global scratch
//   carries the total, read at L2 after a __syncthreads and advanced with
//   integer atomics (a count is order-free).  The rank is therefore the
//   sequential loop's FIFO rank for any lane order, and admission
//   (q_len0 + rank < Q) and ring slot (head + q_len0 + rank) % Q are the
//   sequential loop's exactly; the admitted stores cannot collide, so
//   they go out in parallel.  The rings and q_len are updated in place:
//   the TPU body copied the whole (C, Q) ring every tick (33.5 MB at
//   C = 65,536, Q = 64).
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

__global__ void __launch_bounds__(kAdmitTile)
queue_admit_kernel(int32_t* __restrict__ q_ids,
                   const int32_t* __restrict__ q_head,
                   int32_t* __restrict__ q_len,
                   const int32_t* __restrict__ rid,
                   const int32_t* __restrict__ cell,
                   const bool* __restrict__ valid,
                   bool* __restrict__ admitted,
                   int32_t* __restrict__ seen,
                   int n_cells, int q_cap, int n_lanes) {
  __shared__ __align__(16) int32_t s_cell[kAdmitTile];
  const int tid = threadIdx.x;

  // zero the running count of every cell this burst touches (atomics so
  // that every access to `seen` happens at L2)
  for (int i = tid; i < n_lanes; i += kAdmitTile) {
    if (valid[i]) atomicExch(seen + clamp_cell(cell[i], n_cells), 0);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp_base = tid & ~31;
  for (int base = 0; base < n_lanes; base += kAdmitTile) {
    const int i = base + tid;
    const bool v = i < n_lanes && valid[i];
    const int c = v ? clamp_cell(cell[i], n_cells) : -1;
    s_cell[tid] = c;
    __syncthreads();
    // earlier lanes of the same cell: in earlier warps of the tile by a
    // warp-uniform scan of shared memory (broadcast 16-byte reads), in
    // this warp by matching lane values
    int r = 0;
    const int4* s4 = reinterpret_cast<const int4*>(s_cell);
    for (int j = 0; j < warp_base / 4; ++j) {
      const int4 q = s4[j];
      r += (q.x == c) + (q.y == c) + (q.z == c) + (q.w == c);
    }
    const unsigned same = __match_any_sync(0xffffffffu, c);
    r += __popc(same & ((1u << lane) - 1u));
    if (v) {
      const int rank = __ldcg(seen + c) + r;
      const int len0 = q_len[c];
      const bool ok = len0 + rank < q_cap;
      admitted[i] = ok;
      if (ok) {
        const int slot = (q_head[c] + len0 + rank) % q_cap;
        q_ids[static_cast<int64_t>(c) * q_cap + slot] = rid[i];
      }
    } else if (i < n_lanes) {
      admitted[i] = false;
    }
    __syncthreads();  // every lane of the tile has read `seen`
    if (v) atomicAdd(seen + c, 1);
    __syncthreads();  // the tile's counts land before the next tile reads
  }

  // q_len += admitted lanes per cell; each thread rereads only the lanes
  // it wrote above, and no q_len read remains after the last barrier
  for (int i = tid; i < n_lanes; i += kAdmitTile) {
    if (admitted[i]) atomicAdd(q_len + clamp_cell(cell[i], n_cells), 1);
  }
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

int queue_admit(void* q_ids, const void* q_head, void* q_len,
                const void* rid, const void* cell, const void* valid,
                void* admitted, void* seen, int n_cells, int q_cap,
                int n_lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  queue_admit_kernel<<<1, kAdmitTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(q_ids), static_cast<const int32_t*>(q_head),
      static_cast<int32_t*>(q_len), static_cast<const int32_t*>(rid),
      static_cast<const int32_t*>(cell), static_cast<const bool*>(valid),
      static_cast<bool*>(admitted), static_cast<int32_t*>(seen), n_cells,
      q_cap, n_lanes);
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
