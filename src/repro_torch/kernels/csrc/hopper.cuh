// Helpers shared by the port's kernels that run 3xTF32 products on the
// Hopper tensor cores (flash_attention.cu, ssd.cu): the TF32 split of a
// float32 value, mma.sync and wgmma (A from registers, B from shared
// memory through a 128-byte-swizzle descriptor) with their fences, the
// proxy fence that makes a thread's shared-memory writes visible to wgmma
// (and to TMA), mbarriers, TMA loads of float32 tiles and the tensor-map
// encoder.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 on a finite value: round the magnitude to 10 mantissa
// bits, ties away from zero.  Two integer operations: the instruction
// itself also screens for inf / NaN, which costs three more per value
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed wgmma groups are still in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point
template <int n>
__device__ __forceinline__ void fence_regs(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// a float32 word of shared memory at a byte address
__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the lo half of a raw float32 word that wgmma reads as tf32 (its low 13
// bits dropped): rna_tf32(a - trunc_tf32(a))
__device__ __forceinline__ float raw_lo(float x) {
  return __uint_as_float(
      tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u)));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 16, f32) += A (64 x 8, tf32 in registers) . B (16 x 8, tf32 in
// shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 8, tf32 in registers) . B (32 x 8, tf32 in
// shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, tf32 in registers) . B (64 x 8, tf32 in
// shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (N == 16)
    wgmma_tf32_n16(d, a, db);
  else if constexpr (N == 32)
    wgmma_tf32_n32(d, a, db);
  else
    wgmma_tf32_n64(d, a, db);
}

// mbarriers and TMA (cp.async.bulk.tensor) loads of float32 tiles
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// spins until the phase of the given parity has completed; a barrier
// that stays open for about ten seconds traps (the launch then fails
// with an error) rather than holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// one (32 columns x rows) box of a float32 tensor map with axes
// (column, head, row, batch)
__device__ __forceinline__ void tma_load_f32(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int col, int head,
                                             int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// the coordinates (c1, c2, c3) of a 4-d tensor map whose outer axes are
// head, row and batch in the order of their strides: perm holds the map
// axis (1..3) of head in bits 0-1, of row in 2-3, of batch in 4-5
__device__ __forceinline__ void map_coords(int perm, int head, int row,
                                           int batch, int& c1, int& c2,
                                           int& c3) {
  const int ph = perm & 3, ps = (perm >> 2) & 3;
  c1 = ph == 1 ? head : ps == 1 ? row : batch;
  c2 = ph == 2 ? head : ps == 2 ? row : batch;
  c3 = ph == 3 ? head : ps == 3 ? row : batch;
}

// one box of such a map (make_map) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int perm, uint32_t bar, int col,
                                         int head, int row, int batch) {
  int c1, c2, c3;
  map_coords(perm, head, row, batch, c1, c2, c3);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has loaded
// (the runtime API has no tensor-map encoder, and nothing links libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a tensor map of a (B, S, H, d) operand of esize-byte elements (dtype):
// axis 0 is d, axes 1-3 are head, row and batch sorted by stride (*perm
// says where each went); (cols, rows) boxes with the 128-byte swizzle;
// reads past an axis's end are zero-filled, writes past it dropped
bool make_map(CUtensorMap* map, int* perm, CUtensorMapDataType dtype,
              int esize, int cols, const void* ptr, int d, int heads, int s,
              int batch, long long st_h, long long st_s, long long st_b,
              int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long size[3] = {heads, s, batch}, stride[3] = {st_h, st_s, st_b};
  int order[3] = {0, 1, 2};  // logical axes (head, row, batch) by stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d)}, strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols)};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int ax = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(size[ax]);
    strides[i] = static_cast<cuuint64_t>(stride[ax]) * esize;
    box[i + 1] = ax == 1 ? rows : 1;
    *perm |= (i + 1) << (2 * ax);
  }
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
