// Hand-written Hopper (sm_90a) forward flash attention on the tensor
// cores, with a plain C interface bound from Python through ctypes
// (repro_torch/kernels/flash_attention.py).  Every entry point launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() (or the tensor-map encoder's refusal as
// cudaErrorInvalidValue) so the wrapper can raise on a refused launch.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// flash_attention_pallas (body _flash_kernel): causal or full attention
// with GQA (query head h reads kv head h / (H / KV), no KV replication),
// an optional sliding window (key c is visible to query row r iff
// c > r - window), keys aligned to the end (q_off = Sk - Sq), Dk != Dv
// allowed, masked scores at -1e30, float32 running max / sum /
// accumulator, out = acc / max(l, 1e-30) in q's type.
//
// What bounds it: operations.  At the serving shapes (S = 2048, D = 128)
// it does 4 D flops per visible (query, key) pair against ~(2 D + 2 Dv)
// bytes per query row and key row, far above the card's flops-per-byte
// balance point.  Both instances therefore run both products, S = Q K^T
// and O += P V, on the tensor cores, and skip key tiles that the causal
// mask or the window empties (the reference visits them and adds exact
// zeros; before a row's first visible key it rescales its sums by
// exp(-1e30 - m) = 0, so skipping changes nothing).  Heavy (late,
// causal) query tiles launch first.  Rows and keys past the ragged ends
// are masked and their tiles zero-filled, so any S works.
//
// float32 (flash_fwd_kernel_tf32): 3xTF32 on mma.sync.m16n8k8.  Each
// operand a splits into hi = rna_tf32(a) and lo = rna_tf32(a - hi), with
// cvt.rna.tf32.f32's rounding done as two integer operations; a.b ~
// hi.lo + lo.hi + hi.hi with f32 accumulation keeps float32-level
// accuracy (the dropped lo.lo term is ~2^-22 relative; one TF32 product
// alone keeps about three digits and misses the f32 bar, see
// tests/test_torch_flash_tf32.py).  The softmax stays in f32 with expf.
// Its bound is three TF32 products at 495 TFLOP/s; it may beat the FP32
// CUDA-core bound (67 TFLOP/s).
// mma.sync and not wgmma: TF32 wgmma takes B only from shared memory and
// only K-major, so V would need a transposed copy and the lo halves of K
// and V would double the tiles; mma.sync takes both operands from
// registers, so the split costs instructions, not shared memory.  A CTA
// of 8 warps owns 128 query rows (16 per warp); the query tile sits in
// shared memory pre-scaled in f32 and is split as it is read.  K and V
// tiles of 64 keys stream through a two-stage cp.async ring, the next
// tile loading while the current one computes.  S's C fragment (columns
// 2t, 2t+1 of each 8-key step, t = lane % 4) is reused as P's A fragment
// without shuffles by relabelling the keys of the step: A column t holds
// key 2t and column t + 4 key 2t + 1; V's B fragment is read with the
// same permutation.  Every shared tile has a row pitch of 4 mod 8 floats,
// which makes the Q/K (row g, column t) and the V (row 2t, column g)
// fragment reads conflict-free.  A warp skips the products of a key tile
// its 16 rows cannot see and masks only tiles that cut the mask.  Shared
// memory: (256 pitch(D) + 128 pitch(64 or 128)) floats, 202,752 bytes at
// D = Dv = 128; at Dv <= 64 two CTAs share an SM.
// D in (128, 192] with Dv <= 128 (MLA's prefill: Dk = 128 + 64, Dv = 128)
// is the same kernel with another tiling, chosen at launch by D: at 128
// query rows and 64-key tiles it would need (256 pitch(192) + 128
// pitch(128)) floats = 268,288 bytes, more than a CTA may hold (232,448).
// It takes kWideWarps warps of 16 query rows and kWideBK-key tiles
// instead (below), with the pitch still 4 mod 8 (pitch(192) = 196).
// Keeping Q's split fragments in registers instead would not fit beside
// the accumulator: 96 floats x 2 a thread beside 64.
//
// bfloat16 (flash_fwd_kernel_wgmma): TMA + wgmma, warp-specialised.  A
// CTA of three warpgroups owns 128 query rows: two consumer warpgroups
// of 64 rows each and one producer warpgroup, of which one thread starts
// the TMA loads (setmaxnreg gives the producer 24 registers and each
// consumer 240).  The producer loads Q once and K / V tiles of 128 keys
// into a three-stage ring guarded by full / empty mbarriers, through
// tensor maps with the 128-byte swizzle that the wgmma descriptors name;
// head dims are cut into 64-column panels, and the tensor maps' bounds
// zero-fill the columns past D (D = 120, 60, ...) and the rows past S.
// Each consumer walks a tile in two halves of 64 keys (so S takes 32
// registers, not 64, and S, P and O stay in registers without spills):
// S = Q K^T as wgmma m64n64k16 from shared memory (both K-major), the
// scale applied to S in f32 (the reference scales after its cast to
// f32), the online softmax in registers on the accumulator fragment (in
// the log2 domain, masking only halves that cut the mask), P rounded to
// bf16 in registers and fed as the register A operand of O += P V, with
// V read MN-major through the descriptor's transpose bit.  The two
// consumers take turns issuing (named barriers), so one's softmax runs
// while the other's products run.  A consumer frees a stage once its
// P V has retired (wgmma.wait_group).  The one difference from the
// reference: the reference multiplies an f32 P by V; here P is rounded
// to bf16 first, which the bf16 bars against the plain version (3e-2 per
// element, 1e-2 of each output row's norm) cover.  Shared memory: 32 KB
// (Q) + 3 x (32 + 32) KB (K, V) = 224 KB at D = Dv = 128, one CTA per SM.
// D in (128, 192] with Dv <= 128 (MLA's prefill) is the same kernel with
// three K panels: S = Q K^T takes 12 k16 steps instead of 8, the
// registers stay as they are (S's half is 32 floats, O 64, since Dv <=
// 128), and the ring is cut to fit: three stages of 64 keys
// (kWideStages, kWideKeys below).  MLA's V, the strided view kv[...,
// nope:], is read in place by its tensor map (base 256 bytes in, rows
// 512 bytes apart at deepseek's widths).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMaxD = 192;   // D of every instance, forward and backward
constexpr int kMaxDv = 128;  // Dv of every instance

struct Strides {  // element strides of the (B, S, H, D) operands
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// The key-tile range [first, end) a query tile [q0, q0 + rows) can see.
__device__ __forceinline__ void key_range(int q0, int rows, int Sq, int Sk,
                                          int causal, int window, int bk,
                                          int* first, int* end) {
  const int q_off = Sk - Sq;
  const int q_last = min(q0 + rows, Sq) - 1 + q_off;  // in key positions
  *end = causal ? min(Sk, q_last + 1) : Sk;
  *first = (window ? max(0, q0 + q_off - window + 1) : 0) / bk * bk;
}

// the float32 instance's exp: expf, as the reference's f32 exp (exp2f(x
// log2 e) would add a relative error of about |x| 6e-8 in the rounding of
// x log2 e; tools/flash_exp_ab.py measures both forms)
__device__ __forceinline__ float exp_f32(float x) {
  return expf(x);
}

__device__ __forceinline__ bool visible(int col, int row, int Sk, int causal,
                                        int window) {
  bool ok = col < Sk;
  if (causal) ok = ok && col <= row;
  if (window) ok = ok && col > row - window;
  return ok;
}

// ------------------------------------------------------- float32: 3xTF32
// D <= 128: 8 warps x 16 query rows a CTA, 64-key tiles.  D in (128,
// 192]: 8 warps and 32-key tiles, (128 pitch(D) + 64 (pitch(D) +
// pitch(128))) floats = 184,320 bytes at D = 192; the other layout that
// fits, 4 warps (64 query rows) and 64-key tiles (218,112 bytes), ran
// slower on an H100 (tools/flash_wide_layout.py times both).
constexpr int kWideWarps = 8, kWideBK = 32;

// shared-memory row pitch in floats: D rounded up to 8, plus 4, so the
// pitch is 4 mod 8 (conflict-free fragment reads, 16-byte rows)
__host__ __device__ __forceinline__ int pitch(int d) {
  return (d + 7) / 8 * 8 + 4;
}

// c += a.b in split precision: the two small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// rows [k0, k0 + kBK) of a (S, d) operand into a shared tile of pitch
// ld, by a CTA of kThreads; rows past S are zero-filled
template <int kBK, int kThreads>
__device__ __forceinline__ void load_kv_tile(float* dst, int ld,
                                             const float* src,
                                             long long row_stride, int k0,
                                             int Sk, int d) {
  const int d4 = d / 4;
  for (int idx = threadIdx.x; idx < kBK * d4; idx += kThreads) {
    const int r = idx / d4, c = (idx - r * d4) * 4;
    const bool ok = k0 + r < Sk;
    cp_async16(dst + r * ld + c,
               src + (ok ? static_cast<long long>(k0 + r) * row_stride + c
                         : 0),
               ok);
  }
}

// kNT: 8-column tiles of the output, 8 (Dv <= 64) or 16; kWarps: warps
// of 16 query rows a CTA; kBK: keys per tile
template <int kNT, int kWarps, int kBK>
__global__ void __launch_bounds__(32 * kWarps, kNT == 8 ? 2 : 1)
flash_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int KV, int Sq, int Sk, int D, int Dv,
                      Strides st, float scale, int causal, int window) {
  constexpr int kBQ = 16 * kWarps, kThreads = 32 * kWarps, kJ = kBK / 8;
  extern __shared__ float4 smem4[];
  const int ldk = pitch(D), ldv = pitch(8 * kNT);  // V: every output tile
  float* sQ = reinterpret_cast<float*>(smem4);  // kBQ x ldk
  float* sK = sQ + kBQ * ldk;                   // 2 x kBK x ldk
  float* sV = sK + 2 * kBK * ldk;               // 2 x kBK x ldv

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int q_off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + kvh * st.k_h;
  const float* vb = v + b * st.v_b + kvh * st.v_h;
  float* ob = o + b * st.o_b + h * st.o_h;

  // pad columns of the K / V stages: K's [D, round8(D)), which the last
  // 8-wide step reads, and V's [Dv, 8 kNT), which the output tiles past
  // Dv read (their columns are never stored); cp.async writes neither
  const int dk8 = (D + 7) / 8 * 8;
  for (int idx = threadIdx.x; idx < 2 * kBK * 4; idx += kThreads) {
    const int r = idx >> 2, c = idx & 3;
    if (D + c < dk8) sK[r * ldk + D + c] = 0.f;
  }
  for (int idx = threadIdx.x; idx < 2 * kBK * 8 * kNT; idx += kThreads) {
    const int r = idx / (8 * kNT), c = idx - r * 8 * kNT;
    if (c >= Dv) sV[r * ldv + c] = 0.f;
  }
  // the query tile, pre-scaled in f32, zero past Sq and past D
  for (int idx = threadIdx.x; idx < kBQ * (dk8 / 4); idx += kThreads) {
    const int r = idx / (dk8 / 4), c = (idx - r * (dk8 / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq && c < D) {
      x = *reinterpret_cast<const float4*>(
          qb + static_cast<long long>(q0 + r) * st.q_s + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(sQ + r * ldk + c) = x;
  }

  int k_first, k_end;
  key_range(q0, kBQ, Sq, Sk, causal, window, kBK, &k_first, &k_end);
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  // this warp's rows, in key positions
  const int wr0 = q0 + 16 * warp;
  const int w_last = min(wr0 + 15, Sq - 1) + q_off;
  const int row0 = wr0 + g + q_off, row1 = row0 + 8;

  float acc[kNT][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  if (n_tiles > 0) {
    load_kv_tile<kBK, kThreads>(sK, ldk, kb, st.k_s, k_first, Sk, D);
    load_kv_tile<kBK, kThreads>(sV, ldv, vb, st.v_s, k_first, Sk, Dv);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kBK;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      const int nx = (it + 1) & 1;
      load_kv_tile<kBK, kThreads>(sK + nx * kBK * ldk, ldk, kb, st.k_s,
                                  k0 + kBK, Sk, D);
      load_kv_tile<kBK, kThreads>(sV + nx * kBK * ldv, ldv, vb, st.v_s,
                                  k0 + kBK, Sk, Dv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const bool skip = wr0 >= Sq || (causal && k0 > w_last) ||
                      (window && k0 + kBK - 1 <= wr0 + q_off - window);
    // some key of the tile is hidden from some row of the warp
    const bool masked = k0 + kBK > Sk ||
                        (causal && k0 + kBK - 1 > wr0 + q_off) ||
                        (window && k0 <= w_last - window);
    if (!skip) {
      const float* tK = sK + (it & 1) * kBK * ldk;
      const float* tV = sV + (it & 1) * kBK * ldv;

      // S = Q K^T over 8-wide steps of D
      float s[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
      const float* qr = sQ + (16 * warp + g) * ldk + t;
      const float* kr = tK + g * ldk + t;
      for (int kk = 0; kk < dk8; kk += 8) {
        uint32_t ah[4], al[4];
        split(qr[kk], ah[0], al[0]);
        split(qr[8 * ldk + kk], ah[1], al[1]);
        split(qr[kk + 4], ah[2], al[2]);
        split(qr[8 * ldk + kk + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma_3xtf32(s[j], ah, al, kr[8 * j * ldk + kk],
                     kr[8 * j * ldk + kk + 4]);
      }

      // mask, online softmax; rows g and g + 8 of the warp's 16
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + 8 * j + 2 * t + (c & 1);
          if (masked &&
              !visible(col, c < 2 ? row0 : row1, Sk, causal, window))
            s[j][c] = kNegInf;
          if (c < 2)
            mx0 = fmaxf(mx0, s[j][c]);
          else
            mx1 = fmaxf(mx1, s[j][c]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp_f32(m0 - mn0), al1 = exp_f32(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        s[j][0] = exp_f32(s[j][0] - mn0);
        s[j][1] = exp_f32(s[j][1] - mn0);
        s[j][2] = exp_f32(s[j][2] - mn1);
        s[j][3] = exp_f32(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + sum0;  // this thread's share; summed over the quad
      l1 = l1 * al1 + sum1;  // at the end
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }

      // O += P V over 8-key steps: S's C fragment is P's A fragment with
      // A column t = key 2t and column t + 4 = key 2t + 1
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        uint32_t ah[4], al[4];
        split(s[j][0], ah[0], al[0]);
        split(s[j][2], ah[1], al[1]);
        split(s[j][1], ah[2], al[2]);
        split(s[j][3], ah[3], al[3]);
        const float* vr = tV + (8 * j + 2 * t) * ldv + g;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_3xtf32(acc[n], ah, al, vr[8 * n], vr[ldv + 8 * n]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wr0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= Dv) continue;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r0) * st.o_s +
                                 col) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r1) * st.o_s +
                                 col) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  // the backward's softmax statistics: m + log(l) per row, in the units
  // of the scaled scores, as the reference's _flash_fwd_impl returns them
  if (lse != nullptr && t == 0) {
    float* lb = lse + static_cast<long long>(bh) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (r1 < Sq) lb[r1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

// ----------------------------------------------- bfloat16: TMA + wgmma
constexpr int kWgRows = 128;   // query rows per CTA (two consumers x 64)
constexpr int kPanel = 16384;  // one 64-column panel of 128 rows, bytes
constexpr int kWgThreads = 384;  // two consumer + one producer warpgroup
// the K / V ring: kStages stages of kKeys keys.  D <= 128: three stages
// of 128 keys.  D in (128, 192] (three K panels): three stages would need
// (3 + 3 x 5) x 16 KB = 288 KB, more than a CTA may hold; two stages of
// 128 keys (209 KB) and three of 64 keys (169 KB) fit.  kWideStages /
// kWideKeys name the one kept: three of 64 keys, the faster of the two
// at deepseek's MLA prefill on an H100 (tools/flash_wide_layout.py times
// both; PERF.md has the times).
constexpr int kStages = 3, kKeys = 128;
constexpr int kWideStages = 3, kWideKeys = 64;

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), both bf16 in shared memory,
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16
// in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16
// in shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// named barriers 1 and 2, shared by the two consumer warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, flushed to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// kNPK, kNPV: 64-column panels of D (1-3) and Dv (1 or 2); a ring of
// kStg stages of kBK keys (128 or 64)
template <int kNPK, int kNPV, int kStg, int kBK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       int perm_q, int perm_k, int perm_v,
                       __nv_bfloat16* __restrict__ o, int H, int KV, int Sq,
                       int Sk, int D, int Dv, long long o_b, long long o_s,
                       long long o_h, float scale, int causal, int window) {
  // a K or V panel: 64 columns of kBK rows, 128 bytes a row
  constexpr int kKVPanel = kBK * 128;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kNPK * kPanel;               // kStg tiles
  const uint32_t sV = sK + kStg * kNPK * kKVPanel;      // kStg tiles
  const uint32_t bars = sV + kStg * kNPV * kKVPanel;    // the mbarriers
  const uint32_t barQ = bars, fullK = bars + 8,
                 fullV = fullK + 8 * kStg, empty = fullV + 8 * kStg;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;  // heavy first
  int k_first, k_end;
  key_range(q0, kWgRows, Sq, Sk, causal, window, kBK, &k_first, &k_end);
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK
                                      : 0;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kStg; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(fullV + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform (lane 0's value), as setmaxnreg's warpgroups need
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(barQ, kNPK * kPanel);
      for (int p = 0; p < kNPK; ++p)
        tma_load(sQ + p * kPanel, &tq, perm_q, barQ, 64 * p, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStg;
        const int k0 = k_first + it * kBK;
        // a stage's first use passes at once (parity of the phase
        // before the barrier's first)
        mbar_wait(empty + 8 * s, ((it / kStg) & 1) ^ 1);
        mbar_expect_tx(fullK + 8 * s, kNPK * kKVPanel);
        for (int p = 0; p < kNPK; ++p)
          tma_load(sK + (s * kNPK + p) * kKVPanel, &tk, perm_k,
                   fullK + 8 * s, 64 * p, kvh, k0, b);
        mbar_expect_tx(fullV + 8 * s, kNPV * kKVPanel);
        for (int p = 0; p < kNPV; ++p)
          tma_load(sV + (s * kNPV + p) * kKVPanel, &tv, perm_v,
                   fullV + 8 * s, 64 * p, kvh, k0, b);
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int q_off = Sk - Sq;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr0 = q0 + 64 * wg;  // this warpgroup's first row
    const int row0 = wr0 + 16 * warp + g + q_off, row1 = row0 + 8;
    const int w_last = min(wr0 + 63, Sq - 1) + q_off;
    const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)

    float acc[kNPV * 32];
#pragma unroll
    for (int i = 0; i < kNPV * 32; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // S = Q K^T for one 64-key half of a stage: 16-column steps, four per
    // 64-column panel (started, not waited for)
    auto start_scores = [&](float(&sc)[32], int s, int half) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kNPK; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // 16 columns, in bytes
        wgmma_ss_n64(
            sc,
            desc_sw128(sQ + (kk >> 2) * kPanel + 64 * wg * 128 + col, 16,
                       1024),
            desc_sw128(sK + (s * kNPK + (kk >> 2)) * kKVPanel + half * 8192 +
                           col,
                       16, 1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for one half: V MN-major, 16 keys (2048 bytes) per step
    auto start_pv = [&](const uint32_t(&pa)[4][4], int s, int half) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw128(
            sV + s * kNPV * kKVPanel + half * 8192 + kk * 2048, kKVPanel,
            1024);
        if constexpr (kNPV == 2)
          wgmma_rs_n128(acc, pa[kk], dv);
        else
          wgmma_rs_n64(acc, pa[kk], dv);
      }
      wgmma_commit();
    };
    // the online softmax of one half (keys k0 ..): fragment i is column
    // 8 (i / 4) + 2 t + (i & 1), row g (i & 2 == 0) or g + 8 of the warp's
    // 16.  Scores go to the log2 domain (x = s scale log2 e), p = exp2(x -
    // m).  Where the half is masked, a masked score is set to -1e30 after
    // scaling and x - m is taken exactly, so a row that has seen no
    // visible key yet gets p = 1 where the reference gets exp(0) = 1, and
    // 0 once it has; elsewhere every row has a visible key and p = exp2(
    // fma(s, scale log2 e, -m)).  P goes to bf16 pairs, the A operand of
    // P V; al0 / al1 are the rescale factors of the two rows.
    auto softmax = [&](auto masked_tag, float(&sc)[32], uint32_t(&pa)[4][4],
                       int k0, float& al0, float& al1) {
      constexpr bool kMasked = decltype(masked_tag)::value;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i];
        if constexpr (kMasked) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          x = visible(col, (i & 2) ? row1 : row0, Sk, causal, window)
                  ? x * sl2
                  : kNegInf;
          sc[i] = x;
        }
        if (i & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      if constexpr (!kMasked) {  // scale > 0: the max commutes with it
        mx0 *= sl2;
        mx1 *= sl2;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float mn = (i & 2) ? mn1 : mn0;
        float p0, p1;
        if constexpr (kMasked) {
          p0 = ex2(sc[i] - mn);
          p1 = ex2(sc[i + 1] - mn);
        } else {
          p0 = ex2(fmaf(sc[i], sl2, -mn));
          p1 = ex2(fmaf(sc[i + 1], sl2, -mn));
        }
        if (i & 2)
          sum1 += p0 + p1;
        else
          sum0 += p0 + p1;
        // keys 16 kk + (0..7) fill registers 0, 1; 16 kk + (8..15) 2, 3
        pa[i >> 3][((i >> 2) & 1) * 2 + ((i >> 1) & 1)] = pack_bf16(p0, p1);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
    };
    auto rescale = [&](float al0, float al1) {
#pragma unroll
      for (int i = 0; i < kNPV * 32; ++i) acc[i] *= (i & 2) ? al1 : al0;
    };
    // the tiles the warpgroup computes are one run [it_lo, it_hi): the
    // window hides leading tiles, the causal mask trailing ones
    auto hidden = [&](int it) {
      const int k0 = k_first + it * kBK;
      return wr0 >= Sq || (causal && k0 > w_last) ||
             (window && k0 + kBK - 1 <= wr0 + q_off - window);
    };
    int it_lo = 0, it_hi = n_tiles;
    while (it_lo < it_hi && hidden(it_lo)) ++it_lo;
    while (it_hi > it_lo && hidden(it_hi - 1)) --it_hi;

    // The two consumers take turns on the tensor cores: named barrier 1 + w
    // says "warpgroup w may start its scores", and each warpgroup hands
    // the turn over right after issuing, so one warpgroup's softmax runs
    // while the other's products run.  Every half step syncs and arrives
    // once in each warpgroup, computed or not, so the counts always match.
    const int me = 1 + wg, other = 2 - wg;
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    mbar_wait(barQ, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStg;
      const uint32_t parity = (it / kStg) & 1;
      const bool compute = it >= it_lo && it < it_hi;
      const int k0 = k_first + it * kBK;
      mbar_wait(fullK + 8 * s, parity);
      mbar_wait(fullV + 8 * s, parity);
#pragma unroll
      for (int half = 0; half < kBK / 64; ++half) {
        float sc[32];
        uint32_t pa[4][4];
        named_sync(me);
        if (compute) start_scores(sc, s, half);
        named_arrive(other);
        if (compute) {
          wgmma_wait<0>();
          fence_regs(sc);
          float al0, al1;
          const int kh = k0 + 64 * half;
          if (kh + 64 > Sk || (causal && kh + 63 > wr0 + q_off) ||
              (window && kh <= w_last - window))
            softmax(std::true_type(), sc, pa, kh, al0, al1);
          else
            softmax(std::false_type(), sc, pa, kh, al0, al1);
          rescale(al0, al1);
          start_pv(pa, s, half);
          wgmma_wait<0>();
          fence_regs(acc);
        }
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (wg == 0) named_sync(1);  // the other warpgroup's last hand-over

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int r0 = wr0 + 16 * warp + g, r1 = r0 + 8;
    __nv_bfloat16* orow = o + b * o_b + h * o_h;
#pragma unroll
    for (int i = 0; i < kNPV * 32; i += 4) {
      const int col = 8 * (i >> 2) + 2 * t;
      if (col >= Dv) continue;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            orow + static_cast<long long>(r0) * o_s + col) =
            __floats2bfloat162_rn(acc[i] * inv0, acc[i + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            orow + static_cast<long long>(r1) * o_s + col) =
            __floats2bfloat162_rn(acc[i + 2] * inv1, acc[i + 3] * inv1);
    }
  }
}

// ------------------------------------------------------------ launchers
bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kNT, int kWarps, int kBK>
int launch_tf32(const float* q, const float* k, const float* v, float* o,
                float* lse, const Strides& st, int B, int H, int KV, int Sq, int Sk,
                int D, int Dv, float scale, int causal, int window,
                cudaStream_t stream) {
  constexpr int kBQ = 16 * kWarps;
  const int ldk = pitch(D), ldv = pitch(8 * kNT);
  const size_t smem = sizeof(float) *
                      static_cast<size_t>(kBQ * ldk + 2 * kBK * (ldk + ldv));
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tf32<kNT, kWarps, kBK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel_tf32<kNT, kWarps, kBK><<<grid, 32 * kWarps, smem,
                                            stream>>>(
      q, k, v, o, lse, H, KV, Sq, Sk, D, Dv, st, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int flash_launch_f32(const void* q, const void* k, const void* v, void* o,
                     void* lse, const Strides& st, int B, int H, int KV, int Sq, int Sk,
                     int D, int Dv, float scale, int causal, int window,
                     cudaStream_t stream) {
  // cp.async moves 16-byte chunks: 16-byte bases and strides
  const long long strides[9] = {st.q_b, st.q_s, st.q_h, st.k_b, st.k_s,
                                st.k_h, st.v_b, st.v_s, st.v_h};
  for (long long s : strides)
    if (s % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || o == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  if (D > 128)
    return launch_tf32<16, kWideWarps, kWideBK>(qf, kf, vf, of, lf, st, B, H,
                                                KV, Sq, Sk, D, Dv, scale,
                                                causal, window, stream);
  if (Dv <= 64)
    return launch_tf32<8, 8, 64>(qf, kf, vf, of, lf, st, B, H, KV, Sq, Sk, D,
                                 Dv, scale, causal, window, stream);
  return launch_tf32<16, 8, 64>(qf, kf, vf, of, lf, st, B, H, KV, Sq, Sk, D,
                                Dv, scale, causal, window, stream);
}

template <int kNPK, int kNPV, int kStg, int kBK>
int launch_wgmma(const void* q, const void* k, const void* v,
                 __nv_bfloat16* out, const Strides& st, int B, int H, int KV,
                 int Sq, int Sk, int D, int Dv, float scale, int causal,
                 int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int pq, pk, pv;
  if (!make_map(&tq, &pq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, q, D, H,
                Sq, B, st.q_h, st.q_s, st.q_b, 128) ||
      !make_map(&tk, &pk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, k, D, KV,
                Sk, B, st.k_h, st.k_s, st.k_b, kBK) ||
      !make_map(&tv, &pv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, v, Dv, KV,
                Sk, B, st.v_h, st.v_s, st.v_b, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 1024 + static_cast<size_t>(kNPK) * kPanel +
                      static_cast<size_t>(kStg) * (kNPK + kNPV) * kBK * 128 +
                      8 * (1 + 3 * kStg);
  const dim3 grid(B * H, (Sq + kWgRows - 1) / kWgRows);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<kNPK, kNPV, kStg, kBK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel_wgmma<kNPK, kNPV, kStg, kBK>
      <<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, pq, pk, pv, out, H,
                                           KV, Sq, Sk, D, Dv, st.o_b, st.o_s,
                                           st.o_h, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int flash_launch_bf16(const void* q, const void* k, const void* v, void* o,
                      const Strides& st, int B, int H, int KV, int Sq,
                      int Sk, int D, int Dv, float scale, int causal,
                      int window, cudaStream_t stream) {
  // TMA: 16-byte bases and byte strides (the wrapper copies any other
  // view into an aligned buffer first)
  const long long strides[9] = {st.q_b, st.q_s, st.q_h, st.k_b, st.k_s,
                                st.k_h, st.v_b, st.v_s, st.v_h};
  for (long long s : strides)
    if (s % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npk = (D + 63) / 64, npv = (Dv + 63) / 64;
  auto* out = static_cast<__nv_bfloat16*>(o);
#define FLASH_WGMMA(nk, nv, stg, bk)                                         \
  return launch_wgmma<nk, nv, stg, bk>(q, k, v, out, st, B, H, KV, Sq, Sk,   \
                                       D, Dv, scale, causal, window, stream)
  if (npk == 3) {
    if (npv == 1) FLASH_WGMMA(3, 1, kWideStages, kWideKeys);
    FLASH_WGMMA(3, 2, kWideStages, kWideKeys);
  }
  if (npk == 1) {
    if (npv == 1) FLASH_WGMMA(1, 1, kStages, kKeys);
    FLASH_WGMMA(1, 2, kStages, kKeys);
  }
  if (npv == 1) FLASH_WGMMA(2, 1, kStages, kKeys);
  FLASH_WGMMA(2, 2, kStages, kKeys);
#undef FLASH_WGMMA
}

int flash_launch(bool bf16, const void* q, const void* k, const void* v,
                 void* o, void* lse, const long long* strides, int B, int H, int KV,
                 int Sq, int Sk, int D, int Dv, float scale, int causal,
                 int window, int device, void* stream) {
  if (D > kMaxD || Dv > kMaxDv || D % 4 || Dv % 4 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st;
  long long* f = &st.q_b;
  for (int i = 0; i < 12; ++i) f[i] = strides[i];
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? flash_launch_bf16(q, k, v, o, st, B, H, KV, Sq, Sk, D, Dv,
                                  scale, causal, window, s)
              : flash_launch_f32(q, k, v, o, lse, st, B, H, KV, Sq, Sk, D, Dv,
                                 scale, causal, window, s);
}

// ------------------------------------------------- float32 backward
// flash_attention_backward_f32: dQ, dK, dV of the forward above, from q,
// k, v, dO, the forward's LSE and delta = rowsum(dO * O), recomputing P
// per (resident block, streamed tile) pair as the reference's custom VJP
// does (repro/models/attention.py _flash_vjp_bwd, jnp, not a TPU kernel):
//   p = exp(s - lse), s = (q . k) scale (masked: p = 0),
//   dv_j = sum_i p_ij do_i,  dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,
// with causal ends aligned, the window, GQA (dK and dV sum over a kv
// head's G query heads) and Dk != Dv, D up to 192 and Dv up to 128.
//
// What bounds it: operations, five products a visible (query, key) pair,
// each 3xTF32 at the TF32 peak; the design does seven (S and dP in both
// kernels; fusing them into one kernel of five products is a later
// pass).  Two kernels, no atomics, so every run gives the same
// gradients.  Both are one body (flash_bwd_body) over a resident block
// of 64 rows and a stream of kBs-row tiles (bwd_tile: 32 rows; 64 at D,
// Dv <= 64; 16 in the dK / dV kernel at D > 128):
//  * flash_bwd_dkdv_kernel: resident 64 keys of one kv head (K and V),
//    streamed the tiles of Q and dO (with each row's LSE and delta) that
//    can see them, for each of the group's G query heads in turn;
//    S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, then dV^T += dO^T P and
//    dK^T += Q^T dS, one 64-row block of the head dim at a time.
//  * flash_bwd_dq_kernel: resident 64 query rows of one head (Q and dO,
//    their LSE and delta), streamed the visible K and V tiles; S = Q K^T,
//    dP = dO V^T, P, dS, then dQ^T += K^T dS^T.
// Every product runs on wgmma (m64nNk8, TF32, f32 accumulators) as three
// products, lo.hi + hi.lo + hi.hi: float32-level accuracy, as the
// forward's 3xTF32.  TF32 wgmma takes both operands K-major only (the
// transpose bits are for 16-bit types), so each product is arranged that
// way round: A (64 rows) comes from registers, B from shared memory,
// K-major with the 128-byte swizzle.  The scores take A = the resident
// rows and B = the streamed tile as TMA lands it.  The outputs take A =
// the streamed tile read transposed (so they come out transposed, rows
// of the head dim in 64-row blocks) and B = P or dS, which the consumers
// write from their S / dP fragments as [resident row][streamed row].
// The tensor cores read a raw float32 word as TF32 by dropping its low
// 13 bits, from registers and from shared memory alike (a wgmma on
// words with low bits set equals the truncated words' product, not the
// rounded ones', on an H100: tools/tf32_wgmma_probe.py), so hi is the
// raw word wherever it can be and lo = rna_tf32(a - trunc(a)) (raw_lo):
//  * the resident A fragments are loaded once: hi stays in registers (32
//    a thread per 64 columns; at D = 192 / Dv = 128 the dK / dV kernel
//    reads the last steps' hi from shared memory, bwd_kreg) and lo is
//    written back over the raw resident tile in fragment order, so a
//    score step is one 16-byte load and three wgmma;
//  * the streamed tile is B's hi as it lands; three producer warps write
//    its lo copy, once a tile, into one lo buffer;
//  * the outputs' A is gathered from the raw tile (hi) and raw_lo'd (lo);
//    within each 8-row step the streamed rows are relabelled (out_base)
//    so a warp's gathers hit 32 distinct banks;
//  * P and dS are split in full (hi = tf32(x), lo = tf32(x - hi)).
// A CTA is three warpgroups.  The producer's first warp starts the TMA
// loads (the resident block once, then the streamed tiles into a ring of
// kBwdStages stages guarded by full / empty mbarriers), its other three
// write the lo copies (lo_full / lo_empty); setmaxnreg gives it 40
// registers and each consumer 232.  The two consumers share the resident
// rows and split a tile's work so that their products balance:
// warpgroup 0 runs S, P, dS and the first bwd_split() blocks of dK^T
// (dQ^T), warpgroup 1 dP (handed over through shared memory), dV^T and
// the remaining blocks, each on the other's products while it works on
// its own softmax or dS.  Each output block sums one streamed tile in a
// fresh accumulator that is then added to the block's running sum in
// float32 on the CUDA cores: summed in place, the tensor cores'
// accumulator drops low bits of addends much smaller than it, and dK
// and dV sum thousands of small terms (the yi-6b shape's dK lay 1.0e-4
// of its largest magnitude from plain that way with mma.sync; promoted,
// every BWD_SHAPES gradient lies within 1e-5 of it on an H100).
// Operands are tiled in 32-column panels (128 bytes a row); the tensor
// maps zero-fill columns past D or Dv and rows past S, so any D, Dv in
// multiples of 4 and any S work; masked tiles give P = 0, and a resident
// row that sees no streamed row keeps zeros.
// Shared memory (bwd_smem: 64 resident rows, kBs streamed rows, panels of
// D and Dv rounded up to 64 columns): the resident block, kBwdStages raw
// tiles and one lo tile, 64 x 128-byte dS and P buffers (hi and lo; dQ
// has no P), the handed-over dP (64 kBs floats), the resident lo words
// past bwd_kreg():
//   D = Dv = 128, kBs = 32:  64 + 2 x 32 + 32 + 32 + 8 KB, 206,168 bytes
//                            (dK / dV); 189,784 (dQ);
//   D = 192, Dv = 128: dK / dV at kBs = 16, 80 + 2 x 20 + 20 + 32 + 4 +
//                      40 KB, 222,424 bytes (kBs = 32 would need
//                      247,128 before the resident lo words); dQ at
//                      kBwdWideDqTile = 32, 230,744 bytes (16 fits too,
//                      165,080: tools/flash_wide_layout.py times both).
// A bigger ring or a second lo buffer (to convert a tile while the one
// before it is scored) does not fit at D = 128.  Registers (ptxas: 168 a
// thread at launch, then 232 for the consumers, no spills): the tightest
// consumers are those of the dK / dV kernel at D = 192 / Dv = 128, each
// with three running blocks or two and 12 steps of hi words (bwd_kreg).
constexpr int kBwdRows = 64;         // resident rows a CTA
constexpr int kBwdThreads = 384;     // two consumer warpgroups, a producer
constexpr int kBwdStages = 2;        // the streamed ring
constexpr int kBwdWideDqTile = 32;   // the dQ kernel's kBs at D > 128

// rows of a streamed tile: 32; 64 at D, Dv <= 64 (the fixed costs of a
// tile, its hand-overs and softmax, spread over twice the products, and
// score products of N = 64); at D in (128, 192] (kNBK = 3) 16 for dK / dV
// and kBwdWideDqTile for dQ
template <bool kDKDV, int kNBK, int kNBV>
__host__ __device__ constexpr int bwd_tile() {
  return kNBK > 2 ? (kDKDV ? 16 : kBwdWideDqTile)
                  : (kNBK == 1 && kNBV == 1 ? 64 : 32);
}

// warpgroup 0's share of the dK^T (dQ^T) blocks, which balances the two
// consumers' products (a score product over kNB blocks costs kNB output
// blocks): dK / dV min(kNBK, kNBV), dQ one
template <bool kDKDV, int kNBK, int kNBV>
__host__ __device__ constexpr int bwd_split() {
  return kDKDV ? (kNBV < kNBK ? kNBV : kNBK) : 1;
}

// the 8-column steps of a consumer's resident rows whose hi words it
// keeps in registers (warpgroup kWG: 0 for R1's 8 kNBK steps, 1 for R2's
// 8 kNBV): all of them, but for the dK / dV kernel at D > 128 and Dv >
// 64, where each consumer holds three running blocks (warpgroup 0's two
// beside 96 hi words, warpgroup 1's three beside 64) and would spill;
// there warpgroup 0 keeps 12 steps and warpgroup 1 keeps 8, and the rest
// are read from shared memory
template <bool kDKDV, int kNBK, int kNBV, int kWG>
__host__ __device__ constexpr int bwd_kreg() {
  return kDKDV && kNBK > 2 && kNBV > 1 ? (kWG == 0 ? 12 : 8)
                                       : 8 * (kWG == 0 ? kNBK : kNBV);
}

// dynamic shared memory of one instance: 1 KB of alignment slack, the
// resident block, kBwdStages + 1 tiles, the dS buffers (and P's),
// the handed-over dP, the lo tile's LSE and delta, the lo words of the
// resident steps past bwd_kreg(), the mbarriers
template <bool kDKDV, int kNBK, int kNBV>
__host__ __device__ constexpr int bwd_smem() {
  constexpr int kBs = bwd_tile<kDKDV, kNBK, kNBV>();
  return 1024 + (kBwdRows + (kBwdStages + 1) * kBs) * 128 * 2 *
                    (kNBK + kNBV) +
         (kDKDV ? 4 : 2) * kBwdRows * 128 * ((kBs + 31) / 32) +
         (kBwdRows + 2) * 4 * kBs +
         (8 * kNBK - bwd_kreg<kDKDV, kNBK, kNBV, 0>() + 8 * kNBV -
          bwd_kreg<kDKDV, kNBK, kNBV, 1>()) * 2048 +
         8 * (7 + 2 * kBwdStages);
}

// the consumer warpgroup's own barrier (named barrier 1, 128 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The A fragments are gathered from swizzled tiles.  For a tile whose
// rows are 1024-byte aligned groups of eight, (row r, column c) lies at
// the unswizzled offset with bits 4-6 XORed by r % 8, so each thread keeps
// one base offset and every element of its fragments is that base XOR a
// constant plus a constant.

// a thread's base in the resident block for the scores: row 16 warp + g,
// column t (chunk 0, swizzled by g)
__device__ __forceinline__ uint32_t score_base(int warp, int g, int t) {
  return (16 * warp + g) * 128 + t * 4 + (g << 4);
}

// a thread's base in a kBs-row streamed tile for the outputs, read
// transposed: head-dim column 16 warp + g, streamed row 2 t.  The
// outputs reduce over the streamed rows with each 8-row step's rows
// relabelled, k = t for row 2 t and k = t + 4 for row 2 t + 1 (the P / dS
// buffers store them in that order): a warp's gathers then hit 32
// distinct banks
template <int kBs>
__device__ __forceinline__ uint32_t out_base(int warp, int g, int t) {
  return (warp >> 1) * kBs * 128 + t * 256 + (g & 3) * 4 +
         (((4 * (warp & 1) + (g >> 2)) ^ (2 * t)) << 4);
}

// A thread's resident A fragments, loaded once: rows r, r + 8 and
// columns c, c + 4 of step kk at base ^ (2 (kk % 4) + {0, 1}) x 16, +
// 1024 for r + 8, in the panel kk / 4.  hi is the raw word (the tensor
// cores drop its low 13 bits): the first kKr steps' are kept in
// registers, the rest stay in the raw panels.  lo = raw_lo(a), in
// fragment order (one 16-byte word a thread and step): the first kKr
// steps' written back over their raw panels once every thread of the
// warpgroup has read its words (bar: the warpgroup's named barrier),
// the rest's at lo2.
template <int kK, int kKr>
__device__ __forceinline__ void load_resident(uint8_t* res, float4* lo2,
                                              uint32_t base, int tid,
                                              int bar,
                                              uint32_t (&hi)[kKr][4]) {
  float x[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const uint8_t* p = res + (kk >> 2) * kBwdRows * 128;
    const uint32_t x0 = base ^ ((2 * (kk & 3)) << 4);
    const uint32_t x1 = base ^ ((2 * (kk & 3) + 1) << 4);
    x[kk][0] = lds(p + x0);
    x[kk][1] = lds(p + x0 + 1024);
    x[kk][2] = lds(p + x1);
    x[kk][3] = lds(p + x1 + 1024);
    if (kk < kKr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) hi[kk < kKr ? kk : 0][j] =
          __float_as_uint(x[kk][j]);
    } else {
      lo2[(kk - kKr) * 128 + tid] =
          make_float4(raw_lo(x[kk][0]), raw_lo(x[kk][1]), raw_lo(x[kk][2]),
                      raw_lo(x[kk][3]));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  float4* lo = reinterpret_cast<float4*>(res) + tid;
#pragma unroll
  for (int kk = 0; kk < kKr; ++kk)
    lo[kk * 128] = make_float4(raw_lo(x[kk][0]), raw_lo(x[kk][1]),
                               raw_lo(x[kk][2]), raw_lo(x[kk][3]));
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// s (64 resident rows x kBs streamed rows) = R . T^T over kK 8-column
// steps: R's fragments (load_resident: hi in registers for the first kKr
// steps, then gathered from the raw panels at res; lo at lo[128 kk], then
// lo2[128 (kk - kKr)]), T's raw and lo panels at t_hi, t_lo (B);
// 3xTF32.  Each step is committed and the one before it waited for.
// Returns with the last step in flight.
template <int kBs, int kK, int kKr>
__device__ __forceinline__ void score_product(
    float (&s)[kBs / 2], const uint32_t (&hi)[kKr][4], const float4* lo,
    const uint8_t* res, const float4* lo2, uint32_t base, uint32_t t_hi,
    uint32_t t_lo) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t ah[4];
    float4 l;
    if (kk < kKr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ah[j] = hi[kk < kKr ? kk : 0][j];
      l = lo[kk * 128];
    } else {
      const uint8_t* p = res + (kk >> 2) * kBwdRows * 128;
      const uint32_t x0 = base ^ ((2 * (kk & 3)) << 4);
      const uint32_t x1 = base ^ ((2 * (kk & 3) + 1) << 4);
      ah[0] = __float_as_uint(lds(p + x0));
      ah[1] = __float_as_uint(lds(p + x0 + 1024));
      ah[2] = __float_as_uint(lds(p + x1));
      ah[3] = __float_as_uint(lds(p + x1 + 1024));
      l = lo2[(kk - kKr) * 128];
    }
    const uint32_t al[4] = {__float_as_uint(l.x), __float_as_uint(l.y),
                            __float_as_uint(l.z), __float_as_uint(l.w)};
    const uint32_t off = (kk >> 2) * kBs * 128 + (kk & 3) * 32;
    const uint64_t bh = desc_sw128(t_hi + off, 16, 1024);
    const uint64_t bl = desc_sw128(t_lo + off, 16, 1024);
    wgmma_fence();
    wgmma_tf32<kBs>(s, al, bh);
    wgmma_tf32<kBs>(s, ah, bl);
    wgmma_tf32<kBs>(s, ah, bh);
    wgmma_commit();
    wgmma_wait<1>();
  }
}

// acc[mb] (64-row block kMB0 + mb of the head dim x 64 resident rows) +=
// T^T B over the tile's kBs streamed rows.  T^T is gathered from the raw
// tile at `tile` (A: head-dim columns d, d + 8 and streamed rows j, j + 1
// of step kk at base ^ {0, 32, 16, 48} + 1024 kk + {0, 128}; hi the raw
// word, lo = raw_lo); B is the P or dS buffer (hi at b_hi, lo at b_lo,
// [resident row][streamed row], 32-column panels).  Each block sums in a
// fresh accumulator that is added to acc in float32.
template <int kBs, int kNB, int kMB0>
__device__ __forceinline__ void out_product(float (&acc)[kNB][32],
                                            const uint8_t* tile,
                                            uint32_t base, uint32_t b_hi,
                                            uint32_t b_lo) {
#pragma unroll
  for (int mb = 0; mb < kNB; ++mb) {
    float c[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBs / 8; ++kk) {
      const uint8_t* p = tile + 2 * (kMB0 + mb) * kBs * 128 + kk * 1024;
      const float x[4] = {lds(p + base), lds(p + (base ^ 32)),
                          lds(p + (base ^ 16) + 128),
                          lds(p + (base ^ 48) + 128)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ah[j] = __float_as_uint(x[j]);  // read as tf32: its top 19 bits
        al[j] = __float_as_uint(raw_lo(x[j]));
      }
      const uint32_t boff = (kk >> 2) * kBwdRows * 128 + (kk & 3) * 32;
      const uint64_t bh = desc_sw128(b_hi + boff, 16, 1024);
      const uint64_t bl = desc_sw128(b_lo + boff, 16, 1024);
      wgmma_fence();
      wgmma_tf32<64>(c, al, bh);
      wgmma_tf32<64>(c, ah, bl);
      wgmma_tf32<64>(c, ah, bh);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] += c[i];
  }
}

// kDKDV: the dK / dV kernel (resident K, V; streamed Q, dO), else the dQ
// kernel (resident Q, dO; streamed K, V).  kNBK, kNBV: 64-column blocks
// of D (1-3) and Dv (1 or 2).  tr1 / tr2: the resident operands' tensor
// maps (64-row boxes), ts1 / ts2 the streamed ones' (kBs-row boxes); the
// first of each pair has D columns, the second Dv.
//
// Two consumer warpgroups share the resident rows and split the work of
// a tile: warpgroup 0 computes S, P and dS and the first bwd_split()
// blocks of dK^T (dQ^T); warpgroup 1 computes dP (handed over through
// shared memory), dV^T and the remaining blocks.  The hand-overs are
// mbarriers, one phase a tile: dp_ready (1 -> 0), p_ready (0 -> 1) and
// p_free (1 -> 0, dK / dV only), ds_ready (0 -> 1).  Each waits on the
// other's previous phase before it arrives again (warpgroup 0 arrives on
// p_ready and ds_ready only after it has waited on dp_ready, and on
// p_ready only after it has waited on the previous p_free; warpgroup 1
// arrives on dp_ready only after it has waited on ds_ready, and on p_free
// only after it has waited on p_ready), so no barrier runs a phase ahead
// of its waiter.  The same chain frees the dP and dS buffers; P's is
// free again once p_free says dV has read it.
template <bool kDKDV, int kNBK, int kNBV>
__device__ __forceinline__ void flash_bwd_body(
    const CUtensorMap* tr1, const CUtensorMap* tr2, const CUtensorMap* ts1,
    const CUtensorMap* ts2, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ out1,
    float* __restrict__ out2, int H, int KV, int Sq, int Sk, int D, int Dv,
    float scale, int causal, int window) {
  constexpr int kBs = bwd_tile<kDKDV, kNBK, kNBV>();
  constexpr int kNP1 = 2 * kNBK, kNP = 2 * (kNBK + kNBV);  // 32-col panels
  constexpr int kResBytes = kBwdRows * 128 * kNP;
  constexpr int kTileBytes = kBs * 128 * kNP;
  // one P / dS buffer: 64 rows of kBs columns in 32-column panels
  constexpr int kBuf = kBwdRows * 128 * ((kBs + 31) / 32);
  constexpr int kNS = kBs / 2;          // a thread's S / dP fragment
  constexpr int kN0 = bwd_split<kDKDV, kNBK, kNBV>();  // warpgroup 0's
  constexpr int kN1 = kNBK - kN0;  // out1 blocks of warpgroup 1
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* res = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* stg = res + kResBytes;              // kBwdStages raw tiles
  uint8_t* lo = stg + kBwdStages * kTileBytes;  // the lo copy of one
  uint8_t* buf = lo + kTileBytes;  // dS hi, dS lo (, P hi, P lo)
  float* xbuf = reinterpret_cast<float*>(buf + (kDKDV ? 4 : 2) * kBuf);
  float* stat = xbuf + kBwdRows * kBs;  // the lo tile's LSE, delta
  // the lo words of the resident steps past bwd_kreg: warpgroup 0's, then
  // warpgroup 1's
  constexpr int kKr0 = bwd_kreg<kDKDV, kNBK, kNBV, 0>();
  constexpr int kKr1 = bwd_kreg<kDKDV, kNBK, kNBV, 1>();
  float4* lo2 = reinterpret_cast<float4*>(stat + 2 * kBs);
  float4* lo2b = lo2 + (8 * kNBK - kKr0) * 128;
  const uint32_t bar_res = smem_addr(lo2b + (8 * kNBV - kKr1) * 128);
  const uint32_t full = bar_res + 8, empty = full + 8 * kBwdStages;
  const uint32_t lo_full = empty + 8 * kBwdStages, lo_empty = lo_full + 8;
  const uint32_t dp_ready = lo_empty + 8, p_ready = dp_ready + 8,
                 ds_ready = p_ready + 8, p_free = ds_ready + 8;

  const int G = H / KV, q_off = Sk - Sq;
  int b, rh, r0, s_lo, n_s, n_it;  // batch, resident head and first row,
                                   // first streamed row, tiles
  if constexpr (kDKDV) {
    b = blockIdx.x / KV;
    rh = blockIdx.x - b * KV;
    r0 = blockIdx.y * kBwdRows;  // the first key blocks see the most rows
    // the query rows that can see a key of [r0, k_last]
    const int k_last = min(r0 + kBwdRows, Sk) - 1;
    s_lo = causal ? max(0, r0 - q_off) : 0;
    const int q_hi = window ? min(Sq, k_last + window - q_off) : Sq;
    n_s = q_hi > s_lo ? (q_hi - s_lo + kBs - 1) / kBs : 0;
    n_it = G * n_s;  // iteration it: query head rh G + it / n_s
  } else {
    b = blockIdx.x / H;
    rh = blockIdx.x - b * H;
    r0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;  // heavy tiles first
    int k_end;
    key_range(r0, kBwdRows, Sq, Sk, causal, window, kBs, &s_lo, &k_end);
    n_s = n_it = k_end > s_lo ? (k_end - s_lo + kBs - 1) / kBs : 0;
  }
  const auto s_head = [&](int it) {
    return kDKDV ? rh * G + it / n_s : rh / G;
  };
  const auto s_row = [&](int it) {
    return s_lo + (kDKDV ? it % n_s : it) * kBs;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(lo_full, 3);   // one per lo-writing producer warp
    mbar_init(lo_empty, 8);  // one per consumer warp
    mbar_init(dp_ready, 4);  // one per warp of the arriving warpgroup
    mbar_init(p_ready, 4);
    mbar_init(ds_ready, 4);
    mbar_init(p_free, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp-uniform, as setmaxnreg's warpgroups need
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(bar_res, kResBytes);
        for (int p = 0; p < kNP; ++p)
          tma_load_f32(smem_addr(res + p * kBwdRows * 128),
                       p < kNP1 ? tr1 : tr2, bar_res,
                       32 * (p < kNP1 ? p : p - kNP1), rh, r0, b);
        for (int it = 0; it < n_it; ++it) {
          const int s = it % kBwdStages;
          // a stage's first use passes at once (parity of the phase
          // before the barrier's first)
          mbar_wait(empty + 8 * s, ((it / kBwdStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kTileBytes);
          const uint8_t* tile = stg + s * kTileBytes;
          for (int p = 0; p < kNP; ++p)
            tma_load_f32(smem_addr(tile + p * kBs * 128),
                         p < kNP1 ? ts1 : ts2, full + 8 * s,
                         32 * (p < kNP1 ? p : p - kNP1), s_head(it),
                         s_row(it), b);
        }
      }
    } else {
      // the lo copy of each landed tile (and, for dK / dV, its rows' LSE
      // and delta), once the previous one's scores are done with it
      const int ct = threadIdx.x - 288;
      float4* dst = reinterpret_cast<float4*>(lo);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kBwdStages;
        mbar_wait(lo_empty, (it & 1) ^ 1);
        mbar_wait(full + 8 * s, (it / kBwdStages) & 1);
        const float4* src =
            reinterpret_cast<const float4*>(stg + s * kTileBytes);
        for (int i = ct; i < kTileBytes / 16; i += 96) {
          const float4 x = src[i];
          dst[i] = make_float4(raw_lo(x.x), raw_lo(x.y), raw_lo(x.z),
                               raw_lo(x.w));
        }
        if (kDKDV && ct < kBs) {
          const int q = s_row(it) + ct;
          const long long at = static_cast<long long>(b * H + s_head(it)) * Sq;
          stat[ct] = q < Sq ? lse[at + q] : 0.f;
          stat[kBs + ct] = q < Sq ? delta[at + q] : 0.f;
        }
        fence_async_smem();  // visible to the consumers' wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(lo_full);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t sbase = score_base(cw, g, t);
  const uint32_t obase = out_base<kBs>(cw, g, t);
  const uint32_t b_ds = smem_addr(buf), b_p = b_ds + 2 * kBuf;
  // this thread's dP fragment in xbuf: written by warpgroup 1, read by
  // the thread of warpgroup 0 with the same warp and lane
  float4* xf = reinterpret_cast<float4*>(xbuf + (cw * 32 + lane) * kNS);
  const int rows = kDKDV ? Sk : Sq, heads = kDKDV ? KV : H;
  // acc[i]: head-dim column 64 mb + 16 cw + g (+ 8 where i & 2) of
  // resident row r0 + 8 (i / 4) + 2 t + (i & 1)
  const auto store = [&](float* out, int width, int mb, const float(&a)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 64 * mb + 16 * cw + g + (i & 2) * 4;
      const int r = r0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (d < width && r < rows)
        out[((static_cast<long long>(b) * rows + r) * heads + rh) * width +
            d] = a[i];
    }
  };
  mbar_wait(bar_res, 0);

  if (wg == 0) {
    // ------------------------------- warpgroup 0: S, P, dS; kN0 blocks
    uint32_t rhi[kKr0][4];  // R1's fragments
    load_resident<8 * kNBK, kKr0>(res, lo2, sbase, threadIdx.x, 1, rhi);
    const float4* rlo = reinterpret_cast<const float4*>(res) + threadIdx.x;
    float acc[kN0][32];
#pragma unroll
    for (int m = 0; m < kN0; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
    // dQ: the LSE and delta of this thread's resident rows (16 cw + g,
    // + 8)
    float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
    if constexpr (!kDKDV) {
      const long long at = static_cast<long long>(b * H + rh) * Sq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = r0 + 16 * cw + g + 8 * e;
        if (q < Sq) {
          rl[e] = lse[at + q];
          rd[e] = delta[at + q];
        }
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kBwdStages;
      const int s0 = s_row(it);
      const uint8_t* tile = stg + s * kTileBytes;
      mbar_wait(full + 8 * s, (it / kBwdStages) & 1);
      mbar_wait(lo_full, it & 1);

      // S = R1 T1^T over D
      float sc[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) sc[i] = 0.f;
      score_product<kBs, 8 * kNBK, kKr0>(sc, rhi, rlo, res,
                                         lo2 + threadIdx.x, sbase,
                                         smem_addr(tile), smem_addr(lo));
      wgmma_wait<0>();
      fence_regs(sc);
      // dK / dV: the LSE and delta of this thread's streamed rows (8 j +
      // 2 t, + 1), read before the lo buffer is handed back
      float cl[kBs / 4], cd[kBs / 4];
      if constexpr (kDKDV) {
#pragma unroll
        for (int e = 0; e < kBs / 4; ++e) {
          const int c = 8 * (e >> 1) + 2 * t + (e & 1);
          cl[e] = stat[c];
          cd[e] = stat[kBs + c];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(lo_empty);

      // P; fragment i is resident row 16 cw + g (+ 8 where i & 2),
      // streamed row 8 (i / 4) + 2 t + (i & 1)
      const bool masked =
          kDKDV ? (r0 + kBwdRows > Sk || s0 + kBs > Sq ||
                   (causal && r0 + kBwdRows - 1 > s0 + q_off) ||
                   (window && r0 <= s0 + kBs - 1 + q_off - window))
                : (s0 + kBs > Sk || (causal && s0 + kBs - 1 > r0 + q_off) ||
                   (window &&
                    s0 <= min(r0 + kBwdRows, Sq) - 1 + q_off - window));
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int rr = 16 * cw + g + (i & 2) * 4;
        const int cc = 8 * (i >> 2) + 2 * t + (i & 1);
        const float l = kDKDV ? cl[2 * (i >> 2) + (i & 1)] : rl[(i >> 1) & 1];
        const int key = kDKDV ? r0 + rr : s0 + cc;
        const int q = kDKDV ? s0 + cc : r0 + rr;
        const float p = exp_f32(sc[i] * scale - l);
        sc[i] = masked && !(q < Sq && visible(key, q + q_off, Sk, causal,
                                              window))
                    ? 0.f
                    : p;
      }
      // the B buffers are [resident row][streamed row, relabelled as in
      // out_base], hi and lo: fragment i (streamed row 8 j + 2 t + (i &
      // 1), j = i / 4) at k position 8 j + t + 4 (i & 1) of resident row
      // 16 cw + g (+ 8), so at score_base ^ (2 (j % 4) + (i & 1)) x 16 (+
      // 1024) in the panel j / 4
      const auto put = [&](uint8_t* dst, const float(&x)[kNS]) {
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const uint32_t off =
              (sbase ^ ((2 * ((i >> 2) & 3) + (i & 1)) << 4)) + (i & 2) * 512 +
              (i >> 4) * kBwdRows * 128;
          uint32_t h, l;
          split(x[i], h, l);
          *reinterpret_cast<uint32_t*>(dst + off) = h;
          *reinterpret_cast<uint32_t*>(dst + kBuf + off) = l;
        }
      };
      if constexpr (kDKDV) {
        if (it > 0) mbar_wait(p_free, (it - 1) & 1);  // dV read the last
        put(buf + 2 * kBuf, sc);
        fence_async_smem();
      }
      mbar_wait(dp_ready, it & 1);
      if constexpr (kDKDV) {
        __syncwarp();
        if (lane == 0) mbar_arrive(p_ready);
      }
      // dS = P (dP - delta) scale
      float ds[kNS];
#pragma unroll
      for (int i = 0; i < kNS; i += 4) {
        const float4 x = xf[i / 4];
        ds[i] = x.x;
        ds[i + 1] = x.y;
        ds[i + 2] = x.z;
        ds[i + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float dl = kDKDV ? cd[2 * (i >> 2) + (i & 1)] : rd[(i >> 1) & 1];
        ds[i] = sc[i] * (ds[i] - dl) * scale;
      }
      put(buf, ds);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(ds_ready);
      consumer_sync();  // every warp's dS before this warpgroup's wgmma

      // dK^T += Q^T dS (dQ^T += K^T dS^T), blocks 0 .. kN0 - 1
      out_product<kBs, kN0, 0>(acc, tile, obase, b_ds, b_ds + kBuf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int m = 0; m < kN0; ++m) store(out1, D, m, acc[m]);
  } else {
    // ---------------- warpgroup 1: dP; dV^T and blocks kN0 .. kNBK - 1
    uint32_t rhi[kKr1][4];  // R2's fragments
    uint8_t* res2 = res + kNP1 * kBwdRows * 128;
    load_resident<8 * kNBV, kKr1>(res2, lo2b, sbase, threadIdx.x - 128, 2,
                                  rhi);
    const float4* rlo = reinterpret_cast<const float4*>(res2) +
                        (threadIdx.x - 128);
    float acc1[kN1 > 0 ? kN1 : 1][32], acc2[kDKDV ? kNBV : 1][32];
#pragma unroll
    for (int m = 0; m < (kN1 > 0 ? kN1 : 1); ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[m][i] = 0.f;
#pragma unroll
    for (int m = 0; m < (kDKDV ? kNBV : 1); ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[m][i] = 0.f;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kBwdStages;
      const uint8_t* tile = stg + s * kTileBytes;
      mbar_wait(full + 8 * s, (it / kBwdStages) & 1);
      mbar_wait(lo_full, it & 1);

      // dP = R2 T2^T over Dv, handed to warpgroup 0 (which has read the
      // previous tile's: ds_ready was waited on)
      float dp[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) dp[i] = 0.f;
      score_product<kBs, 8 * kNBV, kKr1>(
          dp, rhi, rlo, res2, lo2b + (threadIdx.x - 128), sbase,
          smem_addr(tile + kNP1 * kBs * 128),
          smem_addr(lo + kNP1 * kBs * 128));
      wgmma_wait<0>();
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(lo_empty);
#pragma unroll
      for (int i = 0; i < kNS; i += 4)
        xf[i / 4] = make_float4(dp[i], dp[i + 1], dp[i + 2], dp[i + 3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(dp_ready);

      if constexpr (kDKDV) {  // dV^T += dO^T P
        mbar_wait(p_ready, it & 1);
        out_product<kBs, kNBV, 0>(acc2, tile + kNP1 * kBs * 128, obase, b_p,
                                  b_p + kBuf);
        __syncwarp();
        if (lane == 0) mbar_arrive(p_free);
      }
      mbar_wait(ds_ready, it & 1);
      if constexpr (kN1 > 0)  // dK^T (dQ^T), blocks kN0 .. kNBK - 1
        out_product<kBs, (kN1 > 0 ? kN1 : 1), kN0>(acc1, tile, obase, b_ds,
                                                   b_ds + kBuf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if constexpr (kN1 > 0) {
#pragma unroll
      for (int m = 0; m < kN1; ++m) store(out1, D, kN0 + m, acc1[m]);
    }
    if constexpr (kDKDV) {
#pragma unroll
      for (int m = 0; m < kNBV; ++m) store(out2, Dv, m, acc2[m]);
    }
  }
}

template <int kNBK, int kNBV>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                      int D, int Dv, float scale, int causal, int window) {
  flash_bwd_body<true, kNBK, kNBV>(&tk, &tv, &tq, &tdo, lse, delta, dk, dv,
                                   H, KV, Sq, Sk, D, Dv, scale, causal,
                                   window);
}

template <int kNBK, int kNBV>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int KV, int Sq, int Sk, int D, int Dv, float scale,
                    int causal, int window) {
  flash_bwd_body<false, kNBK, kNBV>(&tq, &tdo, &tk, &tv, lse, delta, dq,
                                    nullptr, H, KV, Sq, Sk, D, Dv, scale,
                                    causal, window);
}

// a float32 tensor map of a contiguous (batch, s, heads, d) operand:
// (32, rows) boxes (128 bytes a row) with the 128-byte swizzle; reads
// past d or s are zero-filled
bool make_map_f32(CUtensorMap* map, const void* ptr, int d, int heads,
                  int s, int batch, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 4ull * d;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kNBK, int kNBV>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv, int B, int H, int KV, int Sq, int Sk, int D, int Dv,
               float scale, int causal, int window, cudaStream_t stream) {
  constexpr int kBsKV = bwd_tile<true, kNBK, kNBV>();
  constexpr int kBsQ = bwd_tile<false, kNBK, kNBV>();
  CUtensorMap k64, v64, q_s, do_s, q64, do64, k_s, v_s;
  if (!make_map_f32(&k64, k, D, KV, Sk, B, kBwdRows) ||
      !make_map_f32(&v64, v, Dv, KV, Sk, B, kBwdRows) ||
      !make_map_f32(&q_s, q, D, H, Sq, B, kBsKV) ||
      !make_map_f32(&do_s, dout, Dv, H, Sq, B, kBsKV) ||
      !make_map_f32(&q64, q, D, H, Sq, B, kBwdRows) ||
      !make_map_f32(&do64, dout, Dv, H, Sq, B, kBwdRows) ||
      !make_map_f32(&k_s, k, D, KV, Sk, B, kBsQ) ||
      !make_map_f32(&v_s, v, Dv, KV, Sk, B, kBsQ))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem_kv = bwd_smem<true, kNBK, kNBV>();
  constexpr int smem_q = bwd_smem<false, kNBK, kNBV>();
  const dim3 grid_kv(B * KV, (Sk + kBwdRows - 1) / kBwdRows);
  const dim3 grid_q(B * H, (Sq + kBwdRows - 1) / kBwdRows);
  if (grid_kv.y > 65535 || grid_q.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<kNBK, kNBV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<kNBK, kNBV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<kNBK, kNBV><<<grid_kv, kBwdThreads, smem_kv, stream>>>(
      k64, v64, q_s, do_s, lse, delta, dk, dv, H, KV, Sq, Sk, D, Dv, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<kNBK, kNBV><<<grid_q, kBwdThreads, smem_q, stream>>>(
      q64, do64, k_s, v_s, lse, delta, dq, H, KV, Sq, Sk, D, Dv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

int flash_backward(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
                   int Sk, int D, int Dv, float scale, int causal, int window,
                   int device, void* stream) {
  if (D < 4 || Dv < 4 || D > kMaxD || Dv > kMaxDv || D % 4 || Dv % 4 ||
      KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA: 16-byte bases (rows are 16-byte multiples, D % 4 == 0)
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<const float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  const int nbk = (D + 63) / 64, nbv = (Dv + 63) / 64;
#define FLASH_BWD(nk, nv)                                                    \
  return launch_bwd<nk, nv>(q, k, v, dout, lf, df, dqf, dkf, dvf, B, H, KV, \
                            Sq, Sk, D, Dv, scale, causal, window, s)
  if (nbk == 1) {
    if (nbv == 1) FLASH_BWD(1, 1);
    FLASH_BWD(1, 2);
  }
  if (nbk == 3) {
    if (nbv == 1) FLASH_BWD(3, 1);
    FLASH_BWD(3, 2);
  }
  if (nbv == 1) FLASH_BWD(2, 1);
  FLASH_BWD(2, 2);
#undef FLASH_BWD
}

}  // namespace

extern "C" {

// strides: 12 element strides (batch, seq, head) of q, k, v, o in turn;
// the last axis of every operand is contiguous, q / k / v start on 16
// bytes and their strides are multiples of 16 bytes.  lse: null, or a
// contiguous float32 (B, H, Sq) buffer that receives each row's
// log-sum-exp of the scaled scores (the backward's input).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, const long long* strides, int B, int H,
                        int KV, int Sq, int Sk, int D, int Dv, float scale,
                        int causal, int window, int device, void* stream) {
  return flash_launch(false, q, k, v, o, lse, strides, B, H, KV, Sq, Sk, D,
                      Dv, scale, causal, window, device, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int B, int H,
                         int KV, int Sq, int Sk, int D, int Dv, float scale,
                         int causal, int window, int device, void* stream) {
  return flash_launch(true, q, k, v, o, nullptr, strides, B, H, KV, Sq, Sk,
                      D, Dv, scale, causal, window, device, stream);
}

// The backward of flash_attention_f32 (see flash_backward above): q
// (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv), dout (B, Sq, H, Dv)
// and the outputs dq, dk, dv like q, k, v, all contiguous float32; lse
// and delta contiguous float32 (B, H, Sq).  Launches two kernels.
int flash_attention_backward_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int KV, int Sq,
                                 int Sk, int D, int Dv, float scale,
                                 int causal, int window, int device,
                                 void* stream) {
  return flash_backward(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, Sq,
                        Sk, D, Dv, scale, causal, window, device, stream);
}

}  // extern "C"
