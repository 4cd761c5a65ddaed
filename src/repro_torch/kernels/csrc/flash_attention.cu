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

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMaxD = 192;   // D of every instance, forward and backward
constexpr int kMaxDv = 128;  // Dv of every instance

struct Strides {  // element strides of the (B, S, H, D) operands
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (64 columns x 128 rows) box of a 4-d tensor map whose outer axes
// are head, row and batch in the order of their strides: perm holds the
// map axis (1..3) of head in bits 0-1, of row in 2-3, of batch in 4-5
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int perm, uint32_t bar, int col,
                                         int head, int row, int batch) {
  const int ph = perm & 3, ps = (perm >> 2) & 3;
  const int c1 = ph == 1 ? head : ps == 1 ? row : batch;
  const int c2 = ph == 2 ? head : ps == 2 ? row : batch;
  const int c3 = ph == 3 ? head : ps == 3 ? row : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1),
      "r"(c2), "r"(c3)
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

// a bf16 tensor map of a (B, S, H, d) operand: axis 0 is d, axes 1-3
// are head, row and batch sorted by stride (*perm says where each went);
// (64, rows) boxes with the 128-byte swizzle; reads past d or S are
// zero-filled
bool make_map(CUtensorMap* map, int* perm, const void* ptr, int d, int heads,
              int s, int batch, long long st_h, long long st_s,
              long long st_b, int rows) {
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
  cuuint32_t box[4] = {64};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int ax = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(size[ax]);
    strides[i] = static_cast<cuuint64_t>(stride[ax]) * 2;
    box[i + 1] = ax == 1 ? rows : 1;
    *perm |= (i + 1) << (2 * ax);
  }
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  if (!make_map(&tq, &pq, q, D, H, Sq, B, st.q_h, st.q_s, st.q_b, 128) ||
      !make_map(&tk, &pk, k, D, KV, Sk, B, st.k_h, st.k_s, st.k_b, kBK) ||
      !make_map(&tv, &pv, v, Dv, KV, Sk, B, st.v_h, st.v_s, st.v_b, kBK))
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
// per (query tile, key tile) pair as the reference's custom VJP does
// (repro/models/attention.py _flash_vjp_bwd, jnp, not a TPU kernel):
//   p = exp(s - lse), s = (q . k) scale (masked: p = 0),
//   dv_j = sum_i p_ij do_i,  dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - delta_i) scale,
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,
// with causal ends aligned, the window, GQA (dK and dV sum over a kv
// head's G query heads) and Dk != Dv, D up to 192 and Dv up to 128.
//
// What bounds it: operations, five products a visible (query, key) pair;
// the design does seven (S and dP in both kernels).  Every product runs
// on the tensor cores as the forward's 3xTF32 mma.sync (float32-level
// accuracy), with the forward's register trick: a product's C fragment
// is the next product's A fragment once the columns of each 8-wide step
// are relabelled (A column t = row 2t of B, t + 4 = row 2t + 1), so P and
// dS never leave registers.  Two kernels, no atomics, so every run gives
// the same gradients:
//  * flash_bwd_dkdv_kernel: a CTA of 8 warps owns 128 keys of one kv
//    head (16 a warp), holds their K and V tiles in shared memory and
//    dK, dV in registers, and walks the query tiles of kBQ rows that can
//    see them, for each of the G query heads of the group, through a
//    two-stage cp.async ring of Q, dO, LSE and delta: per warp S^T = K
//    Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//  * flash_bwd_dq_kernel: a CTA of 8 warps owns 128 query rows of one
//    head (16 a warp), holds Q, dO and each row's LSE and delta, and
//    walks the visible key tiles through a two-stage ring of K and V:
//    S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
// Tiles that a warp's rows cannot see are skipped, and only tiles that
// cut the mask are masked.  Shared rows have a pitch of 4 mod 8 floats,
// so fragment reads are conflict-free.  Shared memory at D = Dv = 128:
// (128 + 2 x 32) x 264 floats + the LSE / delta ring = 203,264 bytes
// (dK, dV), (128 + 2 x 32) x 264 floats = 202,752 bytes (dQ); at D = 64
// two CTAs share an SM.  D in (128, 192] (MLA's Dk 192) takes another
// tiling (bwd_warps / bwd_tile below).  wgmma and TMA are for a later
// pass.
// Warps a CTA (16 owned rows each: keys in dK / dV, queries in dQ) and
// rows of a streamed tile (queries or keys): 8 and 32 at D <= 128.  At
// D in (128, 192] that would need (128 + 2 x 32) x (pitch(192) +
// pitch(128)) floats = 251,904 bytes of shared memory, more than a CTA
// may hold, and a dK / dV warp holds 16 rows x (192 + 128) accumulators,
// 160 floats a thread.  Two tilings fit (tools/flash_wide_layout.py
// builds and times both; PERF.md has the times and ptxas' registers):
//  * 8 warps and 16-row streamed tiles: 209,920 bytes (+ the LSE /
//    delta ring); a streamed tile's working set (S, dP and their split
//    A fragments) halves, which leaves the registers for dK and dV;
//  * 4 warps (64 owned rows) and 32-row tiles: 167,936 bytes.
// kBwdWideWarps / kBwdWideTile name the one kept.
constexpr int kBwdWideWarps = 8, kBwdWideTile = 16;
template <int kND>
__host__ __device__ constexpr int bwd_warps() {
  return kND > 16 ? kBwdWideWarps : 8;
}
template <int kND>
__host__ __device__ constexpr int bwd_tile() {
  return kND > 16 ? kBwdWideTile : 32;
}

// zero columns [d, width) of rows [0, rows) of a shared tile (cp.async
// writes only the first d); kThreads threads
template <int kThreads>
__device__ __forceinline__ void zero_pad_cols(float* dst, int rows, int ld,
                                              int d, int width) {
  const int w = width - d;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    dst[r * ld + d + c] = 0.f;
  }
}

// s[j] = A rows (16, from a shared tile at `a`, row g at a + g * lda + t)
// . B rows (8 j + g, at b + g * ldb + t), over d8 columns in 8-wide steps,
// 3xTF32
template <int kJ>
__device__ __forceinline__ void rows_dot(float (&s)[kJ][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int d8) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  for (int kk = 0; kk < d8; kk += 8) {
    uint32_t ah[4], al[4];
    split(a[kk], ah[0], al[0]);
    split(a[8 * lda + kk], ah[1], al[1]);
    split(a[kk + 4], ah[2], al[2]);
    split(a[8 * lda + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      mma_3xtf32(s[j], ah, al, b[8 * j * ldb + kk], b[8 * j * ldb + kk + 4]);
  }
}

// acc[n] += X . B, X (16 x 8 kJ) in C-fragment layout (columns 2t, 2t + 1
// of each 8-wide step j), B rows 8 j + 2t and 8 j + 2t + 1 at
// b + (8 j + 2t) * ldb + g, over kN 8-column output tiles.  Each output
// tile is summed over the kJ steps in a fresh fragment and then added to
// acc in float32 on the CUDA cores: the tensor cores' accumulator drops
// low bits of addends much smaller than it, and dK and dV each sum
// thousands of small terms (accumulated in place, the yi-6b shape's dK
// was 1.0e-4 of its largest magnitude away from the plain version)
template <int kJ, int kN>
__device__ __forceinline__ void frag_times_rows(float (&acc)[kN][4],
                                                const float (&x)[kJ][4],
                                                const float* b, int ldb) {
  uint32_t ah[kJ][4], al[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    split(x[j][0], ah[j][0], al[j][0]);
    split(x[j][2], ah[j][1], al[j][1]);
    split(x[j][1], ah[j][2], al[j][2]);
    split(x[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float* br = b + 8 * j * ldb + 8 * n;
      mma_3xtf32(c, ah[j], al[j], br[0], br[ldb]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// kND, kNV: 8-column tiles of dK (D: 8, 16 or 24) and dV (Dv: 8 or 16)
template <int kND, int kNV>
__global__ void __launch_bounds__(32 * bwd_warps<kND>(), 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                      int D, int Dv, float scale, int causal, int window) {
  constexpr int kThreads = 32 * bwd_warps<kND>();
  constexpr int kBK = 16 * bwd_warps<kND>(), kBQ = bwd_tile<kND>();
  constexpr int kJ = kBQ / 8;
  extern __shared__ float4 smem4[];
  const int ldq = pitch(8 * kND), ldo = pitch(8 * kNV);
  float* sK = reinterpret_cast<float*>(smem4);  // kBK x ldq
  float* sV = sK + kBK * ldq;                   // kBK x ldo
  float* sQ = sV + kBK * ldo;                   // 2 x kBQ x ldq
  float* sO = sQ + 2 * kBQ * ldq;               // 2 x kBQ x ldo (dO)
  float* sL = sO + 2 * kBQ * ldo;               // 2 x kBQ (LSE)
  float* sDl = sL + 2 * kBQ;                    // 2 x kBQ (delta)

  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const int k0 = blockIdx.y * kBK;  // the first tiles see the most queries
  const int G = H / KV, q_off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dk8 = (D + 7) / 8 * 8, dv8 = (Dv + 7) / 8 * 8;

  zero_pad_cols<kThreads>(sK, kBK, ldq, D, 8 * kND);
  zero_pad_cols<kThreads>(sV, kBK, ldo, Dv, 8 * kNV);
  zero_pad_cols<kThreads>(sQ, 2 * kBQ, ldq, D, 8 * kND);
  zero_pad_cols<kThreads>(sO, 2 * kBQ, ldo, Dv, 8 * kNV);

  const long long k_row = static_cast<long long>(KV) * D;
  const long long v_row = static_cast<long long>(KV) * Dv;
  const long long q_row = static_cast<long long>(H) * D;
  const long long o_row = static_cast<long long>(H) * Dv;
  load_kv_tile<kBK, kThreads>(
      sK, ldq, k + static_cast<long long>(b) * Sk * k_row + kvh * D, k_row,
      k0, Sk, D);
  load_kv_tile<kBK, kThreads>(
      sV, ldo, v + static_cast<long long>(b) * Sk * v_row + kvh * Dv, v_row,
      k0, Sk, Dv);

  // the query rows that can see a key of [k0, k_last]
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_off) : 0;
  const int q_hi = window ? min(Sq, k_last + window - q_off) : Sq;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + kBQ - 1) / kBQ : 0;
  const int n_it = G * n_q;

  // iteration it: query head kvh G + it / n_q, tile it % n_q, into stage st
  auto stage = [&](int it, int st) {
    const int h = kvh * G + it / n_q, q0 = q_lo + (it % n_q) * kBQ;
    const long long bh = static_cast<long long>(b) * H + h;
    load_kv_tile<kBQ, kThreads>(
        sQ + st * kBQ * ldq, ldq,
        q + static_cast<long long>(b) * Sq * q_row + h * D, q_row, q0, Sq, D);
    load_kv_tile<kBQ, kThreads>(
        sO + st * kBQ * ldo, ldo,
        dout + static_cast<long long>(b) * Sq * o_row + h * Dv, o_row, q0, Sq,
        Dv);
    if (threadIdx.x < kBQ) {
      const int qi = q0 + threadIdx.x;
      sL[st * kBQ + threadIdx.x] = qi < Sq ? lse[bh * Sq + qi] : 0.f;
      sDl[st * kBQ + threadIdx.x] = qi < Sq ? delta[bh * Sq + qi] : 0.f;
    }
  };

  const int wk0 = k0 + 16 * warp;  // this warp's keys, rows g and g + 8
  const int key0 = wk0 + g, key1 = key0 + 8;
  float acc_k[kND][4], acc_v[kNV][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_v[n][c] = 0.f;

  if (n_it > 0) stage(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1, (it + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const int q0 = q_lo + (it % n_q) * kBQ;
    const int q_first = q0 + q_off;                   // in key positions
    const int q_last = min(q0 + kBQ, Sq) - 1 + q_off;
    const bool skip = wk0 >= Sk || (causal && wk0 > q_last) ||
                      (window && wk0 + 15 <= q_first - window);
    // some (key, query) pair of the warp's tile is hidden
    const bool masked = wk0 + 15 >= Sk || q0 + kBQ > Sq ||
                        (causal && wk0 + 15 > q_first) ||
                        (window && wk0 <= q_last - window);
    if (!skip) {
      const float* tQ = sQ + (it & 1) * kBQ * ldq;
      const float* tO = sO + (it & 1) * kBQ * ldo;
      const float* tL = sL + (it & 1) * kBQ;
      const float* tD = sDl + (it & 1) * kBQ;
      // S^T = K Q^T: 16 keys x kBQ queries; P^T in place
      float s[kJ][4];
      rows_dot<kJ>(s, sK + (16 * warp + g) * ldq + t, ldq, tQ + g * ldq + t,
                   ldq, dk8);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          const int qi = q0 + col;
          float p = exp_f32(s[j][c] * scale - tL[col]);
          if (masked && !(qi < Sq && visible(c < 2 ? key0 : key1,
                                             qi + q_off, Sk, causal,
                                             window)))
            p = 0.f;
          s[j][c] = p;
        }
      // dV += P^T dO
      frag_times_rows<kJ, kNV>(acc_v, s, tO + 2 * t * ldo + g, ldo);
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place of P^T
      float dp[kJ][4];
      rows_dot<kJ>(dp, sV + (16 * warp + g) * ldo + t, ldo, tO + g * ldo + t,
                   ldo, dv8);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[j][c] = s[j][c] * (dp[j][c] - tD[8 * j + 2 * t + (c & 1)]) * scale;
      // dK += dS^T Q
      frag_times_rows<kJ, kND>(acc_k, s, tQ + 2 * t * ldq + g, ldq);
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  const long long base = static_cast<long long>(b) * Sk * KV + kvh;
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= D) continue;
    if (key0 < Sk)
      *reinterpret_cast<float2*>(dk + (base + static_cast<long long>(key0) *
                                                  KV) * D + col) =
          make_float2(acc_k[n][0], acc_k[n][1]);
    if (key1 < Sk)
      *reinterpret_cast<float2*>(dk + (base + static_cast<long long>(key1) *
                                                  KV) * D + col) =
          make_float2(acc_k[n][2], acc_k[n][3]);
  }
#pragma unroll
  for (int n = 0; n < kNV; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= Dv) continue;
    if (key0 < Sk)
      *reinterpret_cast<float2*>(dv + (base + static_cast<long long>(key0) *
                                                  KV) * Dv + col) =
          make_float2(acc_v[n][0], acc_v[n][1]);
    if (key1 < Sk)
      *reinterpret_cast<float2*>(dv + (base + static_cast<long long>(key1) *
                                                  KV) * Dv + col) =
          make_float2(acc_v[n][2], acc_v[n][3]);
  }
}

// kND: 8-column tiles of dQ (D), 8, 16 or 24
template <int kND>
__global__ void __launch_bounds__(32 * bwd_warps<kND>(), 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int KV, int Sq, int Sk, int D, int Dv, float scale,
                    int causal, int window) {
  constexpr int kThreads = 32 * bwd_warps<kND>();
  constexpr int kBQ = 16 * bwd_warps<kND>(), kBK = bwd_tile<kND>();
  constexpr int kJ = kBK / 8;
  extern __shared__ float4 smem4[];
  const int ldq = pitch(8 * kND), ldo = pitch(Dv);
  float* sQ = reinterpret_cast<float*>(smem4);  // kBQ x ldq
  float* sO = sQ + kBQ * ldq;                   // kBQ x ldo (dO)
  float* sK = sO + kBQ * ldo;                   // 2 x kBK x ldq
  float* sV = sK + 2 * kBK * ldq;               // 2 x kBK x ldo

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int q_off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dk8 = (D + 7) / 8 * 8, dv8 = (Dv + 7) / 8 * 8;

  zero_pad_cols<kThreads>(sQ, kBQ, ldq, D, dk8);
  zero_pad_cols<kThreads>(sO, kBQ, ldo, Dv, dv8);
  zero_pad_cols<kThreads>(sK, 2 * kBK, ldq, D, 8 * kND);
  zero_pad_cols<kThreads>(sV, 2 * kBK, ldo, Dv, dv8);

  const long long k_row = static_cast<long long>(KV) * D;
  const long long v_row = static_cast<long long>(KV) * Dv;
  const long long q_row = static_cast<long long>(H) * D;
  const long long o_row = static_cast<long long>(H) * Dv;
  const float* kb = k + static_cast<long long>(b) * Sk * k_row + kvh * D;
  const float* vb = v + static_cast<long long>(b) * Sk * v_row + kvh * Dv;
  load_kv_tile<kBQ, kThreads>(
      sQ, ldq, q + static_cast<long long>(b) * Sq * q_row + h * D, q_row, q0,
      Sq, D);
  load_kv_tile<kBQ, kThreads>(
      sO, ldo, dout + static_cast<long long>(b) * Sq * o_row + h * Dv, o_row,
      q0, Sq, Dv);

  // this warp's rows, in key positions, and their LSE and delta
  const int wr0 = q0 + 16 * warp;
  const int w_last = min(wr0 + 15, Sq - 1) + q_off;
  const int r0 = wr0 + g, r1 = r0 + 8;
  const long long at = static_cast<long long>(bh) * Sq;
  const float lse0 = r0 < Sq ? lse[at + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[at + r1] : 0.f;
  const float dl0 = r0 < Sq ? delta[at + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[at + r1] : 0.f;

  int k_first, k_end;
  key_range(q0, kBQ, Sq, Sk, causal, window, kBK, &k_first, &k_end);
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  if (n_tiles > 0) {
    load_kv_tile<kBK, kThreads>(sK, ldq, kb, k_row, k_first, Sk, D);
    load_kv_tile<kBK, kThreads>(sV, ldo, vb, v_row, k_first, Sk, Dv);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kBK;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      const int nx = (it + 1) & 1;
      load_kv_tile<kBK, kThreads>(sK + nx * kBK * ldq, ldq, kb, k_row,
                                     k0 + kBK, Sk, D);
      load_kv_tile<kBK, kThreads>(sV + nx * kBK * ldo, ldo, vb, v_row,
                                     k0 + kBK, Sk, Dv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const bool skip = wr0 >= Sq || (causal && k0 > w_last) ||
                      (window && k0 + kBK - 1 <= wr0 + q_off - window);
    const bool masked = k0 + kBK > Sk ||
                        (causal && k0 + kBK - 1 > wr0 + q_off) ||
                        (window && k0 <= w_last - window);
    if (!skip) {
      const float* tK = sK + (it & 1) * kBK * ldq;
      const float* tV = sV + (it & 1) * kBK * ldo;
      // S = Q K^T: 16 rows x kBK keys; P in place
      float s[kJ][4];
      rows_dot<kJ>(s, sQ + (16 * warp + g) * ldq + t, ldq, tK + g * ldq + t,
                   ldq, dk8);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + 8 * j + 2 * t + (c & 1);
          const int row = (c < 2 ? r0 : r1) + q_off;
          float p = exp_f32(s[j][c] * scale - (c < 2 ? lse0 : lse1));
          if (masked && !visible(col, row, Sk, causal, window)) p = 0.f;
          s[j][c] = p;
        }
      // dP = dO V^T, then dS = P (dP - delta) scale in place of P
      float dp[kJ][4];
      rows_dot<kJ>(dp, sO + (16 * warp + g) * ldo + t, ldo, tV + g * ldo + t,
                   ldo, dv8);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[j][c] = s[j][c] * (dp[j][c] - (c < 2 ? dl0 : dl1)) * scale;
      // dQ += dS K
      frag_times_rows<kJ, kND>(acc, s, tK + 2 * t * ldq + g, ldq);
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  float* ob = dq + static_cast<long long>(b) * Sq * q_row + h * D;
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= D) continue;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r0) * q_row +
                                 col) = make_float2(acc[n][0], acc[n][1]);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r1) * q_row +
                                 col) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <int kND, int kNV>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int B, int H, int KV, int Sq,
               int Sk, int D, int Dv, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int kThreads = 32 * bwd_warps<kND>();
  constexpr int kRows = 16 * bwd_warps<kND>(), kT = bwd_tile<kND>();
  const int ldq = pitch(8 * kND), ldo = pitch(8 * kNV), ldo_q = pitch(Dv);
  const size_t smem_kv =
      sizeof(float) * static_cast<size_t>((kRows + 2 * kT) * (ldq + ldo) +
                                          4 * kT);
  const size_t smem_q =
      sizeof(float) * static_cast<size_t>((kRows + 2 * kT) * (ldq + ldo_q));
  const dim3 grid_kv(B * KV, (Sk + kRows - 1) / kRows);
  const dim3 grid_q(B * H, (Sq + kRows - 1) / kRows);
  if (grid_kv.y > 65535 || grid_q.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<kND, kNV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<kND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<kND, kNV><<<grid_kv, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, Sq, Sk, D, Dv, scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<kND><<<grid_q, kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Sk, D, Dv, scale, causal,
      window);
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
  // cp.async moves 16-byte chunks: 16-byte bases (rows are, D % 4 == 0)
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<const float*>(dout);
  auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<const float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
#define FLASH_BWD(nd, nv)                                                    \
  return launch_bwd<nd, nv>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, B, H, KV, \
                            Sq, Sk, D, Dv, scale, causal, window, s)
  if (D <= 64) {
    if (Dv <= 64) FLASH_BWD(8, 8);
    FLASH_BWD(8, 16);
  }
  if (D > 128) {
    if (Dv <= 64) FLASH_BWD(24, 8);
    FLASH_BWD(24, 16);
  }
  if (Dv <= 64) FLASH_BWD(16, 8);
  FLASH_BWD(16, 16);
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
