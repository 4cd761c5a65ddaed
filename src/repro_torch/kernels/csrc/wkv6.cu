// Hand-written Hopper (sm_90a) RWKV6 WKV recurrence, with a plain C
// interface bound from Python through ctypes (repro_torch/kernels/wkv6.py).
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first launch error so the wrapper
// can raise on a refused launch.
//
// Replaces the TPU kernel repro/kernels/wkv6.py wkv6_pallas (body
// _wkv6_kernel): per (batch, head), from a zero (N, N) state S,
//     o_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//     S[i, j] = exp(lw_t[i]) S[i, j] + k_t[i] v_t[j]
// returning o (in r's type) and the final state (f32).  The TPU kernel
// evaluates it in chunks of 64 with tile-referenced exponents so that its
// matrix unit does the work; this kernel runs the exact recurrence inside
// each chunk of steps, which the chunked form equals up to f32 rounding.
// exp(lw) underflows to 0 for very negative lw, which is the right value:
// nothing is rescaled.
//
// What bounds it: neither bytes nor flops of the function (r, k, v, lw
// read once and o written once; ~5 N^2 flops per (batch, head, step)) but
// the walk along S.  One CTA per (batch, head) walking all S steps would
// give only B * H CTAs (128 of two warps at rwkv6-1.6b on 132 SMs), each
// step waiting on the one before.
//
// Design: state passing over chunks of L steps.  The value columns j are
// independent and the state is linear in the steps, so with
// d_c[i] = prod_{t in chunk c} exp(lw_t[i]) and S_loc_c the chunk's state
// run from zero, the state entering chunk c + 1 is
//     S_in_{c+1} = d_c[i] S_in_c + S_loc_c,   S_in_0 = 0.
// Three launches, all on the caller's stream:
//   1. wkv6_kernel<.., false>: B * H * ceil(S / L) CTAs, each forms its
//      chunk's state from zero as sum_t (k_t[i] D_t[i]) v_t[j], D_t the
//      product of w over the chunk's later steps (one multiply-add per
//      state element and step, where the recurrence takes two), and
//      writes S_loc_c and d_c to a scratch;
//   2. wkv6_kernel_scan: one thread per four (b, h, i, j) walks the chunks
//      in order, overwrites S_loc_c with S_in_c, and writes the final
//      state;
//   3. wkv6_kernel<.., true>: the same grid, each CTA reruns its chunk
//      from S_in_c and emits o.
// The price is bytes: k, v and lw are read twice, and the chunk states
// are written once, read and written by the scan, and read once more.
// Inside a chunk a CTA has N threads; thread (column block cb, row group
// rg) keeps a (N/4)-row x 4-column tile of the f32 state in registers, so
// each shared-memory read of r, k or w feeds four columns.  A step's o
// partial sums over the four row groups meet in a reduce-scatter of three
// shuffles, after which lane rg of a column block holds column 4 cb + rg,
// and a warp stores 32 consecutive columns.  Steps arrive 8 at a time
// through a two-stage cp.async ring, so the next stage's loads fly while
// this one computes; a stage is prepared once in shared memory before
// its steps (w = exp(lw), bf16 widened, the bonus sum_i r u k of each
// step reduced across the lanes that hold it), and r, k and w rows are
// padded so the four row groups hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStage = 8;         // steps per stage of the cp.async ring
constexpr int kScanThreads = 256;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// four consecutive elements of a row as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Shared-memory layout of a chunk's rows: row group g of N/4 rows starts
// at g * (N/4 + 4) floats, so the groups' 16-byte reads fall in distinct
// banks.
template <int N>
struct Layout {
  static constexpr int kRows = N / 4;          // rows per thread
  static constexpr int kPitch = N + 16;        // padded floats per step
  static __device__ __forceinline__ int pos(int i) {
    return (i / kRows) * (kRows + 4) + i % kRows;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 (f32 x 4) or 8 (bf16 x 4) bytes; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int N, bool kEmit>
__global__ void __launch_bounds__(N, N == 64 ? 8 : 16)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ chunk_state,
            float* __restrict__ chunk_decay, int S, int H, int L,
            int n_chunks) {
  using Lay = Layout<N>;
  constexpr int TI = Lay::kRows;
  constexpr int kPitch = Lay::kPitch;
  constexpr int kQuads = N / 4;                 // float4s per step row
  constexpr int kLoads = kStage * kQuads / N;   // float4s per thread
  constexpr unsigned kMask = N >= 32 ? 0xffffffffu : (1u << N) - 1u;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRaw = kEmit ? 3 : 2;           // bf16 r (emit), k, v
  // two stages in flight: f32 operands land where the steps read them;
  // bf16 ones land in s_raw and are widened when their stage is prepared
  __shared__ __align__(16) float s_k[2][kStage][kPitch];
  __shared__ __align__(16) float s_w[2][kStage][kPitch];  // lw, then w
  __shared__ __align__(16) float s_v[2][kStage][N];
  __shared__ __align__(16) float s_r[kEmit ? 2 : 1][kStage][kPitch];
  __shared__ float s_bonus[2][kStage];
  __shared__ __align__(16) T s_raw[kF32 ? 1 : 2][kRaw][kF32 ? 1 : kStage]
                                  [kF32 ? 4 : N];

  const int tid = threadIdx.x;
  const int rg = tid & 3, cb = tid >> 2;
  const int j0 = 4 * cb;
  const int roff = rg * (TI + 4);
  const int bhc = blockIdx.x;
  const int bh = bhc / n_chunks, c = bhc - bh * n_chunks;
  const int b = bh / H, h = bh - b * H;
  const long long row = static_cast<long long>(H) * N;  // one step's stride
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * N;
  const int c0 = c * L, c1 = min(S, c0 + L);
  float* const cs = chunk_state + static_cast<long long>(bhc) * N * N;
  // the emitting pass walks the stages forward; the first pass walks them
  // backward, carrying each row's product of w over the later steps
  const int n_stages = (c1 - c0 + kStage - 1) / kStage;
  auto stage_start = [&](int sg) {
    return c0 + (kEmit ? sg : n_stages - 1 - sg) * kStage;
  };

  // one stage's r (emit), k, v and lw into buffer `buf`; steps past the
  // chunk are zero-filled
  auto issue = [&](int sg, int buf) {
    const int t0 = stage_start(sg), nt = min(kStage, c1 - t0);
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int e = tid + N * s;
      const int tt = e / kQuads, i = 4 * (e % kQuads);
      const bool ok = tt < nt;
      const long long idx = base + (ok ? t0 + tt : c0) * row + i;
      const int p = Lay::pos(i);
      cp_async4(&s_w[buf][tt][p], lw + idx, ok);
      if constexpr (kF32) {
        cp_async4(&s_k[buf][tt][p], k + idx, ok);
        cp_async4(&s_v[buf][tt][i], v + idx, ok);
        if constexpr (kEmit) cp_async4(&s_r[buf][tt][p], r + idx, ok);
      } else {
        cp_async4(&s_raw[buf][0][tt][i], k + idx, ok);
        cp_async4(&s_raw[buf][1][tt][i], v + idx, ok);
        if constexpr (kEmit) cp_async4(&s_raw[buf][2][tt][i], r + idx, ok);
      }
    }
    cp_async_commit();
  };

  // u of the rows this thread prepares: columns 4 (e % kQuads) on
  float4 u4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kEmit) {
    const float* uh = u + h * N + 4 * (tid % kQuads);
    u4 = make_float4(uh[0], uh[1], uh[2], uh[3]);
  }

  float st[TI][4];
  if (kEmit && c > 0) {
#pragma unroll
    for (int m = 0; m < TI; ++m) {
      const float4 s4 = load4(cs + (rg * TI + m) * N + j0);
      st[m][0] = s4.x; st[m][1] = s4.y; st[m][2] = s4.z; st[m][3] = s4.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < TI; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[m][q] = 0.f;
  }
  float decay = 1.f;  // row tid's product of w over later steps

  issue(0, 0);
  for (int sg = 0; sg < n_stages; ++sg) {
    const int buf = sg & 1;
    const int t0 = stage_start(sg), nt = min(kStage, c1 - t0);
    cp_async_wait_all();
    __syncthreads();  // the stage has landed; the previous one is consumed
    if (sg + 1 < n_stages) issue(sg + 1, buf ^ 1);
    if constexpr (kEmit) {
      // w = exp(lw) in place, bf16 operands widened, and the bonus
      // sum_i r u k of each step: quads of a step on kQuads neighbours
#pragma unroll
      for (int s = 0; s < kLoads; ++s) {
        const int e = tid + N * s;
        const int tt = e / kQuads, i = 4 * (e % kQuads);
        const int p = Lay::pos(i);
        float4* w4p = reinterpret_cast<float4*>(&s_w[buf][tt][p]);
        const float4 l4 = *w4p;
        *w4p = make_float4(expf(l4.x), expf(l4.y), expf(l4.z), expf(l4.w));
        float4 k4, r4;
        if constexpr (kF32) {
          k4 = *reinterpret_cast<const float4*>(&s_k[buf][tt][p]);
          r4 = *reinterpret_cast<const float4*>(&s_r[buf][tt][p]);
        } else {
          k4 = load4(&s_raw[buf][0][tt][i]);
          r4 = load4(&s_raw[buf][2][tt][i]);
          *reinterpret_cast<float4*>(&s_k[buf][tt][p]) = k4;
          *reinterpret_cast<float4*>(&s_r[buf][tt][p]) = r4;
          *reinterpret_cast<float4*>(&s_v[buf][tt][i]) =
              load4(&s_raw[buf][1][tt][i]);
        }
        float a = r4.x * u4.x * k4.x;
        a = fmaf(r4.y * u4.y, k4.y, a);
        a = fmaf(r4.z * u4.z, k4.z, a);
        a = fmaf(r4.w * u4.w, k4.w, a);
#pragma unroll
        for (int x = 1; x < kQuads; x <<= 1)
          a += __shfl_xor_sync(kMask, a, x);
        if (e % kQuads == 0) s_bonus[buf][tt] = a;
      }
    } else {
      // the chunk's state from zero is sum_t (k_t[i] D_t[i]) v_t[j] with
      // D_t[i] the product of w[i] over the chunk's steps after t: row
      // tid's k becomes k D in place, latest step first (bf16 k and v are
      // widened here, k by row and v by column)
      const int p = Lay::pos(tid);
      for (int tt = nt - 1; tt >= 0; --tt) {
        float kk;
        if constexpr (kF32) {
          kk = s_k[buf][tt][p];
        } else {
          kk = __bfloat162float(s_raw[buf][0][tt][tid]);
          s_v[buf][tt][tid] = __bfloat162float(s_raw[buf][1][tt][tid]);
        }
        s_k[buf][tt][p] = kk * decay;
        decay *= expf(s_w[buf][tt][p]);
      }
    }
    __syncthreads();
    if constexpr (!kEmit) {
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&s_v[buf][tt][j0]);
        const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int m = 0; m < TI; m += 4) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(&s_k[buf][tt][roff + m]);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              st[m + mm][q] = fmaf(kk[mm], vq[q], st[m + mm][q]);
        }
      }
    } else {
      for (int tt = 0; tt < nt; ++tt) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&s_v[buf][tt][j0]);
        const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < TI; m += 4) {
          const float4 r4 =
              *reinterpret_cast<const float4*>(&s_r[buf][tt][roff + m]);
          const float4 k4 =
              *reinterpret_cast<const float4*>(&s_k[buf][tt][roff + m]);
          const float4 w4 =
              *reinterpret_cast<const float4*>(&s_w[buf][tt][roff + m]);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[q] = fmaf(rr[mm], st[m + mm][q], acc[q]);
              st[m + mm][q] = fmaf(ww[mm], st[m + mm][q], kk[mm] * vq[q]);
            }
        }
        // reduce-scatter over the four row groups: lane rg ends with
        // column j0 + rg, summed as (g0 + g2) + (g1 + g3)
        const bool hi2 = rg & 2, hi1 = rg & 1;
        const float s0 = __shfl_xor_sync(kMask, hi2 ? acc[0] : acc[2], 2);
        const float s1 = __shfl_xor_sync(kMask, hi2 ? acc[1] : acc[3], 2);
        const float p0 = (hi2 ? acc[2] : acc[0]) + s0;
        const float p1 = (hi2 ? acc[3] : acc[1]) + s1;
        const float x = __shfl_xor_sync(kMask, hi1 ? p0 : p1, 1);
        const float vj = hi2 ? (hi1 ? v4.w : v4.z) : (hi1 ? v4.y : v4.x);
        const float out = fmaf(s_bonus[buf][tt], vj, (hi1 ? p1 : p0) + x);
        store(o + base + (t0 + tt) * row + j0 + rg, out);
      }
    }
  }

  if constexpr (!kEmit) {
#pragma unroll
    for (int m = 0; m < TI; ++m)
      *reinterpret_cast<float4*>(cs + (rg * TI + m) * N + j0) =
          make_float4(st[m][0], st[m][1], st[m][2], st[m][3]);
    chunk_decay[static_cast<long long>(bhc) * N + tid] = decay;
  }
}

// S_in_{c+1} = d_c[i] S_in_c + S_loc_c over the chunks of one (b, h), four
// columns of one row per thread; S_loc_c is overwritten with S_in_c.
template <int N>
__global__ void __launch_bounds__(kScanThreads)
wkv6_kernel_scan(float* __restrict__ chunk_state,
                 const float* __restrict__ chunk_decay,
                 float* __restrict__ state_out, int BH, int n_chunks) {
  constexpr int kQuads = N * N / 4;
  constexpr int kBatch = 4;  // chunks whose loads are issued together
  const long long idx = static_cast<long long>(blockIdx.x) * kScanThreads +
                        threadIdx.x;
  if (idx >= static_cast<long long>(BH) * kQuads) return;
  const int bh = static_cast<int>(idx / kQuads);
  const int e = 4 * static_cast<int>(idx % kQuads);
  const int i = e / N;
  float4* const cs = reinterpret_cast<float4*>(
      chunk_state + static_cast<long long>(bh) * n_chunks * N * N + e);
  const float* const dec = chunk_decay +
                           static_cast<long long>(bh) * n_chunks * N + i;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float4 loc[kBatch];
    float d[kBatch];
#pragma unroll
    for (int x = 0; x < kBatch; ++x) {
      if (c0 + x < n_chunks) {
        loc[x] = cs[(c0 + x) * kQuads];
        d[x] = dec[(c0 + x) * N];
      }
    }
#pragma unroll
    for (int x = 0; x < kBatch; ++x) {
      if (c0 + x < n_chunks) {
        cs[(c0 + x) * kQuads] = carry;
        carry = make_float4(fmaf(d[x], carry.x, loc[x].x),
                            fmaf(d[x], carry.y, loc[x].y),
                            fmaf(d[x], carry.z, loc[x].z),
                            fmaf(d[x], carry.w, loc[x].w));
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + static_cast<long long>(bh) * N * N +
                             e) = carry;
}

template <typename T, int N>
int wkv6_launch_n(const void* r, const void* k, const void* v, const void* lw,
                  const void* u, void* o, void* state, void* chunk_state,
                  void* chunk_decay, int B, int S, int H, int L,
                  cudaStream_t s) {
  const int n_chunks = (S + L - 1) / L;
  const long long ctas = static_cast<long long>(B) * H * n_chunks;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  float* csf = static_cast<float*>(chunk_state);
  float* cdf = static_cast<float*>(chunk_decay);
  cudaError_t err;
  if (ctas > 0) {
    wkv6_kernel<T, N, false><<<static_cast<unsigned>(ctas), N, 0, s>>>(
        rt, kt, vt, lwf, uf, static_cast<T*>(o), csf, cdf, S, H, L,
        n_chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const long long scan_threads = static_cast<long long>(B) * H * N * N / 4;
  wkv6_kernel_scan<N>
      <<<static_cast<unsigned>((scan_threads + kScanThreads - 1) /
                               kScanThreads),
         kScanThreads, 0, s>>>(csf, cdf, static_cast<float*>(state), B * H,
                               n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (ctas > 0) {
    wkv6_kernel<T, N, true><<<static_cast<unsigned>(ctas), N, 0, s>>>(
        rt, kt, vt, lwf, uf, static_cast<T*>(o), csf, cdf, S, H, L,
        n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* o, void* state, void* chunk_state,
                void* chunk_decay, int B, int S, int H, int N, int L,
                int device, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return wkv6_launch_n<T, 16>(r, k, v, lw, u, o, state, chunk_state,
                                  chunk_decay, B, S, H, L, s);
    case 32:
      return wkv6_launch_n<T, 32>(r, k, v, lw, u, o, state, chunk_state,
                                  chunk_decay, B, S, H, L, s);
    case 64:
      return wkv6_launch_n<T, 64>(r, k, v, lw, u, o, state, chunk_state,
                                  chunk_decay, B, S, H, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ------------------------------------------------------------- backward
// No TPU kernel: the reference differentiates wkv6_chunked with JAX
// autodiff.  Per (batch, head), with w = exp(lw), dS_t = dL/dS_t and the
// final state's gradient dS_T (zero when none is given):
//     dS_{t-1} = diag(w_t) dS_t + r_t do_t^T
//     dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
//     dk_t = dS_t v_t + u r_t (v_t . do_t)
//     dv_t = dS_t^T k_t + (r_t . u k_t) do_t
//     du   = sum over batch and steps of r_t k_t (v_t . do_t)
//     dlw_m = rowsum(S_e . dS_e) + sum_{m < t <= e} r_t dr'_t
//             - sum_{m <= t <= e} k_t dk'_t
// with dr'_t = S_{t-1} do_t and dk'_t = dS_t v_t (the terms without u) and
// (S_e, dS_e) the state and its gradient at any later step e: here the
// last step of m's chunk, so no sum runs past one chunk (over all S steps
// the two sums would be long and nearly cancel in f32).
//
// What bounds it: the function reads r, k, v, lw and do and writes dr,
// dk, dv and dlw (nine (B, S, H, N) f32 tensors, 0.185 ms of bytes at
// rwkv6-1.6b's training shape), against 12 N^2 flops per (batch, head,
// step): the S and dS recurrences and the products S do, dS v and
// dS^T k (0.192 ms at the FP32 peak).  Operations bound it, and the walk
// along S, one step after another, keeps this simple form well above
// that.
//
// Design: state passing over the forward's chunks of L steps, reusing the
// chunk states S_in_c that the forward leaves in its scratch (the wrapper
// saves them for the backward):
//   1. wkv6_bwd_local: one CTA a chunk but the first, N threads, thread i
//      on row i: the chunk's gradient at its start from a zero gradient at
//      its end, sum_t E_t r_t do_t^T with E_t the product of w over the
//      chunk's earlier steps, and that product over the whole chunk, d_c;
//   2. wkv6_bwd_scan: carries the gradient across chunks from the last,
//      dS_out_{c-1} = d_c dS_out_c + local_c from dS_out_last = dS_T,
//      written over the local ones (the forward's scan, reversed);
//   3. wkv6_bwd_chunk: two CTAs a chunk.  Thread i of a row CTA holds row
//      i of S: a forward walk from S_in_c emits dr and r dr' (parked in
//      dlw) and ends with rowsum(S_e . dS_e); a reverse walk from dS_out_c
//      emits dk and dlw and leaves the CTA's partial of du.  Thread j of
//      a column CTA holds column j of dS: a reverse walk from dS_out_c
//      emits dv.
// Each thread's row or column stays in registers, so every sum of a step
// is the thread's own: row sums for dr' and dk', column sums for dv.
// Steps arrive kBwdStage at a time in shared memory, w = exp(lw) taken as
// they land and the per-step dots v . do and r . (u k) formed once.  No
// atomics: the wrapper sums du's partials in a fixed order, so two calls
// give the same bits.  The padded steps of a ragged last chunk are never
// walked; w underflows to 0 as in the forward, which is exact.

constexpr int kBwdStage = 8;

// one stage of steps: r, k, v, w = exp(lw), do, and the dots of each step
template <int N>
struct BwdStage {
  float r[kBwdStage][N], k[kBwdStage][N], v[kBwdStage][N], w[kBwdStage][N],
      g[kBwdStage][N];
  float vg[kBwdStage], ruk[kBwdStage];
};

// steps [t0, t0 + nt) of this (b, h) into `st` (k, v and the dots only
// when kAll); waits for the stage before to be consumed
template <int N, bool kAll>
__device__ __forceinline__ void bwd_load(BwdStage<N>& st, const float* r,
                                         const float* k, const float* v,
                                         const float* lw, const float* g,
                                         const float* uh, long long base,
                                         long long row, int t0, int nt) {
  constexpr int kQuads = N / 4;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
#pragma unroll
  for (int e = tid; e < kBwdStage * kQuads; e += N) {
    const int tt = e / kQuads, i = 4 * (e % kQuads);
    float4 r4 = zero, k4 = zero, v4 = zero, w4 = zero, g4 = zero;
    if (tt < nt) {
      const long long idx = base + (t0 + tt) * row + i;
      const float4 l4 = load4(lw + idx);
      w4 = make_float4(expf(l4.x), expf(l4.y), expf(l4.z), expf(l4.w));
      r4 = load4(r + idx);
      g4 = load4(g + idx);
      if constexpr (kAll) {
        k4 = load4(k + idx);
        v4 = load4(v + idx);
      }
    }
    *reinterpret_cast<float4*>(&st.r[tt][i]) = r4;
    *reinterpret_cast<float4*>(&st.w[tt][i]) = w4;
    *reinterpret_cast<float4*>(&st.g[tt][i]) = g4;
    if constexpr (kAll) {
      *reinterpret_cast<float4*>(&st.k[tt][i]) = k4;
      *reinterpret_cast<float4*>(&st.v[tt][i]) = v4;
    }
  }
  __syncthreads();
  if constexpr (kAll) {
    if (tid < 2 * kBwdStage) {
      const int tt = tid % kBwdStage;
      float a = 0.f;
      if (tid < kBwdStage) {
        for (int i = 0; i < N; ++i) a = fmaf(st.v[tt][i], st.g[tt][i], a);
        st.vg[tt] = a;
      } else {
        for (int i = 0; i < N; ++i)
          a = fmaf(st.r[tt][i] * uh[i], st.k[tt][i], a);
        st.ruk[tt] = a;
      }
    }
    __syncthreads();
  }
}

// Pass 1: each chunk's gradient at its start from a zero end gradient and
// its decay product; the first chunk's is never read and is skipped.
template <int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_local(const float* __restrict__ r, const float* __restrict__ lw,
               const float* __restrict__ g, float* __restrict__ dchunks,
               float* __restrict__ chunk_decay, int S, int H, int L,
               int n_chunks) {
  __shared__ __align__(16) BwdStage<N> st;
  const int i = threadIdx.x;
  const int bhc = blockIdx.x;
  const int bh = bhc / n_chunks, c = bhc - bh * n_chunks;
  if (c == 0) return;
  const int b = bh / H, h = bh - b * H;
  const long long row = static_cast<long long>(H) * N;
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * N;
  const int c0 = c * L, c1 = min(S, c0 + L);
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  float e = 1.f;  // row i's product of w over the chunk's earlier steps
  for (int t0 = c0; t0 < c1; t0 += kBwdStage) {
    const int nt = min(kBwdStage, c1 - t0);
    bwd_load<N, false>(st, r, nullptr, nullptr, lw, g, nullptr, base, row,
                       t0, nt);
    for (int tt = 0; tt < nt; ++tt) {
      const float re = st.r[tt][i] * e;
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(&st.g[tt][j]);
        acc[j] = fmaf(re, g4.x, acc[j]);
        acc[j + 1] = fmaf(re, g4.y, acc[j + 1]);
        acc[j + 2] = fmaf(re, g4.z, acc[j + 2]);
        acc[j + 3] = fmaf(re, g4.w, acc[j + 3]);
      }
      e *= st.w[tt][i];
    }
  }
  float* out = dchunks + static_cast<long long>(bhc) * N * N + i * N;
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(out + j) =
        make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  chunk_decay[static_cast<long long>(bhc) * N + i] = e;
}

// Pass 2: dS_out_{c-1} = d_c[i] dS_out_c + local_c from the last chunk,
// four columns of one row per thread; dchunks' local gradients are
// overwritten with dS_out_c.  dstate may be null (zero).
template <int N>
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_scan(float* __restrict__ dchunks,
              const float* __restrict__ chunk_decay,
              const float* __restrict__ dstate, int BH, int n_chunks) {
  constexpr int kQuads = N * N / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * kScanThreads +
                        threadIdx.x;
  if (idx >= static_cast<long long>(BH) * kQuads) return;
  const int bh = static_cast<int>(idx / kQuads);
  const int e = 4 * static_cast<int>(idx % kQuads);
  const int i = e / N;
  float4* const cs = reinterpret_cast<float4*>(
      dchunks + static_cast<long long>(bh) * n_chunks * N * N + e);
  const float* const dec = chunk_decay +
                           static_cast<long long>(bh) * n_chunks * N + i;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstate) {
    const float* ds = dstate + static_cast<long long>(bh) * N * N + e;
    carry = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
  for (int c = n_chunks - 1; c > 0; --c) {
    const float4 loc = cs[c * kQuads];
    const float d = dec[c * N];
    cs[c * kQuads] = carry;
    carry = make_float4(fmaf(d, carry.x, loc.x), fmaf(d, carry.y, loc.y),
                        fmaf(d, carry.z, loc.z), fmaf(d, carry.w, loc.w));
  }
  cs[0] = carry;
}

// Pass 3: the gradients, two CTAs a chunk (rows first, then columns).
template <int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ g,
               const float* __restrict__ chunk_state,
               const float* __restrict__ dchunks, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dlw, float* __restrict__ du_part, int S,
               int H, int L, int n_chunks) {
  __shared__ __align__(16) BwdStage<N> st;
  const int n_ctas = gridDim.x / 2;
  const bool cols = static_cast<int>(blockIdx.x) >= n_ctas;
  const int bhc = blockIdx.x - (cols ? n_ctas : 0);
  const int bh = bhc / n_chunks, c = bhc - bh * n_chunks;
  const int b = bh / H, h = bh - b * H;
  const long long row = static_cast<long long>(H) * N;
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * N;
  const int c0 = c * L, c1 = min(S, c0 + L);
  const int n_stages = (c1 - c0 + kBwdStage - 1) / kBwdStage;
  const float* const uh = u + h * N;
  const float* const s_in = chunk_state + static_cast<long long>(bhc) * N * N;
  const float* const ds_out = dchunks + static_cast<long long>(bhc) * N * N;
  const int tid = threadIdx.x;
  float x[N];  // row tid of S or dS, or column tid of dS

  if (!cols) {
    const int i = tid;
    const float ui = uh[i];
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 s4 = load4(s_in + i * N + j);
      x[j] = s4.x; x[j + 1] = s4.y; x[j + 2] = s4.z; x[j + 3] = s4.w;
    }
    float du_acc = 0.f;
    // forward walk from S_in_c: dr, and r dr' parked in dlw
    for (int sg = 0; sg < n_stages; ++sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<N, true>(st, r, k, v, lw, g, uh, base, row, t0, nt);
      for (int tt = 0; tt < nt; ++tt) {
        const float ri = st.r[tt][i], ki = st.k[tt][i], wi = st.w[tt][i];
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(&st.g[tt][j]);
          const float4 v4 = *reinterpret_cast<const float4*>(&st.v[tt][j]);
          a[0] = fmaf(x[j], g4.x, a[0]);
          a[1] = fmaf(x[j + 1], g4.y, a[1]);
          a[2] = fmaf(x[j + 2], g4.z, a[2]);
          a[3] = fmaf(x[j + 3], g4.w, a[3]);
          x[j] = fmaf(wi, x[j], ki * v4.x);
          x[j + 1] = fmaf(wi, x[j + 1], ki * v4.y);
          x[j + 2] = fmaf(wi, x[j + 2], ki * v4.z);
          x[j + 3] = fmaf(wi, x[j + 3], ki * v4.w);
        }
        const float drp = (a[0] + a[1]) + (a[2] + a[3]);
        const float vg = st.vg[tt];
        const long long idx = base + (t0 + tt) * row + i;
        dr[idx] = fmaf(ui * ki, vg, drp);
        dlw[idx] = ri * drp;
        du_acc = fmaf(ri * ki, vg, du_acc);
      }
    }
    // rowsum(S_e . dS_e), and x becomes row i of dS_out_c
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 d4 = load4(ds_out + i * N + j);
      p[0] = fmaf(x[j], d4.x, p[0]);
      p[1] = fmaf(x[j + 1], d4.y, p[1]);
      p[2] = fmaf(x[j + 2], d4.z, p[2]);
      p[3] = fmaf(x[j + 3], d4.w, p[3]);
      x[j] = d4.x; x[j + 1] = d4.y; x[j + 2] = d4.z; x[j + 3] = d4.w;
    }
    float run = (p[0] + p[1]) + (p[2] + p[3]);
    // reverse walk from dS_out_c: dk and dlw
    for (int sg = n_stages - 1; sg >= 0; --sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<N, true>(st, r, k, v, lw, g, uh, base, row, t0, nt);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float ri = st.r[tt][i], ki = st.k[tt][i], wi = st.w[tt][i];
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(&st.g[tt][j]);
          const float4 v4 = *reinterpret_cast<const float4*>(&st.v[tt][j]);
          a[0] = fmaf(x[j], v4.x, a[0]);
          a[1] = fmaf(x[j + 1], v4.y, a[1]);
          a[2] = fmaf(x[j + 2], v4.z, a[2]);
          a[3] = fmaf(x[j + 3], v4.w, a[3]);
          x[j] = fmaf(wi, x[j], ri * g4.x);
          x[j + 1] = fmaf(wi, x[j + 1], ri * g4.y);
          x[j + 2] = fmaf(wi, x[j + 2], ri * g4.z);
          x[j + 3] = fmaf(wi, x[j + 3], ri * g4.w);
        }
        const float dkp = (a[0] + a[1]) + (a[2] + a[3]);
        const long long idx = base + (t0 + tt) * row + i;
        dk[idx] = fmaf(ui * ri, st.vg[tt], dkp);
        const float term = dlw[idx];  // r dr', this thread's own write
        const float glw = fmaf(-ki, dkp, run);
        dlw[idx] = glw;
        run = glw + term;
      }
    }
    du_part[static_cast<long long>(bhc) * N + i] = du_acc;
  } else {
    const int j = tid;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = ds_out[i * N + j];
    // reverse walk from dS_out_c: dv
    for (int sg = n_stages - 1; sg >= 0; --sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<N, true>(st, r, k, v, lw, g, uh, base, row, t0, nt);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float gj = st.g[tt][j];
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < N; i += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(&st.k[tt][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&st.w[tt][i]);
          const float4 r4 = *reinterpret_cast<const float4*>(&st.r[tt][i]);
          a[0] = fmaf(x[i], k4.x, a[0]);
          a[1] = fmaf(x[i + 1], k4.y, a[1]);
          a[2] = fmaf(x[i + 2], k4.z, a[2]);
          a[3] = fmaf(x[i + 3], k4.w, a[3]);
          x[i] = fmaf(w4.x, x[i], r4.x * gj);
          x[i + 1] = fmaf(w4.y, x[i + 1], r4.y * gj);
          x[i + 2] = fmaf(w4.z, x[i + 2], r4.z * gj);
          x[i + 3] = fmaf(w4.w, x[i + 3], r4.w * gj);
        }
        const float dvp = (a[0] + a[1]) + (a[2] + a[3]);
        dv[base + (t0 + tt) * row + j] = fmaf(st.ruk[tt], gj, dvp);
      }
    }
  }
}

template <int N>
int wkv6_bwd_launch_n(const float* r, const float* k, const float* v,
                      const float* lw, const float* u, const float* cs,
                      const float* g, const float* dstate, float* dr,
                      float* dk, float* dv, float* dlw, float* du_part,
                      float* dchunks, float* chunk_decay, int B, int S,
                      int H, int L, cudaStream_t s) {
  const int n_chunks = (S + L - 1) / L;
  const long long ctas = static_cast<long long>(B) * H * n_chunks;
  if (ctas == 0) return 0;
  cudaError_t err;
  if (n_chunks > 1) {
    wkv6_bwd_local<N><<<static_cast<unsigned>(ctas), N, 0, s>>>(
        r, lw, g, dchunks, chunk_decay, S, H, L, n_chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const long long scan_threads = static_cast<long long>(B) * H * N * N / 4;
  wkv6_bwd_scan<N>
      <<<static_cast<unsigned>((scan_threads + kScanThreads - 1) /
                               kScanThreads),
         kScanThreads, 0, s>>>(dchunks, chunk_decay, dstate, B * H,
                               n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_chunk<N><<<static_cast<unsigned>(2 * ctas), N, 0, s>>>(
      r, k, v, lw, u, g, cs, dchunks, dr, dk, dv, dlw, du_part, S, H, L,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, o: contiguous (B, S, H, N) of the named type and lw:
// contiguous (B, S, H, N) f32 (<= 0), each 16-byte aligned; u: (H, N)
// f32; state: (B, H, N, N) f32 out; chunk_state: (B, H, ceil(S / L), N, N)
// f32 and chunk_decay: (B, H, ceil(S / L), N) f32 scratch; L: steps per
// chunk (>= 1).
int wkv6_f32(const void* r, const void* k, const void* v, const void* lw,
             const void* u, void* o, void* state, void* chunk_state,
             void* chunk_decay, int B, int S, int H, int N, int L,
             int device, void* stream) {
  return wkv6_launch<float>(r, k, v, lw, u, o, state, chunk_state,
                            chunk_decay, B, S, H, N, L, device, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* o, void* state, void* chunk_state,
              void* chunk_decay, int B, int S, int H, int N, int L,
              int device, void* stream) {
  return wkv6_launch<__nv_bfloat16>(r, k, v, lw, u, o, state, chunk_state,
                                    chunk_decay, B, S, H, N, L, device,
                                    stream);
}

// The backward, f32 only.  r, k, v, lw, do (g): contiguous (B, S, H, N)
// f32, each 16-byte aligned; u: (H, N); chunk_state: the forward's
// (B, H, ceil(S / L), N, N) chunk states at the same L; dstate: (B, H, N,
// N) or null (zero); dr, dk, dv, dlw: (B, S, H, N) out; du_part: (B, H,
// ceil(S / L), N) out (the wrapper sums it); dchunks: (B, H, ceil(S / L),
// N, N) and chunk_decay (B, H, ceil(S / L), N) f32 scratch.
int wkv6_backward_f32(const void* r, const void* k, const void* v,
                      const void* lw, const void* u, const void* chunk_state,
                      const void* g, const void* dstate, void* dr, void* dk,
                      void* dv, void* dlw, void* du_part, void* dchunks,
                      void* chunk_decay, int B, int S, int H, int N, int L,
                      int device, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[] = {
      static_cast<const float*>(r),  static_cast<const float*>(k),
      static_cast<const float*>(v),  static_cast<const float*>(lw),
      static_cast<const float*>(u),  static_cast<const float*>(chunk_state),
      static_cast<const float*>(g),  static_cast<const float*>(dstate)};
  float* outs[] = {static_cast<float*>(dr),      static_cast<float*>(dk),
                   static_cast<float*>(dv),      static_cast<float*>(dlw),
                   static_cast<float*>(du_part), static_cast<float*>(dchunks),
                   static_cast<float*>(chunk_decay)};
#define WKV6_BWD(NN)                                                        \
  wkv6_bwd_launch_n<NN>(args[0], args[1], args[2], args[3], args[4],        \
                        args[5], args[6], args[7], outs[0], outs[1],        \
                        outs[2], outs[3], outs[4], outs[5], outs[6], B, S,  \
                        H, L, s)
  switch (N) {
    case 16: return WKV6_BWD(16);
    case 32: return WKV6_BWD(32);
    case 64: return WKV6_BWD(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD
}

}  // extern "C"
