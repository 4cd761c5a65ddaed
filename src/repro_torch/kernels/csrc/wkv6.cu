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

}  // extern "C"
