// Hand-written Hopper (sm_90a) RWKV6 WKV recurrence, with a plain C
// interface bound from Python through ctypes (repro_torch/kernels/wkv6.py).
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.
//
// Replaces the TPU kernel repro/kernels/wkv6.py wkv6_pallas (body
// _wkv6_kernel): per (batch, head), from a zero (N, N) state S,
//     o_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//     S[i, j] = exp(lw_t[i]) S[i, j] + k_t[i] v_t[j]
// returning o (in r's type) and the final state (f32).  The TPU kernel
// evaluates it in chunks of 64 with tile-referenced exponents so that its
// matrix unit does the work; this kernel runs the exact recurrence, which
// the chunked form equals up to f32 rounding.  exp(lw) underflows to 0
// for very negative lw, which is the right value: nothing is rescaled.
//
// What bounds it here: the sequential dependence along S.  The work is
// ~5 N^2 flops per (batch, head, step) against 4 N inputs read and N
// outputs written, so neither the card's bytes nor its flops bound it:
// each CTA walks its S steps one after another, and only B * H CTAs run.
//
// Design: one CTA of N threads per (batch, head); thread j keeps column j
// of the f32 state in N registers.  Steps go in chunks of 32: the CTA
// loads the chunk's r, k, v and w = exp(lw) into shared memory with
// coalesced row reads, and computes each step's bonus sum_i r u k once
// (one thread per step), so the step loop itself has no barrier and reads
// shared memory only as 16-byte broadcasts.  N is a template parameter
// (16, 32 or 64) so that the state stays in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // steps staged per shared-memory fill

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ state_out, int S, int H) {
  __shared__ __align__(16) float s_r[kChunk][N];
  __shared__ __align__(16) float s_k[kChunk][N];
  __shared__ __align__(16) float s_w[kChunk][N];
  __shared__ __align__(16) float s_v[kChunk][N];
  __shared__ float s_u[N];
  __shared__ float s_bonus[kChunk];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;
  const long long row = static_cast<long long>(H) * N;  // one step's stride
  const long long base = static_cast<long long>(b) * S * row +
                         static_cast<long long>(h) * N + j;

  s_u[j] = u[h * N + j];
  float st[N];
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int nt = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int tt = 0; tt < nt; ++tt) {
      const long long idx = base + (t0 + tt) * row;
      s_r[tt][j] = to_f32(r[idx]);
      s_k[tt][j] = to_f32(k[idx]);
      s_v[tt][j] = to_f32(v[idx]);
      s_w[tt][j] = expf(lw[idx]);
    }
    __syncthreads();
    for (int tt = j; tt < nt; tt += N) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) a = fmaf(s_r[tt][i] * s_u[i], s_k[tt][i], a);
      s_bonus[tt] = a;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = s_v[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&s_w[tt][i]);
        acc[0] = fmaf(r4.x, st[i + 0], acc[0]);
        acc[1] = fmaf(r4.y, st[i + 1], acc[1]);
        acc[2] = fmaf(r4.z, st[i + 2], acc[2]);
        acc[3] = fmaf(r4.w, st[i + 3], acc[3]);
        st[i + 0] = fmaf(w4.x, st[i + 0], k4.x * vj);
        st[i + 1] = fmaf(w4.y, st[i + 1], k4.y * vj);
        st[i + 2] = fmaf(w4.z, st[i + 2], k4.z * vj);
        st[i + 3] = fmaf(w4.w, st[i + 3], k4.w * vj);
      }
      const float out = (acc[0] + acc[1]) + (acc[2] + acc[3]) +
                        s_bonus[tt] * vj;
      store(o + base + (t0 + tt) * row, out);
    }
  }

  float* sb = state_out + static_cast<long long>(bh) * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) sb[i * N] = st[i];
}

template <typename T, int N>
int wkv6_launch_n(const void* r, const void* k, const void* v, const void* lw,
                  const void* u, void* o, void* state, int B, int S, int H,
                  cudaStream_t s) {
  wkv6_kernel<T, N><<<B * H, N, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<T*>(o),
      static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* o, void* state, int B, int S, int H,
                int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return wkv6_launch_n<T, 16>(r, k, v, lw, u, o, state, B, S, H, s);
    case 32: return wkv6_launch_n<T, 32>(r, k, v, lw, u, o, state, B, S, H, s);
    case 64: return wkv6_launch_n<T, 64>(r, k, v, lw, u, o, state, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, v, o: contiguous (B, S, H, N) of the named type; lw: contiguous
// (B, S, H, N) f32 (<= 0); u: (H, N) f32; state: (B, H, N, N) f32 out.
int wkv6_f32(const void* r, const void* k, const void* v, const void* lw,
             const void* u, void* o, void* state, int B, int S, int H, int N,
             int device, void* stream) {
  return wkv6_launch<float>(r, k, v, lw, u, o, state, B, S, H, N, device,
                            stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* o, void* state, int B, int S, int H, int N,
              int device, void* stream) {
  return wkv6_launch<__nv_bfloat16>(r, k, v, lw, u, o, state, B, S, H, N,
                                    device, stream);
}

}  // extern "C"
