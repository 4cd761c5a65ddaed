// Hand-written Hopper (sm_90a) forward flash attention, with a plain C
// interface bound from Python through ctypes
// (repro_torch/kernels/flash_attention.py).  Every entry point launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// flash_attention_pallas (body _flash_kernel): causal or full attention
// with GQA (query head h reads kv head h / (H / KV), no KV replication),
// an optional sliding window (key c is visible to query row r iff
// c > r - window), keys aligned to the end (q_off = Sk - Sq), Dk != Dv
// allowed, float32 running max / sum / accumulator, output in q's type.
//
// What bounds it here: operations.  At the serving shapes (S = 2048,
// D = 128) it does ~4 D flops per visible (query, key) pair against
// ~(2 D + 2 Dv) bytes per query row and key row, far above the card's
// flops-per-byte balance point.  This first version keeps the f32
// products on the CUDA cores (no wgmma / TMA / warp specialisation yet),
// so its ceiling is the card's FP32 rate, not the tensor cores'.
//
// Design: one CTA of 256 threads per (batch * query head, 64-row query
// tile); heavy (late, causal) tiles are launched first.  The query tile
// is staged once in shared memory (pre-scaled, f32); K and V tiles of 64
// rows take turns in one shared buffer.  Thread (ty, tx) of a 16 x 16
// grid owns query rows ty + 16 i and key columns tx + 16 j (i, j < 4) of
// the score tile, and output columns 4 tx + 64 jj (+0..3) of its rows:
// every shared read is a 16-byte vector, the query/P reads broadcast, the
// K/V reads conflict-free (row pitch of 4 * odd floats).  Row max and sum
// reduce over the 16 lanes of a half warp with shuffles.  Key tiles that
// the causal mask or the window empties for the whole query tile are
// skipped (the reference visits them and adds exact zeros); rows and keys
// past the ragged end are masked, their tiles zero-filled, so any S
// works.  Shared memory: (64 pitch(D) + 64 max(pitch(D), pitch(Dv)) +
// 64 * 68) floats, 84,992 bytes at D = Dv = 128 — two CTAs per SM,
// above the 48 KB default, so the launcher raises the kernel's
// dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 128;
constexpr int kLdP = kBK + 4;  // P tile pitch (68 = 4 * 17)
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Strides {  // element strides of the (B, S, H, D) operands
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared-memory row pitch: D rounded to 4 floats, padded so that pitch/4
// is odd — 16-byte reads of 8 consecutive rows then hit distinct banks
__host__ __device__ __forceinline__ int pitch(int d) {
  const int p = (d + 3) / 4 * 4 + 4;
  return ((p / 4) % 2 == 1) ? p : p + 4;
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int s = row0 + r;
    dst[r * ld + c] =
        s < n_rows ? to_f32(src[static_cast<long long>(s) * row_stride + c]) *
                         mul
                   : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, int D, int Dv, Strides st, float scale,
                 int causal, int window) {
  extern __shared__ float4 smem4[];
  const int ldk = pitch(D), ldv = pitch(Dv);
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * ldk;
  float* sP = sKV + kBK * (ldk > ldv ? ldk : ldv);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int q_off = Sk - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  T* ob = o + b * st.o_b + h * st.o_h;

  load_tile(sQ, ldk, qb, st.q_s, q0, Sq, D, scale);

  // key range that can be visible to some row of this tile
  const int q_last = min(q0 + kBQ, Sq) - 1 + q_off;  // in key positions
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window ? max(0, q0 + q_off - window + 1) : 0;

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with sKV and sP
    load_tile(sKV, ldk, kb, st.k_s, k0, Sk, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * ldk + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i + q_off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window) ok = ok && col > row - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // scores done with K; P written
    load_tile(sKV, ldv, vb, st.v_s, k0, Sk, Dv, 1.f);
    __syncthreads();

    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kLdP + kk);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 4 * tx + 64 * jj;
        if (col < Dv) {
          const float4 v0 = *reinterpret_cast<const float4*>(sKV + (kk + 0) * ldv + col);
          const float4 v1 = *reinterpret_cast<const float4*>(sKV + (kk + 1) * ldv + col);
          const float4 v2 = *reinterpret_cast<const float4*>(sKV + (kk + 2) * ldv + col);
          const float4 v3 = *reinterpret_cast<const float4*>(sKV + (kk + 3) * ldv + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i] + 4 * jj;
            a[0] = fmaf(pa[i].x, v0.x, a[0]);
            a[1] = fmaf(pa[i].x, v0.y, a[1]);
            a[2] = fmaf(pa[i].x, v0.z, a[2]);
            a[3] = fmaf(pa[i].x, v0.w, a[3]);
            a[0] = fmaf(pa[i].y, v1.x, a[0]);
            a[1] = fmaf(pa[i].y, v1.y, a[1]);
            a[2] = fmaf(pa[i].y, v1.z, a[2]);
            a[3] = fmaf(pa[i].y, v1.w, a[3]);
            a[0] = fmaf(pa[i].z, v2.x, a[0]);
            a[1] = fmaf(pa[i].z, v2.y, a[1]);
            a[2] = fmaf(pa[i].z, v2.z, a[2]);
            a[3] = fmaf(pa[i].z, v2.w, a[3]);
            a[0] = fmaf(pa[i].w, v3.x, a[0]);
            a[1] = fmaf(pa[i].w, v3.y, a[1]);
            a[2] = fmaf(pa[i].w, v3.z, a[2]);
            a[3] = fmaf(pa[i].w, v3.w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    T* orow = ob + static_cast<long long>(row) * st.o_s;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = 4 * tx + 64 * jj;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < Dv) store(orow + col + c, acc[i][4 * jj + c] / denom);
    }
  }
}

template <typename T>
int flash_launch(const void* q, const void* k, const void* v, void* o,
                 const long long* strides, int B, int H, int KV, int Sq,
                 int Sk, int D, int Dv, float scale, int causal, int window,
                 int device, void* stream) {
  if (D > kMaxD || Dv > kMaxD || D % 4 || Dv % 4 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st;
  long long* f = &st.q_b;
  for (int i = 0; i < 12; ++i) f[i] = strides[i];
  const int ldk = pitch(D), ldv = pitch(Dv);
  const size_t smem = sizeof(float) *
      static_cast<size_t>(kBQ * ldk + kBK * (ldk > ldv ? ldk : ldv) +
                          kBQ * kLdP);
  err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, D, Dv, st,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 12 element strides (batch, seq, head) of q, k, v, o in turn;
// the last axis of every operand is contiguous.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int B, int H, int KV,
                        int Sq, int Sk, int D, int Dv, float scale,
                        int causal, int window, int device, void* stream) {
  return flash_launch<float>(q, k, v, o, strides, B, H, KV, Sq, Sk, D, Dv,
                             scale, causal, window, device, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int B, int H,
                         int KV, int Sq, int Sk, int D, int Dv, float scale,
                         int causal, int window, int device, void* stream) {
  return flash_launch<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, Sq, Sk,
                                     D, Dv, scale, causal, window, device,
                                     stream);
}

}  // extern "C"
