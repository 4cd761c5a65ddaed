// Hand-written Hopper (sm_90a) Mamba2 SSD scan, with a plain C interface
// bound from Python through ctypes (repro_torch/kernels/ssd.py).  Every
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the first CUDA error so the wrapper can raise
// on a refused launch.
//
// Replaces the TPU kernel repro/kernels/ssd.py ssd_pallas (body
// _ssd_kernel): per (batch, head h, group g = h / (H / G)), walking the
// sequence in chunks of Q steps with the (P, N) state S carried across
// chunks, from the initial state (zero unless one is given):
//     dac_t = sum_{u <= t} dt_u a                   (in-chunk, <= 0)
//     y_t   = sum_{s <= t} (C_t . B_s) exp(dac_t - dac_s) dt_s x_s
//             + exp(dac_t) S C_t + d x_t
//     S'    = exp(dac_Q) S + sum_s dt_s exp(dac_Q - dac_s) x_s B_s^T
// returning y (in x's type) and the final state (f32).  Every exponent is
// <= 0 (dt >= 0 after softplus, a < 0); entries above the diagonal are
// masked before the exp, as _ssd_kernel does.  exp may underflow to 0,
// which is the right value: nothing is rescaled.  The in-chunk cumulative
// decay is summed and differenced in float64: as a float32 cumsum it
// reaches hundreds within a chunk under strong decay, and the difference
// of two such sums loses the digits that exp(dac_t - dac_s) needs near
// the diagonal (the float32 chunked form at the config's chunk of 256
// comes near the reference's tolerance at S = 2048 for that reason).
// The kernel's chunk (Q = 64) is its own, not the config's: the result
// differs from the reference only in rounding and summation order.
//
// What bounds it here: operations.  The exact recurrence is 4 P N flops
// per (batch, head, step) against ~(2 P + 2 N + 1) values moved, far above
// the card's flops-per-byte balance; the chunked form does about twice
// those flops so that they are products.  This first version runs them in
// f32 on the CUDA cores (no wgmma yet), so its ceiling is the FP32 rate.
//
// Design: one CTA of 256 threads per (batch, head) walks the chunks in
// order, as the TPU grid (B * H, nc) does along its sequential chunk axis.
// Per chunk it stages x (Q x P), C (Q x N), B transposed (N x Q) and dt in
// shared memory, reading x, B and C through their strides (they are
// slices of the conv output in the model), and masks the ragged last
// chunk with x = B = C = dt = 0, which is exact.  The chunk's cumulative
// decay is one warp's scan, in float64.  Three products then run as
// 16 x 16 thread grids, each thread a register micro-tile of rows
// ty + 16 i and a contiguous column group, with 16-byte shared reads:
//   scores (Q x Q) = C B^T, masked and decayed;
//   y (Q x P)      = scores x + exp(dac) (C S^T) + d x, stored directly;
//   S^T (N x P)    = exp(dac_Q) S^T + B^T (w x),
//                    w_s = dt_s exp(dac_Q - dac_s).
// The state stays in shared memory, transposed, for the whole sequence.
// P and N are padded to tiles of 32, 64 or 128 (zero columns contribute
// nothing), so any P, N <= 128 works.  Shared memory at P = N = 64:
// 5 tiles of 64 x 68 floats and the chunk's vectors, 88 KB: above the
// 48 KB default, so the launcher raises the kernel's dynamic limit; two
// CTAs fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;         // steps per chunk
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdQ = kQ + 4;   // pitch of the Q-wide tiles (scores, B^T)

struct Strides {  // element strides (batch, seq, head|group)
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, b_g, c_b, c_s, c_g;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int CW>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[CW]) {
  if constexpr (CW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CW; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
    }
  } else {
    static_assert(CW == 2, "column groups are 2, 4 or 8 wide");
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  }
}

__device__ __forceinline__ float lane(const float4& f, int kk) {
  return kk == 0 ? f.x : kk == 1 ? f.y : kk == 2 ? f.z : f.w;
}

// acc[i][j] += sum_{k < K} A[(ty + 16 i) lda + k] w_k Bm[k ldb + tx CW + j]
// (w_k = 1 unless kScale); K, lda and ldb are multiples of 4.
template <int R, int CW, int K, bool kScale>
__device__ __forceinline__ void tile_product(float (&acc)[R][CW],
                                             const float* A, int lda,
                                             const float* Bm, int ldb,
                                             const float* w, int ty,
                                             int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[CW];
      load_cols<CW>(Bm + (k + kk) * ldb + tx * CW, bv);
      if constexpr (kScale) {
        const float wk = w[k + kk];
#pragma unroll
        for (int j = 0; j < CW; ++j) bv[j] *= wk;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float av = lane(a[i], kk);
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

template <int R, int CW>
__device__ __forceinline__ void zero(float (&acc)[R][CW]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
}

// shared-memory floats of one CTA at tile sizes PT x NT
__host__ __device__ constexpr int smem_floats(int PT, int NT) {
  return kQ * (PT + 4)      // x
         + kQ * (NT + 4)    // C
         + NT * kLdQ        // B^T
         + kQ * kLdQ        // scores
         + NT * (PT + 4)    // state^T
         + 3 * kQ           // dt, exp(dac), w
         + 2 * kQ;          // dac (float64)
}

template <typename T, int PT, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ state_out, Strides st, int S, int H, int G,
           int P, int N) {
  constexpr int kLdP = PT + 4, kLdN = NT + 4;
  constexpr int kCW = PT / 16;   // y / state column group
  constexpr int kRN = NT / 16;   // state rows per thread
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [Q][kLdP]
  float* sc = sx + kQ * kLdP;                   // [Q][kLdN]
  float* sbt = sc + kQ * kLdN;                  // [NT][kLdQ]
  float* ss = sbt + NT * kLdQ;                  // [Q][kLdQ]
  float* sst = ss + kQ * kLdQ;                  // [NT][kLdP]: S^T
  float* sdt = sst + NT * kLdP;                 // [Q]
  float* sexp = sdt + kQ;
  float* sw = sexp + kQ;
  double* sdac = reinterpret_cast<double*>(sw + kQ);  // 8-byte aligned

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float ah = a[h];
  const float dh = d_skip ? d_skip[h] : 0.f;
  const T* xb = x + b * st.x_b + h * st.x_h;
  const T* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = bm + b * st.b_b + g * st.b_g;
  const T* cb = cm + b * st.c_b + g * st.c_g;
  const long long y_s = static_cast<long long>(H) * P;  // y is contiguous
  T* yb = y + static_cast<long long>(b) * S * y_s +
          static_cast<long long>(h) * P;
  const long long s_off = static_cast<long long>(bh) * P * N;

  for (int idx = tid; idx < NT * kLdP; idx += kThreads) {
    const int n = idx / kLdP, p = idx - n * kLdP;
    sst[idx] = (init && n < N && p < P) ? init[s_off + p * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int nt = min(kQ, S - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int idx = tid; idx < kQ * PT; idx += kThreads) {
      const int t = idx / PT, p = idx - t * PT;
      sx[t * kLdP + p] = (t < nt && p < P)
                             ? to_f32(xb[(t0 + t) * st.x_s + p]) : 0.f;
    }
    for (int idx = tid; idx < kQ * NT; idx += kThreads) {
      const int t = idx / NT, n = idx - t * NT;
      const bool in = t < nt && n < N;
      sc[t * kLdN + n] = in ? to_f32(cb[(t0 + t) * st.c_s + n]) : 0.f;
      sbt[n * kLdQ + t] = in ? to_f32(bb[(t0 + t) * st.b_s + n]) : 0.f;
    }
    if (tid < kQ)
      sdt[tid] = tid < nt ? to_f32(dtb[(t0 + tid) * st.dt_s]) : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive scan of dt * a in float64, two steps a lane
      const double d0 = static_cast<double>(sdt[2 * tid]) * ah;
      const double d1 = static_cast<double>(sdt[2 * tid + 1]) * ah;
      double inc = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += v;
      }
      const double excl = __shfl_up_sync(0xffffffffu, inc, 1);
      sdac[2 * tid] = (tid ? excl : 0.0) + d0;
      sdac[2 * tid + 1] = inc;
    }
    __syncthreads();
    if (tid < kQ) {
      sexp[tid] = expf(static_cast<float>(sdac[tid]));
      sw[tid] = sdt[tid] *
                expf(static_cast<float>(sdac[kQ - 1] - sdac[tid]));
    }
    {  // scores[t][s] = C_t . B_s exp(dac_t - dac_s) dt_s for s <= t
      float acc[4][4];
      zero(acc);
      tile_product<4, 4, NT, false>(acc, sc, kLdN, sbt, kLdQ, nullptr, ty,
                                    tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx * 4 + j;
          ss[t * kLdQ + s] =
              s <= t ? acc[i][j] *
                           expf(static_cast<float>(sdac[t] - sdac[s])) *
                           sdt[s]
                     : 0.f;
        }
      }
    }
    __syncthreads();
    {  // y = scores x + exp(dac) (C S^T) + d x
      float diag[4][kCW], off[4][kCW];
      zero(diag);
      zero(off);
      tile_product<4, kCW, kQ, false>(diag, ss, kLdQ, sx, kLdP, nullptr, ty,
                                      tx);
      tile_product<4, kCW, NT, false>(off, sc, kLdN, sst, kLdP, nullptr, ty,
                                      tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
        T* yrow = yb + (t0 + t) * y_s;
#pragma unroll
        for (int j = 0; j < kCW; ++j) {
          const int p = tx * kCW + j;
          if (p < P)
            store(yrow + p, diag[i][j] + sexp[t] * off[i][j] +
                                dh * sx[t * kLdP + p]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done
    {  // S^T = exp(dac_Q) S^T + B^T (w x)
      float acc[kRN][kCW];
      zero(acc);
      tile_product<kRN, kCW, kQ, true>(acc, sbt, kLdQ, sx, kLdP, sw, ty, tx);
      const float decay = sexp[kQ - 1];
#pragma unroll
      for (int i = 0; i < kRN; ++i) {
        float* row = sst + (ty + 16 * i) * kLdP + tx * kCW;
#pragma unroll
        for (int j = 0; j < kCW; ++j) row[j] = fmaf(decay, row[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    state_out[s_off + idx] = sst[n * kLdP + p];
  }
}

template <typename T, int PT, int NT>
int ssd_launch_tiles(const void* x, const void* dt, const void* a,
                     const void* b, const void* c, const void* d_skip,
                     const void* init, void* y, void* state,
                     const Strides& st, int B, int S, int H, int G, int P,
                     int N, cudaStream_t s) {
  const int smem = smem_floats(PT, NT) * static_cast<int>(sizeof(float));
  auto kernel = ssd_kernel<T, PT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(state), st, S, H, G, P, N);
  return static_cast<int>(cudaGetLastError());
}

inline int tile_of(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <typename T, int PT>
int ssd_launch_p(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, const void* d_skip, const void* init,
                 void* y, void* state, const Strides& st, int B, int S, int H,
                 int G, int P, int N, cudaStream_t s) {
  switch (tile_of(N)) {
    case 32: return ssd_launch_tiles<T, PT, 32>(x, dt, a, b, c, d_skip, init,
                                                y, state, st, B, S, H, G, P,
                                                N, s);
    case 64: return ssd_launch_tiles<T, PT, 64>(x, dt, a, b, c, d_skip, init,
                                                y, state, st, B, S, H, G, P,
                                                N, s);
    default: return ssd_launch_tiles<T, PT, 128>(x, dt, a, b, c, d_skip,
                                                 init, y, state, st, B, S, H,
                                                 G, P, N, s);
  }
}

template <typename T>
int ssd_launch(const void* x, const void* dt, const void* a, const void* b,
               const void* c, const void* d_skip, const void* init, void* y,
               void* state, const long long* strides, int B, int S, int H,
               int G, int P, int N, int device, void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_of(P)) {
    case 32: return ssd_launch_p<T, 32>(x, dt, a, b, c, d_skip, init, y,
                                        state, st, B, S, H, G, P, N, s);
    case 64: return ssd_launch_p<T, 64>(x, dt, a, b, c, d_skip, init, y,
                                        state, st, B, S, H, G, P, N, s);
    default: return ssd_launch_p<T, 128>(x, dt, a, b, c, d_skip, init, y,
                                         state, st, B, S, H, G, P, N, s);
  }
}

}  // namespace

extern "C" {

// x: (B, S, H, P), dt: (B, S, H), b/c: (B, S, G, N), all of the named type
// and read through strides (12 element strides: batch, seq, head|group of
// x, dt, b, c in turn; the last axis of x, b and c contiguous); a, d_skip:
// (H,) f32 (d_skip may be null: no skip term); init: contiguous (B, H, P,
// N) f32 or null (zero); y: contiguous (B, S, H, P) out; state: contiguous
// (B, H, P, N) f32 out.
int ssd_f32(const void* x, const void* dt, const void* a, const void* b,
            const void* c, const void* d_skip, const void* init, void* y,
            void* state, const long long* strides, int B, int S, int H,
            int G, int P, int N, int device, void* stream) {
  return ssd_launch<float>(x, dt, a, b, c, d_skip, init, y, state, strides,
                           B, S, H, G, P, N, device, stream);
}

int ssd_bf16(const void* x, const void* dt, const void* a, const void* b,
             const void* c, const void* d_skip, const void* init, void* y,
             void* state, const long long* strides, int B, int S, int H,
             int G, int P, int N, int device, void* stream) {
  return ssd_launch<__nv_bfloat16>(x, dt, a, b, c, d_skip, init, y, state,
                                   strides, B, S, H, G, P, N, device, stream);
}

}  // extern "C"
