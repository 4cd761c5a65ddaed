// Hand-written Hopper (sm_90a) Mamba2 SSD scan on the tensor cores, with
// a plain C interface bound from Python through ctypes
// (repro_torch/kernels/ssd.py).  Every entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the first CUDA error so the wrapper can raise on a refused launch.
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
// the diagonal.  The kernel's chunk (Q = 64) is its own, not the
// config's: the result differs from the reference only in rounding and
// summation order.
//
// What bounds it: at zamba2-1.2b's shape (B 4, S 2048, H 64, P = N = 64)
// the chunked form's four products (C B^T, scores x, C S^T and the state
// update; 14 GFLOP with the tiles above the diagonal skipped) against
// ~280 MB of x, y, B, C and dt.  As three TF32 products each (42 GFLOP)
// at the data sheet's 495 TFLOP/s, a rate quoted for wgmma, they would
// take about as long as the bytes at 3.35 TB/s.  mma.sync runs far below
// it: on an H100 this kernel issues 24.4 M m16n8k8 TF32 mma (50 GFLOP,
// C B^T recomputed per P slice) in about 0.57 ms of its 0.79, ~90
// TFLOP/s, ~110 with the split's arithmetic taken out (the f32 flash
// kernel's reach ~137).  So the mma count bounds it, with the copies, the
// decay and the stores on top; tools/ssd_breakdown.py times each part.
//
// What the design does about it:
// - Products on the tensor cores as 3xTF32 mma.sync.m16n8k8 with f32
//   accumulation: each operand a splits into hi = rna_tf32(a) and lo =
//   rna_tf32(a - hi) (rounded with two integer operations, as the f32
//   flash kernel does), and a.b ~ lo.hi + hi.lo + hi.hi keeps
//   float32-level accuracy (one TF32 product keeps about three digits).
//   The tensor cores truncate as they accumulate, so no product lands on
//   a running sum: each 8-wide k-step's big term hi.hi goes into one
//   zeroed temporary and its two small terms into another, both then
//   added to the sum in f32 (rounded to nearest).  Accumulated in place,
//   or all three into one temporary, the truncations put zamba2-1.2b's
//   forward vs generated logits past their 1e-3 bar on an H100 (PERF.md
//   section 6).  The state update
//   likewise sums its products from zero and adds exp(dac_Q) S in one
//   fmaf.  Each k-step issues its products pass by pass over the
//   independent tiles, so no mma waits on the one before.  Score tiles
//   above the diagonal are skipped, and so are their terms in scores x.
// - P is split across CTAs: given a chunk's scores, y's columns and the
//   state's rows are independent along P, so ceil(P / PS) CTAs per
//   (batch, head) each own PS = 32 (or 16) of P's columns, recompute C B^T
//   and the decay, and re-read B, C and dt (from L2: one group serves
//   H / G heads).  At B 4, H 64, P 64 that is 512 CTAs of 4 warps, two per
//   SM; PS = 16 where 32 would leave the grid under two CTAs per SM (batch
//   1).  Not the three-pass chunk-parallel form: at this shape its
//   (B, H, chunks, P, N) chunk states would write and re-read 134 MB, as
//   much again as the bytes bound.
// - Loads overlap compute: a two-stage cp.async ring holds this chunk's
//   and the next chunk's x slice (Q x PS), C and B (Q x N each); the next
//   chunk's copies are issued before this chunk's products.  Warp 0 reads
//   the next chunk's dt into registers as well and, after its products
//   (it owns the fewest score tiles), scans it into the other stage of
//   the decay.  The state (PS x N, f32) is double-buffered in shared
//   memory too: a chunk reads one copy and writes the other, so one
//   barrier a chunk suffices.
//   cp.async moves 16-byte pieces, so x, B and C must start on 16 bytes
//   with strides that are multiples of 16 bytes (the wrapper copies other
//   views); a row's last piece short of 16 bytes (P or N not a multiple
//   of 4 floats or 8 bf16) is loaded element by element.  Rows past S
//   (the ragged last chunk) are zero-filled with dt = 0, which is exact.
// - The chunk's cumulative decay is one warp's float64 scan.
//
// Per chunk, warp w owns score rows t in [16 w, 16 w + 16):
//   scores (16 x 64) = C B^T for columns s <= t, decayed and masked in
//     registers; C's fragments, split once per 8-wide step of N, also feed
//   off (16 x PS)    = C S^T, in the same loop;
//   diag (16 x PS)   = scores x, with the scores' accumulator fragment
//     reused as the A fragment (A column t4 is key 2 t4, t4 + 4 is 2 t4 +
//     1, and x's B fragment is read with the same relabelling);
//   y = diag + exp(dac_t) off + d x, stored to global;
//   S'^T tiles (PS x N) = exp(dac_Q) S + (x w)^T B, w_s = dt_s exp(dac_Q -
//     dac_s), in batches of four tiles, most to the warps with the fewest
//     score tiles (StatePlan), K relabelled the same way.
// Shared tiles have row pitches of 4 mod 16 floats (f32), which makes
// every fragment read conflict-free: (row g, column t4) and (row 2 t4,
// column g) patterns alike.  N is padded to tiles of 32, 64 or 128 and the
// slice to PS columns with zeros, which contribute nothing.  Shared memory
// at PS = 32, N = 64, f32: 108 KB, two CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kQ = 64;        // steps per chunk
constexpr int kWarps = 4;     // one per 16 score rows
constexpr int kThreads = 32 * kWarps;

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
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// row pitch, in elements, of a shared tile W columns wide (W a multiple of
// 16): f32 W + 4 (4 mod 16: conflict-free fragment reads); bf16 W + 8
// (rows stay on 16 bytes)
template <typename T>
__host__ __device__ constexpr int pitch(int w) {
  return sizeof(T) == 4 ? w + 4 : w + 8;
}

// acc[i] += a . b_i over one 8-wide k-step for the tiles i <= last, in
// split precision.  The tensor cores truncate as they accumulate, so no
// product lands on the running sum: the big term hi.hi goes into one
// zeroed temporary, the two small ones (lo.hi, hi.lo) into another, and
// both are added to acc in f32, rounded to nearest.  The products are
// issued pass by pass over the tiles, so no mma waits on the one before.
template <int NTILE>
__device__ __forceinline__ void mma_3xtf32_tiles(
    float (&acc)[NTILE][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
    const float (&b0)[NTILE], const float (&b1)[NTILE], int last) {
  uint32_t bh0[NTILE], bl0[NTILE], bh1[NTILE], bl1[NTILE];
  float big[NTILE][4], small[NTILE][4];
#pragma unroll
  for (int i = 0; i < NTILE; ++i) {
    if (i > last) continue;
    split(b0[i], bh0[i], bl0[i]);
    split(b1[i], bh1[i], bl1[i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) big[i][c] = small[i][c] = 0.f;
    mma_tf32(small[i], al, bh0[i], bh1[i]);
    mma_tf32(big[i], ah, bh0[i], bh1[i]);
  }
#pragma unroll
  for (int i = 0; i < NTILE; ++i)
    if (i <= last) mma_tf32(small[i], ah, bl0[i], bl1[i]);
#pragma unroll
  for (int i = 0; i < NTILE; ++i) {
    if (i > last) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += big[i][c] + small[i][c];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// rows [t0, t0 + kQ) of a (S, cols) operand (row stride rs, first column
// at src) into a shared tile W columns wide (W a multiple of 16 bytes'
// worth, cols <= W) of pitch ld: 16-byte pieces by cp.async, zero-filled
// past S; a last piece short of 16 bytes element by element.  Columns
// past cols are left as they are (zero from the start).  W is a
// compile-time power of two, so a thread's piece needs no division.
template <int W, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long rs, int t0, int S,
                                          int cols) {
  constexpr int kU = 16 / sizeof(T);
  constexpr int kPieces = W / kU;  // per row
  static_assert(kPieces > 0 && (kPieces & (kPieces - 1)) == 0,
                "pieces per row a power of two");
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kQ * kPieces; idx += kThreads) {
    const int r = idx / kPieces, c = (idx % kPieces) * kU;
    const bool row_ok = t0 + r < S;
    const T* from = src + static_cast<long long>(t0 + r) * rs + c;
    if (c + kU <= cols) {
      cp_async16(dst + r * ld + c, row_ok ? from : src, row_ok);
    } else if (c < cols) {
      for (int e = 0; e < cols - c; ++e)
        dst[r * ld + c + e] = row_ok ? from[e] : zero_of<T>();
    }
  }
}

// shared-memory layout of one CTA, in bytes: two stages each of the
// float64 decay, exp(dac), w and dt, then the two state stages (f32, PS x
// (NT + 4)), then the two stages of x (Q x pitch(PS)), C and B (Q x
// pitch(NT))
template <typename T, int PS, int NT>
struct Smem {
  static constexpr int kDac = 0;
  static constexpr int kExp = kDac + 2 * kQ * 8;
  static constexpr int kW = kExp + 2 * kQ * 4;
  static constexpr int kDt = kW + 2 * kQ * 4;
  static constexpr int kState = kDt + 2 * kQ * 4;
  static constexpr int kLS = NT + 4;
  static constexpr int kX = kState + 2 * PS * kLS * 4;
  static constexpr int kLX = pitch<T>(PS);
  static constexpr int kLN = pitch<T>(NT);
  static constexpr int kC = kX + 2 * kQ * kLX * static_cast<int>(sizeof(T));
  static constexpr int kB = kC + 2 * kQ * kLN * static_cast<int>(sizeof(T));
  static constexpr int kBytes =
      kB + 2 * kQ * kLN * static_cast<int>(sizeof(T));
  static_assert(kX % 16 == 0 && kC % 16 == 0 && kB % 16 == 0,
                "tiles start on 16 bytes");
};

// Which warp updates which part of the state.  The state's (PS / 16) x
// (NT / 8) tiles of 16 x 8 go in batches of four along N (one batch: 8
// k-steps of four tiles sharing A), handed out at compile time to the
// warps with the least other work: warp w's score rows carry 2 w + 2
// column tiles of C B^T and as many k-steps of scores x, so warp 3 has the
// most and gets the fewest batches.
template <int PS, int NT>
struct StatePlan {
  int first[kWarps], count[kWarps];
  constexpr StatePlan() : first(), count() {
    int load[kWarps] = {};
    for (int w = 0; w < kWarps; ++w)  // in tile k-steps
      load[w] = (2 * w + 2) * (NT / 8 + PS / 8) + (NT / 8) * (PS / 8);
    for (int q = 0; q < PS * NT / 512; ++q) {
      int best = 0;
      for (int w = 1; w < kWarps; ++w)
        if (load[w] < load[best]) best = w;
      ++count[best];
      load[best] += 4 * (kQ / 8);
    }
    for (int w = 0, f = 0; w < kWarps; ++w) {
      first[w] = f;
      f += count[w];
    }
  }
};

// One warp's scan of a chunk: lane l holds dt of steps 2 l and 2 l + 1;
// writes dt, the inclusive float64 cumsum dac of dt a, exp(dac) and w_s =
// dt_s exp(dac_Q - dac_s) into one stage.
__device__ __forceinline__ void chunk_scan(float dt0, float dt1, float ah,
                                           int lane, float* sdt,
                                           double* sdac, float* sexp,
                                           float* sw) {
  const double d0 = static_cast<double>(dt0) * ah;
  const double d1 = static_cast<double>(dt1) * ah;
  double inc = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  const double excl = __shfl_up_sync(0xffffffffu, inc, 1);
  const double last = __shfl_sync(0xffffffffu, inc, 31);
  const double dac0 = (lane ? excl : 0.0) + d0, dac1 = inc;
  sdt[2 * lane] = dt0;
  sdt[2 * lane + 1] = dt1;
  sdac[2 * lane] = dac0;
  sdac[2 * lane + 1] = dac1;
  sexp[2 * lane] = expf(static_cast<float>(dac0));
  sexp[2 * lane + 1] = expf(static_cast<float>(dac1));
  sw[2 * lane] = dt0 * expf(static_cast<float>(last - dac0));
  sw[2 * lane + 1] = dt1 * expf(static_cast<float>(last - dac1));
}

template <typename T, int PS, int NT>
__global__ void __launch_bounds__(kThreads, NT <= 64 ? 2 : 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ state_out, Strides st, int S, int H, int G,
           int P, int N, int n_slices) {
  using L = Smem<T, PS, NT>;
  constexpr int LS = L::kLS, LX = L::kLX, LN = L::kLN;
  constexpr int kPT = PS / 8;             // 8-wide column tiles of the slice
  constexpr StatePlan<PS, NT> kPlan{};
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  double* sdac = reinterpret_cast<double*>(sm + L::kDac);
  float* sexp = reinterpret_cast<float*>(sm + L::kExp);
  float* sw = reinterpret_cast<float*>(sm + L::kW);
  float* sdt = reinterpret_cast<float*>(sm + L::kDt);
  float* sst = reinterpret_cast<float*>(sm + L::kState);
  T* sx = reinterpret_cast<T*>(sm + L::kX);
  T* sc = reinterpret_cast<T*>(sm + L::kC);
  T* sb = reinterpret_cast<T*>(sm + L::kB);

  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * PS;
  const int pv = min(PS, P - p0);  // the slice's real columns
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const float ah = a[h];
  const float dh = d_skip ? d_skip[h] : 0.f;
  const T* xb = x + b * st.x_b + h * st.x_h + p0;
  const T* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = bm + b * st.b_b + g * st.b_g;
  const T* cb = cm + b * st.c_b + g * st.c_g;
  const long long y_s = static_cast<long long>(H) * P;  // y is contiguous
  T* yb = y + static_cast<long long>(b) * S * y_s +
          static_cast<long long>(h) * P + p0;
  const bool pairs = (P & 1) == 0;  // y's column pairs are 2-aligned
  const long long s_off = static_cast<long long>(bh) * P * N;

  // zero everything once: pad columns stay zero, copies fill the rest
  for (int i = tid; i < L::kBytes / 16; i += kThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (init) {
    for (int idx = tid; idx < pv * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      sst[p * LS + n] = init[s_off + static_cast<long long>(p0 + p) * N + n];
    }
  }

  const int n_chunks = (S + kQ - 1) / kQ;
  auto load_tiles = [&](int stage, int t0) {
    load_rows<PS>(sx + stage * kQ * LX, LX, xb, st.x_s, t0, S, pv);
    load_rows<NT>(sc + stage * kQ * LN, LN, cb, st.c_s, t0, S, N);
    load_rows<NT>(sb + stage * kQ * LN, LN, bb, st.b_s, t0, S, N);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // warp 0 reads a chunk's dt (two steps a lane; 0 past S)
  auto dt_at = [&](int t) {
    return t < S ? to_f32(dtb[static_cast<long long>(t) * st.dt_s]) : 0.f;
  };
  if (n_chunks > 0) {
    load_tiles(0, 0);
    if (warp == 0)
      chunk_scan(dt_at(2 * lane), dt_at(2 * lane + 1), ah, lane, sdt, sdac,
                 sexp, sw);
  }

  // this warp's score rows, and its tiles of the state update
  const int r0 = 16 * warp + gq, r1 = r0 + 8;
  const int jmax = 2 * warp + 1;  // last 8-wide score column tile with s <= t
  int st_first = 0, st_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w == warp) {
      st_first = kPlan.first[w];
      st_count = kPlan.count[w];
    }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int cur = ch & 1, nxt = cur ^ 1;
    const int t0 = ch * kQ, nt = min(kQ, S - t0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this chunk has landed; the last one is done
    const bool more = ch + 1 < n_chunks;
    if (more) load_tiles(nxt, t0 + kQ);
    float dt_next0 = 0.f, dt_next1 = 0.f;  // warp 0: the next chunk's dt
    if (warp == 0 && more) {
      dt_next0 = dt_at(t0 + kQ + 2 * lane);
      dt_next1 = dt_at(t0 + kQ + 2 * lane + 1);
    }

    const T* cX = sx + cur * kQ * LX;
    const T* cC = sc + cur * kQ * LN;
    const T* cB = sb + cur * kQ * LN;
    const float* cS = sst + cur * PS * LS;
    const float* cdt = sdt + cur * kQ;
    const double* cdac = sdac + cur * kQ;
    const float* cexp = sexp + cur * kQ;
    const float* cw = sw + cur * kQ;
    float* nS = sst + nxt * PS * LS;

    // scores = C B^T (columns s <= t) and off = C S^T, sharing C's split
    float scr[8][4], off[kPT][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) scr[j][c] = 0.f;
#pragma unroll
    for (int n = 0; n < kPT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) off[n][c] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < NT; kk += 8) {
      uint32_t ah4[4], al4[4];
      split(to_f32(cC[r0 * LN + kk + tq]), ah4[0], al4[0]);
      split(to_f32(cC[r1 * LN + kk + tq]), ah4[1], al4[1]);
      split(to_f32(cC[r0 * LN + kk + tq + 4]), ah4[2], al4[2]);
      split(to_f32(cC[r1 * LN + kk + tq + 4]), ah4[3], al4[3]);
      float b0[8], b1[8];
      const T* br = cB + gq * LN + kk + tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b0[j] = j <= jmax ? to_f32(br[8 * j * LN]) : 0.f;
        b1[j] = j <= jmax ? to_f32(br[8 * j * LN + 4]) : 0.f;
      }
      mma_3xtf32_tiles(scr, ah4, al4, b0, b1, jmax);
      float s0[kPT], s1[kPT];
      const float* sr = cS + gq * LS + kk + tq;
#pragma unroll
      for (int n = 0; n < kPT; ++n) {
        s0[n] = sr[8 * n * LS];
        s1[n] = sr[8 * n * LS + 4];
      }
      mma_3xtf32_tiles(off, ah4, al4, s0, s1, kPT - 1);
    }

    // decay and mask the scores: (t, s) = (r0 | r1, 8 j + 2 tq (+1))
    {
      const double dac_r0 = cdac[r0], dac_r1 = cdac[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > jmax) continue;
        const int s0 = 8 * j + 2 * tq;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = c < 2 ? r0 : r1, s = s0 + (c & 1);
          const double dac_t = c < 2 ? dac_r0 : dac_r1;
          scr[j][c] = s <= t ? scr[j][c] *
                                   expf(static_cast<float>(dac_t - cdac[s])) *
                                   cdt[s]
                             : 0.f;
        }
      }
    }

    // diag = scores x over the visible 8-key steps
    float diag[kPT][4];
#pragma unroll
    for (int n = 0; n < kPT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) diag[n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > jmax) continue;
      uint32_t ah4[4], al4[4];
      split(scr[j][0], ah4[0], al4[0]);
      split(scr[j][2], ah4[1], al4[1]);
      split(scr[j][1], ah4[2], al4[2]);
      split(scr[j][3], ah4[3], al4[3]);
      const T* xr = cX + (8 * j + 2 * tq) * LX + gq;
      float x0[kPT], x1[kPT];
#pragma unroll
      for (int n = 0; n < kPT; ++n) {
        x0[n] = to_f32(xr[8 * n]);
        x1[n] = to_f32(xr[LX + 8 * n]);
      }
      mma_3xtf32_tiles(diag, ah4, al4, x0, x1, kPT - 1);
    }

    // y = diag + exp(dac_t) off + d x for the chunk's real rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? r1 : r0;
      if (t >= nt) continue;
      const float e = cexp[t];
      T* yrow = yb + static_cast<long long>(t0 + t) * y_s;
#pragma unroll
      for (int n = 0; n < kPT; ++n) {
        const int p = 8 * n + 2 * tq;
        const float v0 = diag[n][2 * half] + e * off[n][2 * half] +
                         dh * to_f32(cX[t * LX + p]);
        const float v1 = diag[n][2 * half + 1] + e * off[n][2 * half + 1] +
                         dh * to_f32(cX[t * LX + p + 1]);
        if (pairs && p + 1 < pv) {
          store2(yrow + p, v0, v1);
        } else {
          if (p < pv) store(yrow + p, v0);
          if (p + 1 < pv) store(yrow + p + 1, v1);
        }
      }
    }

    // S' = exp(dac_Q) S + (x w)^T B into the other state stage, in this
    // warp's batches of four 16 x 8 tiles
    {
      const float decay = cexp[kQ - 1];
#pragma unroll 1
      for (int q = st_first; q < st_first + st_count; ++q) {
        const int pr0 = 16 * (q / (NT / 32)) + gq, pr1 = pr0 + 8;
        const int n0 = (q % (NT / 32)) * 32;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < kQ; kk += 8) {
          const int s0 = kk + 2 * tq, s1 = s0 + 1;
          const float w0 = cw[s0], w1 = cw[s1];
          uint32_t ah4[4], al4[4];
          split(to_f32(cX[s0 * LX + pr0]) * w0, ah4[0], al4[0]);
          split(to_f32(cX[s0 * LX + pr1]) * w0, ah4[1], al4[1]);
          split(to_f32(cX[s1 * LX + pr0]) * w1, ah4[2], al4[2]);
          split(to_f32(cX[s1 * LX + pr1]) * w1, ah4[3], al4[3]);
          float b0[4], b1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = n0 + 8 * i + gq;
            b0[i] = to_f32(cB[s0 * LN + n]);
            b1[i] = to_f32(cB[s1 * LN + n]);
          }
          mma_3xtf32_tiles(acc, ah4, al4, b0, b1, 3);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + 8 * i + 2 * tq;
          nS[pr0 * LS + n] = fmaf(decay, cS[pr0 * LS + n], acc[i][0]);
          nS[pr0 * LS + n + 1] = fmaf(decay, cS[pr0 * LS + n + 1], acc[i][1]);
          nS[pr1 * LS + n] = fmaf(decay, cS[pr1 * LS + n], acc[i][2]);
          nS[pr1 * LS + n + 1] = fmaf(decay, cS[pr1 * LS + n + 1], acc[i][3]);
        }
      }
    }

    // warp 0 prepares the next chunk's decay in the other stage (its
    // last readers finished before this chunk's barrier)
    if (warp == 0 && more)
      chunk_scan(dt_next0, dt_next1, ah, lane, sdt + nxt * kQ,
                 sdac + nxt * kQ, sexp + nxt * kQ, sw + nxt * kQ);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const float* fS = sst + (n_chunks & 1) * PS * LS;
  for (int idx = tid; idx < pv * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    state_out[s_off + static_cast<long long>(p0 + p) * N + n] =
        fS[p * LS + n];
  }
}

template <typename T, int PS, int NT>
int ssd_launch_tiles(const void* x, const void* dt, const void* a,
                     const void* b, const void* c, const void* d_skip,
                     const void* init, void* y, void* state,
                     const Strides& st, int B, int S, int H, int G, int P,
                     int N, cudaStream_t s) {
  const int smem = Smem<T, PS, NT>::kBytes;
  auto kernel = ssd_kernel<T, PS, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (P + PS - 1) / PS;
  kernel<<<B * H * n_slices, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(state), st, S, H, G, P, N, n_slices);
  return static_cast<int>(cudaGetLastError());
}

inline int tile_of(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <typename T, int PS>
int ssd_launch_n(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, const void* d_skip, const void* init,
                 void* y, void* state, const Strides& st, int B, int S, int H,
                 int G, int P, int N, cudaStream_t s) {
  switch (tile_of(N)) {
    case 32: return ssd_launch_tiles<T, PS, 32>(x, dt, a, b, c, d_skip, init,
                                                y, state, st, B, S, H, G, P,
                                                N, s);
    case 64: return ssd_launch_tiles<T, PS, 64>(x, dt, a, b, c, d_skip, init,
                                                y, state, st, B, S, H, G, P,
                                                N, s);
    default: return ssd_launch_tiles<T, PS, 128>(x, dt, a, b, c, d_skip,
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
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // slices of 32 columns of P, or of 16 where 32 would give under two
  // CTAs per SM
  const long long ctas32 = static_cast<long long>(B) * H * ((P + 31) / 32);
  if (P > 16 && ctas32 >= 2LL * sms)
    return ssd_launch_n<T, 32>(x, dt, a, b, c, d_skip, init, y, state, st, B,
                               S, H, G, P, N, s);
  return ssd_launch_n<T, 16>(x, dt, a, b, c, d_skip, init, y, state, st, B,
                             S, H, G, P, N, s);
}


// ------------------------------------------------------------- backward
// No TPU kernel: the reference differentiates ssd_chunked (plus the D
// skip term) with JAX autodiff.  This is the gradient of the chunked
// ("dual") SSD form of Dao & Gu, "Transformers are SSMs" (2024), the
// algorithm the forward kernel runs, per (batch, head) and per sub-chunk
// of Q = 64 steps.  With dac_t the sub-chunk's cumulative decay
// sum_{u <= t} a dt_u (float64, one warp), L_ts = exp(dac_t - dac_s) for
// s <= t (else 0), w_s = exp(dac_Q - dac_s), E = exp(dac_Q), u = dt x,
// M = (C B^T) o L, S_in the state at the sub-chunk's start and dS_out the
// gradient at its end (the final state's gradient is dstate, zero when
// none is given):
//     dM    = (dy u^T) o mask,  dMs = dM o L
//     du    = M^T dy + diag(w) B dS_out^T,     dx = dt o du + d dy
//     dC    = dMs B + diag(e^dac) dy S_in
//     dB    = dMs^T C + diag(w) u dS_out
//     dS_in = E dS_out + dy^T diag(e^dac) C,   S_out = E S_in + u^T diag(w) B
// The decay's gradient G_t (d loss / d dac_t) is the row sum less the
// column sum of dM o M, plus e^dac_t dy_t . S_in C_t, less r_t = dt_t x_t .
// (du's dS_out term)_t, and at t = Q - 1 plus sum_s r_s + E <S_in,
// dS_out>.  Its reverse cumulative sum R within the sub-chunk gives ddt_t
// = x_t . du_t + a R_t and da's partial sum_t dt_t R_t, one per
// sub-chunk: no float32 sum runs over more than 64 steps, and the wrapper
// adds the partials pairwise.  dB and dC sum over the heads of a group,
// da and dd over batch and steps: the kernels write per-head gradients
// and per-sub-chunk partials, and the wrapper sums them in a fixed order
// (no atomics: two calls give the same bits).
//
// What bounds it: ten 64 x 64 x 64 products a sub-chunk and (batch, head)
// (eight in the chunk pass, two in the local pass), each as three TF32
// products (lo.hi + hi.lo + hi.hi, float32-level accuracy) at the TF32
// peak, against reading x, dt, B, C and dy and writing their gradients.
// At zamba2-1.2b's training shape the products bound it (chip_smoke.py
// counts both).
//
// Design: state passing over the sub-chunks (their states kept at every
// 64-step boundary), three launches; the two heavy ones are persistent,
// one CTA of two warpgroups an SM walking its share of the (batch, head,
// sub-chunk) items.  Tiles move by TMA (cp.async.bulk.tensor, 64-row
// boxes of 32 columns in the 128-byte swizzle the products read, rows and
// columns past S, P or N zero-filled on the way in and dropped on the way
// out): one thread issues a whole item's copies, an mbarrier says when
// they have landed, and the outputs are staged in shared tiles and
// written by TMA too.  Written as scattered 4-byte stores, dx, dB and dC
// took about a third of the chunk pass, and issuing cp.async copies a
// fifth (tools/ssd_bwd_breakdown.py).
//   1. ssd_bwd_local: each sub-chunk's state from zero (u^T diag(w) B) and
//      its gradient at its start from a zero end gradient (dy^T diag(e^dac)
//      C), and E.  A two-stage ring: the next item's x, dy, B, C and dt
//      land while this item's transposes and products run.
//   2. ssd_bwd_scan: one thread an element: the state forward across
//      sub-chunks from the initial state (S_in of each) and the gradient
//      backward from dstate (dS_out of each), dinit the last carry;
//   3. ssd_bwd_chunk: every gradient of a sub-chunk from its S_in and
//      dS_out.  Its 13 tiles leave no room for a second stage, so the
//      next item's tiles are copied into this item's as they fall free,
//      once [D] is done: they land while [E] (the decay's gradient) and
//      [F] (dC's product) run.  B, S_in and their lo / x's lo tiles
//      alternate between two tiles each from one item to the next, so the
//      next B and S_in land beside this item's, and the staged dx and dB
//      beside the next item's lo copies.
// A CTA that walked several sub-chunks of a chunk would need each one's
// end gradient first (a pre-walk product a sub-chunk) and would park them
// (16 KB each): in registers they spilled, and at two sub-chunks a chunk
// the pre-walk cost more than halving the stored states saved.
// Every product is a warpgroup's wgmma (TF32, float32 accumulators) over
// K = 64.  In the local pass the two warpgroups run one product each, a
// whole 64 x 64 output (m64n64k8: the state and its gradient); in the
// chunk pass they split each product's columns (m64n32k8), so the kept
// fragments take 16 registers a thread (with all 64 columns they
// spilled).  TF32 wgmma takes B from shared memory K-major only, so each
// product is arranged with its B operand a tile kept K-major: x, dy, B and
// C as TMA lands them ([step][feature]) with a lo copy, or a tile the CTA
// writes (M^T, dMs^T, dMs, x^T, dy^T) hi and lo; A comes from registers,
// gathered from any of the tiles in either orientation.  wgmma reads a
// float32 word as TF32 by dropping its low 13 bits
// (tools/tf32_wgmma_probe.py), so a raw word is its own hi and lo =
// rna_tf32(a - trunc(a)) (raw_lo).  Each product sums its 8 k-steps in a
// fresh accumulator that is then added to its running sum in float32.
// Shared memory (ssd_bwd_chunk): 13 tiles of 16 KB (x, dy, two for B and
// its lo copy, C, two for S_in and x's lo copy, dy's lo copy, two written
// operands hi and lo, dS_out) and 8.3 KB of per-step vectors, partial
// sums, the next dt and the mbarrier: 221,456 bytes; ssd_bwd_local: two
// stages of four tiles, x^T and dy^T hi and lo, the vectors: 199,184
// bytes.  The wrapper pads the last axis of the outputs and the states to
// a multiple of 4 floats (TMA's 16-byte strides) and splits P or N past
// 64 (up to 128) into slices of 64 (the scan is a sum of independent
// scans over slices of P and of N).  Rows past S are zero-filled with dt
// = 0, which is exact.

constexpr int kBQ = 64;           // steps of a sub-chunk: wgmma's M
constexpr int kBD = 64;           // P and N of one call
constexpr int kBThreads = 256;    // two warpgroups
constexpr int kBScanThreads = 256;
constexpr int kT = kBQ * kBD * 4;  // one float32 64 x 64 tile, bytes

struct BwdArgs {
  const float *dt, *a, *d_skip;
  long long dt_b, dt_s, dt_h;  // dt's element strides
  int S, H, G, P, N;
  // make_map's axis orders of x, dy, B, C, the states and the outputs
  int perm_x, perm_dy, perm_b, perm_c, perm_s, perm_out;
};

// tensor maps (make_map, float32, 64-row boxes of 32 columns): x and dy
// (P, H, S, B), B and C (N, G, S, B); the states, (N, P, sub-chunk, B H),
// read with "head" the sub-chunk and "batch" (batch, head); the per-head
// outputs dx (P, H, S, B), dB and dC (N, H, S, B)
struct BwdMaps {
  CUtensorMap x, dy, b, c, s, ds, dx, db, dc;
};

// shared-memory layouts (bytes from a 1024-byte boundary)
struct BwdSmem {  // ssd_bwd_chunk; B and S_in swap tiles with B's and
                  // x's lo copies from one item to the next
  static constexpr int kX = 0, kDY = kT, kB0 = 2 * kT, kC = 3 * kT;
  static constexpr int kQ0 = 4 * kT, kB1 = 5 * kT, kDYL = 6 * kT;
  static constexpr int kW1 = 7 * kT, kW2 = 9 * kT;  // hi, then lo
  static constexpr int kQ1 = 11 * kT, kDS = 12 * kT;
  static constexpr int kVec = 13 * kT;
  static constexpr int kRed = kVec + 2048;
  static constexpr int kDt = kRed + 6144;  // the next item's dt
  static constexpr int kBar = kDt + 256;   // its tiles' mbarrier
  static constexpr int kBytes = kBar + 16;
  static constexpr int kLoad = 6 * kT;  // bytes of an item's tiles
};
struct LocalSmem {  // ssd_bwd_local: stage s's x, dy, B, C at 4 s kT
  static constexpr int kW1 = 8 * kT, kW2 = 10 * kT;  // x^T, dy^T hi, lo
  static constexpr int kVec = 12 * kT;
  static constexpr int kDt = kVec + 2048;  // each stage's dt
  static constexpr int kBar = kDt + 512;   // each stage's mbarrier
  static constexpr int kBytes = kBar + 16;
};

// the float64 cumulative decay of a sub-chunk, first of its vectors
__device__ __forceinline__ double* dac_at(uint8_t* v) {
  return reinterpret_cast<double*>(v);
}

// per-step vectors of a sub-chunk (at kVec): dac (float64), dt, e^dac, w,
// dt w, E
struct BwdVec {
  decltype(dac_at(nullptr)) dac;
  float *dt, *ex, *w, *dtw, *e;
  __device__ explicit BwdVec(uint8_t* v)
      : dac(dac_at(v)),
        dt(reinterpret_cast<float*>(v + 512)),
        ex(dt + 64), w(dt + 128), dtw(dt + 192), e(dt + 256) {}
};

// Byte offset of (row r, column c) in a 64 x 64 float32 tile kept K-major
// for wgmma: two 32-column panels of 64 rows x 128 bytes, each row's
// 16-byte pieces XOR-swizzled by r % 8 (the 128-byte swizzle; tiles start
// on 1024 bytes).
__device__ __forceinline__ uint32_t toff(int r, int c) {
  return (c >> 5) * 8192 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

// this thread's place in its warpgroup's 64 x kN fragments: element i is
// row row(i) and column col(i) of the 64 x 64 output; at kN = 32 the two
// warpgroups split the columns (the warpgroup's 32 at 32 wg), at kN = 64
// each computes all of them
template <int kN>
struct Frag {
  int r0, kt, wg;
  uint32_t nat, tr;  // tile offsets of element 0, natural and transposed
  __device__ Frag()
      : r0(16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)),
        kt(threadIdx.x & 3), wg(threadIdx.x >> 7) {
    const int w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
    nat = (kN == 32 ? 8192 * wg : 0) + r0 * 128 +
          (((kt >> 1) ^ g) << 4) + 8 * (kt & 1);
    tr = (w >> 1) * 8192 + (kN == 32 ? 4096 * wg : 0) + 256 * kt +
         (((4 * (w & 1) + (g >> 2)) ^ (2 * kt)) << 4) + 4 * (g & 3);
  }
  __device__ int row(int i) const { return r0 + 8 * ((i >> 1) & 1); }
  __device__ int col(int i) const {
    return (kN == 32 ? 32 * wg : 0) + 8 * (i >> 2) + 2 * kt + (i & 1);
  }
  // toff(row(i), col(i)) and toff(col(i), row(i)): the base XOR a
  // constant plus a constant
  __device__ uint32_t off(int i) const {
    const int j = i >> 2;
    return (nat ^ ((2 * (j & 3)) << 4)) + (j >> 2) * 8192 +
           1024 * ((i >> 1) & 1) + 4 * (i & 1);
  }
  __device__ uint32_t off_t(int i) const {
    return (tr ^ ((2 * ((i >> 1) & 1) + (i & 1)) << 4)) + 1024 * (i >> 2) +
           128 * (i & 1);
  }
};
using Frag32 = Frag<32>;
using Frag64 = Frag<64>;

// acc (the warpgroup's 64 x kN block) = A Bt^T over K = 64 in 3xTF32, in
// a fresh accumulator.  A (row m, column k) is the tile's (m, k), or its
// (k, m) when kTrans, times scale[k] when kScale, gathered from shared
// memory into registers; Bt is a K-major tile whose rows are the output's
// columns (hi at bh, lo at bl; at kN = 32 the warpgroup reads its 32
// rows).  Each thread's gathers are one base offset XOR a constant plus a
// constant (the swizzle: rows r0 and r0 + 8, columns kt and kt + 4 of
// each 8-wide step natural; transposed, rows 8 kk + kt (+ 4) of columns
// r0 (+ 8)).
template <int kN, bool kTrans, bool kScale>
__device__ __forceinline__ void product(float (&acc)[kN / 2],
                                        const Frag<kN>& f,
                                        const uint8_t* tile,
                                        const float* scale, uint32_t bh,
                                        uint32_t bl) {
  const int w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const uint32_t base =
      kTrans ? (w >> 1) * 8192 + 128 * f.kt +
                   (((4 * (w & 1) + (g >> 2)) ^ f.kt) << 4) + 4 * (g & 3)
             : f.r0 * 128 + (g << 4) + 4 * f.kt;
  float c[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) c[i] = 0.f;
  if (kN == 32) {
    bh += 4096 * f.wg;
    bl += 4096 * f.wg;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t o[4];
    if (kTrans) {
      o[0] = base + 1024 * kk;
      o[1] = (base ^ (2 << 4)) + 1024 * kk;
      o[2] = (base ^ (4 << 4)) + 1024 * kk + 512;
      o[3] = (base ^ (6 << 4)) + 1024 * kk + 512;
    } else {
      o[0] = (base ^ ((2 * (kk & 3)) << 4)) + (kk >> 2) * 8192;
      o[1] = o[0] + 1024;
      o[2] = (base ^ ((2 * (kk & 3) + 1) << 4)) + (kk >> 2) * 8192;
      o[3] = o[2] + 1024;
    }
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = lds(tile + o[j]);
    if (kScale) {
      const float s0 = scale[8 * kk + f.kt], s1 = scale[8 * kk + f.kt + 4];
      x[0] *= s0;
      x[1] *= s0;
      x[2] *= s1;
      x[3] *= s1;
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ah[j] = __float_as_uint(x[j]);  // read as tf32: its top 19 bits
      al[j] = __float_as_uint(raw_lo(x[j]));
    }
    const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
    const uint64_t dh = desc_sw128(bh + off, 16, 1024);
    const uint64_t dl = desc_sw128(bl + off, 16, 1024);
    wgmma_fence();
    wgmma_tf32<kN>(c, al, dh);
    wgmma_tf32<kN>(c, ah, dl);
    wgmma_tf32<kN>(c, ah, dh);
    wgmma_commit();
    wgmma_wait<1>();  // the next k-step's gathers overlap these products
  }
  wgmma_wait<0>();
  fence_regs(c);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = c[i];
}

// a tile (both 32-column panels of a 64-row box) of a map (make_map)
// into dst, counted on the mbarrier bar
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap& map,
                                         int perm, uint32_t bar, int head,
                                         int row, int batch) {
  tma_load(smem_addr(dst), &map, perm, bar, 0, head, row, batch);
  tma_load(smem_addr(dst + 8192), &map, perm, bar, 32, head, row, batch);
}

// a tile to a map (make_map), in the thread's bulk async-group
__device__ __forceinline__ void tma_store_tile(const CUtensorMap& map,
                                               int perm, const uint8_t* src,
                                               int head, int row, int batch) {
  int c1, c2, c3;
  map_coords(perm, head, row, batch, c1, c2, c3);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(&map)),
        "r"(smem_addr(src + 8192 * p)), "r"(32 * p), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the thread's bulk stores have read their shared memory (kRead) or
// are done
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a sub-chunk's dt (stride dt_s, 0 past S) into 64 floats, 4 bytes a copy
__device__ __forceinline__ void load_dt(float* dst, const float* dtb,
                                        long long dt_s, int t0, int S) {
  if (threadIdx.x < kBQ) {
    const bool ok = t0 + threadIdx.x < S;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + threadIdx.x)),
                 "l"(ok ? dtb + (t0 + threadIdx.x) * dt_s : dtb),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// the lo copy of a tile, in the same layout
__device__ __forceinline__ void lo_copy(uint8_t* dst, const uint8_t* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kT / 16; i += kBThreads) {
    const float4 v = s4[i];
    d4[i] = make_float4(raw_lo(v.x), raw_lo(v.y), raw_lo(v.z), raw_lo(v.w));
  }
}

// a tile's transpose, hi (raw) at dst and lo at dst + kT; a warp moves
// blocks of 8 rows x 4 columns (its reads hit 32 banks, its writes 16)
__device__ __forceinline__ void transpose(uint8_t* dst, const uint8_t* src) {
  const int lane = threadIdx.x & 31;
  for (int blk = threadIdx.x >> 5; blk < 128; blk += kBThreads / 32) {
    const int r = 8 * (blk >> 4) + (lane >> 2), c = 4 * (blk & 15) + (lane & 3);
    const float x = lds(src + toff(r, c));
    const uint32_t o = toff(c, r);
    *reinterpret_cast<float*>(dst + o) = x;
    *reinterpret_cast<float*>(dst + kT + o) = raw_lo(x);
  }
}

// a fragment (element i at (row(i), col(i))) into a tile at (row, col),
// or transposed at (col, row); hi (raw) at dst and lo at dst + kT
template <int kN>
__device__ __forceinline__ void put_frag(uint8_t* dst, const Frag<kN>& f,
                                         const float (&v)[kN / 2],
                                         bool trans) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const uint32_t o = trans ? f.off_t(i) : f.off(i);
    *reinterpret_cast<float*>(dst + o) = v[i];
    *reinterpret_cast<float*>(dst + kT + o) = raw_lo(v[i]);
  }
}

// a fragment into a tile transposed, at (col(i), row(i)), for TMA to
// write out
template <int kN>
__device__ __forceinline__ void put_out(uint8_t* dst, const Frag<kN>& f,
                                        const float (&v)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i)
    *reinterpret_cast<float*>(dst + f.off_t(i)) = v[i];
}

// sum over a warp, the same order on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// each column's sum over the warp's 16 rows of a fragment, into
// red[warp % 4][column]
template <int kN>
__device__ __forceinline__ void col_sums(float* red, const Frag<kN>& f,
                                         const float (&v)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    if (i & 2) continue;
    float s = v[i] + v[i + 2];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if ((threadIdx.x & 31) < 4)  // the lanes of row 0
      red[((threadIdx.x >> 5) & 3) * 64 + f.col(i)] = s;
  }
}

// one warp: the sub-chunk's dt (landed in dts, 0 past S), its float64
// cumulative decay dac and E, e^dac, w, dt w into the vectors
__device__ __forceinline__ void scan_dt(const BwdVec& v, const float* dts,
                                        float ah) {
  const int lane = threadIdx.x & 31;
  const float dt0 = dts[2 * lane], dt1 = dts[2 * lane + 1];
  const double d0 = static_cast<double>(dt0) * ah;
  const double d1 = static_cast<double>(dt1) * ah;
  double inc = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double x = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += x;
  }
  const double excl = __shfl_up_sync(0xffffffffu, inc, 1);
  const double last = __shfl_sync(0xffffffffu, inc, 31);
  const double dac[2] = {(lane ? excl : 0.0) + d0, inc};
  const float dts2[2] = {dt0, dt1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    v.dac[t] = dac[e];
    v.dt[t] = dts2[e];
    v.ex[t] = expf(static_cast<float>(dac[e]));
    v.w[t] = expf(static_cast<float>(last - dac[e]));
    v.dtw[t] = dts2[e] * v.w[t];
  }
  if (lane == 0) v.e[0] = expf(static_cast<float>(last));
}

// an item's (batch, head, group) and sub-chunk
struct BwdItem {
  int bi, h, g, bh, j, t0;
  const float* dt;
  __device__ BwdItem(const BwdArgs& q, int item, int n_sub) {
    bh = item / n_sub;
    j = item - bh * n_sub;
    bi = bh / q.H;
    h = bh - bi * q.H;
    g = h / (q.H / q.G);
    t0 = kBQ * j;
    dt = q.dt + bi * q.dt_b + h * q.dt_h;
  }
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// Pass 1: each sub-chunk's state from zero and its gradient at its start
// from a zero end gradient, and its decay product E.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_local(const __grid_constant__ BwdMaps maps, BwdArgs q, int items,
              float* __restrict__ decay) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  using L = LocalSmem;
  uint8_t *sW1 = sm + L::kW1, *sW2 = sm + L::kW2;
  const BwdVec v(sm + L::kVec);
  const Frag64 f;  // warpgroup 0 runs the state, warpgroup 1 its gradient
  const int n_sub = (q.S + kBQ - 1) / kBQ;
  const auto stage = [&](int s) { return sm + 4 * kT * s; };
  const auto dts = [&](int s) {
    return reinterpret_cast<float*>(sm + L::kDt) + kBQ * s;
  };
  const auto bar = [&](int s) { return smem_addr(sm + L::kBar + 8 * s); };
  // an item's x, dy, B, C (TMA, one thread) and dt into stage s
  const auto load = [&](int item, int s) {
    const BwdItem k(q, item, n_sub);
    if (threadIdx.x == 0) {
      uint8_t* to = stage(s);
      mbar_expect_tx(bar(s), 4 * kT);
      tma_tile(to, maps.x, q.perm_x, bar(s), k.h, k.t0, k.bi);
      tma_tile(to + kT, maps.dy, q.perm_dy, bar(s), k.h, k.t0, k.bi);
      tma_tile(to + 2 * kT, maps.b, q.perm_b, bar(s), k.g, k.t0, k.bi);
      tma_tile(to + 3 * kT, maps.c, q.perm_c, bar(s), k.g, k.t0, k.bi);
    }
    load_dt(dts(s), k.dt, q.dt_s, k.t0, q.S);
    cp_commit();
  };
  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    mbar_init(bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (blockIdx.x < items) load(blockIdx.x, 0);
  for (int item = blockIdx.x, it = 0; item < items;
       item += gridDim.x, ++it) {
    const int s = it & 1;
    const BwdItem k(q, item, n_sub);
    if (item + gridDim.x < items) {  // the next item into the other stage
      load(item + gridDim.x, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    mbar_wait(bar(s), (it >> 1) & 1);
    if (threadIdx.x == 0) bulk_wait<true>();  // the last item's states read
    __syncthreads();
    uint8_t *sX = stage(s), *sDY = sX + kT, *sB = sX + 2 * kT,
            *sC = sX + 3 * kT;
    if (threadIdx.x < 32) scan_dt(v, dts(s), q.a[k.h]);
    transpose(sW1, sX);   // x^T: rows p, K = s
    transpose(sW2, sDY);  // dy^T: rows p, K = t
    fence_async_smem();
    __syncthreads();
    float acc[32];
    if (f.wg == 0) {
      // S^T [n][p] = sum_s (B[s][n] dt_s w_s) x[s][p], staged over x^T
      product<64, true, true>(acc, f, sB, v.dtw, smem_addr(sW1),
                              smem_addr(sW1 + kT));
      put_out(sW1, f, acc);
    } else {
      // dS^T [n][p] = sum_t (C[t][n] e^dac_t) dy[t][p], over dy^T
      product<64, true, true>(acc, f, sC, v.ex, smem_addr(sW2),
                              smem_addr(sW2 + kT));
      put_out(sW2, f, acc);
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      decay[item] = v.e[0];
      tma_store_tile(maps.s, q.perm_s, sW1, k.j, 0, k.bh);
      tma_store_tile(maps.ds, q.perm_s, sW2, k.j, 0, k.bh);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<false>();
}

// Pass 2, one thread four elements of the states' (B, H, P, n4) rows (n4
// = N rounded up to 4; the padding's lanes carry garbage that nothing
// reads): S_in of each sub-chunk forward from the initial state (null:
// zero), dS_out of each backward from dS_T (null: zero), each written over
// the sub-chunk's local value; dinit (may be null) last.  Eight
// sub-chunks' values are read at once, 16 bytes a thread.
__device__ __forceinline__ float4 fma4(float d, float4 c, float4 l) {
  return make_float4(fmaf(d, c.x, l.x), fmaf(d, c.y, l.y), fmaf(d, c.z, l.z),
                     fmaf(d, c.w, l.w));
}

__global__ void __launch_bounds__(kBScanThreads)
ssd_bwd_scan(float* __restrict__ s_chunks, float* __restrict__ ds_chunks,
             const float* __restrict__ decay, const float* __restrict__ init,
             const float* __restrict__ dstate, float* __restrict__ dinit,
             int BH, int P, int N, int n_chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) *
                            kBScanThreads + threadIdx.x;
  const int n4 = (N + 3) & ~3, PN = P * n4;
  if (idx >= static_cast<long long>(BH) * (PN / 4)) return;
  const int bh = static_cast<int>(idx / (PN / 4));
  const int e = 4 * static_cast<int>(idx - static_cast<long long>(bh) *
                                               (PN / 4));
  const long long off = static_cast<long long>(bh) * n_chunks * PN + e;
  const float* dec = decay + static_cast<long long>(bh) * n_chunks;
  auto at = [&](float* p, int c) {
    return reinterpret_cast<float4*>(p + off + static_cast<long long>(c) * PN);
  };
  // (B, H, P, N) index of each lane's element of init, dstate and dinit,
  // -1 in the padding
  long long io[4];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    io[l] = (e + l) % n4 < N
                ? (static_cast<long long>(bh) * P + (e + l) / n4) * N +
                      (e + l) % n4
                : -1;
  const auto get = [&](const float* src) {
    float v[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = src && io[l] >= 0 ? src[io[l]] : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  float4 carry = get(init);
  for (int c0 = 0; c0 < n_chunks; c0 += 8) {
    float4 loc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < n_chunks) loc[i] = *at(s_chunks, c0 + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i >= n_chunks) break;
      *at(s_chunks, c0 + i) = carry;
      carry = fma4(dec[c0 + i], carry, loc[i]);
    }
  }
  carry = get(dstate);
  for (int c1 = n_chunks; c1 > 0; c1 -= 8) {
    float4 loc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c1 - 1 - i >= 0) loc[i] = *at(ds_chunks, c1 - 1 - i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c1 - 1 - i;
      if (c < 0) break;
      *at(ds_chunks, c) = carry;
      carry = fma4(dec[c], carry, loc[i]);
    }
  }
  if (dinit) {
    const float v[4] = {carry.x, carry.y, carry.z, carry.w};
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (io[l] >= 0) dinit[io[l]] = v[l];
  }
}

// Pass 3: every gradient of a sub-chunk from its S_in and dS_out, in
// stages between barriers: [A] this item's tiles landed, the last item's
// staged outputs read; [B] the decay vectors, lo copies, <S_in, dS_out>;
// [C] M and dMs, M^T and dMs^T written, then dC's S_in term and the sums
// of dM o M; [D] du (dx, x . du) and dB, staged; [E] dx and dB written
// out and the next item's tiles asked for, dMs written, the decay's
// gradient (ddt, da's and dd's partials); [F] dC, staged and written out.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_chunk(const __grid_constant__ BwdMaps maps, BwdArgs q, int items,
              float* __restrict__ ddt, float* __restrict__ da_part,
              float* __restrict__ dd_part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  using L = BwdSmem;
  uint8_t *sX = sm + L::kX, *sDY = sm + L::kDY, *sC = sm + L::kC,
          *sDYL = sm + L::kDYL, *sW1 = sm + L::kW1, *sW2 = sm + L::kW2,
          *sDS = sm + L::kDS;
  float* sDt = reinterpret_cast<float*>(sm + L::kDt);
  const uint32_t bar = smem_addr(sm + L::kBar);
  const BwdVec v(sm + L::kVec);
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  float *red_row = red, *red_col = red + 128, *red_goff = red + 384,
        *red_x12 = red + 640, *red_x2 = red + 896, *red_dd = red + 1152,
        *red_sds = red + 1408;
  const Frag32 f;  // the warpgroups split each product's columns
  const int S = q.S;
  const int n_sub = (S + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t aX = smem_addr(sX), aDY = smem_addr(sDY),
                 aDYL = smem_addr(sDYL), aW1 = smem_addr(sW1),
                 aW2 = smem_addr(sW2);
  // an item's x, dy, C and dS_out, its B into tile sb and S_in into ss
  // (TMA, one thread), and its dt
  const auto load = [&](int item, uint8_t* sb, uint8_t* ss) {
    const BwdItem k(q, item, n_sub);
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, L::kLoad);
      tma_tile(sX, maps.x, q.perm_x, bar, k.h, k.t0, k.bi);
      tma_tile(sDY, maps.dy, q.perm_dy, bar, k.h, k.t0, k.bi);
      tma_tile(sC, maps.c, q.perm_c, bar, k.g, k.t0, k.bi);
      tma_tile(sb, maps.b, q.perm_b, bar, k.g, k.t0, k.bi);
      tma_tile(ss, maps.s, q.perm_s, bar, k.j, 0, k.bh);
      tma_tile(sDS, maps.ds, q.perm_s, bar, k.j, 0, k.bh);
    }
    load_dt(sDt, k.dt, q.dt_s, k.t0, S);
    cp_commit();
  };
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (blockIdx.x < items) load(blockIdx.x, sm + L::kB0, sm + L::kQ1);
  for (int item = blockIdx.x, it = 0; item < items;
       item += gridDim.x, ++it) {
    const BwdItem k(q, item, n_sub);
    const int next = item + gridDim.x;
    const int t0 = k.t0, nt = min(kBQ, S - t0);
    // B and S_in swap tiles with B's and x's lo copies from one item to
    // the next
    const bool odd = it & 1;
    uint8_t* sB = sm + (odd ? L::kB1 : L::kB0);
    uint8_t* sBL = sm + (odd ? L::kB0 : L::kB1);
    uint8_t* sS = sm + (odd ? L::kQ0 : L::kQ1);
    uint8_t* sXL = sm + (odd ? L::kQ1 : L::kQ0);
    const uint32_t aB = smem_addr(sB), aBL = smem_addr(sBL),
                   aXL = smem_addr(sXL);
    const float ah = q.a[k.h];
    const float dh = q.d_skip ? q.d_skip[k.h] : 0.f;

    // [A]
    cp_wait<0>();
    mbar_wait(bar, it & 1);
    if (threadIdx.x == 0) bulk_wait<true>();
    __syncthreads();

    // [B]
    if (warp == 0) scan_dt(v, sDt, ah);
    lo_copy(sXL, sX);
    lo_copy(sBL, sB);
    lo_copy(sDYL, sDY);
    {
      float sds = 0.f;  // this thread's share of <S_in, dS_out>
      for (int o = 4 * threadIdx.x; o < kT; o += 4 * kBThreads)
        sds = fmaf(lds(sS + o), lds(sDS + o), sds);
      sds = warp_sum(sds);
      if (lane == 0) red_sds[warp] = sds;
    }
    fence_async_smem();
    __syncthreads();

    // [C] M = (C B^T) o L and dMs = dM o L, [t][s]
    float m[16], dms[16];
    product<32, false, false>(m, f, sC, nullptr, aB, aBL);
    product<32, false, false>(dms, f, sDY, nullptr, aX, aXL);
    {
      float dmm[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = f.row(i), s = f.col(i);
        if (s <= t) {
          const float l = expf(static_cast<float>(v.dac[t] - v.dac[s]));
          const float dm = dms[i] * v.dt[s];
          m[i] *= l;
          dms[i] = dm * l;
          dmm[i] = dm * m[i];
        } else {
          m[i] = dms[i] = dmm[i] = 0.f;
        }
      }
      // row sums over this warpgroup's columns, column sums over the
      // warp's rows
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) (i & 2 ? r1 : r0) += dmm[i];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, off);
        r1 += __shfl_xor_sync(0xffffffffu, r1, off);
      }
      if (f.kt == 0) {
        red_row[64 * f.wg + f.r0] = r0;
        red_row[64 * f.wg + f.r0 + 8] = r1;
      }
      col_sums(red_col, f, dmm);
    }
    put_frag(sW1, f, m, true);    // M^T: rows s, K = t
    put_frag(sW2, f, dms, true);  // dMs^T: rows s, K = t
    // dC's S_in term, [n][t]: e^dac_t sum_p S_in[p][n] dy[t][p]; and its
    // part of the decay's gradient, e^dac_t dy_t . S_in C_t
    float u3[16];
    product<32, true, false>(u3, f, sS, nullptr, aDY, aDYL);
    {
      float gv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        u3[i] *= v.ex[f.col(i)];
        gv[i] = u3[i] * lds(sC + f.off_t(i));  // C[t][n]
      }
      col_sums(red_goff, f, gv);
    }
    fence_async_smem();
    __syncthreads();

    // [D] du^T [p][s] = dy^T M + (dS_out B^T) o w; dx (staged over dy's
    // lo copy); x . du
    {
      float u1[16], du[16];
      product<32, false, false>(u1, f, sDS, nullptr, aB, aBL);
      product<32, true, false>(du, f, sDY, nullptr, aW1, aW1 + kT);
      float ddv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int s = f.col(i);
        const uint32_t o = f.off_t(i);  // (s, p)
        const float xv = lds(sX + o), dyv = lds(sDY + o);
        u1[i] *= v.w[s];
        du[i] += u1[i];
        *reinterpret_cast<float*>(sDYL + o) = fmaf(v.dt[s], du[i], dh * dyv);
        du[i] *= xv;
        u1[i] *= xv;
        ddv[i] = dyv * xv;
      }
      col_sums(red_x12, f, du);
      col_sums(red_x2, f, u1);
      col_sums(red_dd, f, ddv);
    }
    // dB^T [n][s] = C^T dMs + (dS_out^T x^T) o (w dt), staged over S_in
    {
      float u2[16], db[16];
      product<32, true, false>(u2, f, sDS, nullptr, aX, aXL);
      product<32, true, false>(db, f, sC, nullptr, aW2, aW2 + kT);
#pragma unroll
      for (int i = 0; i < 16; ++i) db[i] += u2[i] * v.dtw[f.col(i)];
      put_out(sS, f, db);
    }
    fence_async_smem();
    __syncthreads();

    // [E] dx and dB out; the next item's tiles land while [E] and [F] run
    // (B and S_in into this item's lo tiles of B and x)
    if (threadIdx.x == 0) {
      tma_store_tile(maps.dx, q.perm_out, sDYL, k.h, t0, k.bi);
      tma_store_tile(maps.db, q.perm_out, sS, k.h, t0, k.bi);
      bulk_commit();
    }
    if (next < items) load(next, sBL, sXL);
    put_frag(sW1, f, dms, false);  // dMs: rows t, K = s
    if (warp == 0) {
      // G_t, its reverse cumulative sum R, ddt, da's and dd's partials;
      // lane l holds steps 2 l and 2 l + 1
      float g[2], x12[2], dd = 0.f, rsum = 0.f;
      const auto sum4 = [&](const float* r, int t) {
        return ((r[t] + r[64 + t]) + r[128 + t]) + r[192 + t];
      };
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        const float rt = v.dt[t] * sum4(red_x2, t);
        g[e] = (((red_row[t] + red_row[64 + t]) - sum4(red_col, t)) +
                sum4(red_goff, t)) - rt;
        x12[e] = sum4(red_x12, t);
        dd += sum4(red_dd, t);
        rsum += rt;
      }
      rsum = warp_sum(rsum);
      float sds = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sds += red_sds[w];
      if (lane == 31) g[1] += rsum + v.e[0] * sds;
      const float pair = g[0] + g[1];
      float suf = pair;  // sum over lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += x;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float rr[2] = {(after + g[1]) + g[0], after + g[1]};
      float da = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        if (t < nt)
          ddt[(static_cast<long long>(k.bi) * S + t0 + t) * q.H + k.h] =
              fmaf(ah, rr[e], x12[e]);
        da = fmaf(v.dt[t], rr[e], da);
      }
      da = warp_sum(da);
      dd = warp_sum(dd);
      if (lane == 0) {
        da_part[static_cast<long long>(k.bh) * n_sub + k.j] = da;
        dd_part[static_cast<long long>(k.bh) * n_sub + k.j] = dd;
      }
    }
    fence_async_smem();
    __syncthreads();

    // [F] dC^T [n][t] = B^T dMs^T + the S_in term, staged over dMs^T
    {
      float dc[16];
      product<32, true, false>(dc, f, sB, nullptr, aW1, aW1 + kT);
#pragma unroll
      for (int i = 0; i < 16; ++i) dc[i] += u3[i];
      put_out(sW2, f, dc);
    }
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_tile(maps.dc, q.perm_out, sW2, k.h, t0, k.bi);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<false>();
}

// the maps of the backward's operands, outputs and states (make_map);
// false if one is refused
bool bwd_maps(BwdMaps* m, BwdArgs* q, const float* x, const float* b,
              const float* c, const float* dy, const long long* st, float* dx,
              float* db_head, float* dc_head, float* s_chunks,
              float* ds_chunks, int B) {
  const int S = q->S, H = q->H, G = q->G, P = q->P, N = q->N;
  const int p4 = (P + 3) & ~3, n4 = (N + 3) & ~3;
  const int n_sub = (S + kBQ - 1) / kBQ;
  const auto f32 = [](CUtensorMap* map, int* perm, const void* ptr, int d,
                      int heads, int s, int batch, long long st_h,
                      long long st_s, long long st_b) {
    return make_map(map, perm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32, ptr,
                    d, heads, s, batch, st_h, st_s, st_b, kBQ);
  };
  int perm_dx;
  return f32(&m->x, &q->perm_x, x, P, H, S, B, st[2], st[1], st[0]) &&
         f32(&m->dy, &q->perm_dy, dy, P, H, S, B, st[14], st[13], st[12]) &&
         f32(&m->b, &q->perm_b, b, N, G, S, B, st[8], st[7], st[6]) &&
         f32(&m->c, &q->perm_c, c, N, G, S, B, st[11], st[10], st[9]) &&
         // the states: "head" the sub-chunk, "row" P, "batch" (batch, head)
         f32(&m->s, &q->perm_s, s_chunks, N, n_sub, P, B * H,
             1LL * P * n4, n4, 1LL * n_sub * P * n4) &&
         f32(&m->ds, &q->perm_s, ds_chunks, N, n_sub, P, B * H,
             1LL * P * n4, n4, 1LL * n_sub * P * n4) &&
         f32(&m->dx, &perm_dx, dx, P, H, S, B, p4, 1LL * H * p4,
             1LL * S * H * p4) &&
         f32(&m->db, &q->perm_out, db_head, N, H, S, B, n4, 1LL * H * n4,
             1LL * S * H * n4) &&
         f32(&m->dc, &q->perm_out, dc_head, N, H, S, B, n4, 1LL * H * n4,
             1LL * S * H * n4) &&
         perm_dx == q->perm_out;
}

int ssd_bwd_launch(const BwdMaps& maps, const BwdArgs& q, int B, int sms,
                   const float* init, const float* dstate, float* ddt,
                   float* dinit, float* da_part, float* dd_part,
                   float* s_chunks, float* ds_chunks, float* decay,
                   cudaStream_t s) {
  const int n_sub = (q.S + kBQ - 1) / kBQ;
  const long long items = static_cast<long long>(B) * q.H * n_sub;
  if (items == 0) return 0;
  if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>(items < sms ? items : static_cast<long long>(sms));
  constexpr int local_smem = LocalSmem::kBytes + 1024;
  constexpr int chunk_smem = BwdSmem::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      local_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chunk_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_local<<<grid, kBThreads, local_smem, s>>>(
      maps, q, static_cast<int>(items), decay);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long quads =
      static_cast<long long>(B) * q.H * q.P * ((q.N + 3) & ~3) / 4;
  ssd_bwd_scan<<<static_cast<unsigned>((quads + kBScanThreads - 1) /
                                       kBScanThreads),
                 kBScanThreads, 0, s>>>(s_chunks, ds_chunks, decay, init,
                                        dstate, dinit, B * q.H, q.P, q.N,
                                        n_sub);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<<<grid, kBThreads, chunk_smem, s>>>(
      maps, q, static_cast<int>(items), ddt, da_part, dd_part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, S, H, P), dt: (B, S, H), b/c: (B, S, G, N), all of the named type
// and read through strides (12 element strides: batch, seq, head|group of
// x, dt, b, c in turn; the last axis of x, b and c contiguous, and x, b, c
// starting on 16 bytes with strides that are multiples of 16 bytes); a,
// d_skip: (H,) f32 (d_skip may be null: no skip term); init: contiguous
// (B, H, P, N) f32 or null (zero); y: contiguous (B, S, H, P) out; state:
// contiguous (B, H, P, N) f32 out.
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

// The backward, f32 only, P and N up to 64 (the wrapper slices wider
// ones).  x, dt, b, c, dy read through `strides` as the forward reads
// them (15 element strides: batch, seq, head|group of x, dt, b, c and dy
// in turn; the last axis of x, b, c and dy contiguous, and x, b, c, dy
// starting on 16 bytes with strides that are multiples of 16 bytes); a,
// d_skip (null: no skip term) (H,); init (null: zero) and dstate (null:
// zero): contiguous (B, H, P, N).  Out, contiguous: dx (B, S, H, p4), ddt
// (B, S, H), db_head and dc_head (B, S, H, n4) per head (the wrapper sums
// each group's), dinit (B, H, P, N, may be null), da_part and dd_part
// (B, H, ceil(S / 64)) per sub-chunk, where p4 and n4 are P and N rounded
// up to a multiple of 4 (columns past P or N are not written), all
// starting on 16 bytes.  Scratch: s_chunks and ds_chunks (B, H,
// ceil(S / 64), P, n4), decay (B, H, ceil(S / 64)).
int ssd_backward_f32(const void* x, const void* dt, const void* a,
                     const void* b, const void* c, const void* d_skip,
                     const void* init, const void* dy, const void* dstate,
                     void* dx, void* ddt, void* db_head, void* dc_head,
                     void* dinit, void* da_part, void* dd_part,
                     void* s_chunks, void* ds_chunks, void* decay,
                     const long long* strides, int B, int S, int H, int G,
                     int P, int N, int device, void* stream) {
  if (P < 1 || P > kBD || N < 1 || N > kBD || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  BwdArgs q{f(dt), f(a), f(d_skip), strides[3], strides[4], strides[5],
            S, H, G, P, N, 0, 0, 0, 0, 0, 0};
  BwdMaps maps;
  if (!bwd_maps(&maps, &q, f(x), f(b), f(c), f(dy), strides, w(dx),
                w(db_head), w(dc_head), w(s_chunks), w(ds_chunks), B))
    return static_cast<int>(cudaErrorInvalidValue);
  return ssd_bwd_launch(maps, q, B, sms, f(init), f(dstate), w(ddt),
                        w(dinit), w(da_part), w(dd_part), w(s_chunks),
                        w(ds_chunks), w(decay),
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
