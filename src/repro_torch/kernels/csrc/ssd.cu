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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 on a finite value, as two integer operations (the
// instruction also screens for inf / NaN, which costs three more)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // extern "C"
