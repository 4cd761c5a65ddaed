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


// ------------------------------------------------------------- backward
// No TPU kernel: the reference differentiates ssd_chunked (plus the D
// skip term) with JAX autodiff.  Per (batch, head), with the (P, N) state
//     S_t = e_t S_{t-1} + dt_t x_t B_t^T,  e_t = exp(a dt_t),
//     y_t = S_t C_t + d x_t                (y reads S_t: inclusive),
// dS_t = dL/dS_t and the final state's gradient dS_T (zero when none is
// given):
//     dS_t  = e_{t+1} dS_{t+1} + dy_t C_t^T
//     dC_t  = S_t^T dy_t,  dB_t = dt_t dS_t^T x_t,
//     dx_t  = dt_t dS_t B_t + d dy_t,  dd = sum dy . x,
//     dinit = e_0 dS_0,
//     g_t   = C_t . dC_t - B_t . dB_t,
//     D_m   = <S_e, dS_e> + sum_{m <= t <= e} g_t,
//     ddt_m = a D_m + x_m^T dS_m B_m,  da = sum_m dt_m D_m,
// where D_m = e_m <dS_m, S_{m-1}> is the gradient of the decay's exponent
// and (S_e, dS_e) are the state at any later step e and the gradient it
// gets from the steps after e: here the last step of m's chunk, so no sum
// runs past one chunk.  dB and dC sum over the heads of a group, and da,
// dd over batch and steps: the kernels write per-head gradients and
// per-CTA partials, and the wrapper sums them in a fixed order (no
// atomics: two calls give the same bits).
//
// What bounds it: the function reads x, dt, B, C and dy and writes dx,
// dt's, B's and C's gradients (0.12 ms of bytes at zamba2-1.2b's training
// shape), against 12 P N flops per (batch, step, head) of the exact
// recurrences on the CUDA cores: the S and dS recurrences and the
// products S^T dy, dS^T x and dS B (0.38 ms at the FP32 peak).  So
// operations bound it; the walks along S add the wait of each step on
// the one before.
//
// Design: state passing over chunks of L steps (the wrapper's, as WKV6's),
// the chunk states recomputed rather than kept from the forward (whose
// tensor-core chunks of 64 would have to write them: 134 MB a layer at
// zamba2-1.2b's shape).  D threads a CTA (D = 32, 64 or 128 covering P and
// N, padded with zeros that stay zero), each with a row or a column of S
// or dS in registers, so every sum of a step is the thread's own:
//   1. ssd_bwd_local: two CTAs a chunk, thread n on column n: the chunk's
//      state from a zero state, and its gradient at its start from a zero
//      gradient at its end, sum_t E_t dy_t C_t^T (E_t the product of e over
//      the chunk's steps up to t), with the chunk's decay product;
//   2. ssd_bwd_scan: one thread an element: carries the state forward
//      across chunks from the initial state (S_in_c) and the gradient
//      backward from dS_T (dS_out_c), each over its local values, and
//      writes dinit;
//   3. ssd_bwd_chunk: three CTAs a chunk.  Columns of S: a forward walk
//      from S_in_c emits dC per head and ends with <S_e, dS_out_c>.
//      Columns of dS: a reverse walk from dS_out_c emits dS^T x per head.
//      Rows of dS: a reverse walk emits dx;
//   4. ssd_bwd_dt: one warp a chunk walks it backward over the per-head
//      dC and dS^T x: the dots C . dC, B . dS^T x and dy . x, D, ddt, dB =
//      dt dS^T x in place, and the CTA's partials of da and dd.
// Steps arrive kBwdStage at a time in shared memory with e = exp(a dt);
// padded steps are never walked, and e underflows to 0, which is exact.

constexpr int kBwdStage = 8;
constexpr int kBwdScanThreads = 256;

template <int D>
struct BwdStage {
  float x[kBwdStage][D], g[kBwdStage][D], b[kBwdStage][D], c[kBwdStage][D];
  float dt[kBwdStage], e[kBwdStage];
};

struct BwdArgs {
  const float *x, *dt, *b, *c, *dy;
  Strides st;
  float a;  // this head's
  int S, H, P, N, b_idx, h, g;
};

// steps [t0, t0 + nt) into `st`, zero past P, N and nt; waits for the stage
// before to be consumed
template <int D>
__device__ __forceinline__ void bwd_load(BwdStage<D>& st, const BwdArgs& q,
                                         int t0, int nt) {
  __syncthreads();
  const int tid = threadIdx.x;
  for (int e = tid; e < kBwdStage * D; e += D) {
    const int tt = e / D, j = e - tt * D;
    const long long t = t0 + tt;
    const bool step = tt < nt;
    const bool in_p = step && j < q.P, in_n = step && j < q.N;
    st.x[tt][j] = in_p ? q.x[q.b_idx * q.st.x_b + t * q.st.x_s +
                             q.h * q.st.x_h + j] : 0.f;
    st.g[tt][j] = in_p ? q.dy[((q.b_idx * static_cast<long long>(q.S) + t) *
                               q.H + q.h) * q.P + j] : 0.f;
    st.b[tt][j] = in_n ? q.b[q.b_idx * q.st.b_b + t * q.st.b_s +
                             q.g * q.st.b_g + j] : 0.f;
    st.c[tt][j] = in_n ? q.c[q.b_idx * q.st.c_b + t * q.st.c_s +
                             q.g * q.st.c_g + j] : 0.f;
  }
  if (tid < kBwdStage) {
    const float dt = tid < nt ? q.dt[q.b_idx * q.st.dt_b +
                                     (t0 + tid) * q.st.dt_s +
                                     q.h * q.st.dt_h] : 0.f;
    st.dt[tid] = dt;
    st.e[tid] = expf(q.a * dt);
  }
  __syncthreads();
}

__device__ __forceinline__ BwdArgs bwd_args(
    const float* x, const float* dt, const float* a, const float* b,
    const float* c, const float* dy, const Strides& st, int S, int H, int G,
    int P, int N, int bh) {
  const int bi = bh / H, h = bh - bi * H;
  return BwdArgs{x, dt, b, c, dy, st, a[h], S, H, P, N, bi, h, h / (H / G)};
}

// Pass 1, two CTAs a chunk: the chunk's state from zero (first half of the
// grid) and its gradient at its start from a zero end gradient, with its
// decay product (second half).
template <int D>
__global__ void __launch_bounds__(D)
ssd_bwd_local(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dy,
              Strides strides, float* __restrict__ s_chunks,
              float* __restrict__ ds_chunks, float* __restrict__ decay,
              int S, int H, int G, int P, int N, int L, int n_chunks) {
  __shared__ BwdStage<D> st;
  const int n_ctas = gridDim.x / 2;
  const bool grad = static_cast<int>(blockIdx.x) >= n_ctas;
  const int bhc = blockIdx.x - (grad ? n_ctas : 0);
  const int bh = bhc / n_chunks, ch = bhc - bh * n_chunks;
  const BwdArgs q = bwd_args(x, dt, a, bm, cm, dy, strides, S, H, G, P, N,
                             bh);
  const int n = threadIdx.x;
  const int c0 = ch * L, c1 = min(S, c0 + L);
  float s[D];
#pragma unroll
  for (int p = 0; p < D; ++p) s[p] = 0.f;
  float run = 1.f;  // the product of e up to this step
  for (int t0 = c0; t0 < c1; t0 += kBwdStage) {
    const int nt = min(kBwdStage, c1 - t0);
    bwd_load<D>(st, q, t0, nt);
    for (int tt = 0; tt < nt; ++tt) {
      if (!grad) {
        const float bn = st.dt[tt] * st.b[tt][n], et = st.e[tt];
#pragma unroll
        for (int p = 0; p < D; ++p)
          s[p] = fmaf(et, s[p], st.x[tt][p] * bn);
      } else {
        run *= st.e[tt];
        const float cn = run * st.c[tt][n];
#pragma unroll
        for (int p = 0; p < D; ++p) s[p] = fmaf(cn, st.g[tt][p], s[p]);
      }
    }
  }
  float* out = (grad ? ds_chunks : s_chunks) +
               static_cast<long long>(bhc) * P * N + n;
  if (n < N) {
#pragma unroll
    for (int p = 0; p < D; ++p)
      if (p < P) out[p * N] = s[p];
  }
  if (grad && n == 0) decay[bhc] = run;
}

// Pass 2, one thread an element of (B, H, P, N): S_in_c forward from the
// initial state (null: zero), dS_out_c backward from dS_T (null: zero),
// each written over the chunk's local value; dinit (may be null) last.
__global__ void __launch_bounds__(kBwdScanThreads)
ssd_bwd_scan(float* __restrict__ s_chunks, float* __restrict__ ds_chunks,
             const float* __restrict__ decay, const float* __restrict__ init,
             const float* __restrict__ dstate, float* __restrict__ dinit,
             int BH, int PN, int n_chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) *
                            kBwdScanThreads + threadIdx.x;
  if (idx >= static_cast<long long>(BH) * PN) return;
  const int bh = static_cast<int>(idx / PN);
  const int e = static_cast<int>(idx - static_cast<long long>(bh) * PN);
  const long long off = static_cast<long long>(bh) * n_chunks * PN + e;
  const float* dec = decay + static_cast<long long>(bh) * n_chunks;
  float carry = init ? init[idx] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float loc = s_chunks[off + static_cast<long long>(c) * PN];
    s_chunks[off + static_cast<long long>(c) * PN] = carry;
    carry = fmaf(dec[c], carry, loc);
  }
  carry = dstate ? dstate[idx] : 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const float loc = ds_chunks[off + static_cast<long long>(c) * PN];
    ds_chunks[off + static_cast<long long>(c) * PN] = carry;
    carry = fmaf(dec[c], carry, loc);
  }
  if (dinit) dinit[idx] = carry;
}

// Pass 3, three CTAs a chunk: columns of S (dC per head, <S_e, dS_out_c>),
// columns of dS (dS^T x per head), rows of dS (dx).
template <int D>
__global__ void __launch_bounds__(D)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dy,
              const float* __restrict__ d_skip, Strides strides,
              const float* __restrict__ s_chunks,
              const float* __restrict__ ds_chunks, float* __restrict__ dx,
              float* __restrict__ dc_head, float* __restrict__ dsx_head,
              float* __restrict__ sds, int S, int H, int G, int P, int N,
              int L, int n_chunks) {
  __shared__ BwdStage<D> st;
  __shared__ float red[D / 32];
  const int n_ctas = gridDim.x / 3;
  const int role = blockIdx.x / n_ctas;
  const int bhc = blockIdx.x - role * n_ctas;
  const int bh = bhc / n_chunks, ch = bhc - bh * n_chunks;
  const BwdArgs q = bwd_args(x, dt, a, bm, cm, dy, strides, S, H, G, P, N,
                             bh);
  const int tid = threadIdx.x;
  const int c0 = ch * L, c1 = min(S, c0 + L);
  const int n_stages = (c1 - c0 + kBwdStage - 1) / kBwdStage;
  const long long cs = static_cast<long long>(bhc) * P * N;
  // per-head rows of (B, S, H, N) and (B, S, H, P), step t
  auto head_row = [&](int t, int w) {
    return ((q.b_idx * static_cast<long long>(S) + t) * H + q.h) * w;
  };
  float s[D];

  if (role == 0) {
    // column n of S, forward from S_in_c: dC_t[n] = sum_p S_t[p, n] dy_t[p]
    const int n = tid;
#pragma unroll
    for (int p = 0; p < D; ++p)
      s[p] = n < N && p < P ? s_chunks[cs + p * N + n] : 0.f;
    for (int sg = 0; sg < n_stages; ++sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<D>(st, q, t0, nt);
      for (int tt = 0; tt < nt; ++tt) {
        const float bn = st.dt[tt] * st.b[tt][n], et = st.e[tt];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < D; ++p) {
          s[p] = fmaf(et, s[p], st.x[tt][p] * bn);
          acc[p & 3] = fmaf(s[p], st.g[tt][p], acc[p & 3]);
        }
        if (n < N)
          dc_head[head_row(t0 + tt, N) + n] = (acc[0] + acc[1]) +
                                              (acc[2] + acc[3]);
      }
    }
    // <S_e, dS_out_c>: this column's share, then the CTA's in order
    float part = 0.f;
    if (n < N) {
#pragma unroll
      for (int p = 0; p < D; ++p)
        if (p < P) part = fmaf(s[p], ds_chunks[cs + p * N + n], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < D / 32; ++w) total += red[w];
      sds[bhc] = total;
    }
  } else if (role == 1) {
    // column n of dS, backward from dS_out_c: (dS_t^T x_t)[n]
    const int n = tid;
#pragma unroll
    for (int p = 0; p < D; ++p)
      s[p] = n < N && p < P ? ds_chunks[cs + p * N + n] : 0.f;
    for (int sg = n_stages - 1; sg >= 0; --sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<D>(st, q, t0, nt);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float cn = st.c[tt][n], et = st.e[tt];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < D; ++p) {
          s[p] = fmaf(st.g[tt][p], cn, s[p]);  // dS_t
          acc[p & 3] = fmaf(s[p], st.x[tt][p], acc[p & 3]);
          s[p] *= et;  // its share of dS_{t-1}
        }
        if (n < N)
          dsx_head[head_row(t0 + tt, N) + n] = (acc[0] + acc[1]) +
                                               (acc[2] + acc[3]);
      }
    }
  } else {
    // row p of dS, backward from dS_out_c: dx_t[p] = dt_t (dS_t B_t)[p]
    // + d dy_t[p]
    const int p = tid;
    const float dh = d_skip ? d_skip[q.h] : 0.f;
#pragma unroll
    for (int n = 0; n < D; ++n)
      s[n] = p < P && n < N ? ds_chunks[cs + p * N + n] : 0.f;
    for (int sg = n_stages - 1; sg >= 0; --sg) {
      const int t0 = c0 + sg * kBwdStage, nt = min(kBwdStage, c1 - t0);
      bwd_load<D>(st, q, t0, nt);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float gp = st.g[tt][p], et = st.e[tt];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < D; ++n) {
          s[n] = fmaf(gp, st.c[tt][n], s[n]);
          acc[n & 3] = fmaf(s[n], st.b[tt][n], acc[n & 3]);
          s[n] *= et;
        }
        if (p < P)
          dx[head_row(t0 + tt, P) + p] = fmaf(
              st.dt[tt], (acc[0] + acc[1]) + (acc[2] + acc[3]), dh * gp);
      }
    }
  }
}

// sum over a warp, the same order on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass 4, one warp a chunk, backward over its steps: ddt, dB per head in
// place (dt dS^T x), and the chunk's partials of da and dd.
__global__ void __launch_bounds__(32)
ssd_bwd_dt(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dy,
           Strides q, const float* __restrict__ dc_head,
           float* __restrict__ dsx_head, const float* __restrict__ sds,
           float* __restrict__ ddt, float* __restrict__ da_part,
           float* __restrict__ dd_part, int S, int H, int G, int P, int N,
           int L, int n_chunks) {
  const int bhc = blockIdx.x;
  const int bh = bhc / n_chunks, ch = bhc - bh * n_chunks;
  const int bi = bh / H, h = bh - bi * H, g = h / (H / G);
  const int lane = threadIdx.x;
  const float ah = a[h];
  const int c0 = ch * L, c1 = min(S, c0 + L);
  float dac = sds[bhc];  // D: <S_e, dS_out_c>, then the g_t added
  float da = 0.f, dd = 0.f;
  for (int t = c1 - 1; t >= c0; --t) {
    const long long hn = ((bi * static_cast<long long>(S) + t) * H + h) * N;
    const long long hp = ((bi * static_cast<long long>(S) + t) * H + h) * P;
    const float* bt = bm + bi * q.b_b + t * q.b_s + g * q.b_g;
    const float* ct = cm + bi * q.c_b + t * q.c_s + g * q.c_g;
    const float* xt = x + bi * q.x_b + t * q.x_s + h * q.x_h;
    const float dtt = dt[bi * q.dt_b + t * q.dt_s + h * q.dt_h];
    float cdc = 0.f, bsx = 0.f, gx = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float sx = dsx_head[hn + n];
      cdc = fmaf(ct[n], dc_head[hn + n], cdc);
      bsx = fmaf(bt[n], sx, bsx);
      dsx_head[hn + n] = dtt * sx;  // dB of this head
    }
    for (int p = lane; p < P; p += 32) gx = fmaf(dy[hp + p], xt[p], gx);
    cdc = warp_sum(cdc);
    bsx = warp_sum(bsx);  // x^T dS B
    gx = warp_sum(gx);
    dac += fmaf(-dtt, bsx, cdc);  // g_t = C . dC - dt x^T dS B
    if (lane == 0) ddt[(bi * static_cast<long long>(S) + t) * H + h] =
        fmaf(ah, dac, bsx);
    da = fmaf(dtt, dac, da);
    dd += gx;
  }
  if (lane == 0) {
    da_part[bhc] = da;
    dd_part[bhc] = dd;
  }
}

template <int D>
int ssd_bwd_launch_d(const float* x, const float* dt, const float* a,
                     const float* b, const float* c, const float* d_skip,
                     const float* init, const float* dy, const float* dstate,
                     float* dx, float* ddt, float* db_head, float* dc_head,
                     float* dinit, float* da_part, float* dd_part,
                     float* s_chunks, float* ds_chunks, float* decay,
                     float* sds, const Strides& st, int B, int S, int H,
                     int G, int P, int N, int L, cudaStream_t s) {
  const int n_chunks = (S + L - 1) / L;
  const long long ctas = static_cast<long long>(B) * H * n_chunks;
  if (ctas == 0) return 0;
  cudaError_t err;
  ssd_bwd_local<D><<<static_cast<unsigned>(2 * ctas), D, 0, s>>>(
      x, dt, a, b, c, dy, st, s_chunks, ds_chunks, decay, S, H, G, P, N, L,
      n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(B) * H * P * N;
  ssd_bwd_scan<<<static_cast<unsigned>((elems + kBwdScanThreads - 1) /
                                       kBwdScanThreads),
                 kBwdScanThreads, 0, s>>>(s_chunks, ds_chunks, decay, init,
                                          dstate, dinit, B * H, P * N,
                                          n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<D><<<static_cast<unsigned>(3 * ctas), D, 0, s>>>(
      x, dt, a, b, c, dy, d_skip, st, s_chunks, ds_chunks, dx, dc_head,
      db_head, sds, S, H, G, P, N, L, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dt<<<static_cast<unsigned>(ctas), 32, 0, s>>>(
      x, dt, a, b, c, dy, st, dc_head, db_head, sds, ddt, da_part, dd_part,
      S, H, G, P, N, L, n_chunks);
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

// The backward, f32 only.  x, dt, b, c read through `strides` as the
// forward reads them (any alignment); a, d_skip (null: no skip term) (H,);
// init (null: zero) and dstate (null: zero): contiguous (B, H, P, N); dy:
// contiguous (B, S, H, P).  Out: dx (B, S, H, P), ddt (B, S, H), db_head
// and dc_head (B, S, H, N) per head (the wrapper sums each group's),
// dinit (B, H, P, N, may be null), da_part and dd_part (B, H, ceil(S /
// L)).  Scratch: s_chunks and ds_chunks (B, H, ceil(S / L), P, N), decay
// and sds (B, H, ceil(S / L)).  L: steps per chunk (>= 1).
int ssd_backward_f32(const void* x, const void* dt, const void* a,
                     const void* b, const void* c, const void* d_skip,
                     const void* init, const void* dy, const void* dstate,
                     void* dx, void* ddt, void* db_head, void* dc_head,
                     void* dinit, void* da_part, void* dd_part,
                     void* s_chunks, void* ds_chunks, void* decay, void* sds,
                     const long long* strides, int B, int S, int H, int G,
                     int P, int N, int L, int device, void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || G < 1 || H % G || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
#define SSD_BWD(DD)                                                         \
  ssd_bwd_launch_d<DD>(f(x), f(dt), f(a), f(b), f(c), f(d_skip), f(init),   \
                       f(dy), f(dstate), w(dx), w(ddt), w(db_head),         \
                       w(dc_head), w(dinit), w(da_part), w(dd_part),        \
                       w(s_chunks), w(ds_chunks), w(decay), w(sds), st, B,  \
                       S, H, G, P, N, L, s)
  switch (tile_of(P > N ? P : N)) {
    case 32: return SSD_BWD(32);
    case 64: return SSD_BWD(64);
    default: return SSD_BWD(128);
  }
#undef SSD_BWD
}

}  // extern "C"
