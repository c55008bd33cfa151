// Fused windowed-LSTM recurrence → final hidden state, for Hopper (sm_90a),
// with the per-step h·wh product on the tensor cores.
//
// Replaces the Pallas TPU kernel `_pallas_final` / `_kernel` in
// sitewhere_tpu/ops/lstm_kernel.py (pallas_call at :75). Same function:
// a single-layer LSTM over T scalar steps from zero state, fused i/f/g/o
// gates, returning ONLY the final h [B, H]. Numerics match the Pallas
// kernel: x_t and h enter the products rounded to bf16, wx/wh are rounded
// to bf16 as they are loaded, products are summed in f32 (the x·wx term
// is exact in f32), b is added in f32, gates and state are f32; the gate
// nonlinearities are accurate to a few ulp (see `cell`).
//
// What bounds it on this card: the work is 2·B·T·(1+H)·4H FLOP
// (≈34 GFLOP per flush at B=16384, T=63, H=64 → ≈35 µs at the 989 TFLOP/s
// bf16 dense rate) against ≈8 MB of traffic (xn in, h out, weights once),
// so operations bound it. With the product on the tensor cores, the gate
// nonlinearities set the pace: each (row, unit) cell costs 5
// transcendentals a step; libm's expf/tanhf with IEEE division take
// ≈10 SFU operations and ≈85 FP32 instructions (≈0.35 ms of issue at
// B=16384 on 132 SMs), the SFU form below 7 SFU operations and ≈25 FP32
// instructions. The T-step dependency makes small buckets latency-bound.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, device time per
// launch): ≈0.23 ms at B=16384 (≈7× the bound) and ≈0.036 ms at B=256.
//
// Design:
// - A warp owns a tile of 16 rows (the m of mma.m16n8k16) and a set of
//   8-unit blocks. Each step it runs [16, H] × [H, 4H] with
//   mma.sync.m16n8k16 bf16 → f32, accumulators initialised to
//   fma(x_t, wx, b) in f32. For H=8 the k depth is padded to 16 with zero
//   weight rows and zero h columns.
// - Gate-local accumulators: for a unit block [u0, u0+8) the warp takes
//   the four n-tiles at columns g·H + u0 (g = i, f, g, o). The m16n8 C
//   layout puts the same (row, unit) at the same fragment slot of every
//   n-tile, so a lane holds i, f, g and o of its 4 cells and the c/h
//   update needs no exchange.
// - h as the next A operand: the C fragments of two adjacent unit blocks,
//   rounded to bf16, are exactly one k16 A fragment. When one warp owns
//   every unit of its rows (large buckets), h never leaves registers and
//   the step loop has no barrier. When a tile's units are split over WN
//   warps (small buckets, to shorten the per-step chain and fill the
//   card), each warp writes its bf16 slice of h into a double-buffered
//   shared tile (row stride H+8 bf16: conflict-free fragment reads) and
//   one barrier a step suffices.
// - The dispatcher splits units over up to 8 warps until the grid holds
//   ≈1024 warps (2 a scheduler), and halves the tile to 8 rows (the mma's
//   rows 8-15 carry zeros) when there are fewer 16-row tiles than SMs, so
//   bucket 256 runs on 32 SMs and bucket 1024 on 128 instead of 16 and 64.
// - Units are processed 16 at a time (one k-block of the next h), which
//   caps the live accumulators at 32 a lane.
// - wh is read as f32 and stored once per CTA in shared memory as bf16
//   B fragments, in the order a lane reads them: one 16-byte load feeds
//   two n-tiles, a warp's load covers 512 contiguous bytes (no bank
//   conflicts); 32 KB at H=64. wx and b sit beside it as (wx, wx, b, b)
//   float4s per lane column. The CTA's x rows are staged in shared memory
//   (bf16-rounded, 64 steps at a time, odd row stride); only [rows, H]
//   is written back. The ragged row edge computes on zeros, unstored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NUM_SMS_H100 = 132;
constexpr int TCH = 64;            // steps of x staged at a time
constexpr int XS = TCH + 1;        // odd row stride of the x tile
constexpr int TARGET_WARPS = 1024; // ≈ 2 warps per scheduler on 132 SMs
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The LSTM cell on f32 gate pre-activations: updates c, returns h.
// σ(v) = 1 / (1 + 2^(-v·log2 e)) and tanh v = 2σ(2v) − 1 through the SFU's
// ex2 and reciprocal, accurate to a few ulp (absolute error ≈1e-7), with
// one reciprocal shared by σ(i), σ(f), σ(o) and tanh(g): 7 SFU operations
// a cell, against 10 with a reciprocal each and ≈4× the FP32 instructions
// with libm's expf/tanhf and IEEE division. tanh.approx.f32 (relative
// error 2^-11) is faster but lands more than 2e-3 from the plain version
// on some inputs.
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_(float v) {
  return fmaf(2.0f, sigmoid(2.0f * v), -1.0f);
}

// 1 + 2^(-v·log2 e), the exponent capped at 31 so that a product of four
// stays finite (σ below 2^-31 reads as 2^-31: an error under 5e-10)
__device__ __forceinline__ float denom(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(e) : "f"(fminf(-1.4426950409f * v, 31.0f)));
  return 1.0f + e;
}
__device__ __forceinline__ float cell(float gi, float gf, float gg, float go,
                                      float& c) {
  const float di = denom(gi), df = denom(gf), dg = denom(2.0f * gg),
              dq = denom(go);
  const float pif = di * df, pgq = dg * dq;
  const float r = __fdividef(1.0f, pif * pgq);  // 1 / (di·df·dg·dq)
  const float rif = r * pgq, rgq = r * pif;     // 1/(di·df), 1/(dg·dq)
  c = (rif * di) * c + (rif * df) * fmaf(2.0f, rgq * dq, -1.0f);
  return (rgq * dg) * tanh_(c);
}

// d += a · b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int H>
struct Shape {
  static constexpr int G = 4 * H;
  static constexpr int UB = H / 8;           // 8-unit blocks
  static constexpr int KB = (H + 15) / 16;   // k16 blocks of h
  static constexpr int HS = H + 8;           // bf16 row stride of the h tile
};

template <int H, int WN, int TILES, int MR>
constexpr size_t smem_bytes() {
  using S = Shape<H>;
  constexpr int ROWS = MR * TILES;
  return sizeof(uint4) * S::KB * S::UB * 2 * 32    // wh B fragments
         + sizeof(float4) * S::UB * 16             // (wx, wx, b, b)
         + sizeof(float) * ROWS * XS               // x tile
         + (WN > 1 ? sizeof(uint16_t) * 2 * ROWS * S::HS : 0);  // h tiles
}

// WN warps share the units of each of the CTA's TILES row tiles; a tile
// holds MR real rows (16, or 8 with the mma's rows 8-15 left at zero).
template <int H, int WN, int TILES, int MR>
__global__ void __launch_bounds__(32 * WN * TILES)
lstm_window_final_kernel(const float* __restrict__ xn, long ldx,
                         const float* __restrict__ wx,
                         const float* __restrict__ wh,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int B, int T) {
  using S = Shape<H>;
  constexpr int UB = S::UB, KB = S::KB, G = S::G;
  constexpr int UBW = UB / WN;                // unit blocks a warp owns
  constexpr int CH = UBW < 2 ? UBW : 2;       // unit blocks per chunk
  constexpr int NTHREADS = 32 * WN * TILES;
  constexpr int ROWS = MR * TILES;
  constexpr int HW = S::HS / 2;               // h tile row stride, words
  constexpr int NE = MR == 16 ? 4 : 2;        // fragment slots holding rows
  static_assert(UB % WN == 0 && UBW % CH == 0, "units split evenly");
  static_assert(MR == 8 || MR == 16, "a tile is 8 or 16 rows");

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wf = reinterpret_cast<uint4*>(smem);        // [KB][UB][2][32]
  auto* wb = reinterpret_cast<float4*>(wf + KB * UB * 2 * 32);  // [UB][4][4]
  auto* xs = reinterpret_cast<float*>(wb + UB * 16);            // [ROWS][XS]
  auto* hs = reinterpret_cast<uint32_t*>(xs + ROWS * XS);  // [2][ROWS][HW]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = warp / WN;
  const int ub0 = (warp % WN) * UBW;
  const int grp = lane >> 2, tig = lane & 3;
  const long row0 = static_cast<long>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>(min(static_cast<long>(ROWS), B - row0));

  // wf[((kb·UB + ub)·2 + gp)·32 + l] = B fragments of gates 2gp, 2gp+1 for
  // k block kb, unit block ub, lane l: {b0, b1} of each (bf16 pairs of
  // consecutive k, zero past H)
  for (int idx = threadIdx.x; idx < KB * UB * 2 * 32; idx += NTHREADS) {
    const int l = idx & 31, gp = (idx >> 5) & 1;
    const int ub = (idx >> 6) % UB, kb = (idx >> 6) / UB;
    const int n = 8 * ub + (l >> 2);
    const int k = 16 * kb + 2 * (l & 3);
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (2 * gp + j) * H + n;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k + (e & 1) + 8 * (e >> 1);
        w[e] = kk < H ? wh[kk * G + col] : 0.0f;
      }
      v[2 * j] = pack_bf16(w[0], w[1]);
      v[2 * j + 1] = pack_bf16(w[2], w[3]);
    }
    wf[idx] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  // wb[(ub·4 + g)·4 + tig] = (wx[c], wx[c+1], b[c], b[c+1]), c = g·H+8ub+2tig
  for (int idx = threadIdx.x; idx < UB * 16; idx += NTHREADS) {
    const int tg = idx & 3, g = (idx >> 2) & 3, ub = idx >> 4;
    const int col = g * H + 8 * ub + 2 * tg;
    wb[idx] = make_float4(bf16_round(wx[col]), bf16_round(wx[col + 1]),
                          bias[col], bias[col + 1]);
  }

  uint32_t ha[KB][4];  // h_{t-1} as A fragments, bf16
  float c[UBW][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ha[kb][e] = 0u;
#pragma unroll
  for (int u = 0; u < UBW; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[u][e] = 0.0f;

  const int lr0 = tile * MR + grp;  // the lane's rows: lr0 (and lr0 + 8)
  const float* xr0 = xs + lr0 * XS;
  const float* xr1 = xr0 + 8 * XS;

  for (int t0 = 0; t0 < T; t0 += TCH) {
    const int tn = min(TCH, T - t0);
    if (t0 > 0) __syncthreads();  // every warp is done with the last chunk
    for (int idx = threadIdx.x; idx < ROWS * tn; idx += NTHREADS) {
      const int r = idx / tn, tt = idx - r * tn;
      xs[r * XS + tt] =
          r < nrows ? bf16_round(xn[(row0 + r) * ldx + t0 + tt]) : 0.0f;
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const float x0 = xr0[tt], x1 = MR == 16 ? xr1[tt] : 0.0f;
      uint32_t hn[KB][4];  // h_t as A fragments (WN == 1)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) hn[kb][e] = 0u;
      uint32_t* hbuf = hs + (t & 1) * ROWS * HW;

#pragma unroll
      for (int q = 0; q < UBW / CH; ++q) {
        float acc[CH][4][4];  // [unit block][gate][fragment slot]
#pragma unroll
        for (int u = 0; u < CH; ++u) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float4 w = wb[(ub0 + q * CH + u) * 16 + g * 4 + tig];
            acc[u][g][0] = fmaf(x0, w.x, w.z);
            acc[u][g][1] = fmaf(x0, w.y, w.w);
            acc[u][g][2] = fmaf(x1, w.x, w.z);
            acc[u][g][3] = fmaf(x1, w.y, w.w);
          }
        }
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const uint4* f =
                wf + ((kb * UB + ub0 + q * CH + u) * 2) * 32 + lane;
            const uint4 w01 = f[0], w23 = f[32];
            mma_bf16(acc[u][0], ha[kb], w01.x, w01.y);
            mma_bf16(acc[u][1], ha[kb], w01.z, w01.w);
            mma_bf16(acc[u][2], ha[kb], w23.x, w23.y);
            mma_bf16(acc[u][3], ha[kb], w23.z, w23.w);
          }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int ul = q * CH + u;  // unit block within the warp's set
          const int ub = ub0 + ul;
          float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            hv[e] = cell(acc[u][0][e], acc[u][1][e], acc[u][2][e],
                         acc[u][3][e], c[ul][e]);
          }
          if (t == T - 1) {
            const int col = 8 * ub + 2 * tig;
            if (lr0 < nrows)
              *reinterpret_cast<float2*>(&out[(row0 + lr0) * H + col]) =
                  make_float2(hv[0], hv[1]);
            if (MR == 16 && lr0 + 8 < nrows)
              *reinterpret_cast<float2*>(&out[(row0 + lr0 + 8) * H + col]) =
                  make_float2(hv[2], hv[3]);
          }
          const uint32_t lo = pack_bf16(hv[0], hv[1]);  // row lr0
          const uint32_t hi = pack_bf16(hv[2], hv[3]);  // row lr0 + 8
          if constexpr (WN == 1) {
            hn[ub >> 1][2 * (ub & 1)] = lo;
            hn[ub >> 1][2 * (ub & 1) + 1] = hi;
          } else {
            hbuf[lr0 * HW + 4 * ub + tig] = lo;
            if constexpr (MR == 16) hbuf[(lr0 + 8) * HW + 4 * ub + tig] = hi;
          }
        }
      }

      if constexpr (WN == 1) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int e = 0; e < 4; ++e) ha[kb][e] = hn[kb][e];
      } else {
        __syncthreads();  // h_t is complete; the other buffer is free
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          ha[kb][0] = hbuf[lr0 * HW + 8 * kb + tig];
          ha[kb][2] = hbuf[lr0 * HW + 8 * kb + 4 + tig];
          if constexpr (MR == 16) {
            ha[kb][1] = hbuf[(lr0 + 8) * HW + 8 * kb + tig];
            ha[kb][3] = hbuf[(lr0 + 8) * HW + 8 * kb + 4 + tig];
          }
        }
      }
    }
  }
}

template <int H, int WN, int TILES, int MR>
cudaError_t launch(const float* xn, long ldx, const float* wx, const float* wh,
                   const float* bias, float* out, int B, int T,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H, WN, TILES, MR>();
  static_assert(smem <= MAX_SMEM, "shared memory of one CTA");
  // the attribute is the current card's, so it is set at every launch (a
  // mesh launches on several)
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_window_final_kernel<H, WN, TILES, MR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int ROWS = MR * TILES;
  const unsigned grid = static_cast<unsigned>((B + ROWS - 1) / ROWS);
  lstm_window_final_kernel<H, WN, TILES, MR>
      <<<grid, 32 * WN * TILES, smem, stream>>>(xn, ldx, wx, wh, bias, out, B,
                                                T);
  return cudaGetLastError();
}

// Split each MR-row tile's units over WN warps until the grid holds about
// TARGET_WARPS warps (small buckets: a shorter chain a step and more SMs
// busy); pack four warps into a CTA, sharing one weight copy, once that
// still leaves a CTA for every SM.
template <int H, int MR>
cudaError_t dispatch_rows(const float* xn, long ldx, const float* wx,
                          const float* wh, const float* bias, float* out,
                          int B, int T, cudaStream_t stream) {
  constexpr int UB = H / 8;
  const long tiles = (B + MR - 1) / MR;
  int wn = 1;
  while (wn < UB && wn < 8 && tiles * wn < TARGET_WARPS) wn *= 2;
  const bool pack = tiles * wn >= 4L * NUM_SMS_H100;
  if (wn == 1) {
    if constexpr (MR == 16) {
      if (pack)
        return launch<H, 1, 4, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
    }
    return launch<H, 1, 1, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
  }
  if constexpr (UB >= 2) {
    if (wn == 2) {
      if constexpr (MR == 16) {
        if (pack)
          return launch<H, 2, 2, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
      }
      return launch<H, 2, 1, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
    }
  }
  if constexpr (UB >= 4) {
    if (wn == 4)
      return launch<H, 4, 1, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
  }
  if constexpr (UB >= 8) {
    if (wn == 8)
      return launch<H, 8, 1, MR>(xn, ldx, wx, wh, bias, out, B, T, stream);
  }
  return cudaErrorInvalidConfiguration;
}

// Fewer 16-row tiles than SMs: halve the tile, so that twice as many SMs
// share the per-step gate work (the mma's rows 8-15 then carry zeros).
template <int H>
cudaError_t dispatch(const float* xn, long ldx, const float* wx,
                     const float* wh, const float* bias, float* out, int B,
                     int T, cudaStream_t stream) {
  if ((B + 15) / 16 < NUM_SMS_H100)
    return dispatch_rows<H, 8>(xn, ldx, wx, wh, bias, out, B, T, stream);
  return dispatch_rows<H, 16>(xn, ldx, wx, wh, bias, out, B, T, stream);
}

}  // namespace

// xn [B, ldx] f32 (first T columns used), wx [4H] f32, wh [H, 4H] f32,
// bias [4H] f32 → out [B, H] f32; H ∈ {8, 16, 32, 64}. wx and wh are
// rounded to bf16 as they are loaded. Returns a cudaError_t (0 on success).
extern "C" int swx_lstm_window_final(const float* xn, long ldx, const float* wx,
                                     const float* wh, const float* bias,
                                     float* out, int B, int T, int H,
                                     void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T <= 0 || ldx < T) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 8:
      return dispatch<8>(xn, ldx, wx, wh, bias, out, B, T, s);
    case 16:
      return dispatch<16>(xn, ldx, wx, wh, bias, out, B, T, s);
    case 32:
      return dispatch<32>(xn, ldx, wx, wh, bias, out, B, T, s);
    case 64:
      return dispatch<64>(xn, ldx, wx, wh, bias, out, B, T, s);
    default:
      return cudaErrorInvalidValue;
  }
}
