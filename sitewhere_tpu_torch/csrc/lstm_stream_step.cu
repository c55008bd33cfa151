// One streaming-LSTM step a scored event, in place on device-resident state,
// for Hopper (sm_90a): the pool's and the session's whole dispatch in one
// launch.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA, which
// fuses the gather, the cell and the scatter into a few TPU ops. In the port
// the same step in PyTorch is a chain of about 60 small kernels (7 gathers and
// 7 `index_put_` scatters a state leaf set, the Welford update, two bf16
// products spelled out in float32, four activations, the head, the cast),
// each launched by the host under `torch.func.vmap`: 3–4 ms of the event
// loop a dispatch whatever the batch, while the card works microseconds.
// This kernel is that chain as one launch (`scoring/stream.py`'s
// `streaming_step`, whose plain version is the chain).
//
// What it computes, per dispatch column (tenant t, column j) with device id
// d = dev[t, j] and reading v = val[t, j], on state row t·rows + d — the
// order and the roundings of `StreamingLstmModel.step_score`:
//   1. xn = (v − mean) / √(var + 1e-6); score = |xn − pred| once count ≥
//      min_count, else 0; clipped to [0, clip] (NaN passes, as torch.clamp);
//   2. count' = min(count + 1, window); δ = v − mean; mean' = mean + δ/count';
//      var' = var + ((v − mean')·δ − var) / count';
//   3. x = (v − mean') / √(var' + 1e-6);
//   4. gates = (bf16(bf16(x)·bf16(wx)) + bf16(bf16(h)·bf16(wh))) + b, both
//      products summed in float32 and rounded once to bf16 (`_matmul_round`);
//      c' = σ(f)·c + σ(i)·tanh(g); h' = σ(o)·tanh(c');
//   5. pred' = h'·head_w + head_b, a float32 dot product;
//   6. the state written back to the same row, the score in the ring's
//      score type (float32, float16 or bfloat16, rounded to nearest).
// The scalar arithmetic uses the IEEE-rounded intrinsics (__fadd_rn, …), so
// that no multiply-add is contracted where PyTorch's separate kernels round
// twice; σ is torch's 1 / (1 + expf(−v)) and tanh is tanhf, libm's accurate
// forms, not the SFU's: the state recurs for as long as a device reports, and
// at this size the SFU saves nothing. Only the h·wh sum's order (tensor-core
// accumulation against the plain chain's float32 GEMM) and the head's order
// differ from the plain chain on the card.
//
// What bounds it on this card: bytes. A column reads and writes back h and c
// (2 × H float32), pred, mean, var and count, reads its id and value and
// writes its score: ≈1.07 KB at H=64, ≈17.5 MB for a 16,384-column
// dispatch, ≈5.2 µs at 3.35 TB/s. The arithmetic is 2·H·4H + 8H + 2H ≈ 33 kFLOP a column (≈0.5 µs
// of tensor-core time at 16,384 columns); the five accurate transcendentals
// a cell cost more issue slots than the product, ≈6 µs at 16,384 columns.
//
// Design:
// - A CTA of 8 warps owns one tenant (blockIdx.y) and walks 128-column tiles
//   of its dispatch row (blockIdx.x, then every gridDim.x-th); the grid
//   holds about two CTAs an SM, so the tenant's weights are staged once a
//   CTA: wh as bf16 B fragments in the order a lane reads them (K1's layout,
//   `lstm_window.cu`: gate-local n-tiles, so a lane holds i, f, g and o of
//   its cells), (bf16(wx), b) pairs as float4s, the head's weights.
// - A warp owns 16 columns, the m of mma.m16n8k16. Lanes 0–15 each read one
//   column's id, value and scalar state, score it and write the Welford
//   stats back; shuffles hand each lane the rows and inputs of its fragment
//   rows (grp and grp + 8).
// - h is loaded from its gathered row straight into bf16 A fragments (each
//   load a full 32-byte sector), c into registers in the C layout; the first
//   tile's loads are issued before the weights are staged, so their latency
//   overlaps the staging. Every h of the warp is read before the first mma
//   (mma.sync is warp-synchronous), so writing h' in place is safe.
// - The head is a per-lane partial dot product over its units, summed over
//   the four lanes of a quad.
// - Ids are unique within a tenant's row of the dispatch apart from the
//   scratch row (occurrence rounds), so every real row has one owner; the
//   scratch row may be written by several columns at once, and nobody reads
//   it. An id outside [0, rows) is never read or written (the host checks
//   ids before a launch; this only keeps a stray one off other rows).
// - The kernel allocates nothing and does not synchronise; it runs on the
//   stream it is given (PyTorch's current one).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NUM_SMS_H100 = 132;
constexpr int WARPS = 8;                       // 16-column warp tiles a CTA
constexpr int COLS = 16 * WARPS;               // columns a CTA tile
constexpr int TARGET_CTAS = 2 * NUM_SMS_H100;  // two CTAs an SM
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// torch.sigmoid's float formula on the card: 1 / (1 + exp(−v))
__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// d += a · b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Out>
__device__ __forceinline__ Out to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int H>
struct Shape {
  static constexpr int G = 4 * H;
  static constexpr int UB = H / 8;          // 8-unit blocks
  static constexpr int KB = (H + 15) / 16;  // k16 blocks of h
};

__device__ __forceinline__ float2 load2(const float* p, long row, int H,
                                        int k) {
  return row >= 0 ? *reinterpret_cast<const float2*>(p + row * H + k)
                  : make_float2(0.0f, 0.0f);
}

template <int H, typename Out>
__global__ void __launch_bounds__(32 * WARPS, 2)
lstm_stream_step_kernel(const int* __restrict__ dev,
                        const float* __restrict__ val, int B,
                        float* pred, float* mean, float* var, int* count,
                        float* hs, float* cs, long rows,
                        const float* __restrict__ wx,
                        const float* __restrict__ wh,
                        const float* __restrict__ bias,
                        const float* __restrict__ head_w,
                        const float* __restrict__ head_b,
                        Out* __restrict__ scores, int window, int min_count,
                        float clip) {
  using S = Shape<H>;
  constexpr int UB = S::UB, KB = S::KB, G = S::G;
  constexpr int NTHREADS = 32 * WARPS;

  __shared__ uint4 wf[KB * UB * 2 * 32];  // wh B fragments, [KB][UB][2][32]
  __shared__ float4 wb[UB * 16];          // (wx, wx, b, b), [UB][4][4]
  __shared__ float hw[H];                 // the head's weights

  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const long base = static_cast<long>(t) * rows;  // the tenant's row 0
  dev += static_cast<long>(t) * B;
  val += static_cast<long>(t) * B;
  scores += static_cast<long>(t) * B;
  wx += static_cast<long>(t) * G;
  wh += static_cast<long>(t) * H * G;
  bias += static_cast<long>(t) * G;
  head_w += static_cast<long>(t) * H;
  const float hb = head_b[t];

  const int ntiles = (B + COLS - 1) / COLS;
  bool staged = false;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // 1. lanes 0-15 read one column each; every lane learns the rows of
    // its fragment rows grp and grp + 8
    const int col = tile * COLS + warp * 16 + (lane & 15);
    const bool own = lane < 16 && col < B;
    long row = -1;
    if (own) {
      const int id = dev[col];
      if (id >= 0 && id < rows) row = base + id;
    }
    const long r0 = __shfl_sync(FULL, row, grp);
    const long r1 = __shfl_sync(FULL, row, grp + 8);

    // 2. every load of the tile before any store: the column's value and
    // scalar state, h as bf16 A fragments, c in the C layout
    float v = 0.0f, m = 0.0f, s2 = 0.0f, p = 0.0f;
    int n = 0;
    if (row >= 0) {
      v = val[col];
      m = mean[row];
      s2 = var[row];
      p = pred[row];
      n = count[row];
    }
    uint32_t ha[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const int k = 16 * kb + 2 * tig;
      const float2 a0 = load2(hs, r0, H, k), a1 = load2(hs, r1, H, k);
      ha[kb][0] = pack_bf16(a0.x, a0.y);
      ha[kb][1] = pack_bf16(a1.x, a1.y);
      if (16 * kb + 8 < H) {
        const float2 a2 = load2(hs, r0, H, k + 8), a3 = load2(hs, r1, H, k + 8);
        ha[kb][2] = pack_bf16(a2.x, a2.y);
        ha[kb][3] = pack_bf16(a3.x, a3.y);
      } else {  // H = 8: k padded to 16 with zeros
        ha[kb][2] = 0u;
        ha[kb][3] = 0u;
      }
    }
    float cc[UB][4];
#pragma unroll
    for (int ub = 0; ub < UB; ++ub) {
      const int u = 8 * ub + 2 * tig;
      const float2 c0 = load2(cs, r0, H, u), c1 = load2(cs, r1, H, u);
      cc[ub][0] = c0.x;
      cc[ub][1] = c0.y;
      cc[ub][2] = c1.x;
      cc[ub][3] = c1.y;
    }

    // 3. score, Welford update and the cell's input, in step_score's order
    float x = 0.0f;
    if (row >= 0) {
      const float xn =
          __fdiv_rn(__fsub_rn(v, m), __fsqrt_rn(__fadd_rn(s2, 1e-6f)));
      float score = n >= min_count ? fabsf(__fsub_rn(xn, p)) : 0.0f;
      if (!isnan(score)) score = fminf(fmaxf(score, 0.0f), clip);
      scores[col] = to_out<Out>(score);
      const int n1 = min(n + 1, window);
      const float fn1 = static_cast<float>(n1);
      const float delta = __fsub_rn(v, m);
      const float m1 = __fadd_rn(m, __fdiv_rn(delta, fn1));
      const float d1 = __fsub_rn(v, m1);
      const float s1 = __fadd_rn(
          s2, __fdiv_rn(__fsub_rn(__fmul_rn(d1, delta), s2), fn1));
      mean[row] = m1;
      var[row] = s1;
      count[row] = n1;
      x = __fdiv_rn(d1, __fsqrt_rn(__fadd_rn(s1, 1e-6f)));
    } else if (own) {
      scores[col] = to_out<Out>(0.0f);
    }
    const float xb0 = bf16_round(__shfl_sync(FULL, x, grp));
    const float xb1 = bf16_round(__shfl_sync(FULL, x, grp + 8));

    // 4. the tenant's weights, once a CTA (after the first tile's loads
    // are in flight)
    if (!staged) {
      // wf[((kb·UB + ub)·2 + gp)·32 + l]: B fragments of gates 2gp, 2gp+1
      // for k block kb, unit block ub, lane l (bf16 pairs of consecutive k,
      // zero past H)
      for (int idx = threadIdx.x; idx < KB * UB * 2 * 32; idx += NTHREADS) {
        const int l = idx & 31, gp = (idx >> 5) & 1;
        const int ub = (idx >> 6) % UB, kb = (idx >> 6) / UB;
        const int n = 8 * ub + (l >> 2);
        const int k = 16 * kb + 2 * (l & 3);
        uint32_t w4[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int wcol = (2 * gp + j) * H + n;
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + (e & 1) + 8 * (e >> 1);
            w[e] = kk < H ? wh[kk * G + wcol] : 0.0f;
          }
          w4[2 * j] = pack_bf16(w[0], w[1]);
          w4[2 * j + 1] = pack_bf16(w[2], w[3]);
        }
        wf[idx] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
      // wb[(ub·4 + g)·4 + tig] = (wx[c], wx[c+1], b[c], b[c+1]),
      // c = g·H + 8ub + 2tig; wx rounded to bf16 as `_matmul_round` does
      for (int idx = threadIdx.x; idx < UB * 16; idx += NTHREADS) {
        const int tg = idx & 3, g = (idx >> 2) & 3, ub = idx >> 4;
        const int wcol = g * H + 8 * ub + 2 * tg;
        wb[idx] = make_float4(bf16_round(wx[wcol]), bf16_round(wx[wcol + 1]),
                              bias[wcol], bias[wcol + 1]);
      }
      for (int idx = threadIdx.x; idx < H; idx += NTHREADS) hw[idx] = head_w[idx];
      __syncthreads();
      staged = true;
    }

    // 5. gates, cell and head, 8 units at a time
    float p0 = 0.0f, p1 = 0.0f;  // head partial sums of rows r0, r1
#pragma unroll
    for (int ub = 0; ub < UB; ++ub) {
      float acc[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const uint4* f = wf + ((kb * UB + ub) * 2) * 32 + lane;
        const uint4 w01 = f[0], w23 = f[32];
        mma_bf16(acc[0], ha[kb], w01.x, w01.y);
        mma_bf16(acc[1], ha[kb], w01.z, w01.w);
        mma_bf16(acc[2], ha[kb], w23.x, w23.y);
        mma_bf16(acc[3], ha[kb], w23.z, w23.w);
      }
      const int u = 8 * ub + 2 * tig;
      float hv[4], cv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (r0, u), (r0, u+1), (r1, u), (r1, u+1)
        const float xb = e < 2 ? xb0 : xb1;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 w = wb[(ub * 4 + g) * 4 + tig];
          const float wxg = (e & 1) ? w.y : w.x;
          const float bg = (e & 1) ? w.w : w.z;
          gate[g] = __fadd_rn(__fadd_rn(bf16_round(__fmul_rn(xb, wxg)),
                                        bf16_round(acc[g][e])),
                              bg);
        }
        const float si = sigmoid(gate[0]), sf = sigmoid(gate[1]);
        const float tg = tanhf(gate[2]), so = sigmoid(gate[3]);
        cv[e] = __fadd_rn(__fmul_rn(sf, cc[ub][e]), __fmul_rn(si, tg));
        hv[e] = __fmul_rn(so, tanhf(cv[e]));
      }
      if (r0 >= 0) {
        *reinterpret_cast<float2*>(hs + r0 * H + u) = make_float2(hv[0], hv[1]);
        *reinterpret_cast<float2*>(cs + r0 * H + u) = make_float2(cv[0], cv[1]);
      }
      if (r1 >= 0) {
        *reinterpret_cast<float2*>(hs + r1 * H + u) = make_float2(hv[2], hv[3]);
        *reinterpret_cast<float2*>(cs + r1 * H + u) = make_float2(cv[2], cv[3]);
      }
      p0 = fmaf(hv[1], hw[u + 1], fmaf(hv[0], hw[u], p0));
      p1 = fmaf(hv[3], hw[u + 1], fmaf(hv[2], hw[u], p1));
    }
    p0 += __shfl_xor_sync(FULL, p0, 1);
    p0 += __shfl_xor_sync(FULL, p0, 2);
    p1 += __shfl_xor_sync(FULL, p1, 1);
    p1 += __shfl_xor_sync(FULL, p1, 2);
    if (tig == 0) {
      if (r0 >= 0) pred[r0] = __fadd_rn(p0, hb);
      if (r1 >= 0) pred[r1] = __fadd_rn(p1, hb);
    }
  }
}

template <int H, typename Out>
cudaError_t launch(const int* dev, const float* val, int T, int B, float* pred,
                   float* mean, float* var, int* count, float* h, float* c,
                   long rows, const float* wx, const float* wh,
                   const float* bias, const float* head_w,
                   const float* head_b, void* scores, int window,
                   int min_count, float clip, cudaStream_t stream) {
  const int ntiles = (B + COLS - 1) / COLS;
  const int per_tenant = (TARGET_CTAS + T - 1) / T;
  const dim3 grid(static_cast<unsigned>(ntiles < per_tenant ? ntiles
                                                            : per_tenant),
                  static_cast<unsigned>(T));
  lstm_stream_step_kernel<H, Out><<<grid, 32 * WARPS, 0, stream>>>(
      dev, val, B, pred, mean, var, count, h, c, rows, wx, wh, bias, head_w,
      head_b, static_cast<Out*>(scores), window, min_count, clip);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch(int score_kind, const int* dev, const float* val, int T,
                     int B, float* pred, float* mean, float* var, int* count,
                     float* h, float* c, long rows, const float* wx,
                     const float* wh, const float* bias, const float* head_w,
                     const float* head_b, void* scores, int window,
                     int min_count, float clip, cudaStream_t stream) {
  switch (score_kind) {
    case 0:
      return launch<H, float>(dev, val, T, B, pred, mean, var, count, h, c,
                              rows, wx, wh, bias, head_w, head_b, scores,
                              window, min_count, clip, stream);
    case 1:
      return launch<H, __half>(dev, val, T, B, pred, mean, var, count, h, c,
                               rows, wx, wh, bias, head_w, head_b, scores,
                               window, min_count, clip, stream);
    case 2:
      return launch<H, __nv_bfloat16>(dev, val, T, B, pred, mean, var, count,
                                      h, c, rows, wx, wh, bias, head_w,
                                      head_b, scores, window, min_count, clip,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One step for the [T, B] dispatch dev (int32 device ids) / val (float32):
// state leaves pred, mean, var [T·rows] f32, count [T·rows] int32, h, c
// [T·rows, H] f32 (tenant t's rows start at t·rows), updated in place;
// params stacked per tenant, contiguous f32: wx [T, 4H], wh [T, H, 4H],
// bias [T, 4H], head_w [T, H], head_b [T]; scores [T, B] of score_kind
// (0 float32, 1 float16, 2 bfloat16). H ∈ {8, 16, 32, 64}. Returns a
// cudaError_t (0 on success).
extern "C" int swx_lstm_stream_step(const int* dev, const float* val, int T,
                                    int B, float* pred, float* mean,
                                    float* var, int* count, float* h, float* c,
                                    long rows, const float* wx,
                                    const float* wh, const float* bias,
                                    const float* head_w, const float* head_b,
                                    void* scores, int score_kind, int H,
                                    int window, int min_count, float clip,
                                    void* stream) {
  if (T <= 0 || B <= 0) return cudaSuccess;
  if (T > 65535 || rows <= 0 || window <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 8:
      return dispatch<8>(score_kind, dev, val, T, B, pred, mean, var, count,
                         h, c, rows, wx, wh, bias, head_w, head_b, scores,
                         window, min_count, clip, s);
    case 16:
      return dispatch<16>(score_kind, dev, val, T, B, pred, mean, var, count,
                          h, c, rows, wx, wh, bias, head_w, head_b, scores,
                          window, min_count, clip, s);
    case 32:
      return dispatch<32>(score_kind, dev, val, T, B, pred, mean, var, count,
                          h, c, rows, wx, wh, bias, head_w, head_b, scores,
                          window, min_count, clip, s);
    case 64:
      return dispatch<64>(score_kind, dev, val, T, B, pred, mean, var, count,
                          h, c, rows, wx, wh, bias, head_w, head_b, scores,
                          window, min_count, clip, s);
    default:
      return cudaErrorInvalidValue;
  }
}
