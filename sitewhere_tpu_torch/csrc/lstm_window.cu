// Fused windowed-LSTM recurrence → final hidden state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pallas_final` / `_kernel` in
// sitewhere_tpu/ops/lstm_kernel.py (pallas_call at :75). Same function:
// a single-layer LSTM over T scalar steps from zero state, fused i/f/g/o
// gates, returning ONLY the final h [B, H]. Numerics match the Pallas
// kernel: x_t and h enter the products rounded to bf16, wx/wh are bf16,
// products are summed in f32, b is added in f32, gates and state are f32
// with accurate expf/tanhf (build without --use_fast_math).
//
// What bounds it on this card: the work is 2·B·T·(1+H)·4H FLOP
// (≈34 GFLOP per flush at B=16384, T=63, H=64 → ≈35 µs at the 989 TFLOP/s
// bf16 dense rate) against ≈8 MB of traffic (xn in, h out, weights once),
// so operations, not bytes, bound it; the T-step dependency makes small
// buckets latency-bound. This first version runs the products as f32 FMAs
// on the CUDA cores (67 TFLOP/s f32 peak, so ≈0.5 ms at B=16384); moving
// them onto the tensor cores (mma.sync / wgmma) is the next step.
//
// Design, after what the Pallas kernel keeps out of device memory:
// - One CTA per tile of ROWS = ROW_GROUPS·RPT rows. wh (as f32 pairs of
//   consecutive k, 64 KB at H=64), the tile's x rows and h live in shared
//   memory for all T steps; c stays in registers; only [rows, H] is
//   written back.
// - Thread (j, rg) owns hidden unit j of RPT rows and computes gates
//   j, H+j, 2H+j, 3H+j, so the c/h update is thread-local. Each weight
//   pair read from shared memory feeds RPT rows. Two __syncthreads a step:
//   one after every thread has read h_{t-1}, one after h_t is written.
// - RPT is 1 for small buckets (two rows per CTA: bucket 256 → 128 CTAs
//   on 132 SMs) and 4 once the grid still fills the card twice over.
// - The ragged edge is masked: missing rows compute on zeros and are not
//   stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int ROW_GROUPS = 2;  // blockDim.y
constexpr int NUM_SMS_H100 = 132;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int H, int RPT>
__global__ void __launch_bounds__(H * ROW_GROUPS)
lstm_window_final_kernel(const float* __restrict__ xn, long ldx,
                         const __nv_bfloat16* __restrict__ wx,
                         const __nv_bfloat16* __restrict__ wh,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int B, int T) {
  constexpr int G = 4 * H;
  constexpr int ROWS = ROW_GROUPS * RPT;
  constexpr int NTHREADS = H * ROW_GROUPS;
  extern __shared__ __align__(16) unsigned char smem[];
  // ws[kp][c] = (wh[2kp][c], wh[2kp+1][c]) as f32
  float2* ws = reinterpret_cast<float2*>(smem);
  float* hs = reinterpret_cast<float*>(ws + (H / 2) * G);  // [ROWS][H]
  float* xs = hs + ROWS * H;                               // [ROWS][T]

  const int j = threadIdx.x;
  const int rg = threadIdx.y;
  const int tid = rg * H + j;
  const long row0 = static_cast<long>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>(min(static_cast<long>(ROWS), B - row0));

  for (int idx = tid; idx < (H / 2) * G; idx += NTHREADS) {
    const int kp = idx / G, c = idx - kp * G;
    ws[idx] = make_float2(__bfloat162float(wh[(2 * kp) * G + c]),
                          __bfloat162float(wh[(2 * kp + 1) * G + c]));
  }
  for (int idx = tid; idx < ROWS * T; idx += NTHREADS) {
    const int r = idx / T, t = idx - r * T;
    xs[idx] = r < nrows ? bf16_round(xn[(row0 + r) * ldx + t]) : 0.0f;
  }
  for (int idx = tid; idx < ROWS * H; idx += NTHREADS) hs[idx] = 0.0f;

  float wxg[4], bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    wxg[g] = __bfloat162float(wx[g * H + j]);
    bg[g] = bias[g * H + j];
  }
  float c[RPT], h_last[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = h_last[r] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

#pragma unroll 4
    for (int kp = 0; kp < H / 2; ++kp) {
      float2 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = ws[kp * G + g * H + j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float2 hv =
            *reinterpret_cast<const float2*>(&hs[(rg * RPT + r) * H + 2 * kp]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = fmaf(hv.x, w[g].x, acc[r][g]);
          acc[r][g] = fmaf(hv.y, w[g].y, acc[r][g]);
        }
      }
    }
    __syncthreads();  // every thread has read h_{t-1}

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int lr = rg * RPT + r;
      const float x = xs[lr * T + t];
      // x·wx is exact in f32 (bf16 × bf16), so the fma equals
      // dot(x, wx) + dot(h, wh) as the Pallas kernel sums them
      const float gi = fmaf(x, wxg[0], acc[r][0]) + bg[0];
      const float gf = fmaf(x, wxg[1], acc[r][1]) + bg[1];
      const float gg = fmaf(x, wxg[2], acc[r][2]) + bg[2];
      const float go = fmaf(x, wxg[3], acc[r][3]) + bg[3];
      c[r] = sigmoid(gf) * c[r] + sigmoid(gi) * tanhf(gg);
      const float h = sigmoid(go) * tanhf(c[r]);
      h_last[r] = h;
      hs[lr * H + j] = bf16_round(h);
    }
    __syncthreads();  // h_t is complete
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lr = rg * RPT + r;
    if (lr < nrows) out[(row0 + lr) * H + j] = h_last[r];
  }
}

template <int H, int RPT>
cudaError_t launch(const float* xn, long ldx, const __nv_bfloat16* wx,
                   const __nv_bfloat16* wh, const float* bias, float* out,
                   int B, int T, cudaStream_t stream) {
  constexpr int ROWS = ROW_GROUPS * RPT;
  const size_t smem = sizeof(float2) * (H / 2) * (4 * H) +
                      sizeof(float) * ROWS * (H + T);
  static size_t configured = 0;  // largest dynamic smem opted into so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_window_final_kernel<H, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const unsigned grid = static_cast<unsigned>((B + ROWS - 1) / ROWS);
  lstm_window_final_kernel<H, RPT>
      <<<grid, dim3(H, ROW_GROUPS), smem, stream>>>(xn, ldx, wx, wh, bias,
                                                    out, B, T);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch(const float* xn, long ldx, const __nv_bfloat16* wx,
                     const __nv_bfloat16* wh, const float* bias, float* out,
                     int B, int T, cudaStream_t stream) {
  // four rows a thread once the grid still covers every SM twice
  if ((B + ROW_GROUPS * 4 - 1) / (ROW_GROUPS * 4) >= 2 * NUM_SMS_H100)
    return launch<H, 4>(xn, ldx, wx, wh, bias, out, B, T, stream);
  return launch<H, 1>(xn, ldx, wx, wh, bias, out, B, T, stream);
}

}  // namespace

// xn [B, ldx] f32 (first T columns used), wx [4H] bf16, wh [H, 4H] bf16,
// bias [4H] f32 → out [B, H] f32. Returns a cudaError_t (0 on success).
extern "C" int swx_lstm_window_final(const float* xn, long ldx, const void* wx,
                                     const void* wh, const float* bias,
                                     float* out, int B, int T, int H,
                                     void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T <= 0 || ldx < T) return cudaErrorInvalidValue;
  const auto* wxb = static_cast<const __nv_bfloat16*>(wx);
  const auto* whb = static_cast<const __nv_bfloat16*>(wh);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return dispatch<32>(xn, ldx, wxb, whb, bias, out, B, T, s);
    case 64:
      return dispatch<64>(xn, ldx, wxb, whb, bias, out, B, T, s);
    default:
      return cudaErrorInvalidValue;
  }
}
