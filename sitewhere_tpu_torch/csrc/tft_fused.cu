// The pointwise work of the Temporal Fusion Transformer's forward, fused
// beside its float32 products, for Hopper (sm_90a): K3.
//
// Replaces no Pallas kernel: the JAX package leaves the TFT's forward to XLA
// (`sitewhere_tpu/models/tft.py`). In the port every dense layer spells the
// reference's bf16 product out in float32 (`models/common.py`'s
// `_matmul_round`: the operand cast to bf16 and back, the weight the same,
// a float32 sgemm, the product cast to bf16 and back) and adds its bias in
// a broadcast kernel; around the products sit ELU, the GLU's sigmoid and
// multiply, the residual add and LayerNorm's ten pointwise kernels, and the
// recurrence spends about 14 launches a step around its one product. At
// the published electricity widths (168 + 24 steps, d = 160) those passes
// took about twice the card's product time, and their launches held the
// host. Each kernel here is one of those chains as one pass that reads a
// product's float32 output once and writes the next product's operand once
// (`ops/tft_fused.py`, whose plain versions are the chains).
//
// Bit for bit with the chains, so with the benchmark's reference: the
// float32 products (cuBLAS, sequential float32 sums) and the reductions
// (LayerNorm's means, the softmaxes) stay PyTorch's, and every pointwise
// step here is the chain's, in its order, rounded where the chain
// materialises a float32 tensor: __fadd_rn / __fmul_rn / __fdiv_rn, which
// nvcc never contracts into a multiply-add, and the accurate libdevice
// functions PyTorch's kernels call (expf, expm1f, tanhf, rsqrtf), built
// without fast-math. The casts round to nearest even like c10's. σ(v) is
// torch's 1 / (1 + expf(−v)).
//
// What bounds it on this card: bytes. Every kernel is a pass over rows of
// float32 columns, a few FLOP an element against 8–20 bytes; at 3.35 TB/s
// a [16,384 × 168, 160] float32 tensor (1.76 GB) takes 0.53 ms to read.
//
// Layout: every operand is a float32 view of the call's row space
// [R0, R1, R2] by columns, given as (pointer, s0, s1, s2, sc) in elements:
// R0 is the tenant axis of a vmapped call (1 otherwise), a stride 0 row
// dimension broadcasts (a bias, a context row over a window's steps), and
// sc is the column stride (0 for a per-row scalar such as LayerNorm's mean).
// A thread takes V consecutive columns of a row (V = 4, one 16-byte load
// an operand, where the wrapper found every operand aligned for it; else
// 1), a block's x threads a row's columns and its y threads up to 512 / x
// rows, so consecutive threads read consecutive addresses and each thread
// issues its loads at once. Nothing is allocated or synchronised; each
// entry launches on the stream it is given and returns the launch's
// cudaError.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_OPERANDS = 24;
constexpr int THREADS = 512;           // a block's threads at most
constexpr int MAX_VARS = 4;            // the selection networks' inputs

struct Operand {
  const char* p;
  long long s0, s1, s2, sc;
};

struct Args {
  Operand o[MAX_OPERANDS];
  long long r0, r1, r2;
  int n, aux0, aux1;
  float f;
};

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float rnd<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sigm(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// LayerNorm's ε as torch adds it: the Python float 1e-6 cast to float32
__device__ __forceinline__ float ln_eps() { return static_cast<float>(1e-6); }

// the element offset of an operand's row
struct Row {
  long long i0, i1, i2;
  __device__ __forceinline__ long long at(const Operand& o) const {
    return i0 * o.s0 + i1 * o.s1 + i2 * o.s2;
  }
};

// this thread's row, or false past the last one
__device__ __forceinline__ bool row_of(const Args& a, Row& row) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= a.r0 * a.r1 * a.r2) return false;
  const long long q = r / a.r2;
  row.i2 = r - q * a.r2;
  row.i1 = q % a.r1;
  row.i0 = q / a.r1;
  return true;
}

// V consecutive columns of one row
template <int V>
struct Vec {
  float v[V];
};

__device__ __forceinline__ float ld(const Operand& o, long long base, int c) {
  return reinterpret_cast<const float*>(o.p)[base + c * o.sc];
}

// columns c..c+V-1; a row's scalar (sc = 0) repeated; V = 4 only where the
// wrapper found the operand's rows 16-byte aligned and sc 0 or 1
template <int V>
__device__ __forceinline__ Vec<V> ldv(const Operand& o, long long base,
                                      int c) {
  Vec<V> r;
  const float* p = reinterpret_cast<const float*>(o.p);
  if (V == 4 && o.sc == 1) {
    const float4 q = *reinterpret_cast<const float4*>(p + base + c);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = p[base + (c + k) * o.sc];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void stv(const Operand& o, long long base, int c,
                                    const Vec<V>& x) {
  float* p = reinterpret_cast<float*>(const_cast<char*>(o.p));
  if (V == 4) {
    *reinterpret_cast<float4*>(p + base + c) =
        make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
    p[base + c * o.sc] = x.v[0];
  }
}

// the columns of a row this thread takes, V at a time
#define FOR_COLUMNS(c, n) \
  for (int c = threadIdx.x * V; c < (n); c += blockDim.x * V)

// y = f32(rdt(x)): operands 0 out, 1 x
template <typename RT, int V>
__global__ void round_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &out = a.o[0], &x = a.o[1];
  const long long bo = row.at(out), bx = row.at(x);
  FOR_COLUMNS(c, a.n) {
    Vec<V> y = ldv<V>(x, bx, c);
#pragma unroll
    for (int k = 0; k < V; ++k) y.v[k] = rnd<RT>(y.v[k]);
    stv<V>(out, bo, c, y);
  }
}

// A dense layer's epilogue: y = f32(rdt(mm)) + b, then + (f32(rdt(mm2)) +
// b2) (a GRN's context term, added in the program's order), then ELU
// (aux0); writes y (operand 0) and/or f32(rdt(y)) (operand 1, the next
// product's operand). Operands 2 mm, 3 b, 4 mm2, 5 b2.
template <typename RT, int V>
__global__ void dense_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &raw = a.o[0], &rd = a.o[1], &mm = a.o[2], &b = a.o[3],
                &mm2 = a.o[4], &b2 = a.o[5];
  const long long braw = row.at(raw), brd = row.at(rd), bmm = row.at(mm),
                  bb = row.at(b), bmm2 = row.at(mm2), bb2 = row.at(b2);
  FOR_COLUMNS(c, a.n) {
    const Vec<V> m = ldv<V>(mm, bmm, c), bias = ldv<V>(b, bb, c);
    Vec<V> y, yr;
#pragma unroll
    for (int k = 0; k < V; ++k) y.v[k] = add(rnd<RT>(m.v[k]), bias.v[k]);
    if (mm2.p) {
      const Vec<V> m2 = ldv<V>(mm2, bmm2, c), bias2 = ldv<V>(b2, bb2, c);
#pragma unroll
      for (int k = 0; k < V; ++k)
        y.v[k] = add(y.v[k], add(rnd<RT>(m2.v[k]), bias2.v[k]));
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (a.aux0) y.v[k] = y.v[k] > 0.0f ? y.v[k] : expm1f(y.v[k]);
      yr.v[k] = rnd<RT>(y.v[k]);
    }
    if (raw.p) stv<V>(raw, braw, c, y);
    if (rd.p) stv<V>(rd, brd, c, yr);
  }
}

// The gated skip: g = f32(rdt(mm)) + b over 2n columns, value and gate its
// halves; out = skip + value·σ(gate), the skip a float32 input or, with a
// skip bias (operand 4), the skip layer's product rounded and biased.
// Operands 0 out, 1 mm, 2 b, 3 skip, 4 skip bias.
template <typename RT, int V>
__global__ void gate_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &out = a.o[0], &mm = a.o[1], &b = a.o[2], &skip = a.o[3],
                &sb = a.o[4];
  const long long bo = row.at(out), bmm = row.at(mm), bb = row.at(b),
                  bs = row.at(skip), bsb = row.at(sb);
  const int n = a.n;
  FOR_COLUMNS(c, n) {
    const Vec<V> mv = ldv<V>(mm, bmm, c), mg = ldv<V>(mm, bmm, n + c),
                 bv = ldv<V>(b, bb, c), bg = ldv<V>(b, bb, n + c),
                 s = ldv<V>(skip, bs, c);
    Vec<V> sk = s, y;
    if (sb.p) {
      const Vec<V> sbias = ldv<V>(sb, bsb, c);
#pragma unroll
      for (int k = 0; k < V; ++k)
        sk.v[k] = add(rnd<RT>(s.v[k]), sbias.v[k]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float val = add(rnd<RT>(mv.v[k]), bv.v[k]);
      const float gate = add(rnd<RT>(mg.v[k]), bg.v[k]);
      y.v[k] = add(sk.v[k], mul(val, sigm(gate)));
    }
    stv<V>(out, bo, c, y);
  }
}

// LayerNorm's centred square, (x − mu)², for torch's second mean.
// Operands 0 out, 1 x, 2 mu (a row's scalar).
template <typename RT, int V>
__global__ void sqdev_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &out = a.o[0], &x = a.o[1], &mu = a.o[2];
  const long long bo = row.at(out), bx = row.at(x);
  const float m = ld(mu, row.at(mu), 0);
  FOR_COLUMNS(c, a.n) {
    Vec<V> y = ldv<V>(x, bx, c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = sub(y.v[k], m);
      y.v[k] = mul(d, d);
    }
    stv<V>(out, bo, c, y);
  }
}

__device__ __forceinline__ float norm(float x, float mu, float inv,
                                      float scale, float bias) {
  return add(mul(mul(sub(x, mu), inv), scale), bias);
}

// LayerNorm's apply, (x − mu)·rsqrt(var + ε)·scale + bias, given torch's
// means: writes y (operand 0) and/or f32(rdt(y)) (operand 1). Operands 2 x,
// 3 mu, 4 var, 5 scale, 6 bias.
template <typename RT, int V>
__global__ void ln_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &raw = a.o[0], &rd = a.o[1], &x = a.o[2], &mu = a.o[3],
                &var = a.o[4], &scale = a.o[5], &bias = a.o[6];
  const long long braw = row.at(raw), brd = row.at(rd), bx = row.at(x),
                  bsc = row.at(scale), bbi = row.at(bias);
  const float m = ld(mu, row.at(mu), 0);
  const float inv = rsqrtf(add(ld(var, row.at(var), 0), ln_eps()));
  FOR_COLUMNS(c, a.n) {
    const Vec<V> xv = ldv<V>(x, bx, c), sv = ldv<V>(scale, bsc, c),
                 bv = ldv<V>(bias, bbi, c);
    Vec<V> y, yr;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      y.v[k] = norm(xv.v[k], m, inv, sv.v[k], bv.v[k]);
      yr.v[k] = rnd<RT>(y.v[k]);
    }
    if (raw.p) stv<V>(raw, braw, c, y);
    if (rd.p) stv<V>(rd, brd, c, yr);
  }
}

// A variable selection's end: each input's GRN LayerNorm applied, weighed
// by its selection weight and summed in input order from 0 (the program's
// multiply and sum over the stacked inputs). Operands 0 out, 1 rounded out,
// 2 w (aux0 = nv columns), then per input i: 3 + 5i x, mu, var, scale, bias.
template <typename RT, int V>
__global__ void vsn_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &raw = a.o[0], &rd = a.o[1], &w = a.o[2];
  const int nv = a.aux0;
  long long bx[MAX_VARS], bsc[MAX_VARS], bbi[MAX_VARS];
  float m[MAX_VARS], inv[MAX_VARS], wv[MAX_VARS];
  const long long bw = row.at(w);
#pragma unroll
  for (int i = 0; i < MAX_VARS; ++i) {
    if (i < nv) {
      const int o = 3 + 5 * i;   // x, mu, var, scale, bias of input i
      bx[i] = row.at(a.o[o]);
      m[i] = ld(a.o[o + 1], row.at(a.o[o + 1]), 0);
      inv[i] = rsqrtf(add(ld(a.o[o + 2], row.at(a.o[o + 2]), 0), ln_eps()));
      bsc[i] = row.at(a.o[o + 3]);
      bbi[i] = row.at(a.o[o + 4]);
      wv[i] = ld(w, bw, i);
    }
  }
  const long long braw = row.at(raw), brd = row.at(rd);
  FOR_COLUMNS(c, a.n) {
    Vec<V> acc, accr;
#pragma unroll
    for (int k = 0; k < V; ++k) acc.v[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_VARS; ++i) {
      if (i < nv) {
        const int o = 3 + 5 * i;
        const Vec<V> xv = ldv<V>(a.o[o], bx[i], c),
                     sv = ldv<V>(a.o[o + 3], bsc[i], c),
                     bv = ldv<V>(a.o[o + 4], bbi[i], c);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc.v[k] = add(acc.v[k], mul(norm(xv.v[k], m[i], inv[i], sv.v[k],
                                            bv.v[k]), wv[i]));
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) accr.v[k] = rnd<RT>(acc.v[k]);
    if (raw.p) stv<V>(raw, braw, c, acc);
    if (rd.p) stv<V>(rd, brd, c, accr);
  }
}

// One LSTM step: gates = (f32(rdt(xw)) + f32(rdt(mm))) + b over i, f, g, o;
// c' = σ(f)·c + σ(i)·tanh(g); h' = σ(o)·tanh(c'). Writes c' (operand 0) and
// f32(rdt(h')), the next step's operand (1), and again into the step's slot
// of the sequence's output (6, where given). Operands 2 xw (the step's input
// product), 3 mm (h·wh), 4 b, 5 c; n = d, the gates 4d columns.
template <typename RT, int V>
__global__ void cell_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &cout = a.o[0], &hr = a.o[1], &xw = a.o[2], &mm = a.o[3],
                &b = a.o[4], &cin = a.o[5], &slot = a.o[6];
  const long long bco = row.at(cout), bh = row.at(hr), bxw = row.at(xw),
                  bmm = row.at(mm), bb = row.at(b), bci = row.at(cin),
                  bsl = row.at(slot);
  const int d = a.n;
  FOR_COLUMNS(c, d) {
    Vec<V> g[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Vec<V> x = ldv<V>(xw, bxw, j * d + c), m = ldv<V>(mm, bmm, j * d + c),
                   bias = ldv<V>(b, bb, j * d + c);
#pragma unroll
      for (int k = 0; k < V; ++k)
        g[j].v[k] = add(add(rnd<RT>(x.v[k]), rnd<RT>(m.v[k])), bias.v[k]);
    }
    const Vec<V> c0 = ldv<V>(cin, bci, c);
    Vec<V> cn, h;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cn.v[k] = add(mul(sigm(g[1].v[k]), c0.v[k]),
                    mul(sigm(g[0].v[k]), tanhf(g[2].v[k])));
      h.v[k] = rnd<RT>(mul(sigm(g[3].v[k]), tanhf(cn.v[k])));
    }
    stv<V>(cout, bco, c, cn);
    stv<V>(hr, bh, c, h);
    if (slot.p) stv<V>(slot, bsl, c, h);
  }
}

// The inputs' embeddings: per input v of nv (aux1) and unit k of d (aux0),
// y = f32(rdt(f32(rdt(f_v))·w[v, k])) + b[v, k], the exact product of two
// rounded values that the K = 1 product computes. Writes y stacked over the
// inputs (operand 0, nv·d columns), f32(rdt(y)) in the same layout (1) and
// each input's rounded columns on its own (5 + v). Operands 2 f (nv
// columns, read one a time), 3 w (the rounded weights, nv·d), 4 b (nv·d).
// With V = 4, d is a multiple of 4, so a thread's columns share an input.
template <typename RT, int V>
__global__ void embed_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &raw = a.o[0], &flat = a.o[1], &f = a.o[2], &w = a.o[3],
                &b = a.o[4];
  const int d = a.aux0, nv = a.aux1;
  long long bv[MAX_VARS];
#pragma unroll
  for (int i = 0; i < MAX_VARS; ++i)
    if (i < nv) bv[i] = row.at(a.o[5 + i]);
  const long long braw = row.at(raw), bfl = row.at(flat), bf = row.at(f),
                  bw = row.at(w), bb = row.at(b);
  FOR_COLUMNS(j, a.n) {
    const int v = j / d, k = j - v * d;
    const float fr = rnd<RT>(ld(f, bf, v));
    const Vec<V> wv = ldv<V>(w, bw, j), bias = ldv<V>(b, bb, j);
    Vec<V> y, yr;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      y.v[q] = add(rnd<RT>(mul(fr, wv.v[q])), bias.v[q]);
      yr.v[q] = rnd<RT>(y.v[q]);
    }
    stv<V>(raw, braw, j, y);
    stv<V>(flat, bfl, j, yr);
#pragma unroll
    for (int i = 0; i < MAX_VARS; ++i)
      if (i == v) stv<V>(a.o[5 + i], bv[i], k, yr);
  }
}

// The attention's logits: f32(rdt(e))·inv (the division by √(d/heads) as
// torch carries it out, times the float32 reciprocal), −1e9 where a horizon
// query q may not see key k: k > Wc + q, or k < Wc and the key's reading is
// not valid. Rows are (tenant, batch, head·horizon), the horizon fastest, so
// q = i2 mod H (aux0); aux1 = Wc; n = W keys. Operands 0 out, 1 e, 2 valid
// (one byte a key, read one a time).
template <typename RT, int V>
__global__ void logits_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &out = a.o[0], &e = a.o[1], &valid = a.o[2];
  const long long bo = row.at(out), be = row.at(e), bv = row.at(valid);
  const int q = static_cast<int>(row.i2 % a.aux0), wc = a.aux1;
  const unsigned char* ok = reinterpret_cast<const unsigned char*>(valid.p);
  FOR_COLUMNS(c, a.n) {
    const Vec<V> x = ldv<V>(e, be, c);
    Vec<V> y;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int k = c + j;
      const bool seen =
          k <= wc + q && (k >= wc || ok[bv + k * valid.sc] != 0);
      y.v[j] = seen ? mul(rnd<RT>(x.v[j]), a.f) : -1.0e9f;
    }
    stv<V>(out, bo, c, y);
  }
}

bool fill(Args& a, const long long* desc, int nops, const long long* dims,
          float f) {
  if (nops < 0 || nops > MAX_OPERANDS) return false;
  for (int i = 0; i < MAX_OPERANDS; ++i) {
    Operand& o = a.o[i];
    if (i < nops) {
      const long long* d = desc + 5 * i;
      o.p = reinterpret_cast<const char*>(d[0]);
      o.s0 = d[1];
      o.s1 = d[2];
      o.s2 = d[3];
      o.sc = d[4];
    } else {
      o = Operand{nullptr, 0, 0, 0, 0};
    }
  }
  a.r0 = dims[0];
  a.r1 = dims[1];
  a.r2 = dims[2];
  a.n = static_cast<int>(dims[3]);
  a.aux0 = static_cast<int>(dims[4]);
  a.aux1 = static_cast<int>(dims[5]);
  a.f = f;
  return a.r0 >= 0 && a.r1 >= 0 && a.r2 >= 0 && a.n >= 0;
}

using Kernel = void (*)(Args);

int launch(Kernel k, const Args& a, int v, void* stream) {
  const long long rows = a.r0 * a.r1 * a.r2;
  if (rows == 0 || a.n == 0) return cudaSuccess;
  const int per_row = (a.n + v - 1) / v;
  const int tx = per_row < THREADS ? per_row : THREADS;
  const int ty = THREADS / tx;
  const long long blocks = (rows + ty - 1) / ty;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  k<<<static_cast<unsigned>(blocks), dim3(tx, ty), 0,
      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Every entry: desc holds nops operands as (pointer, s0, s1, s2, sc), dims
// is (R0, R1, R2, n, aux0, aux1, V), kind the rounding type (0 bfloat16,
// 1 float16); returns the launch's cudaError.
#define SWX_TFT_ENTRY(NAME, KERNEL)                                          \
  extern "C" int swx_tft_##NAME(const long long* desc, int nops,           \
                                const long long* dims, float f, int kind,  \
                                void* stream) {                            \
    Args a;                                                                \
    if (!fill(a, desc, nops, dims, f)) return cudaErrorInvalidValue;       \
    const int v = static_cast<int>(dims[6]);                               \
    if (v == 4 && a.n % 4 != 0) return cudaErrorInvalidValue;              \
    if (kind == 0 && v == 4)                                               \
      return launch(KERNEL<__nv_bfloat16, 4>, a, 4, stream);               \
    if (kind == 0 && v == 1)                                               \
      return launch(KERNEL<__nv_bfloat16, 1>, a, 1, stream);               \
    if (kind == 1 && v == 4) return launch(KERNEL<__half, 4>, a, 4, stream); \
    if (kind == 1 && v == 1) return launch(KERNEL<__half, 1>, a, 1, stream); \
    return cudaErrorInvalidValue;                                          \
  }

SWX_TFT_ENTRY(round, round_kernel)
SWX_TFT_ENTRY(dense, dense_kernel)
SWX_TFT_ENTRY(gate, gate_kernel)
SWX_TFT_ENTRY(sqdev, sqdev_kernel)
SWX_TFT_ENTRY(ln, ln_kernel)
SWX_TFT_ENTRY(vsn, vsn_kernel)
SWX_TFT_ENTRY(cell, cell_kernel)
SWX_TFT_ENTRY(embed, embed_kernel)
SWX_TFT_ENTRY(logits, logits_kernel)
