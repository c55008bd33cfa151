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
// reductions (LayerNorm's means, the softmaxes) and the products that
// `mm_kernel` below does not take stay PyTorch's (cuBLAS's float32 products
// sum k in ascending order at the forward's shapes, and `mm_kernel` sums
// the same way), and every pointwise
// step here is the chain's, in its order, rounded where the chain
// materialises a float32 tensor: __fadd_rn / __fmul_rn / __fdiv_rn, which
// nvcc never contracts into a multiply-add, and the accurate libdevice
// functions PyTorch's kernels call (expf, expm1f, tanhf, rsqrtf), built
// without fast-math. The casts round to nearest even like c10's. σ(v) is
// torch's 1 / (1 + expf(−v)).
//
// What bounds it on this card: bytes, but for `mm_kernel`. Every other
// kernel is a pass over rows of float32 columns, a few FLOP an element
// against 8–20 bytes; at 3.35 TB/s a [16,384 × 168, 160] float32 tensor
// (1.76 GB) takes 0.53 ms to read.
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
  long long inner;   // a product's consecutive rows that share a weight
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

// The order probe: out = x·w, one thread an output, summed over k = 0 … K−1
// in ascending order with __fmaf_rn from a zero accumulator; no rounding.
// Operands 0 out (n columns), 1 x (aux0 = K columns), 2 w (the row's
// [K, n] weight, row-major; its row strides select a tenant's).
template <typename RT, int V>
__global__ void probe_kernel(Args a) {
  Row row;
  if (!row_of(a, row)) return;
  const Operand &out = a.o[0], &x = a.o[1], &w = a.o[2];
  const long long bo = row.at(out), bx = row.at(x);
  const float* wp = reinterpret_cast<const float*>(w.p) + row.at(w);
  float* op = reinterpret_cast<float*>(const_cast<char*>(out.p));
  for (int c = threadIdx.x; c < a.n; c += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < a.aux0; ++k)
      acc = __fmaf_rn(ld(x, bx, k), wp[static_cast<long long>(k) * a.n + c],
                      acc);
    op[bo + c * out.sc] = acc;
  }
}

// -- the products: a dense layer, its product and its epilogue -------------
//
// out = epilogue(x·w): x the layer's rounded operand (operand 2, K = aux0
// columns, contiguous, 16-byte aligned rows), w its rounded [K, n] weight
// (operand 3, row-major; its row strides pick a tenant's). A block of 256
// threads computes 64 rows by BN output columns (`MmShape`). k is streamed
// in slices of 32 through a ring of MM_STAGES shared-memory stages
// (cp.async, 16 bytes a copy, zero-filled past K and past the rows; the
// weight's slice comes from L2, where the small weights stay). A thread
// holds 4 rows (ty + 16 i) by 2 J columns: an A row's four k in one shared
// read, and per k one 16-byte read of B a group of four columns.
//
// Every accumulator is summed over k = 0 … K−1 in ascending order with one
// __fmaf_rn a step from zero: the order of cuBLAS's SIMT kernels at these
// shapes (`ops/tft_fused.py` `fits`), so the same bits, since each product
// of two bf16 or float16 values is exact in float32; a zero-filled step
// adds +0, which leaves a sum that started at +0 as it is. The epilogue is
// dense_kernel's, verbatim, on the sums in registers; the float32 product
// never reaches device memory. The rows of a block share one weight:
// `inner` consecutive rows of the call's row space do, and the grid's z
// walks those groups (the tenants of a stacked call).
//
// What bounds it: operations, at the card's 67 TFLOP/s float32 FFMA peak
// (2·K·N FLOP against 4·(K + 2N) bytes a row: 53 FLOP a byte at K = N =
// 160). Its design: a layer's 160 outputs in one block (no column wasted
// at the electricity widths, where cuBLAS's 64-wide tiles compute 192), 32
// in one where n is 32 (`TftConfig`'s defaults), few shared reads per
// multiply-add, two blocks an SM, and an epilogue that reads its operands
// before its arithmetic.

constexpr int MM_THREADS = 256;
constexpr int MM_STAGES = 3;

// A block takes BN = 32 J output columns, a thread 2 J of them: float4
// groups at 64 q + 4 tx, then a float2 group at 64 ⌊J/2⌋ + 2 tx where J is
// odd.
template <int J>
struct MmShape {
  static constexpr int TM = 4;              // rows a thread
  static constexpr int BK = 32;             // k a slice
  static constexpr int BM = 16 * TM;        // rows a block
  static constexpr int BN = 32 * J;         // output columns a block
  static constexpr int W = 2 * J;           // output columns a thread
  static constexpr int Q4 = J / 2;          // its float4 groups
  static constexpr int AST = BK + 4;        // an A row in shared memory
  static constexpr int A_STAGE = BM * AST;
  static constexpr int B_STAGE = BK * BN;
  static constexpr int SMEM = MM_STAGES * (A_STAGE + B_STAGE) * 4;
  // the block column of the thread's column t
  __device__ __forceinline__ static int col(int t, int tx) {
    return t < 4 * Q4 ? 64 * (t / 4) + 4 * tx + t % 4
                      : 64 * Q4 + 2 * tx + (t - 4 * Q4);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// row r of the call's row space: no division where the rows are one
// dimension (the common call), 32-bit division where they fit
__device__ __forceinline__ Row row_at(const Args& a, long long r) {
  Row row;
  if (a.r0 == 1 && a.r1 == 1) {
    row.i0 = row.i1 = 0;
    row.i2 = r;
  } else if (a.r0 * a.r1 * a.r2 <= 0xffffffffLL) {
    const unsigned u = static_cast<unsigned>(r);
    const unsigned r1 = static_cast<unsigned>(a.r1);
    const unsigned r2 = static_cast<unsigned>(a.r2);
    const unsigned q = u / r2;
    row.i2 = u - q * r2;
    row.i1 = q % r1;
    row.i0 = q / r1;
  } else {
    const long long q = r / a.r2;
    row.i2 = r - q * a.r2;
    row.i1 = q % a.r1;
    row.i0 = q / a.r1;
  }
  return row;
}

// an operand's row: its first element and its column stride
struct RowPtr {
  const float* p;
  int sc;
  __device__ __forceinline__ float operator[](int c) const { return p[c * sc]; }
};
__device__ __forceinline__ RowPtr row_ptr(const Operand& o, const Row& row) {
  return {reinterpret_cast<const float*>(o.p) + (o.p ? row.at(o) : 0),
          static_cast<int>(o.sc)};
}

// the row d rows on from `row` (d ≥ 0): no division, a carry a time
__device__ __forceinline__ void step_row(const Args& a, Row& row, int d) {
  row.i2 += d;
  while (row.i2 >= a.r2) {
    row.i2 -= a.r2;
    if (++row.i1 == a.r1) {
      row.i1 = 0;
      ++row.i0;
    }
  }
}

// One row's epilogue on the group of V output columns from column t of
// the thread (block column c): the arithmetic on the operands already read
// (bv, x5), then V-wide stores (the outputs are the wrapper's own,
// contiguous and aligned), none past n. E: the context term (1) or none
// (0).
template <typename RT, int E, int V, int W>
__device__ __forceinline__ void mm_group(const Args& a, const float (&acc)[W],
                                         int t, int c, const float* bv,
                                         const float* x5, float* y0,
                                         float* y1) {
  float y[V], yr[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float u = add(rnd<RT>(acc[t + v]), bv[t + v]);
    if constexpr (E == 1) u = add(u, x5[t + v]);
    if (a.aux1) u = u > 0.0f ? u : expm1f(u);
    y[v] = u;
    yr[v] = rnd<RT>(u);
  }
  if (c >= a.n) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float* out = k == 0 ? y0 : y1;
    const float* src = k == 0 ? y : yr;
    if (!out) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + c) =
          make_float4(src[0], src[1], src[2], src[3]);
    } else {
      *reinterpret_cast<float2*>(out + c) = make_float2(src[0], src[1]);
    }
  }
}

// Operands: 0 y, 1 f32(rdt(y)), 2 x, 3 w, 4 b, 5 the context term (a GRN's
// f32(rdt(mm2)) + b2, which the wrapper adds beforehand, as the program
// does). y = f32(rdt(x·w)) + b, plus the context term, then ELU where
// aux1; writes y and/or f32(rdt(y)).
template <typename RT, int J, int E>
__global__ void __launch_bounds__(MM_THREADS, 2) mm_kernel(Args a) {
  using S = MmShape<J>;
  constexpr int TM = S::TM, BK = S::BK, BM = S::BM, BN = S::BN;
  constexpr int W = S::W, AST = S::AST, Q4 = S::Q4, Q2 = J % 2;
  constexpr int QPR = BK / 4;                      // A copies a row a slice
  constexpr int ACOPY = BM * QPR, AL = (ACOPY + MM_THREADS - 1) / MM_THREADS;
  constexpr int NB = BK * BN / 4;                  // B copies a slice
  extern __shared__ float4 mm_smem[];
  float* As = reinterpret_cast<float*>(mm_smem);
  float* Bs = As + MM_STAGES * S::A_STAGE;
  const Operand &x = a.o[2], &w = a.o[3];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int K = a.aux0, n = a.n;
  const long long first = static_cast<long long>(blockIdx.z) * a.inner;
  // the block's tile: the column tiles of a row tile are neighbours in
  // launch order, so they read x's rows from L2 in turn
  const unsigned nt = (a.n + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / nt) * BM;
  const int n0 = static_cast<int>(blockIdx.x % nt) * BN;
  const float* wp =
      reinterpret_cast<const float*>(w.p) + row_at(a, first).at(w);

  // the rows this thread copies: (tid + 256 u) / QPR, a float4 of k each
  const float* arow[AL];
  bool aok[AL];
  Row xrow = row_at(a, first + m0 + tid / QPR);
#pragma unroll
  for (int u = 0; u < AL; ++u) {
    const int idx = tid + MM_THREADS * u;
    const long long r = m0 + idx / QPR;
    if (u) step_row(a, xrow, MM_THREADS / QPR);
    aok[u] = idx < ACOPY && r < a.inner;
    arow[u] = reinterpret_cast<const float*>(x.p) + (aok[u] ? xrow.at(x) : 0);
  }
  const int kq = (tid % QPR) * 4;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    float* as = As + stage * S::A_STAGE;
#pragma unroll
    for (int u = 0; u < AL; ++u) {
      const int idx = tid + MM_THREADS * u;
      if (ACOPY % MM_THREADS != 0 && idx >= ACOPY) break;
      const bool ok = aok[u] && k0 + kq < K;
      cp_async16(as + (idx / QPR) * AST + kq, ok ? arow[u] + k0 + kq : arow[u],
                 ok);
    }
    float* bs = Bs + stage * S::B_STAGE;
#pragma unroll
    for (int i = tid; i < NB; i += MM_THREADS) {
      const int kr = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = k0 + kr < K && n0 + c < n;
      cp_async16(bs + kr * BN + c,
                 ok ? wp + static_cast<long long>(k0 + kr) * n + n0 + c : wp,
                 ok);
    }
  };

  float acc[TM][W];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < W; ++t) acc[i][t] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();   // slice kt landed; every thread is done with kt − 1
    const int next = kt + MM_STAGES - 1;
    if (next < nk) load(next % MM_STAGES, next);
    cp_async_commit();
    const float* as = As + (kt % MM_STAGES) * S::A_STAGE;
    const float* bs = Bs + (kt % MM_STAGES) * S::B_STAGE;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * AST + k4);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float* brow = bs + (k4 + h) * BN;
        float bv[W];
#pragma unroll
        for (int q = 0; q < Q4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(brow + 64 * q + 4 * tx);
          bv[4 * q] = v.x;
          bv[4 * q + 1] = v.y;
          bv[4 * q + 2] = v.z;
          bv[4 * q + 3] = v.w;
        }
        if constexpr (Q2 != 0) {
          const float2 v =
              *reinterpret_cast<const float2*>(brow + 64 * Q4 + 2 * tx);
          bv[4 * Q4] = v.x;
          bv[4 * Q4 + 1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = h == 0 ? av[i].x
                           : h == 1 ? av[i].y
                           : h == 2 ? av[i].z
                                    : av[i].w;
#pragma unroll
          for (int t = 0; t < W; ++t)
            acc[i][t] = __fmaf_rn(ai, bv[t], acc[i][t]);
        }
      }
    }
  }

  // the epilogue, a row at a time: every operand of the row read first
  // (past n the last column is read and nothing stored), then the
  // arithmetic and the stores a group of columns at a time
  Row row = row_at(a, first + m0 + ty);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= a.inner) break;
    if (i) step_row(a, row, 16);
    const RowPtr b = row_ptr(a.o[4], row), e5 = row_ptr(a.o[5], row);
    float bv[W], x5[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const int c = min(n0 + S::col(t, tx), n - 1);
      bv[t] = b[c];
      if constexpr (E == 1) x5[t] = e5[c];
    }
    float* y0 = a.o[0].p ? reinterpret_cast<float*>(const_cast<char*>(
                               a.o[0].p)) + row.at(a.o[0])
                         : nullptr;
    float* y1 = a.o[1].p ? reinterpret_cast<float*>(const_cast<char*>(
                               a.o[1].p)) + row.at(a.o[1])
                         : nullptr;
#pragma unroll
    for (int q = 0; q < Q4; ++q)
      mm_group<RT, E, 4>(a, acc[i], 4 * q, n0 + 64 * q + 4 * tx, bv, x5, y0,
                         y1);
    if constexpr (Q2 != 0)
      mm_group<RT, E, 2>(a, acc[i], 4 * Q4, n0 + 64 * Q4 + 2 * tx, bv, x5,
                         y0, y1);
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
  a.inner = 0;
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

template <typename RT, int J, int E>
int mm_launch(const Args& a, void* stream) {
  using S = MmShape<J>;
  // over 48 KB of shared memory at J = 5: the attribute is the current
  // card's, so it is set at every launch (a mesh launches on several)
  const cudaError_t e = cudaFuncSetAttribute(
      mm_kernel<RT, J, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return e;
  const long long rows = a.r0 * a.r1 * a.r2;
  if (rows == 0 || a.n == 0) return cudaSuccess;
  if (a.inner < 1 || rows % a.inner != 0) return cudaErrorInvalidValue;
  const long long groups = rows / a.inner;
  const long long mt = (a.inner + S::BM - 1) / S::BM;
  const long long nt = (a.n + S::BN - 1) / S::BN;
  if (mt * nt > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  mm_kernel<RT, J, E><<<dim3(static_cast<unsigned>(mt * nt), 1,
                             static_cast<unsigned>(groups)),
                        MM_THREADS, S::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// a block of 32 output columns where n is 32, else of 160 (the electricity
// widths' d in one block); with the context term (E = 1) or without (0)
template <typename RT>
int mm_pick(const Args& a, void* stream) {
  const bool ctx = a.o[5].p != nullptr;
  if (a.n <= 32) {
    return ctx ? mm_launch<RT, 1, 1>(a, stream)
               : mm_launch<RT, 1, 0>(a, stream);
  }
  return ctx ? mm_launch<RT, 5, 1>(a, stream) : mm_launch<RT, 5, 0>(a, stream);
}

}  // namespace

// The product's entry: dims is (R0, R1, R2, n, K, inner, elu); the wrapper
// checked x's alignment and the weight's layout.
extern "C" int swx_tft_dense_mm(const long long* desc, int nops,
                                const long long* dims, float f, int kind,
                                void* stream) {
  Args a;
  if (!fill(a, desc, nops, dims, f)) return cudaErrorInvalidValue;
  a.inner = dims[5];
  a.aux1 = static_cast<int>(dims[6]);
  if (nops != 6 || a.aux0 < 1 || a.o[2].sc != 1 || a.n % 32 != 0)
    return cudaErrorInvalidValue;
  if (kind == 0) return mm_pick<__nv_bfloat16>(a, stream);
  if (kind == 1) return mm_pick<__half>(a, stream);
  return cudaErrorInvalidValue;
}

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
SWX_TFT_ENTRY(probe, probe_kernel)
