// Shifted-window 3D multi-head attention forward (Swin UNETR) for NVIDIA
// Hopper, sm_90a, head width 16.
//
// Replaces no TPU kernel: the JAX package has no transformer. The wrapper,
// the plain torch version and the definition of what is computed are in
// iterseg_tpu_torch/ops/window_attention.py. In short, for qkv
// (B, Dp, Hp, Wp, 3C) float32 on the zero-padded token grid, per window of
// n = wd*wh*ww tokens of the grid rolled by -shift (MONAI window_partition)
// and per head: softmax(q k^T * scale + bias + mask) v, written to
// (B, Dp, Hp, Wp, C) at the tokens' own grid positions.
//  * Roll and partition are addressing: the token at position p of the
//    rolled grid is read from, and written to, grid position
//    (p + shift) mod P, where MONAI's reverse roll puts it.
//  * bias[i][j] = table[(q_off(i) - k_off(j)) * heads + head], MONAI's
//    relative_position_index of the full 7^3 window (a clipped window of n
//    tokens takes its [:n, :n] corner), which is linear in the tokens'
//    coordinates in the full window's flattening.
//  * mask = -100 where the query's and the key's region ids differ (MONAI
//    compute_mask over the padded grid: per shifted axis, ids 0, 1, 2 for
//    [:-w], [-w:-s], [-s:]), in shifted windows only.
//
// Design: one block a (window, head). The window's keys and values
// (n x 16 floats each, 43.9 KB at n = 343), the head's column of the bias
// table (8.8 KB) and each key's table offset and region id go to shared
// memory once; each thread then owns two queries, keeps q and the output
// accumulator in registers, and walks all n keys with an online softmax
// that rescales once every KC keys. Every shared read of a key is a
// broadcast, and each feeds both of the thread's queries. No score leaves
// the registers: only the output is written.
//
// Bound: float32 FMA throughput. A window-head of 343 tokens is 7.5 MFLOP
// (4 n^2 16) against 88 KB of q, k, v and output. Products are IEEE
// float32 FMAs (no tensor cores, so no TF32, as device.f32_numerics
// requires); build without --use_fast_math. exp2f is the accurate
// library function (2 ulp).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WIDTH = 16;            // head width
constexpr int F = 7;                 // the full window, per axis
constexpr int TABLE_ROWS = (2 * F - 1) * (2 * F - 1) * (2 * F - 1);
constexpr int MAX_N = F * F * F;
constexpr int QPT = 2;               // queries a thread
constexpr int KC = 8;                // keys between two rescalings
constexpr int MAX_THREADS = ((MAX_N + QPT - 1) / QPT + 31) / 32 * 32;
// q_off - k_off of a query and a key at the same place: the table's centre
constexpr int CENTRE = (F - 1) * (2 * F - 1) * (2 * F - 1)
                       + (F - 1) * (2 * F - 1) + F - 1;
constexpr float MASK = -100.0f;
constexpr float LOG2E = 1.4426950408889634f;

struct Geometry {
  int Dp, Hp, Wp;     // the padded grid
  int nwd, nwh, nww;  // windows a grid, per axis
  int wd, wh, ww;     // the window
  int sd, sh, sw;     // the shift (all 0: an unshifted block)
  int heads, n;
  float scale;
};

// token i's row of the full window's flattened relative index
__device__ __forceinline__ int full_offset(int i) {
  return (i / (F * F)) * ((2 * F - 1) * (2 * F - 1))
         + ((i / F) % F) * (2 * F - 1) + i % F;
}

__device__ __forceinline__ int region(int p, int P, int w, int s) {
  return s > 0 ? (p >= P - w) + (p >= P - s) : 0;
}

__device__ __forceinline__ int wrap(int p, int P) {
  return p >= P ? p - P : p;
}

// Window-local token i of window (b, ed, eh, ew): its grid row (rolled
// back) and, in shifted blocks, its region id.
struct Token {
  int row;
  int reg;
};

template <bool SHIFTED>
__device__ __forceinline__ Token token(const Geometry& g, int b, int ed,
                                       int eh, int ew, int i) {
  int pd = ed * g.wd + i / (g.wh * g.ww);
  int ph = eh * g.wh + (i / g.ww) % g.wh;
  int pw = ew * g.ww + i % g.ww;
  Token t;
  t.row = ((b * g.Dp + wrap(pd + g.sd, g.Dp)) * g.Hp
           + wrap(ph + g.sh, g.Hp)) * g.Wp + wrap(pw + g.sw, g.Wp);
  t.reg = SHIFTED ? region(pd, g.Dp, g.wd, g.sd) * 9
                        + region(ph, g.Hp, g.wh, g.sh) * 3
                        + region(pw, g.Wp, g.ww, g.sw)
                  : 0;
  return t;
}

__device__ __forceinline__ float dot16(const float* q, float4 a, float4 b,
                                       float4 c, float4 d) {
  float s = q[0] * a.x;
  s = fmaf(q[1], a.y, s);
  s = fmaf(q[2], a.z, s);
  s = fmaf(q[3], a.w, s);
  s = fmaf(q[4], b.x, s);
  s = fmaf(q[5], b.y, s);
  s = fmaf(q[6], b.z, s);
  s = fmaf(q[7], b.w, s);
  s = fmaf(q[8], c.x, s);
  s = fmaf(q[9], c.y, s);
  s = fmaf(q[10], c.z, s);
  s = fmaf(q[11], c.w, s);
  s = fmaf(q[12], d.x, s);
  s = fmaf(q[13], d.y, s);
  s = fmaf(q[14], d.z, s);
  return fmaf(q[15], d.w, s);
}

__device__ __forceinline__ void axpy16(float* acc, float p, float4 a,
                                       float4 b, float4 c, float4 d) {
  acc[0] = fmaf(p, a.x, acc[0]);
  acc[1] = fmaf(p, a.y, acc[1]);
  acc[2] = fmaf(p, a.z, acc[2]);
  acc[3] = fmaf(p, a.w, acc[3]);
  acc[4] = fmaf(p, b.x, acc[4]);
  acc[5] = fmaf(p, b.y, acc[5]);
  acc[6] = fmaf(p, b.z, acc[6]);
  acc[7] = fmaf(p, b.w, acc[7]);
  acc[8] = fmaf(p, c.x, acc[8]);
  acc[9] = fmaf(p, c.y, acc[9]);
  acc[10] = fmaf(p, c.z, acc[10]);
  acc[11] = fmaf(p, c.w, acc[11]);
  acc[12] = fmaf(p, d.x, acc[12]);
  acc[13] = fmaf(p, d.y, acc[13]);
  acc[14] = fmaf(p, d.z, acc[14]);
  acc[15] = fmaf(p, d.w, acc[15]);
}

size_t shared_bytes(int n) {
  return (size_t)2 * n * WIDTH * sizeof(float) + TABLE_ROWS * sizeof(float)
         + (size_t)n * sizeof(int);
}

template <bool SHIFTED>
__global__ void __launch_bounds__(MAX_THREADS)
    window_attention_fwd(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         float* __restrict__ out, Geometry g) {
  extern __shared__ float4 smem[];
  const int n = g.n;
  float4* sk = smem;                               // n x 4 float4
  float4* sv = smem + n * 4;                       // n x 4 float4
  float* stab = (float*)(smem + 2 * n * 4);        // the head's column
  int* sinfo = (int*)(stab + TABLE_ROWS);          // k_off | region << 16

  const int C = g.heads * WIDTH;
  const int head = blockIdx.x % g.heads;
  int w = blockIdx.x / g.heads;
  const int ew = w % g.nww;
  w /= g.nww;
  const int eh = w % g.nwh;
  w /= g.nwh;
  const int ed = w % g.nwd;
  const int b = w / g.nwd;

  for (int t = threadIdx.x; t < n * 4; t += blockDim.x) {
    const int j = t >> 2, part = t & 3;
    const Token k = token<SHIFTED>(g, b, ed, eh, ew, j);
    const float4* src = reinterpret_cast<const float4*>(
        qkv + (size_t)k.row * 3 * C + C + head * WIDTH);
    sk[t] = src[part];
    sv[t] = src[C / 4 + part];
    if (part == 0) sinfo[j] = full_offset(j) | (k.reg << 16);
  }
  for (int t = threadIdx.x; t < TABLE_ROWS; t += blockDim.x)
    stab[t] = table[t * g.heads + head];

  float q[QPT][WIDTH], acc[QPT][WIDTH], m[QPT], l[QPT];
  int qoff[QPT], qreg[QPT], qrow[QPT];
  bool live[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    int i = threadIdx.x + u * blockDim.x;
    live[u] = i < n;
    i = min(i, n - 1);
    const Token t = token<SHIFTED>(g, b, ed, eh, ew, i);
    qrow[u] = t.row;
    qreg[u] = t.reg;
    qoff[u] = full_offset(i) + CENTRE;
    const float4* src = reinterpret_cast<const float4*>(
        qkv + (size_t)t.row * 3 * C + head * WIDTH);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 v = src[p];
      q[u][4 * p] = v.x * g.scale;
      q[u][4 * p + 1] = v.y * g.scale;
      q[u][4 * p + 2] = v.z * g.scale;
      q[u][4 * p + 3] = v.w * g.scale;
    }
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) acc[u][c] = 0.0f;
    m[u] = -INFINITY;
    l[u] = 0.0f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += KC) {
    float s[QPT][KC];
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      const int j = min(j0 + jj, n - 1);
      const float4* k = sk + 4 * j;
      const float4 k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3];
      const int info = sinfo[j];
      const int koff = info & 0xffff;
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        float a = dot16(q[u], k0, k1, k2, k3) + stab[qoff[u] - koff];
        if (SHIFTED && (info >> 16) != qreg[u]) a += MASK;
        s[u][jj] = j0 + jj < n ? a : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      float mx = m[u];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) mx = fmaxf(mx, s[u][jj]);
      const float alpha = exp2f((m[u] - mx) * LOG2E);
      l[u] *= alpha;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) acc[u][c] *= alpha;
      m[u] = mx;
      const float mxl = mx * LOG2E;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) s[u][jj] = exp2f(fmaf(s[u][jj], LOG2E,
                                                            -mxl));
    }
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      const float4* v = sv + 4 * min(j0 + jj, n - 1);
      const float4 v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        l[u] += s[u][jj];
        axpy16(acc[u], s[u][jj], v0, v1, v2, v3);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if (!live[u]) continue;
    const float r = 1.0f / l[u];
    float4* dst = reinterpret_cast<float4*>(out + (size_t)qrow[u] * C
                                            + head * WIDTH);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      dst[p] = make_float4(acc[u][4 * p] * r, acc[u][4 * p + 1] * r,
                           acc[u][4 * p + 2] * r, acc[u][4 * p + 3] * r);
  }
}

template <bool SHIFTED>
int launch(const float* qkv, const float* table, float* out,
           const Geometry& g, int blocks, cudaStream_t stream) {
  // above 48 KB a block must opt in, per function and card: set it each
  // launch, as a launch may go to any card
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd<SHIFTED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared_bytes(MAX_N));
  if (err != cudaSuccess) return (int)err;
  const int threads = ((g.n + QPT - 1) / QPT + 31) / 32 * 32;
  window_attention_fwd<SHIFTED>
      <<<blocks, threads, shared_bytes(g.n), stream>>>(qkv, table, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int window_attention_width() { return WIDTH; }

int window_attention_max_tokens() { return MAX_N; }

// qkv (B, Dp, Hp, Wp, 3 heads 16) and out (B, Dp, Hp, Wp, heads 16)
// float32, contiguous; table (13^3, heads) float32. Returns a CUDA error
// code (0: launched).
int window_attention_run(const float* qkv, const float* table, float* out,
                         int B, int Dp, int Hp, int Wp, int wd, int wh,
                         int ww, int sd, int sh, int sw, int heads,
                         float scale, void* stream) {
  Geometry g;
  g.Dp = Dp;
  g.Hp = Hp;
  g.Wp = Wp;
  g.nwd = Dp / wd;
  g.nwh = Hp / wh;
  g.nww = Wp / ww;
  g.wd = wd;
  g.wh = wh;
  g.ww = ww;
  g.sd = sd;
  g.sh = sh;
  g.sw = sw;
  g.heads = heads;
  g.n = wd * wh * ww;
  g.scale = scale;
  const int blocks = B * g.nwd * g.nwh * g.nww * heads;
  if (blocks == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return sd > 0 || sh > 0 || sw > 0
             ? launch<true>(qkv, table, out, g, blocks, s)
             : launch<false>(qkv, table, out, g, blocks, s);
}

}  // extern "C"
