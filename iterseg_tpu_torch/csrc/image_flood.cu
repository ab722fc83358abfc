// Seeded image watershed (hop-tie claim recurrence) for NVIDIA Hopper,
// sm_90a.
//
// Replaces the TPU kernel iterseg_tpu/ops/pallas_flood.py:_image_flood_kernel
// (driven by pallas_image_flood_jit). The flood rule is the image recurrence
// of iterseg_tpu_torch/ops/device_flood.py, skimage's node-keyed heap rule
// watershed(values, markers, mask) on the DoG path's -EDT: a free voxel u
// (in the mask, not a seed) takes the labelled face neighbour v with the
// smallest key (d_v, h_v, idx_v) and claims only if that key is strictly
// below its stored claimant key (ckd_u, ckh_u, cki_u); then
// d_u = max(d_v, values[u]), lab_u = lab_v, and the hop count h_u is 0 when
// that max rose strictly above d_v, else h_v + 1. Seeds start at their own
// value with h = 0 and claimant key -inf, and never change.
//
// Tie order: idx is the row-major ravel index of the (Z, Y, X) volume the
// caller passes, as in the JAX recurrence.
//
// Schedule: flood_schedule.cuh, shared with affinity_flood.cu (the frontier
// of active tiles, the double buffer, the one persistent cooperative launch
// per flood, and why skipping tiles is exact). This file holds only the
// state layout and the claim rule:
//  * state words per voxel: d (f32 bits), lab, h, ckd (f32 bits), ckh,
//    cki; d, lab and h go through the shared halo'd tile, the claimant key,
//    the code and the value stay in registers.
// With inner_cap = 1 a step is exactly one step of the synchronous
// recurrence, so the labels equal JAX wavefront_image_flood_jit(mode=
// "claim") bit for bit. The hop reset compares max(d_v, value) > d_v in f32
// with IEEE semantics: build without --use_fast_math.
//
// Bound: memory. A processed tile reads d, lab and h through its halo'd
// tile ((4*10*34) / (2*8*32) = 2.7x the tile's words), code, and for free
// voxels ckd, ckh, cki and the value, and writes 6 words per free voxel:
// a few dozen compares per voxel against ~70 bytes, far below the card's
// operations per byte. The frontier keeps that traffic to the tiles that
// can still change; the init pass (about 34 B a voxel) is the floor.

#include "flood_schedule.cuh"

namespace {

using flood::Schedule;
using flood::Tile;
using flood::Voxel;

__device__ __forceinline__ float D(Tile* sh, int z, int y, int x) {
  return __int_as_float(sh[0][z][y][x]);
}

struct ImageRule {
  struct Best {
    float kd;
    int kh;
    int ki;
    int lab;
  };

  static __device__ __forceinline__ void consider(Best& b, float d_v,
                                                  int lab_v, int h_v,
                                                  int idx_v) {
    bool better =
        lab_v > 0 &&
        (d_v < b.kd ||
         (d_v == b.kd && (h_v < b.kh || (h_v == b.kh && idx_v < b.ki))));
    if (better) {
      b.kd = d_v;
      b.kh = h_v;
      b.ki = idx_v;
      b.lab = lab_v;
    }
  }

  static constexpr int kWords = 6;      // d, lab, h, ckd, ckh, cki
  static constexpr int kHaloWords = 3;  // d, lab, h
  struct Params {
    const float* values;  // (Z, Y, X)
  };
  struct Own {
    float ckd, val;
    int ckh, cki;
  };

  static __device__ __forceinline__ void start(int* w, int lab, bool seeded,
                                               const Params& p, long long g) {
    w[0] = __float_as_int(seeded ? p.values[g] : INFINITY);
    w[1] = lab;
    w[2] = 0;
    w[3] = __float_as_int(seeded ? -INFINITY : INFINITY);
    w[4] = 0;
    w[5] = 0;
  }

  static __device__ __forceinline__ void load(Own& o, const int* src,
                                              long long N, const Voxel& v,
                                              const Params& p,
                                              const Schedule&) {
    o.ckd = __int_as_float(__ldcg(src + 3 * N + v.g));
    o.ckh = __ldcg(src + 4 * N + v.g);
    o.cki = __ldcg(src + 5 * N + v.g);
    o.val = __ldg(p.values + v.g);
  }

  // The best labelled neighbour and the claim test.
  static __device__ __forceinline__ bool best(Best& b, Tile* sh, const Own& o,
                                              const Voxel& v,
                                              const Schedule& s) {
    const int lz = v.lz, ly = v.ly, lx = v.lx;
    const int idx = (int)v.g, YX = s.Y * s.X, X = s.X;
    b = Best{INFINITY, 0, 0, 0};
    consider(b, D(sh, lz - 1, ly, lx), sh[1][lz - 1][ly][lx],
             sh[2][lz - 1][ly][lx], idx - YX);
    consider(b, D(sh, lz + 1, ly, lx), sh[1][lz + 1][ly][lx],
             sh[2][lz + 1][ly][lx], idx + YX);
    consider(b, D(sh, lz, ly - 1, lx), sh[1][lz][ly - 1][lx],
             sh[2][lz][ly - 1][lx], idx - X);
    consider(b, D(sh, lz, ly + 1, lx), sh[1][lz][ly + 1][lx],
             sh[2][lz][ly + 1][lx], idx + X);
    consider(b, D(sh, lz, ly, lx - 1), sh[1][lz][ly][lx - 1],
             sh[2][lz][ly][lx - 1], idx - 1);
    consider(b, D(sh, lz, ly, lx + 1), sh[1][lz][ly][lx + 1],
             sh[2][lz][ly][lx + 1], idx + 1);
    return b.kd < o.ckd ||
           (b.kd == o.ckd &&
            (b.kh < o.ckh || (b.kh == o.ckh && b.ki < o.cki)));
  }

  static __device__ __forceinline__ void apply(Tile* sh, Own& o, const Best& b,
                                               const Voxel& v) {
    // torch.maximum semantics: NaN propagates
    const float d_new =
        (isnan(b.kd) || isnan(o.val)) ? NAN : fmaxf(b.kd, o.val);
    sh[0][v.lz][v.ly][v.lx] = __float_as_int(d_new);
    sh[1][v.lz][v.ly][v.lx] = b.lab;
    sh[2][v.lz][v.ly][v.lx] = d_new > b.kd ? 0 : b.kh + 1;
    o.ckd = b.kd;
    o.ckh = b.kh;
    o.cki = b.ki;
  }

  static __device__ __forceinline__ void store(int* dst, long long N,
                                               const Voxel& v, Tile* sh,
                                               const Own& o) {
    dst[v.g] = sh[0][v.lz][v.ly][v.lx];
    dst[N + v.g] = sh[1][v.lz][v.ly][v.lx];
    dst[2 * N + v.g] = sh[2][v.lz][v.ly][v.lx];
    dst[3 * N + v.g] = __float_as_int(o.ckd);
    dst[4 * N + v.g] = o.ckh;
    dst[5 * N + v.g] = o.cki;
  }
};

}  // namespace

extern "C" {

// The init kernel on `stream`: the start state into both buffers of `state`
// ((2, 6, Z, Y, X) int32 words; seeds at their own value), `code`, and the
// first worklist in `work` (3 + 5 * n_tiles int32). Returns the CUDA error
// of the launch (0 on success).
int image_flood_init(int* state, uint8_t* code, const float* values,
                     const int* seeds, const uint8_t* mask, int Z, int Y,
                     int X, int* work, void* stream) {
  return flood::launch_init<ImageRule>(state, code, {values}, seeds, mask, Z,
                                       Y, X, work, (cudaStream_t)stream);
}

// The whole flood after the init kernel, one cooperative launch on
// `stream`; `result` (3 int64) receives steps, converged and tile_steps.
// Returns the CUDA error of the launch (0 on success).
int image_flood_run(int* state, const uint8_t* code, const float* values,
                    int Z, int Y, int X, int inner_cap, int max_steps,
                    int* work, long long* result, void* stream) {
  return flood::launch_run<ImageRule>(state, code, {values}, Z, Y, X,
                                      inner_cap, max_steps, work, result,
                                      (cudaStream_t)stream);
}

// The kernel's tile shape, so the plain version can reproduce its schedule.
void image_flood_tile(int* tz, int* ty, int* tx) {
  *tz = flood::TZ;
  *ty = flood::TY;
  *tx = flood::TX;
}

}  // extern "C"
