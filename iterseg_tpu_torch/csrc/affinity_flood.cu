// Seeded affinity flood (claim recurrence) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel iterseg_tpu/ops/pallas_flood.py:_flood_kernel
// (driven by pallas_flood_jit). The flood rule is the claim recurrence of
// iterseg_tpu_torch/ops/device_flood.py: a free voxel u (in the mask, not a
// seed) takes the labelled face neighbour v with the smallest key
// (d_v, idx_v) and claims only if that key is strictly below its stored
// claimant key (ckd_u, cki_u); then d_u = max(d_v, w_uv), lab_u = lab_v.
// The weight crossing between p and p + e_a is aff[a][p + e_a].
//
// Tie order: idx is the row-major ravel index of the (Z, Y, X) volume the
// caller passes. Every row-major embedding orders voxels alike, so ties
// break as in the JAX recurrence and the Pallas kernel.
//
// Schedule: flood_schedule.cuh (its note gives the frontier of active
// tiles, the persistent cooperative launch and why skipping tiles is
// exact). TPU grids run in order, and the Pallas kernel's cross-tile
// Gauss-Seidel sweep relies on it; CTAs here run in no order, so the state
// is double-buffered and every step is deterministic. This file holds only
// the state layout and the claim rule:
//  * state words per voxel: d (f32 bits), lab, ckd (f32 bits), cki; d and
//    lab go through the shared halo'd tile, the claimant key, the code and
//    the six entering weights stay in registers;
//  * seeds start at d = 0 with claimant key -inf.
// With inner_cap = 1 a step is exactly one step of the synchronous
// recurrence, so the labels equal JAX wavefront_flood_jit(mode="claim") bit
// for bit.
//
// Bound: memory. A processed tile reads d and lab through its halo'd tile
// ((4*10*34) / (2*8*32) = 2.7x the tile's words), and per free voxel ckd,
// cki, code and the entering affinities, and writes d, lab, ckd, cki,
// against a few dozen integer and float compares per voxel. The frontier
// keeps that traffic to the tiles that can still change; the init pass
// (about 22 B a voxel) is the floor of a flood.

#include "flood_schedule.cuh"

namespace {

using flood::Schedule;
using flood::Tile;
using flood::Voxel;

__device__ __forceinline__ float D(Tile* sh, int z, int y, int x) {
  return __int_as_float(sh[0][z][y][x]);
}

struct AffinityRule {
  struct Best {
    float kd;
    int ki;
    int lab;
    float w;
  };

  static __device__ __forceinline__ void consider(Best& b, float d_v,
                                                  int lab_v, float w,
                                                  int idx_v) {
    bool better = lab_v > 0 &&
                  (d_v < b.kd || (d_v == b.kd && idx_v < b.ki));
    if (better) {
      b.kd = d_v;
      b.ki = idx_v;
      b.lab = lab_v;
      b.w = w;
    }
  }

  static constexpr int kWords = 4;      // d, lab, ckd, cki
  static constexpr int kHaloWords = 2;  // d, lab
  struct Params {
    const float* aff;  // (3, Z, Y, X)
  };
  struct Own {
    float ckd;
    int cki;
    float w[6];
  };

  static __device__ __forceinline__ void start(int* w, int lab, bool seeded,
                                               const Params&, long long) {
    w[0] = __float_as_int(seeded ? 0.0f : INFINITY);
    w[1] = lab;
    w[2] = __float_as_int(seeded ? -INFINITY : INFINITY);
    w[3] = 0;
  }

  static __device__ __forceinline__ void load(Own& o, const int* src,
                                              long long N, const Voxel& v,
                                              const Params& p,
                                              const Schedule& s) {
    const float* __restrict__ aff = p.aff;
    const long long g = v.g, YX = (long long)s.Y * s.X;
    o.ckd = __int_as_float(__ldcg(src + 2 * N + g));
    o.cki = __ldcg(src + 3 * N + g);
    o.w[0] = __ldg(aff + g);                                    // z-
    o.w[1] = v.gz + 1 < s.Z ? __ldg(aff + g + YX) : INFINITY;   // z+
    o.w[2] = __ldg(aff + N + g);                                // y-
    o.w[3] = v.gy + 1 < s.Y ? __ldg(aff + N + g + s.X) : INFINITY;  // y+
    o.w[4] = __ldg(aff + 2 * N + g);                            // x-
    o.w[5] = v.gx + 1 < s.X ? __ldg(aff + 2 * N + g + 1) : INFINITY;  // x+
  }

  // The best labelled neighbour and the claim test.
  static __device__ __forceinline__ bool best(Best& b, Tile* sh, const Own& o,
                                              const Voxel& v,
                                              const Schedule& s) {
    const int lz = v.lz, ly = v.ly, lx = v.lx;
    const int idx = (int)v.g, YX = s.Y * s.X, X = s.X;
    b = Best{INFINITY, 0, 0, 0.0f};
    consider(b, D(sh, lz - 1, ly, lx), sh[1][lz - 1][ly][lx], o.w[0],
             idx - YX);
    consider(b, D(sh, lz + 1, ly, lx), sh[1][lz + 1][ly][lx], o.w[1],
             idx + YX);
    consider(b, D(sh, lz, ly - 1, lx), sh[1][lz][ly - 1][lx], o.w[2],
             idx - X);
    consider(b, D(sh, lz, ly + 1, lx), sh[1][lz][ly + 1][lx], o.w[3],
             idx + X);
    consider(b, D(sh, lz, ly, lx - 1), sh[1][lz][ly][lx - 1], o.w[4],
             idx - 1);
    consider(b, D(sh, lz, ly, lx + 1), sh[1][lz][ly][lx + 1], o.w[5],
             idx + 1);
    return b.kd < o.ckd || (b.kd == o.ckd && b.ki < o.cki);
  }

  static __device__ __forceinline__ void apply(Tile* sh, Own& o, const Best& b,
                                               const Voxel& v) {
    // torch.maximum semantics: NaN propagates
    const float d = (isnan(b.kd) || isnan(b.w)) ? NAN : fmaxf(b.kd, b.w);
    sh[0][v.lz][v.ly][v.lx] = __float_as_int(d);
    sh[1][v.lz][v.ly][v.lx] = b.lab;
    o.ckd = b.kd;
    o.cki = b.ki;
  }

  static __device__ __forceinline__ void store(int* dst, long long N,
                                               const Voxel& v, Tile* sh,
                                               const Own& o) {
    dst[v.g] = sh[0][v.lz][v.ly][v.lx];
    dst[N + v.g] = sh[1][v.lz][v.ly][v.lx];
    dst[2 * N + v.g] = __float_as_int(o.ckd);
    dst[3 * N + v.g] = o.cki;
  }
};

}  // namespace

extern "C" {

// The init kernel on `stream`: the start state into both buffers of `state`
// ((2, 4, Z, Y, X) int32 words), `code`, and the first worklist in `work`
// (3 + 5 * n_tiles int32). `aff` is unused: every flood's init takes its
// input. Returns the CUDA error of the launch (0 on success).
int affinity_flood_init(int* state, uint8_t* code, const float* aff,
                        const int* seeds, const uint8_t* mask, int Z, int Y,
                        int X, int* work, void* stream) {
  return flood::launch_init<AffinityRule>(state, code, {aff}, seeds, mask, Z,
                                          Y, X, work, (cudaStream_t)stream);
}

// The whole flood after the init kernel, one cooperative launch on
// `stream`; `result` (3 int64) receives steps, converged and tile_steps.
// Returns the CUDA error of the launch (0 on success).
int affinity_flood_run(int* state, const uint8_t* code, const float* aff,
                       int Z, int Y, int X, int inner_cap, int max_steps,
                       int* work, long long* result, void* stream) {
  return flood::launch_run<AffinityRule>(state, code, {aff}, Z, Y, X,
                                         inner_cap, max_steps, work, result,
                                         (cudaStream_t)stream);
}

// The kernel's tile shape, so the plain version can reproduce its schedule.
void affinity_flood_tile(int* tz, int* ty, int* tx) {
  *tz = flood::TZ;
  *ty = flood::TY;
  *tx = flood::TX;
}

}  // extern "C"
