// Device code shared by the forward megakernels (megakernel.cu: K1a, K1c,
// K1d, K1e, K1', K2, K4's write side), the fused VJP kernel (gradkernel.cu:
// K3 and its BVH and tape-read variants) and the wavefront's segment kernels
// (wavefront.cu: K5, K6): the counter-based RNG, the jittered thin-lens ray,
// the closest-hit policies (brute sweep, flat BVH sweep, skip-pointer BVH
// walk, the dense stage, tape read), the v2 / v1 materials, the sky and the
// gamma.  K3's passes must give the forward's image bit for bit, and the
// wavefront the same samples, so every kernel takes a bounce step in the
// same two halves: its closest hit from closest_hit() below (under the
// policy: closest_hit_staged() over a flat BVH, closest_hit_walk() over
// the walk, closest_hit_brute() without a BVH), then shade().  The
// forward's render_refill (megakernel.cu), K3's k3_step (gradkernel.cu;
// or the tape's winner) and the wavefront's segment loops (wavefront.cu)
// all do so.
//
// The skip-pointer walk (K1d) replaces raytpu/kernels/megakernel.py:640-696
// and its VJP twin gradkernel.py:544-594, the path raytpu takes past 64
// leaves a copy and for unpadded BVHs.  What bounds it on this card: the
// same as the flat sweep, f32 operations in the box and sphere tests, plus
// a data-dependent loop whose length differs per lane (divergence) and a
// dependent load per node (the next row's address is the last row's skip).
// Where the flat sweep tests all L leaf boxes of a copy, the walk tests the
// nodes whose ancestors the ray enters within its best t so far: O(log L)
// per leaf reached, so it wins where L is large.  One thread walks its own
// ray through its own octant's copy with no stack (the skip pointers are
// the stack).  The forward and K3 walk through closest_hit_walk() below:
// node rows in a 16-byte layout (two float4 a node) read through L1,
// spheres as 16-byte rows, each lane advancing to its next entered leaf
// before the lanes sweep their leaves together, each missed sphere test
// ended before the square root.  raytpu's tile rule (a
// node is entered when any lane of the (8, 128) tile hits it) is a TPU
// mechanism for its vector unit, not semantics: the closest hit does not
// depend on which nodes a ray visits.
//
// Numerics (both kernels are built with -fmad=false and without fast math):
// the op order is raytpu/golden.py's (and raytpu_torch/golden.py's), so no
// multiply-add contracts.  Contraction at the ground sphere's discriminant
// half_b^2 - a*c moves t by ~19 ulp (catastrophic cancellation at r = 1000).
// The root test relies on sqrtf(negative) = NaN and on NaN comparing false.
// Where raytpu uses exp(log(c)/3) for a cube root, sin/cos of 2*pi*u,
// exp(log(x)/gamma) for gamma and rsqrt for normalization, so does this file.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr uint32_t kK = 1103515245u;
constexpr uint32_t kWeyl = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kFold = 0xBB67AE85u;
constexpr float kInvU24 = 1.0f / 16777216.0f;
constexpr float kInvI31 = 1.0f / 2147483648.0f;
constexpr float kTwoPi = 6.28318530718f;
constexpr float kSafeEps = 1e-20f;
constexpr float kInf = 3.0e38f;  // "no hit yet"; the golden's +inf

// Camera pack (raytpu_torch.kernels.megakernel.pack_camera, 19 floats):
// origin, horizontal, vertical, lower_left, the lens basis u and v, lens_r.
// The lens basis v is named w here, since v is the vertical span.
struct CamPack {
  float o[3], h[3], v[3], ll[3], u[3], w[3], lens_r;
};

// The (9, n) scene pack: rows cx cy cz rad mat_type ar ag ab mat_param.
struct SceneView {
  const float* __restrict__ cx;
  const float* __restrict__ cy;
  const float* __restrict__ cz;
  const float* __restrict__ rad;
  const float* __restrict__ mt;
  const float* __restrict__ ar;
  const float* __restrict__ ag;
  const float* __restrict__ ab;
  const float* __restrict__ mp;
  int n;
};

__device__ __forceinline__ SceneView scene_view(const float* pack, int n) {
  return SceneView{pack,         pack + n,     pack + 2 * n,
                   pack + 3 * n, pack + 4 * n, pack + 5 * n,
                   pack + 6 * n, pack + 7 * n, pack + 8 * n, n};
}

// The brute sweep's stage (kDense: every forward, K3, K5 and K6 launch
// without a BVH up to kDenseMax spheres): the
// scene's rows (cx, cy, cz, rad * rad) staged once per block in the
// kernel's dynamic shared memory, 16 bytes a sphere (327 spheres 5.2 KB,
// the cap of 4096 64 KB).  rad * rad is the f32 product sphere_root()
// forms, so the root test is the pack's to the bit.  Every thread of the
// block calls stage_dense() before any thread returns (threads past the
// frame included): it ends with the block's one barrier, and the sweeps
// after it read the rows with no other, since threads of a block sit at
// different samples and bounces.  Past kDenseMax the brute sweep reads the
// scene pack (kBrute).
extern __shared__ float4 dense_rows[];
// the largest scene stage_dense() stages: 64 KB of rows (raytpu's
// _DENSE_MAX; raytpu_torch.kernels.megakernel.DENSE_MAX)
constexpr int kDenseMax = 4096;

__device__ __forceinline__ void stage_dense(const float* pack, int n) {
  const int nt = blockDim.x * blockDim.y;
  for (int j = threadIdx.x + blockDim.x * threadIdx.y; j < n; j += nt) {
    const float rad = pack[3 * n + j];
    dense_rows[j] = make_float4(pack[j], pack[n + j], pack[2 * n + j],
                                rad * rad);
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t base_hash(uint32_t px, uint32_t py) {
  uint32_t hx = kK * ((px >> 1) ^ py);
  uint32_t hy = kK * ((py >> 1) ^ px);
  uint32_t h32 = kK * (hx ^ (hy >> 3));
  return h32 ^ (h32 >> 16);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fold_in(uint32_t state, uint32_t k) {
  return fmix32(state + (k + 1u) * kFold);
}

// One state advance (Weyl step + finalize): returns the draw, advances state.
__device__ __forceinline__ uint32_t draw(uint32_t& state) {
  state += kWeyl;
  return fmix32(state);
}

__device__ __forceinline__ float u31(uint32_t n) {
  return static_cast<float>(static_cast<int>(n & 0x7FFFFFFFu)) * kInvI31;
}

__device__ __forceinline__ float hash1_of(uint32_t n) {
  return static_cast<float>(static_cast<int>(n >> 8)) * kInvU24;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = rsqrtf(fmaxf(dot3(x, y, z, x, y, z), kSafeEps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ void reflect(float vx, float vy, float vz,
                                        float nx, float ny, float nz,
                                        float& ox, float& oy, float& oz) {
  float d = dot3(vx, vy, vz, nx, ny, nz);
  ox = vx - 2.0f * d * nx;
  oy = vy - 2.0f * d * ny;
  oz = vz - 2.0f * d * nz;
}

// Unit-sphere sample from the draw n (hash3 lanes): cbrt radius as
// exp(log(c)/3) with the c == 0 guard, angles as sin/cos of b * 2pi.
__device__ __forceinline__ void unit_sphere(uint32_t n, float& sx, float& sy,
                                            float& sz) {
  float a = u31(n);
  float b = u31(n * 16807u);
  float c = u31(n * 48271u);
  float h = a * 2.0f - 1.0f;
  float phi = b * kTwoPi;
  float r = c > 0.0f ? expf(logf(fmaxf(c, 1e-30f)) / 3.0f) : 0.0f;
  float s = sqrtf(fmaxf(1.0f - h * h, 0.0f));
  float rs = r * s;
  sx = rs * sinf(phi);
  sy = rs * cosf(phi);
  sz = r * h;
}

// The sky of direction (dx, dy, dz): lerp(white, (.5, .7, 1.), t).
__device__ __forceinline__ void sky(float dx, float dy, float dz, float& r,
                                    float& g, float& b) {
  float ux = dx, uy = dy, uz = dz;
  normalize3(ux, uy, uz);
  float t = 0.5f * (uy + 1.0f);
  r = 1.0f - 0.5f * t;
  g = 1.0f - 0.3f * t;
  b = 1.0f;
}

__device__ __forceinline__ float to_gamma(float lin, float gamma) {
  return lin > 0.0f ? expf(logf(lin) / gamma) : 0.0f;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// What raygen drew, for the camera cotangent: the jittered screen
// coordinates (u, v) and the unit-disk lens sample (0 for a pinhole).
struct RayGen {
  float u, v, ldx, ldy;
};

// Jittered camera ray (golden accumulate_pixels + camera.get_ray).  A
// pinhole camera consumes no lens draw.
__device__ __forceinline__ Ray gen_ray(const CamPack& cam, float fx, float fy,
                                       float inv_w, float inv_h,
                                       uint32_t& sd, RayGen& g) {
  float j1a = u31(draw(sd));
  float j2b = u31(draw(sd) * 48271u);
  g.u = (fx + j1a * 1.1f) * inv_w;
  g.v = (fy + j2b * 1.1f) * inv_h;
  g.ldx = 0.0f;
  g.ldy = 0.0f;
  float offx = 0.0f, offy = 0.0f, offz = 0.0f;
  if (cam.lens_r > 0.0f) {
    uint32_t n = draw(sd);
    float a = u31(n);
    float b = u31(n * 48271u);
    float phi = b * kTwoPi;
    float r = sqrtf(a);
    g.ldx = r * sinf(phi);
    g.ldy = r * cosf(phi);
    float rdx = cam.lens_r * g.ldx;
    float rdy = cam.lens_r * g.ldy;
    offx = cam.u[0] * rdx + cam.w[0] * rdy;
    offy = cam.u[1] * rdx + cam.w[1] * rdy;
    offz = cam.u[2] * rdx + cam.w[2] * rdy;
  }
  Ray r;
  r.ox = cam.o[0] + offx;
  r.oy = cam.o[1] + offy;
  r.oz = cam.o[2] + offz;
  r.dx = cam.ll[0] + g.u * cam.h[0] + g.v * cam.v[0] - r.ox;
  r.dy = cam.ll[1] + g.u * cam.h[1] + g.v * cam.v[1] - r.oy;
  r.dz = cam.ll[2] + g.u * cam.h[2] + g.v * cam.v[2] - r.oz;
  return r;
}

// ---- the closest hit: a compile-time policy ------------------------------
//
// The brute sweep (closest_hit_brute()): every sphere in index order, each
// missed test ended before the square root (sweep_rows), from the rows
// stage_dense() put in shared memory (kDense: every kernel up to
// kDenseMax spheres) or from the scene pack (kBrute: past kDenseMax);
// raytpu's dense MXU stage, megakernel.py:462-527, is a TPU layout of this
// same min / argmin: its bf16x3 one-hot extraction is this sweep reading
// the winner's attributes once, in scatter().  Flat BVH
// (closest_hit_staged()): the outlier tail, then the leaf rows of the
// octant copy the ray's own direction picks, front to back, a leaf where
// the ray enters its box within its best t so far.  Walk
// (closest_hit_walk()): the outlier tail, then the skip-pointer walk of
// that copy's nodes.  Tape read (K3's replay of K4's tape): the winner
// from the tape, its t recomputed for that one sphere.  All of them
// compute a sphere's t with sphere_root()'s arithmetic, so a
// winner's t is one number wherever it comes from, and the images and
// residuals of every variant are bit-equal (the BVH's up to exact equal-t
// ties of distinct spheres).  The flat sweep and the walk enter the same
// leaves in the same order: an interior box is the exact hull of its
// children's, and the rounded slab bounds are monotone in the box.
enum HitPolicy { kBrute = 0, kFlat = 1, kWalk = 2, kDense = 3 };

// The flat leaf list of a BVH (raytpu_torch/bvh.py): `flat` (8 * n_leaves,
// 9) f32 rows [min xyz, max xyz, start, count, skip], copy o's leaves in
// its front-to-back order; every leaf holds leaf_size permuted rows (NaN
// dummies pad it); the outliers are permuted rows [out_base, +out_cnt).
struct FlatBvh {
  const float* __restrict__ flat;
  int n_leaves, leaf_size, out_base, out_cnt;
};

// The node list of a BVH for the walk (closest_hit_walk()): copies *
// n_trav nodes in preorder, each [min xyz, max xyz, start, count, skip]
// in the 16-byte layout of `rows` (see WalkRow), count 0 for an interior
// node, skip the row after the node's subtree, relative within its copy;
// copies is 8 (padded leaves: copy o ordered front to back for octant o)
// or 1 (raytpu's unpadded variable leaves); the outliers as in FlatBvh
// (none without padding); `spheres` the permuted scene's rows (cx, cy, cz,
// rad * rad).
struct NodeBvh {
  int n_trav, copies, out_base, out_cnt;
  const float4* __restrict__ rows;
  const float4* __restrict__ spheres;
};

// Per-thread counts of the census (K1'): leaves entered, closest-hit
// steps, samples, nodes the walk visits (the other policies leave it 0);
// under the forward's persistent sample refill also the warp's
// bounce-loop, sphere-test and node-loop iterations, each counted by one
// lane of the lanes that run it (warp_tick), and the lane's own sphere
// tests.
struct Census {
  unsigned leaves, steps, samples, nodes, warp_steps, warp_tests,
      warp_nodes, tests;
};

// Adds k to c in the lowest active lane only: summed over the warp, one k
// for each time the warp runs the code, whichever of its lanes take part.
__device__ __forceinline__ void warp_tick(unsigned& c, unsigned k) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(m) - 1)) c += k;
}

// The next item (a pixel, a ray slot) of a lane whose item is done, on a
// persistent grid of `first` threads that took items [0, first) first:
// the lanes that ask together take consecutive items from *counter (0 at
// launch), one atomic a warp.  The block's x extent is a multiple of 32.
__device__ __forceinline__ int next_item(unsigned* counter, int first) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(m, base, leader);
  return first + static_cast<int>(base + __popc(m & ((1u << lane) - 1u)));
}

// Where a sweep reads sphere j's centre and squared radius: the scene pack
// (the brute sweep past kDenseMax, the flat sweep's unstaged rows, the
// tape's one sphere) or the rows stage_dense() staged (the brute sweep up
// to kDenseMax).  r2 is the f32 product rad * rad either way.
struct SceneRows {
  const SceneView& s;
  __device__ __forceinline__ float x(int j) const { return s.cx[j]; }
  __device__ __forceinline__ float y(int j) const { return s.cy[j]; }
  __device__ __forceinline__ float z(int j) const { return s.cz[j]; }
  __device__ __forceinline__ float r2(int j) const {
    return s.rad[j] * s.rad[j];
  }
};
struct DenseRows {
  __device__ __forceinline__ float x(int j) const { return dense_rows[j].x; }
  __device__ __forceinline__ float y(int j) const { return dense_rows[j].y; }
  __device__ __forceinline__ float z(int j) const { return dense_rows[j].z; }
  __device__ __forceinline__ float r2(int j) const { return dense_rows[j].w; }
};
// Rows (cx, cy, cz, rad * rad) from device memory at q: the walk's sphere
// rows, one 16-byte load a test where the scene pack takes four.
struct GlobalRows {
  const float4* __restrict__ q;
  __device__ __forceinline__ float x(int j) const { return q[j].x; }
  __device__ __forceinline__ float y(int j) const { return q[j].y; }
  __device__ __forceinline__ float z(int j) const { return q[j].z; }
  __device__ __forceinline__ float r2(int j) const { return q[j].w; }
};
// Rows (cx, cy, cz, rad * rad) from shared memory at q: the flat sweep's
// rows stage_flat() staged.
struct StagedRows {
  const float4* q;
  __device__ __forceinline__ float x(int j) const { return q[j].x; }
  __device__ __forceinline__ float y(int j) const { return q[j].y; }
  __device__ __forceinline__ float z(int j) const { return q[j].z; }
  __device__ __forceinline__ float r2(int j) const { return q[j].w; }
};

// The root test of ray r against sphere j (golden.hit_world's arithmetic,
// op for op): the t the sweeps compare, NaN or < t_min on a miss.  The NaN
// form of the root test: disc < 0 -> sqrtf gives NaN -> compares false.
// In two halves: disc_at(), the discriminant (and half_b), then root_of(),
// the roots; every sweep ends a test between them when the discriminant is
// negative or NaN (see sweep_rows).
template <class Rows>
__device__ __forceinline__ float disc_at(const Rows& rows, const Ray& r,
                                         float a, int j, float& half_b) {
  float ocx = r.ox - rows.x(j);
  float ocy = r.oy - rows.y(j);
  float ocz = r.oz - rows.z(j);
  float rad2 = rows.r2(j);
  half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad2;
  return half_b * half_b - a * c;
}

__device__ __forceinline__ float root_of(float half_b, float disc,
                                         float inv_a, float t_min) {
  float sqrtd = sqrtf(disc);
  float root1 = (-half_b - sqrtd) * inv_a;
  float root2 = (-half_b + sqrtd) * inv_a;
  return root1 >= t_min ? root1 : root2;
}

template <class Rows>
__device__ __forceinline__ float root_at(const Rows& rows, const Ray& r,
                                         float a, float inv_a, float t_min,
                                         int j) {
  float half_b;
  const float disc = disc_at(rows, r, a, j, half_b);
  return root_of(half_b, disc, inv_a, t_min);
}

__device__ __forceinline__ float sphere_root(const SceneView& s, const Ray& r,
                                             float a, float inv_a,
                                             float t_min, int j) {
  return root_at(SceneRows{s}, r, a, inv_a, t_min, j);
}

// Rows [j0, j0 + count) of `rows` into the running best, as spheres first,
// first + 1, ...: strict <, so among equal t the first tested wins.
// A negative or NaN discriminant (a miss, or a padding row) ends the test
// before the square root: root_of()'s sqrtf gives NaN there and no root
// passes, so the outcome is the same, and sqrtf takes its slow path (a
// call) for every such argument, most of a sweep's tests.  Counting, the
// warp runs as many iterations as the largest count of the lanes that
// sweep together (the walk's unpadded leaves differ).
template <bool kCount, class Rows>
__device__ __forceinline__ void sweep_rows(const Rows& rows, int j0,
                                           int count, int first, const Ray& r,
                                           float a, float inv_a, float t_min,
                                           float& tb, int& win, Census& cn) {
  if (kCount) {
    warp_tick(cn.warp_tests, __reduce_max_sync(__activemask(),
                                               static_cast<unsigned>(count)));
    cn.tests += count;
  }
  for (int i = 0; i < count; ++i) {
    float half_b;
    const float disc = disc_at(rows, r, a, j0 + i, half_b);
    if (!(disc >= 0.0f)) continue;
    const float root = root_of(half_b, disc, inv_a, t_min);
    if (root >= t_min && root < tb) {
      tb = root;
      win = first + i;
    }
  }
}

// min / max that propagate NaN, as torch.minimum and jnp.minimum do (fminf
// drops it): a slab test on a padded face gives NaN and must enter.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The slab test of ray r against the box of a BVH row: entered iff
// !(tnear > tfar), tnear clamped below by t_min and tfar above by the best
// t so far; a NaN (a ray on a padded face) enters.
__device__ __forceinline__ bool box_enter(const float* row, const Ray& r,
                                          float inv_dx, float inv_dy,
                                          float inv_dz, float t_min,
                                          float tb) {
  float t1 = (row[0] - r.ox) * inv_dx;
  float t2 = (row[3] - r.ox) * inv_dx;
  float t3 = (row[1] - r.oy) * inv_dy;
  float t4 = (row[4] - r.oy) * inv_dy;
  float t5 = (row[2] - r.oz) * inv_dz;
  float t6 = (row[5] - r.oz) * inv_dz;
  float tnear = nan_max(nan_max(nan_min(t1, t2), nan_min(t3, t4)),
                        nan_max(nan_min(t5, t6), t_min));
  float tfar = nan_min(nan_min(nan_max(t1, t2), nan_max(t3, t4)),
                       nan_min(nan_max(t5, t6), tb));
  return !(tnear > tfar);
}

// The brute sweep's closest hit (golden.hit_world): kDense over the rows
// stage_dense() staged (the kernel staged them first), kBrute over the
// scene pack.  Returns the winner or -1; tb = its t.
template <int kHit, bool kCount>
__device__ __forceinline__ int closest_hit_brute(const SceneView& s,
                                                 const Ray& r, float t_min,
                                                 float& tb, Census& cn) {
  float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  float inv_a = 1.0f / a;
  tb = kInf;
  int win = -1;
  if (kHit == kDense)
    sweep_rows<kCount>(DenseRows{}, 0, s.n, 0, r, a, inv_a, t_min, tb, win,
                       cn);
  else
    sweep_rows<kCount>(SceneRows{s}, 0, s.n, 0, r, a, inv_a, t_min, tb, win,
                       cn);
  return win;
}

// ---- the flat sweep from shared memory (the forward's K1c, K1b/bvh, K1',
// K2 and K4 over a flat BVH, K3's every sweep over one, K5/bvh and K6/bvh)
//
// golden.hit_world_bvh's tests over the scene in leaf order (the outliers,
// then the leaves whose boxes the ray enters within its best t so far,
// front to back in its octant's copy), in the same order for each lane, so
// the same winner, t and census; what is the card's is where the operands
// come from and which lanes run a leaf's sweep together.  stage_flat()
// puts the sweep's operands in the kernel's dynamic shared memory once per
// block, as much of them as the block may hold (FlatStage, planned by the
// wrapper from the device's opt-in limit): first the leaves' rows (cx, cy, cz,
// rad * rad) of leaves [0, leaves), leaf by leaf with one unused row after
// each, then the outliers' rows, then each octant copy's leaf boxes as two
// rows, (min xyz, the leaf's first staged row or -1) and (max xyz, its
// first permuted row).  The plan stages the boxes first (every lane tests
// all of its copy's), then the outliers (every step sweeps them), then the
// leaves that still fit; what is not staged is read from the scene pack
// and bvh.flat with the same arithmetic.  rad * rad is the f32 product
// sphere_root() forms.  The unused row shifts leaf i's rows by i x 16
// bytes across the banks: a 64-row leaf is 1 KB, a multiple of the banks'
// 128-byte cycle, so without it lanes sweeping different leaves at the same
// slot would read one bank group (an 8-way conflict in each quarter-warp
// phase of a 16-byte load).  config 4's BVH (8 leaves of 64, one outlier)
// stages 10.4 KB; 64 leaves of 64 with 4 outliers 83.0 KB.  K3 plans its
// stage within what leaves its blocks resident beside its refill's static
// shared memory (raytpu_torch.kernels.gradkernel.k3_stage), so a large BVH
// may stage part of itself there.
extern __shared__ float4 flat_rows[];

// What stage_flat() stages: leaves [0, leaves) of the BVH's leaf rows,
// `outliers` rows (0 or all of them) and `boxes` rows (0 or 16 a leaf).
struct FlatStage {
  int leaves, outliers, boxes;
};

// float4 rows stage_flat() writes (the launch's shared memory / 16).
__host__ __device__ constexpr int flat_stage_rows(const FlatStage& st,
                                                  int leaf_size) {
  return st.leaves * (leaf_size + 1) + st.outliers + st.boxes;
}

// Every thread of the block calls it before any thread returns (threads
// past the frame included): it ends with the block's one barrier, as
// stage_dense() does.
__device__ __forceinline__ void stage_flat(const float* pack, int n,
                                           const FlatBvh& bvh,
                                           const FlatStage& st) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int ls = bvh.leaf_size;
  const int leaf_rows = st.leaves * (ls + 1);
  const int rows = leaf_rows + st.outliers;
  for (int t = tid; t < rows; t += nt) {
    int j = bvh.out_base + (t - leaf_rows);  // an outlier's permuted row
    if (t < leaf_rows) {
      const int leaf = t / (ls + 1), slot = t - leaf * (ls + 1);
      if (slot == ls) continue;  // the unused row
      j = leaf * ls + slot;
    }
    const float rad = pack[3 * n + j];
    flat_rows[t] = make_float4(pack[j], pack[n + j], pack[2 * n + j],
                               rad * rad);
  }
  float4* boxes = flat_rows + rows;
  for (int b = tid; 2 * b < st.boxes; b += nt) {
    const float* row = bvh.flat + static_cast<size_t>(b) * 9;
    const int start = static_cast<int>(row[6]), leaf = start / ls;
    boxes[2 * b] = make_float4(
        row[0], row[1], row[2],
        static_cast<float>(leaf < st.leaves ? start + leaf : -1));
    boxes[2 * b + 1] = make_float4(row[3], row[4], row[5], row[6]);
  }
  __syncthreads();
}

// The flat sweep's closest hit over what stage_flat() staged (the rest
// from the scene pack and bvh.flat).  A lane walks its own octant copy's
// boxes front to back up to the next leaf it enters (the cheap box tests,
// run apart), then every lane that found one sweeps its leaf together: a
// warp runs as many leaf sweeps a step as its busiest lane enters, where a
// loop over leaf positions would run one for every position any lane
// entered.  The outliers come first, at warp-uniform rows.
template <bool kCount>
__device__ __forceinline__ int closest_hit_staged(const SceneView& s,
                                                  const FlatBvh& bvh,
                                                  const FlatStage& st,
                                                  const Ray& r, float t_min,
                                                  float& tb, Census& cn) {
  const float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const float inv_a = 1.0f / a;
  tb = kInf;
  int win = -1;
  const int n_leaves = bvh.n_leaves, ls = bvh.leaf_size;
  const int out_row = st.leaves * (ls + 1);
  if (st.outliers)
    sweep_rows<kCount>(StagedRows{flat_rows}, out_row, bvh.out_cnt,
                       bvh.out_base, r, a, inv_a, t_min, tb, win, cn);
  else
    sweep_rows<kCount>(SceneRows{s}, bvh.out_base, bvh.out_cnt,
                       bvh.out_base, r, a, inv_a, t_min, tb, win, cn);
  const float inv_dx = 1.0f / r.dx, inv_dy = 1.0f / r.dy,
              inv_dz = 1.0f / r.dz;
  const int octant = (r.dx < 0.0f ? 4 : 0) | (r.dy < 0.0f ? 2 : 0) |
                     (r.dz < 0.0f ? 1 : 0);
  const float4* box =
      flat_rows + out_row + st.outliers + 2 * octant * n_leaves;
  const float* row = bvh.flat + static_cast<size_t>(octant) * n_leaves * 9;
  const int staged_boxes = st.boxes ? n_leaves : 0;
  for (int k = 0;; ++k) {
    float4 lo, hi;
    for (; k < staged_boxes; ++k) {
      lo = box[2 * k];
      hi = box[2 * k + 1];
      const float b[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
      if (box_enter(b, r, inv_dx, inv_dy, inv_dz, t_min, tb)) break;
    }
    for (; k >= staged_boxes && k < n_leaves; ++k) {  // boxes not staged
      const float* g = row + 9 * k;
      lo = make_float4(g[0], g[1], g[2], 0.0f);
      hi = make_float4(g[3], g[4], g[5], g[6]);
      const float b[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
      if (box_enter(b, r, inv_dx, inv_dy, inv_dz, t_min, tb)) break;
    }
    if (k == n_leaves) return win;
    if (kCount) ++cn.leaves;
    const int start = static_cast<int>(hi.w);
    int staged = static_cast<int>(lo.w);
    if (!st.boxes)
      staged = start / ls < st.leaves ? start + start / ls : -1;
    if (staged >= 0)
      sweep_rows<kCount>(StagedRows{flat_rows}, staged, ls, start, r, a,
                         inv_a, t_min, tb, win, cn);
    else
      sweep_rows<kCount>(SceneRows{s}, start, ls, start, r, a, inv_a, t_min,
                         tb, win, cn);
  }
}

// ---- the walk over 16-byte rows (the forward's K1d, K1b/walk, K1', K2
// and K4 over the walk, K3's every sweep over it, K5/walk and K6/walk) ---
//
// golden.hit_world_walk's tests (the outliers, then the copy's nodes in
// preorder, a leaf swept where the ray enters its box, a subtree skipped
// where it misses), in the same order for each lane, with the same tb at
// each box test, so the same winner, t and census: the CUDA tests
// test_walk_kernels_match_plain, test_walk_refill_bit_equal_plain and
// test_segment_kernels_match_plain[walk, walk_unpadded], and chip_smoke.py's
// phases 7b and 8b, hold it bit for bit against that plain version.
// A node row in the 16-byte layout (WalkRow; written by
// raytpu_torch.bvh.pack_walk_rows, which refuses a BVH whose values it
// cannot hold): two float4, lo = (min xyz, w0) and hi = (max xyz, w1), the
// bits of
//     w0 = skip | (start & 0xFF) << 24,    w1 = start >> 8 | count << 12,
// skip in 24 bits (n_trav < 2^24), start and count in 20 (fewer than 2^20
// permuted rows).  A node's count and skip take one operation each, its
// start (a leaf's only) three.  The rows are read from `walk.rows` in
// device memory, the node's two float4 side by side; the spheres' rows
// (outliers and leaves) from `walk.spheres`, one 16-byte load a test, the
// outliers at warp-uniform rows (a broadcast).  The node rows are not
// staged in shared memory: on an H100 a stage of the whole list, or of its
// first rows, was no faster than L1 (PERF.md, section 6).

// A node row's fields (see above).
struct WalkRow {
  float4 lo, hi;
  __device__ __forceinline__ int count() const {
    return static_cast<int>(__float_as_uint(hi.w) >> 12);
  }
  __device__ __forceinline__ int skip() const {
    return static_cast<int>(__float_as_uint(lo.w) & 0xFFFFFFu);
  }
  __device__ __forceinline__ int start() const {
    return static_cast<int>((__float_as_uint(lo.w) >> 24) |
                            ((__float_as_uint(hi.w) & 0xFFFu) << 8));
  }
};

// The walk's closest hit over the node rows walk.rows and the sphere rows
// walk.spheres.  A lane walks its own octant copy's nodes, box tests only,
// up to the next leaf it enters (the cheap tests, run apart), then every
// lane that found one sweeps its leaf together: a warp runs as many leaf
// sweeps a step as its busiest lane enters, where a loop over nodes would
// run a sweep at every node position any lane entered a leaf.  The
// outliers come first.  Counting, one warp_nodes tick for each node-loop
// iteration any lane of the warp runs.
template <bool kCount>
__device__ __forceinline__ int closest_hit_walk(const NodeBvh& walk,
                                                const Ray& r, float t_min,
                                                float& tb, Census& cn) {
  const float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const float inv_a = 1.0f / a;
  tb = kInf;
  int win = -1;
  const GlobalRows spheres{walk.spheres};
  sweep_rows<kCount>(spheres, walk.out_base, walk.out_cnt, walk.out_base, r,
                     a, inv_a, t_min, tb, win, cn);
  const float inv_dx = 1.0f / r.dx, inv_dy = 1.0f / r.dy,
              inv_dz = 1.0f / r.dz;
  const int octant = (r.dx < 0.0f ? 4 : 0) | (r.dy < 0.0f ? 2 : 0) |
                     (r.dz < 0.0f ? 1 : 0);
  const int copy = walk.copies == 8 ? octant : 0;
  const float4* g = walk.rows + 2 * static_cast<size_t>(copy) * walk.n_trav;
  int rel = 0;
  for (;;) {
    // box tests up to the next entered leaf (rel stays on it): an entered
    // interior node falls through to rel + 1, anything else jumps to its
    // skip
    WalkRow row;
    bool leaf = false;
    while (!leaf && rel < walk.n_trav) {
      row = WalkRow{g[2 * rel], g[2 * rel + 1]};
      const float b[6] = {row.lo.x, row.lo.y, row.lo.z,
                          row.hi.x, row.hi.y, row.hi.z};
      const bool enter = box_enter(b, r, inv_dx, inv_dy, inv_dz, t_min, tb);
      if (kCount) {
        ++cn.nodes;
        warp_tick(cn.warp_nodes, 1u);
      }
      leaf = enter && row.count() > 0;
      if (!leaf) rel = enter ? rel + 1 : row.skip();
    }
    if (!leaf) return win;
    if (kCount) ++cn.leaves;
    const int start = row.start();
    sweep_rows<kCount>(spheres, start, row.count(), start, r, a, inv_a,
                       t_min, tb, win, cn);
    rel = row.skip();
  }
}

// The closest hit of ray r under the policy kHit, for every kernel's bounce
// step: the flat sweep (kFlat: closest_hit_staged over what stage_flat()
// staged), the walk (kWalk: closest_hit_walk) or the brute sweep (kDense,
// kBrute: closest_hit_brute).  Returns the winner or -1; tb = its t.
template <int kHit, bool kCount>
__device__ __forceinline__ int closest_hit(const SceneView& s,
                                           const FlatBvh& bvh,
                                           const FlatStage& st,
                                           const NodeBvh& walk, const Ray& r,
                                           float t_min, float& tb,
                                           Census& cn) {
  if constexpr (kHit == kFlat)
    return closest_hit_staged<kCount>(s, bvh, st, r, t_min, tb, cn);
  else if constexpr (kHit == kWalk)
    return closest_hit_walk<kCount>(walk, r, t_min, tb, cn);
  else
    return closest_hit_brute<kHit, kCount>(s, r, t_min, tb, cn);
}

// The winner-index tape of one pixel (K4): tape[k * stride + pix], k the
// pixel's global bounce step counted across its samples in order; int16
// (wide == 0) or int32 elements; g_cap steps are kept, later ones are not.
// K4 writes it in render_refill (megakernel.cu); K3 reads it in its own
// step (k3_step).
enum TapeMode { kNoTape = 0, kTapeWrite = 1 };

struct TapeCursor {
  void* buf;
  size_t stride, pix;
  int g_cap, k, wide;

  __device__ __forceinline__ int get() const {
    const size_t i = static_cast<size_t>(k) * stride + pix;
    return wide ? static_cast<const int*>(buf)[i]
                : static_cast<int>(static_cast<const int16_t*>(buf)[i]);
  }
  __device__ __forceinline__ void put(int w) const {
    const size_t i = static_cast<size_t>(k) * stride + pix;
    if (wide)
      static_cast<int*>(buf)[i] = w;
    else
      static_cast<int16_t*>(buf)[i] = static_cast<int16_t>(w);
  }
};

// Material scatter of a ray that hit sphere `win` at t (golden.scatter):
// one draw feeds the sphere sample (hash3 lanes) and the Schlick coin
// (hash1) alike.  Writes the hit point into r's origin, the new direction
// into r's direction, multiplies the attenuation into (cr, cg, cb) and
// advances sd by its one draw.
__device__ __forceinline__ void scatter(const SceneView& s, int win, float tb,
                                        bool is_g, bool v1, uint32_t& sd,
                                        Ray& r, float& cr, float& cg,
                                        float& cb) {
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  // hit point and outward normal
  float hpx = r.ox + tb * dx;
  float hpy = r.oy + tb * dy;
  float hpz = r.oz + tb * dz;
  float h_rad = s.rad[win];
  float inv_r = 1.0f / (h_rad == 0.0f ? 1.0f : h_rad);
  float nx = (hpx - s.cx[win]) * inv_r;
  float ny = (hpy - s.cy[win]) * inv_r;
  float nz = (hpz - s.cz[win]) * inv_r;
  bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
  float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  uint32_t n = draw(sd);
  float mp = s.mp[win];
  float odx, ody, odz;
  float atr = 1.0f, atg = 1.0f, atb = 1.0f;
  if (is_g) {
    float h1 = hash1_of(n);
    float ior = fmaxf(mp, 1e-3f);
    float ux = dx, uy = dy, uz = dz;
    normalize3(ux, uy, uz);
    float ratio = front ? 1.0f / ior : ior;
    float cosine = fminf(dot3(-ux, -uy, -uz, nx, ny, nz), 1.0f);
    float sine = sqrtf(fmaxf(1.0f - cosine * cosine, 0.0f));
    bool cannot = ratio * sine > 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    float m = 1.0f - cosine;
    float schlick = r0 + (1.0f - r0) * (m * m * m * m * m);
    if (cannot || schlick > h1) {
      reflect(ux, uy, uz, nx, ny, nz, odx, ody, odz);
    } else {  // refract (golden._refract)
      float cos_t = fminf(dot3(-ux, -uy, -uz, nx, ny, nz), 1.0f);
      float px = ratio * (ux + cos_t * nx);
      float py = ratio * (uy + cos_t * ny);
      float pz = ratio * (uz + cos_t * nz);
      float par = -sqrtf(fmaxf(fabsf(1.0f - dot3(px, py, pz, px, py, pz)),
                               kSafeEps));
      odx = px + par * nx;
      ody = py + par * ny;
      odz = pz + par * nz;
    }
  } else {
    bool is_d = s.mt[win] == 0.0f;
    float sx, sy, sz;
    unit_sphere(n, sx, sy, sz);
    atr = s.ar[win];
    atg = s.ag[win];
    atb = s.ab[win];
    if (v1) {
      // hemisphere flip (Shader_RT.fx:151-163)
      bool flip = dot3(sx, sy, sz, nx, ny, nz) > 0.0f;
      float hx = flip ? sx : -sx;
      float hy = flip ? sy : -sy;
      float hz = flip ? sz : -sz;
      if (is_d) {  // n + hemisphere, near-zero guard, unnormalized
        float lx = nx + hx, ly = ny + hy, lz = nz + hz;
        bool near0 = fabsf(lx) < 1e-8f && fabsf(ly) < 1e-8f &&
                     fabsf(lz) < 1e-8f;
        odx = near0 ? nx : lx;
        ody = near0 ? ny : ly;
        odz = near0 ? nz : lz;
      } else {  // reflect(normalize(rd)) + saturate(fuzz) * hemisphere
        float ux = dx, uy = dy, uz = dz;
        normalize3(ux, uy, uz);
        float rx, ry, rz;
        reflect(ux, uy, uz, nx, ny, nz, rx, ry, rz);
        float fz = fminf(fmaxf(mp, 0.0f), 1.0f);
        odx = rx + fz * hx;
        ody = ry + fz * hy;
        odz = rz + fz * hz;
      }
    } else if (is_d) {  // normalize(normal + sphere sample)
      odx = nx + sx;
      ody = ny + sy;
      odz = nz + sz;
      normalize3(odx, ody, odz);
    } else {  // normalize(reflect(rd, n) + fuzz * sphere sample)
      float rx, ry, rz;
      reflect(dx, dy, dz, nx, ny, nz, rx, ry, rz);
      odx = rx + mp * sx;
      ody = ry + mp * sy;
      odz = rz + mp * sz;
      normalize3(odx, ody, odz);
    }
  }
  cr = cr * atr;
  cg = cg * atg;
  cb = cb * atb;
  r.ox = hpx;
  r.oy = hpy;
  r.oz = hpz;
  r.dx = odx;
  r.dy = ody;
  r.dz = odz;
}

// A bounce past its closest hit `win` at t = tb (-1: a miss): on a miss
// the sky of the pre-scatter direction, on the hit of an unknown material
// absorption (black, seed kept), else the scatter, which moves r,
// multiplies the throughput (cr, cg, cb) in and advances sd by its one
// draw.  Returns whether the ray scattered (lives on).  On a miss the
// radiance (rr, rg, rb) gains c * sky, raytpu's add-once rule
// (megakernel.py:734: a sample misses once, so a radiance carried across a
// slot's samples sums them, as the wavefront's does).  A bounce step of
// golden.bounce_step (raytpu's make_bounce_body) is closest_hit(), then
// this.
__device__ __forceinline__ bool shade(const SceneView& s, int win, float tb,
                                      bool v1, uint32_t& sd, Ray& r,
                                      float& cr, float& cg, float& cb,
                                      float& rr, float& rg, float& rb) {
  if (win < 0) {  // miss: sky of the pre-scatter direction
    float kr, kg, kb;
    sky(r.dx, r.dy, r.dz, kr, kg, kb);
    rr = rr + cr * kr;
    rg = rg + cg * kg;
    rb = rb + cb * kb;
    return false;
  }
  float mt = s.mt[win];
  bool is_d = mt == 0.0f, is_m = mt == 1.0f, is_g = mt == 2.0f;
  if (!(is_d || is_m || is_g)) return false;  // absorbed: black, seed kept
  scatter(s, win, tb, is_g, v1, sd, r, cr, cg, cb);
  return true;
}

}  // namespace rt
