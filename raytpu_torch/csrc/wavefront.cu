// The sorted wavefront's segment kernels for Hopper (sm_90a): one thread
// per ray slot, but K5 under the dense stage, on a persistent slot grid.
//
//   K5  segment          raytpu/wavefront.py::_make_segment_kernel (:94),
//                        launched by _render_wavefront_impl (:465)
//   K6  refill segment   raytpu/wavefront.py::_make_refill_segment_kernel
//                        (:192), launched at :546
//
// The wavefront keeps its rays in SoA planes of R slots, R = pad32(H) *
// pad32(W) * B (B samples of a pixel in flight), which
// raytpu_torch/wavefront.py sorts by a key between segments (torch.sort of
// the key and a gather of every plane).  K5 runs up to n_bounces bounces of
// each live slot and writes the next sort key; K6 does the same with
// in-kernel respawn: a slot whose sample ends folds its radiance into the
// slot's sums and, while its pixel has samples left, casts the next one.
// Both take a bounce through render_common.cuh's bounce_step(), the device
// function of K1-K4, under the closest-hit policy the scene takes (brute,
// the dense stage, the flat BVH sweep or the walk), so a slot's samples are
// the megakernel's to the bit and at one slot a pixel (B = 1) the image is
// render()'s.
//
// What it computes, not how the TPU did it: raytpu's (rows, 128) tiles, the
// tile-wide early exit for a tile with no live lane and the tile-coherent
// BVH walk are TPU mechanisms.  Here a dead slot's thread copies the slot
// through, and each thread sweeps its own ray.  What the sort buys on this
// card is warp coherence: after a sort, neighbouring threads hold rays of
// one direction octant leaving one cell of the scene, so a warp's lanes
// enter the same leaves and end at similar depths.  Under the dense stage
// (REFERENCE_V2's 327 spheres, 3 + 9 + 38 bounces a wave) a warp still
// waits for its longest slot: there K5 runs on a persistent grid whose
// lanes take their next slot from a counter when theirs is done
// (dense_segment), at the price of plane loads and stores that no longer
// coalesce once the lanes part.
//
// What bounds it: the bounce's f32 operations (the sweep, as in K1), plus
// the planes: K5 reads 14 f32 planes and writes 15 (58 + 60 bytes a slot),
// K6 reads 19 and writes 16 (76 + 64 bytes), once per launch, where the
// megakernel keeps a sample in registers for its whole path.  Those bytes,
// the sorts between launches and the per-wave raygen are the wavefront's
// price for reordering rays.
//
// Sort keys (raytpu/wavefront.py:166-182, :287-305): a live slot's key is
// its cell, direction octant major, then the origin quantized to 32 x 32 x
// 8 cells of the scene's box (x, z, then y: raytpu's order); a dead slot's
// 1e9; in K6 a freshly respawned slot's the primary band 2^20 + its
// direction quantized to 64 x 64 and the sign of z.  Every key is an integer
// below 2^24, exact in f32.  The quantizer clamps before it truncates, which
// is raytpu's clip(trunc(x)) for every finite x.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

using namespace rt;

constexpr float kDeadKey = 1.0e9f;
constexpr float kPrimaryBase = 1048576.0f;  // 2^20
constexpr int kQxz = 32, kQy = 8, kQdir = 64;
// K6's ride planes: key pid sdpk ox oy oz dx dy dz cr cg cb seed ar ag ab
constexpr int kRide = 16;
constexpr int kBlock = 256;

// The closest-hit operands and the frame's scalars K5 and K6 share.
struct Common {
  const float* scene;  // (9, n) scene pack (leaf order with a BVH)
  int n;
  FlatBvh bvh;         // kFlat's leaf list
  NodeBvh walk;        // kWalk's node list
  const float* box;    // (6,) the key's box: lo xyz, bins / extent xyz
  const float* in;     // planes in, (planes, R)
  float* out;          // planes out, (planes, R)
  int R, n_bounces, v1;
  float t_min;
};

struct SegParams {
  Common c;
  unsigned* slot_next;  // K5/dense: the slot counter, 0 at launch; else null
};

struct RefillParams {
  Common c;
  const float* aux;  // (3, R): px, py (absolute), bidx
  const CamPack* cam;
  int depth, spp_slot, stride;  // stride: B, the samples of a pixel in flight
  float inv_w, inv_h;
};

// clip(trunc(x), 0, bins - 1) for finite x; NaN -> 0
__device__ __forceinline__ int quant(float x, int bins) {
  const float top = static_cast<float>(bins - 1);
  x = x > 0.0f ? x : 0.0f;
  x = x < top ? x : top;
  return static_cast<int>(x);
}

// raytpu's _cell_key: octant major, then x, z, y cells of the origin.
__device__ __forceinline__ float cell_key(const float* box, const Ray& r) {
  const int qx = quant((r.ox - box[0]) * box[3], kQxz);
  const int qy = quant((r.oy - box[1]) * box[4], kQy);
  const int qz = quant((r.oz - box[2]) * box[5], kQxz);
  const int octant = (r.dx < 0.0f ? 4 : 0) + (r.dy < 0.0f ? 2 : 0) +
                     (r.dz < 0.0f ? 1 : 0);
  return static_cast<float>(((octant * kQxz + qx) * kQxz + qz) * kQy + qy);
}

// The primary band of a freshly respawned slot (raytpu/wavefront.py:292-300).
__device__ __forceinline__ float primary_key(const Ray& r) {
  const float inv = rsqrtf(
      fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, kSafeEps));
  const float half = static_cast<float>(kQdir / 2);
  const int qdx = quant((r.dx * inv + 1.0f) * half, kQdir);
  const int qdy = quant((r.dy * inv + 1.0f) * half, kQdir);
  const int sz = r.dz < 0.0f ? 1 : 0;
  return kPrimaryBase + static_cast<float>((sz * kQdir + qdx) * kQdir + qdy);
}

// K5 under the dense stage: a persistent grid whose lanes each run one
// loop of bounce steps.  A lane writes its slot when the slot is done (dead
// on entry, died, or ran n_bounces), then takes the next slot from
// *slot_next (next_item: one atomic a warp), so a warp waits for its
// busiest lane once a launch rather than for the longest slot of each
// round; slots are independent within a segment, so each slot's planes and
// key are the one-slot kernel's bit for bit.  The sort puts coherent rays
// and the dead tail in consecutive slots, and lanes that ask together take
// consecutive slots.
__device__ __forceinline__ void dense_segment(const SegParams& p,
                                              const SceneView& s) {
  const Common& c = p.c;
  const size_t R = static_cast<size_t>(c.R);
  const int threads = gridDim.x * blockDim.x;
  const bool v1 = c.v1 != 0;
  Ray r{};
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  float alive = 0.0f;
  uint32_t sd = 0u;
  int b = 0;
  TapeCursor tc{nullptr, 0, 0, 0, 0, 0};
  Census cn{0u, 0u, 0u, 0u};
  auto load = [&](int i) {
    const float* in = c.in + i;
    r = Ray{in[0], in[R], in[2 * R], in[3 * R], in[4 * R], in[5 * R]};
    cr = in[6 * R];
    cg = in[7 * R];
    cb = in[8 * R];
    rr = in[9 * R];
    rg = in[10 * R];
    rb = in[11 * R];
    alive = in[12 * R];
    sd = __float_as_uint(in[13 * R]);
    b = 0;
  };
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < c.R) load(i);
  while (i < c.R) {
    if (alive > 0.0f && b < c.n_bounces) {
      if (bounce_step<kDense, kNoTape, false>(s, c.bvh, c.walk, r, sd,
                                              c.t_min, v1, cr, cg, cb, rr,
                                              rg, rb, tc, cn)) {
        ++b;
        continue;
      }
      alive = 0.0f;
    }
    float* out = c.out + i;
    out[0] = r.ox;
    out[R] = r.oy;
    out[2 * R] = r.oz;
    out[3 * R] = r.dx;
    out[4 * R] = r.dy;
    out[5 * R] = r.dz;
    out[6 * R] = cr;
    out[7 * R] = cg;
    out[8 * R] = cb;
    out[9 * R] = rr;
    out[10 * R] = rg;
    out[11 * R] = rb;
    out[12 * R] = alive;
    out[13 * R] = __uint_as_float(sd);
    out[14 * R] = alive > 0.0f ? cell_key(c.box, r) : kDeadKey;
    i = next_item(p.slot_next, threads);
    if (i < c.R) load(i);
  }
}

// K5: up to n_bounces bounces of a live slot, then its key; one slot a
// thread but under the dense stage (dense_segment).
template <int kHit>
__global__ void __launch_bounds__(kBlock) render_segment_kernel(SegParams p) {
  const Common& c = p.c;
  const SceneView s = scene_view(c.scene, c.n);
  if constexpr (kHit == kDense) {
    // the scene is staged before any thread of the block returns
    stage_dense(c.scene, c.n);
    dense_segment(p, s);
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c.R) return;
    const size_t R = static_cast<size_t>(c.R);
    const float* in = c.in + i;
    float* out = c.out + i;
    Ray r{in[0], in[R], in[2 * R], in[3 * R], in[4 * R], in[5 * R]};
    float cr = in[6 * R], cg = in[7 * R], cb = in[8 * R];
    float rr = in[9 * R], rg = in[10 * R], rb = in[11 * R];
    float alive = in[12 * R];
    uint32_t sd = __float_as_uint(in[13 * R]);
    if (alive > 0.0f) {
      TapeCursor tc{nullptr, 0, 0, 0, 0, 0};
      Census cn{0u, 0u, 0u, 0u};
      for (int b = 0; b < c.n_bounces; ++b) {
        if (!bounce_step<kHit, kNoTape, false>(
                s, c.bvh, c.walk, r, sd, c.t_min, c.v1 != 0, cr, cg, cb, rr,
                rg, rb, tc, cn)) {
          alive = 0.0f;
          break;
        }
      }
    }
    out[0] = r.ox;
    out[R] = r.oy;
    out[2 * R] = r.oz;
    out[3 * R] = r.dx;
    out[4 * R] = r.dy;
    out[5 * R] = r.dz;
    out[6 * R] = cr;
    out[7 * R] = cg;
    out[8 * R] = cb;
    out[9 * R] = rr;
    out[10 * R] = rg;
    out[11 * R] = rb;
    out[12 * R] = alive;
    out[13 * R] = __uint_as_float(sd);
    out[14 * R] = alive > 0.0f ? cell_key(c.box, r) : kDeadKey;
  }
}

// K6: up to n_bounces refill steps of a live slot (raytpu's
// make_refill_step, megakernel.py:986-1028): a bounce; a sample that ended
// (a miss, an absorption or the depth cap) adds its radiance to the slot's
// sums and, while s + 1 < spp_slot, respawns the pixel's next sample, whose
// stream is fold_in(base_hash(px, py), (s + 1) * B + bidx) (parallel RNG).
template <int kHit>
__global__ void __launch_bounds__(kBlock) render_refill_kernel(RefillParams p) {
  const Common& c = p.c;
  const SceneView s = scene_view(c.scene, c.n);
  if (kHit == kDense) stage_dense(c.scene, c.n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.R) return;
  const size_t R = static_cast<size_t>(c.R);
  const float* in = c.in + i;
  float* out = c.out + i;
  if (!(in[0] < kDeadKey)) {  // exhausted: the slot rides through
#pragma unroll
    for (int k = 0; k < kRide; ++k) out[k * R] = in[k * R];
    return;
  }
  const float sdpk = in[2 * R];  // s * 256 + d
  const float s_f = floorf(sdpk * (1.0f / 256.0f));
  int smp = static_cast<int>(s_f);
  int d = static_cast<int>(sdpk - s_f * 256.0f);
  Ray r{in[3 * R], in[4 * R], in[5 * R], in[6 * R], in[7 * R], in[8 * R]};
  float cr = in[9 * R], cg = in[10 * R], cb = in[11 * R];
  uint32_t sd = __float_as_uint(in[12 * R]);
  float ar = in[13 * R], ag = in[14 * R], ab = in[15 * R];
  const float fx = p.aux[i], fy = p.aux[R + i];
  const uint32_t bidx =
      static_cast<uint32_t>(static_cast<int>(p.aux[2 * R + i]));
  const uint32_t seed0 = base_hash(static_cast<uint32_t>(static_cast<int>(fx)),
                                   static_cast<uint32_t>(static_cast<int>(fy)));
  const CamPack cam = *p.cam;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // 0 at every segment's bounds
  bool alive = true;
  TapeCursor tc{nullptr, 0, 0, 0, 0, 0};
  Census cn{0u, 0u, 0u, 0u};
  for (int b = 0; b < c.n_bounces && alive; ++b) {
    const bool scattered = bounce_step<kHit, kNoTape, false>(
        s, c.bvh, c.walk, r, sd, c.t_min, c.v1 != 0, cr, cg, cb, rr, rg, rb,
        tc, cn);
    ++d;
    if (scattered && d < p.depth) continue;
    // the sample ended: fold it in, respawn while the pixel has samples
    ar = ar + rr;
    ag = ag + rg;
    ab = ab + rb;
    rr = 0.0f;
    rg = 0.0f;
    rb = 0.0f;
    ++smp;
    if (smp < p.spp_slot) {
      sd = fold_in(seed0, static_cast<uint32_t>(smp) *
                              static_cast<uint32_t>(p.stride) + bidx);
      RayGen g;
      r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, g);
      cr = 1.0f;
      cg = 1.0f;
      cb = 1.0f;
      d = 0;
    } else {
      alive = false;
    }
  }
  out[0] = alive ? (d == 0 ? primary_key(r) : cell_key(c.box, r)) : kDeadKey;
  out[R] = in[R];  // pid
  out[2 * R] = static_cast<float>(smp) * 256.0f + static_cast<float>(d);
  out[3 * R] = r.ox;
  out[4 * R] = r.oy;
  out[5 * R] = r.oz;
  out[6 * R] = r.dx;
  out[7 * R] = r.dy;
  out[8 * R] = r.dz;
  out[9 * R] = cr;
  out[10 * R] = cg;
  out[11 * R] = cb;
  out[12 * R] = __uint_as_float(sd);
  out[13 * R] = ar;
  out[14 * R] = ag;
  out[15 * R] = ab;
}

template <typename P>
void set_common(P& p, const void* scene, int n, const void* flat, int n_leaves,
                int leaf_size, const void* nodes, int n_trav, int copies,
                int out_base, int out_cnt, const void* box, const void* in,
                void* out, int R, int n_bounces, float t_min, int v1) {
  p.c.scene = static_cast<const float*>(scene);
  p.c.n = n;
  p.c.bvh = FlatBvh{static_cast<const float*>(flat), n_leaves, leaf_size,
                    out_base, out_cnt};
  p.c.walk = NodeBvh{static_cast<const float*>(nodes), n_trav, copies,
                     out_base, out_cnt};
  p.c.box = static_cast<const float*>(box);
  p.c.in = static_cast<const float*>(in);
  p.c.out = static_cast<float*>(out);
  p.c.R = R;
  p.c.n_bounces = n_bounces;
  p.c.t_min = t_min;
  p.c.v1 = v1;
}

// One launch of `kernel` over R slots; the dense stage's rows in dynamic
// shared memory, past 48 KB after the kernel opts in.  `persistent`: a
// persistent grid, the blocks the card holds at once (at most R / kBlock).
template <typename P>
int launch(void (*kernel)(P), bool dense, bool persistent, const P& p,
           cudaStream_t stream) {
  const size_t shmem = dense ? sizeof(float4) * p.c.n : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int blocks = (p.c.R + kBlock - 1) / kBlock;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(kernel), kBlock, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = std::max(1, std::min(blocks, sms * per_sm));
  }
  void* args[] = {const_cast<P*>(&p)};
  cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kBlock),
      args, shmem, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

bool bad_operands(int n, int dense, const void* flat, const void* nodes,
                  int n_trav, int copies, int R) {
  return n < 1 || R < 1 || (flat != nullptr && nodes != nullptr) ||
         (nodes != nullptr && (n_trav < 1 || (copies != 1 && copies != 8))) ||
         (dense && (flat != nullptr || nodes != nullptr || n > kDenseMax));
}

}  // namespace

// C entry points (loaded with ctypes).  Each launches on `stream`, does not
// synchronise and returns cudaGetLastError() so a refused launch is
// reported.  The closest-hit policy follows the operands as in
// megakernel.cu: `flat` -> the flat BVH sweep, `nodes` -> the walk (the
// scene in leaf order for both, the outlier tail [out_base, +out_cnt)),
// neither -> the brute sweep over the scene pack (kBrute: no stage), or
// with `dense` over the rows stage_dense() stages (kDense).  `box`: the
// key's 6 floats on the device.  `in` and `out` hold (planes, R) f32
// planes and must not overlap.
//
// K5: in = the 14 planes ox oy oz dx dy dz cr cg cb rr rg rb alive seed
// (the u32 bits), out = the same 14 after up to n_bounces bounces, then the
// key.  Under the dense stage `slot_next` (one u32, 0 at launch) is the
// counter from which its persistent grid takes the slots past its first
// ones; the other policies take none (null).
extern "C" int raytpu_wavefront_segment(
    const void* scene, int n, int dense, const void* flat, int n_leaves,
    int leaf_size, const void* nodes, int n_trav, int copies, int out_base,
    int out_cnt, const void* box, const void* in, void* out, int R,
    int n_bounces, float t_min, int v1, void* slot_next, void* stream) {
  if (bad_operands(n, dense, flat, nodes, n_trav, copies, R) ||
      n_bounces < 0 || (slot_next != nullptr) != (dense != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  SegParams p;
  set_common(p, scene, n, flat, n_leaves, leaf_size, nodes, n_trav, copies,
             out_base, out_cnt, box, in, out, R, n_bounces, t_min, v1);
  p.slot_next = static_cast<unsigned*>(slot_next);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flat != nullptr)
    return launch(render_segment_kernel<kFlat>, false, false, p, st);
  if (nodes != nullptr)
    return launch(render_segment_kernel<kWalk>, false, false, p, st);
  if (dense) return launch(render_segment_kernel<kDense>, true, true, p, st);
  return launch(render_segment_kernel<kBrute>, false, false, p, st);
}

// K6: in = the 16 ride planes key pid sdpk ox oy oz dx dy dz cr cg cb seed
// ar ag ab, `aux` the 3 planes px py bidx of the same slots; out = the 16
// ride planes, the key first.  `cam`: the (19,) camera pack; spp_slot =
// spp / stride samples a slot, depth the frame's.
extern "C" int raytpu_wavefront_refill(
    const void* cam, const void* scene, int n, int dense, const void* flat,
    int n_leaves, int leaf_size, const void* nodes, int n_trav, int copies,
    int out_base, int out_cnt, const void* box, const void* in,
    const void* aux, void* out, int R, int n_bounces, int depth,
    int spp_slot, int stride, float t_min,
    float inv_w, float inv_h, int v1, void* stream) {
  if (bad_operands(n, dense, flat, nodes, n_trav, copies, R) ||
      n_bounces < 0 || depth < 1 || depth > 256 || spp_slot < 1 ||
      spp_slot > 65535 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RefillParams p;
  set_common(p, scene, n, flat, n_leaves, leaf_size, nodes, n_trav, copies,
             out_base, out_cnt, box, in, out, R, n_bounces, t_min, v1);
  p.aux = static_cast<const float*>(aux);
  p.cam = static_cast<const CamPack*>(cam);
  p.depth = depth;
  p.spp_slot = spp_slot;
  p.stride = stride;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flat != nullptr)
    return launch(render_refill_kernel<kFlat>, false, false, p, st);
  if (nodes != nullptr)
    return launch(render_refill_kernel<kWalk>, false, false, p, st);
  if (dense) return launch(render_refill_kernel<kDense>, true, false, p, st);
  return launch(render_refill_kernel<kBrute>, false, false, p, st);
}
