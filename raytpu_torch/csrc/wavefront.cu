// The sorted wavefront's segment kernels for Hopper (sm_90a): a persistent
// slot grid whose lanes take one ray slot after another.
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
// Every bounce is the forward's: closest_hit() (render_common.cuh) under
// the policy the scene takes, then shade(), so a slot's samples are the
// megakernel's to the bit and at one slot a pixel (B = 1) the image is
// render()'s.
//
// What it computes, not how the TPU did it: raytpu's (rows, 128) tiles, the
// tile-wide early exit for a tile with no live lane and the tile-coherent
// BVH walk are TPU mechanisms.  What the sort buys on this card is warp
// coherence: after a sort, neighbouring slots hold rays of one direction
// octant leaving one cell of the scene, so lanes that take neighbouring
// slots enter the same leaves.  The design is the forward's (megakernel.cu,
// render_refill):
// - the closest hit is the forward's sweep under each policy: over a flat
//   BVH closest_hit_staged() over the leaf boxes, outliers and leaf rows
//   stage_flat() puts in shared memory once a block (planned by the
//   wrapper within the device's opt-in limit, the rest read from the pack
//   and the leaf list), over the walk closest_hit_walk() over 16-byte node
//   and sphere rows, without a BVH the brute sweep over the rows
//   stage_dense() stages up to kDenseMax spheres (the pack past that);
//   each lane advances to its own next leaf and the lanes sweep their
//   leaves together, and a missed test ends before sqrtf;
// - a persistent slot grid (segment_loop, refill_loop): as many blocks as
//   the card holds at once with the launch's shared memory, each lane
//   running one loop of bounce steps; it writes its slot when the slot is
//   done and takes the next from a counter (next_item: one atomic a warp),
//   so a warp waits for its busiest lane once a launch rather than for the
//   longest slot of each block of 32, and each block stages its rows once
//   a launch rather than once for every 256 slots.  Slots are independent
//   within a launch, so each slot's planes and key are the one-slot
//   kernel's bit for bit.  The price: plane loads and stores that no longer
//   coalesce once the lanes part (lanes that ask together take consecutive
//   slots, so they do at first and in the dead tail the sort gathers).
//
// What bounds it: the bounce's f32 operations (the sweep, as in K1), plus
// the planes: K5 reads 14 f32 planes and writes 15 (56 + 60 bytes a slot),
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
  const float* scene;   // (9, n) scene pack (leaf order with a BVH)
  int n;
  FlatBvh bvh;          // kFlat's leaf list
  FlatStage stage;      // what of it kFlat stages in shared memory
  NodeBvh walk;         // kWalk's node and sphere rows
  const float* box;     // (6,) the key's box: lo xyz, bins / extent xyz
  const float* in;      // planes in, (planes, R)
  float* out;           // planes out, (planes, R)
  unsigned* slot_next;  // the slot counter, 0 at launch where read
  int R, n_bounces, v1;
  float t_min;
};

struct SegParams {
  Common c;
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

// The block's stage of the policy's rows in shared memory (kFlat:
// stage_flat's plan, kDense: stage_dense; nothing for the walk and the
// pack).  Every thread calls it before any thread returns: a stage ends
// with the block's one barrier.
template <int kHit>
__device__ __forceinline__ void stage(const Common& c) {
  if constexpr (kHit == kFlat)
    stage_flat(c.scene, c.n, c.bvh, c.stage);
  else if constexpr (kHit == kDense)
    stage_dense(c.scene, c.n);
}

// The next slot of a lane whose slot is done: from c.slot_next (next_item:
// the lanes that ask together take consecutive slots, one atomic a warp),
// or none where the grid's first pass covered every slot (R <= its
// threads: the counter is neither read nor zeroed for that launch).
__device__ __forceinline__ int next_slot(const Common& c) {
  const int threads = gridDim.x * blockDim.x;
  return threads < c.R ? next_item(c.slot_next, threads) : c.R;
}

// K5: up to n_bounces bounces of every live slot, then its key.  Each lane
// runs one loop of bounce steps: it writes its slot when the slot is done
// (dead on entry, died, or ran n_bounces), then takes the next slot from
// c.slot_next (next_slot).
template <int kHit>
__global__ void __launch_bounds__(kBlock) render_segment_kernel(SegParams p) {
  const Common& c = p.c;
  stage<kHit>(c);
  const SceneView s = scene_view(c.scene, c.n);
  const size_t R = static_cast<size_t>(c.R);
  const bool v1 = c.v1 != 0;
  Ray r{};
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  float alive = 0.0f;
  uint32_t sd = 0u;
  int b = 0;
  Census cn{};  // unused: K5 does not count
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
      float tb;
      const int win = closest_hit<kHit, false>(s, c.bvh, c.stage, c.walk, r,
                                               c.t_min, tb, cn);
      if (shade(s, win, tb, v1, sd, r, cr, cg, cb, rr, rg, rb)) {
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
    i = next_slot(c);
    if (i < c.R) load(i);
  }
}

// K6: up to n_bounces refill steps of every live slot (raytpu's
// make_refill_step, megakernel.py:986-1028): a bounce; a sample that ended
// (a miss, an absorption or the depth cap) adds its radiance to the slot's
// sums and, while s + 1 < spp_slot, respawns the pixel's next sample, whose
// stream is fold_in(base_hash(px, py), (s + 1) * B + bidx) (parallel RNG).
// The grid is K5's: each lane runs one loop of steps, writes its slot when
// the slot is exhausted (it rides through as a copy), ran n_bounces or
// spent its samples, then takes the next slot (next_slot).  A respawn
// reads the camera pack where it happens, not held in registers.
template <int kHit>
__global__ void __launch_bounds__(kBlock) render_refill_kernel(RefillParams p) {
  const Common& c = p.c;
  stage<kHit>(c);
  const SceneView s = scene_view(c.scene, c.n);
  const CamPack& cam = *p.cam;
  const size_t R = static_cast<size_t>(c.R);
  const bool v1 = c.v1 != 0;
  // the slot's pixel and seed; its sample's ray, throughput, seed, index
  // and bounce; the sample's radiance (0 at every segment's bounds) and the
  // slot's sums; whether the slot still casts, the steps taken
  float fx = 0.0f, fy = 0.0f;
  uint32_t bidx = 0u, seed0 = 0u, sd = 0u;
  Ray r{};
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int smp = 0, d = 0, b = 0;
  bool ride = false, alive = false;
  Census cn{};  // unused: K6 does not count
  auto load = [&](int i) {
    const float* in = c.in + i;
    ride = !(in[0] < kDeadKey);  // exhausted: the slot rides through
    alive = !ride;
    b = 0;
    if (ride) return;
    const float sdpk = in[2 * R];  // s * 256 + d
    const float s_f = floorf(sdpk * (1.0f / 256.0f));
    smp = static_cast<int>(s_f);
    d = static_cast<int>(sdpk - s_f * 256.0f);
    r = Ray{in[3 * R], in[4 * R], in[5 * R], in[6 * R], in[7 * R], in[8 * R]};
    cr = in[9 * R];
    cg = in[10 * R];
    cb = in[11 * R];
    sd = __float_as_uint(in[12 * R]);
    ar = in[13 * R];
    ag = in[14 * R];
    ab = in[15 * R];
    fx = p.aux[i];
    fy = p.aux[R + i];
    bidx = static_cast<uint32_t>(static_cast<int>(p.aux[2 * R + i]));
    seed0 = base_hash(static_cast<uint32_t>(static_cast<int>(fx)),
                      static_cast<uint32_t>(static_cast<int>(fy)));
    rr = rg = rb = 0.0f;
  };
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < c.R) load(i);
  while (i < c.R) {
    if (alive && b < c.n_bounces) {
      float tb;
      const int win = closest_hit<kHit, false>(s, c.bvh, c.stage, c.walk, r,
                                               c.t_min, tb, cn);
      const bool scattered = shade(s, win, tb, v1, sd, r, cr, cg, cb, rr,
                                   rg, rb);
      ++b;
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
      continue;
    }
    const float* in = c.in + i;
    float* out = c.out + i;
    if (ride) {
#pragma unroll
      for (int k = 0; k < kRide; ++k) out[k * R] = in[k * R];
    } else {
      out[0] = alive ? (d == 0 ? primary_key(r) : cell_key(c.box, r))
                     : kDeadKey;
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
    i = next_slot(c);
    if (i < c.R) load(i);
  }
}

template <typename P>
void set_common(P& p, const void* scene, int n, const void* flat, int n_leaves,
                int leaf_size, const void* nodes, int n_trav, int copies,
                int out_base, int out_cnt, int stage_leaves,
                int stage_outliers, int stage_boxes, const void* spheres,
                const void* box, const void* in, void* out, int R,
                int n_bounces, float t_min, int v1, void* slot_next) {
  p.c.scene = static_cast<const float*>(scene);
  p.c.n = n;
  p.c.bvh = FlatBvh{static_cast<const float*>(flat), n_leaves, leaf_size,
                    out_base, out_cnt};
  p.c.stage = FlatStage{stage_leaves, stage_outliers, stage_boxes};
  p.c.walk = NodeBvh{n_trav, copies, out_base, out_cnt,
                     static_cast<const float4*>(nodes),
                     static_cast<const float4*>(spheres)};
  p.c.box = static_cast<const float*>(box);
  p.c.in = static_cast<const float*>(in);
  p.c.out = static_cast<float*>(out);
  p.c.slot_next = static_cast<unsigned*>(slot_next);
  p.c.R = R;
  p.c.n_bounces = n_bounces;
  p.c.t_min = t_min;
  p.c.v1 = v1;
}

// One launch of kernel<kHit> over R slots on a persistent grid: the blocks
// the card holds at once with the launch's shared memory (the policy's
// stage; past 48 KB after the kernel opts in), at most R / kBlock.  Zeroes
// the slot counter on the stream first where the grid has fewer threads
// than slots (see next_slot).
template <int kHit, typename P>
int launch(void (*kernel)(P), const P& p, cudaStream_t stream) {
  const size_t shmem =
      kHit == kDense  ? sizeof(float4) * p.c.n
      : kHit == kFlat ? sizeof(float4) * flat_stage_rows(p.c.stage,
                                                         p.c.bvh.leaf_size)
                      : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kBlock, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int need = (p.c.R + kBlock - 1) / kBlock;
  const int blocks = std::max(1, std::min(need, sms * per_sm));
  if (blocks < need) {
    e = cudaMemsetAsync(p.c.slot_next, 0, sizeof(unsigned), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {const_cast<P*>(&p)};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                       dim3(kBlock), args, shmem, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// K5's and K6's instantiation of the policy the operands give (see the
// entry points).
int launch_segment(const SegParams& p, const void* flat, const void* nodes,
                   cudaStream_t stream) {
  if (flat != nullptr)
    return launch<kFlat>(render_segment_kernel<kFlat>, p, stream);
  if (nodes != nullptr)
    return launch<kWalk>(render_segment_kernel<kWalk>, p, stream);
  if (p.c.n <= kDenseMax)
    return launch<kDense>(render_segment_kernel<kDense>, p, stream);
  return launch<kBrute>(render_segment_kernel<kBrute>, p, stream);
}

int launch_refill(const RefillParams& p, const void* flat, const void* nodes,
                  cudaStream_t stream) {
  if (flat != nullptr)
    return launch<kFlat>(render_refill_kernel<kFlat>, p, stream);
  if (nodes != nullptr)
    return launch<kWalk>(render_refill_kernel<kWalk>, p, stream);
  if (p.c.n <= kDenseMax)
    return launch<kDense>(render_refill_kernel<kDense>, p, stream);
  return launch<kBrute>(render_refill_kernel<kBrute>, p, stream);
}

bool bad_operands(int n, const void* flat, int n_leaves, const void* nodes,
                  int n_trav, int copies, int out_cnt, int stage_leaves,
                  int stage_outliers, int stage_boxes, const void* spheres,
                  int R, int n_bounces, const void* slot_next) {
  return n < 1 || R < 1 || n_bounces < 0 || slot_next == nullptr ||
         (flat != nullptr && nodes != nullptr) ||
         (nodes != nullptr && (n_trav < 1 || (copies != 1 && copies != 8) ||
                               spheres == nullptr)) ||
         (flat != nullptr &&
          (stage_leaves < 0 || stage_leaves > n_leaves ||
           (stage_outliers != 0 && stage_outliers != out_cnt) ||
           (stage_boxes != 0 && stage_boxes != 16 * n_leaves)));
}

}  // namespace

// C entry points (loaded with ctypes).  Each zeroes `slot_next` (one u32 of
// the caller's, from which the persistent grid takes the slots past its
// first ones) on `stream` where the grid has fewer threads than slots,
// launches there, does not synchronise and returns
// cudaGetLastError() so a refused launch is reported.  The closest-hit
// policy follows the operands as in megakernel.cu: `flat` -> the flat BVH
// sweep, staging stage_leaves leaves, stage_outliers outlier rows (0 or
// out_cnt) and stage_boxes box rows (0 or 16 n_leaves) in shared memory
// (FlatStage, planned by the wrapper within the device's opt-in limit);
// `nodes` -> the walk of its `copies` copies of n_trav node rows in the
// 16-byte layout over the permuted scene's rows (cx, cy, cz, rad * rad) in
// `spheres` (the scene in leaf order for both, the outlier tail
// [out_base, +out_cnt)); neither -> the brute sweep, over the rows it
// stages in shared memory up to kDenseMax spheres (kDense), else over the
// scene pack (kBrute).  `box`: the key's 6 floats on the device.  `in` and
// `out` hold (planes, R) f32 planes and must not overlap.
//
// K5: in = the 14 planes ox oy oz dx dy dz cr cg cb rr rg rb alive seed
// (the u32 bits), out = the same 14 after up to n_bounces bounces, then the
// key.
extern "C" int raytpu_wavefront_segment(
    const void* scene, int n, const void* flat, int n_leaves, int leaf_size,
    const void* nodes, int n_trav, int copies, int out_base, int out_cnt,
    int stage_leaves, int stage_outliers, int stage_boxes,
    const void* spheres, const void* box, const void* in, void* out, int R,
    int n_bounces, float t_min, int v1, void* slot_next, void* stream) {
  if (bad_operands(n, flat, n_leaves, nodes, n_trav, copies, out_cnt,
                   stage_leaves, stage_outliers, stage_boxes, spheres, R,
                   n_bounces, slot_next))
    return static_cast<int>(cudaErrorInvalidValue);
  SegParams p;
  set_common(p, scene, n, flat, n_leaves, leaf_size, nodes, n_trav, copies,
             out_base, out_cnt, stage_leaves, stage_outliers, stage_boxes,
             spheres, box, in, out, R, n_bounces, t_min, v1, slot_next);
  return launch_segment(p, flat, nodes, static_cast<cudaStream_t>(stream));
}

// K6: in = the 16 ride planes key pid sdpk ox oy oz dx dy dz cr cg cb seed
// ar ag ab, `aux` the 3 planes px py bidx of the same slots; out = the 16
// ride planes, the key first.  `cam`: the (19,) camera pack; spp_slot =
// spp / stride samples a slot, depth the frame's.
extern "C" int raytpu_wavefront_refill(
    const void* cam, const void* scene, int n, const void* flat, int n_leaves,
    int leaf_size, const void* nodes, int n_trav, int copies, int out_base,
    int out_cnt, int stage_leaves, int stage_outliers, int stage_boxes,
    const void* spheres, const void* box, const void* in, const void* aux,
    void* out, int R, int n_bounces, int depth, int spp_slot, int stride,
    float t_min, float inv_w, float inv_h, int v1, void* slot_next,
    void* stream) {
  if (bad_operands(n, flat, n_leaves, nodes, n_trav, copies, out_cnt,
                   stage_leaves, stage_outliers, stage_boxes, spheres, R,
                   n_bounces, slot_next) ||
      depth < 1 || depth > 256 || spp_slot < 1 || spp_slot > 65535 ||
      stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RefillParams p;
  set_common(p, scene, n, flat, n_leaves, leaf_size, nodes, n_trav, copies,
             out_base, out_cnt, stage_leaves, stage_outliers, stage_boxes,
             spheres, box, in, out, R, n_bounces, t_min, v1, slot_next);
  p.aux = static_cast<const float*>(aux);
  p.cam = static_cast<const CamPack*>(cam);
  p.depth = depth;
  p.spp_slot = spp_slot;
  p.stride = stride;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  return launch_refill(p, flat, nodes, static_cast<cudaStream_t>(stream));
}
