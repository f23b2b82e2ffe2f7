// Fused image + VJP kernel K3 for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/kernels/gradkernel.py::render_pallas_vjp
// (kernel body _make_grad_kernel, both of its PASS 2 schedules: the
// per-sample pass and the windowed refill, p2_refill, :999-1518; the bounce
// transpose is _bounce_f's, the silhouette terms silhouette_terms'), with
// the brute sweep, the flat BVH sweep (bvh=), the skip-pointer walk
// (gradkernel.py:544-594, past 64 leaves a copy or unpadded) and the tape
// replay (K4's read side, tape_mode="read"; a partial tape walks past
// g_cap on a walk BVH).  Given an image cotangent ct it returns the
// image, the cotangent of every sphere's continuous leaves (center, radius,
// albedo, mat_param) and the 18 raygen sums from which the host assembles
// the camera cotangent.  The (8, 128) tiles, the VMEM residual scratch, the
// one-hot MXU scatter, the block_w scramble, the multi-tile grouping and
// the SMEM Kahan slots are TPU mechanisms with no counterpart here; the
// refill schedule is not one (below).
//
//   PASS 1 (skipped when the image is given, parallel RNG only): the
//          pixel's spp samples through k3_trace(), the forward's sweep
//          (K1a's, K1c's or K1d's) and shade(), so the image is the
//          forward's bit for bit; then the cotangent of the linear sample
//          sum, d_acc = ct * exp(log(img)*(1-gamma))/gamma * inv_spp (0
//          where img <= 0), in gradkernel.py:878-888's order.
//   PASS 2, per sample (sequential RNG, or asked for): one thread a pixel
//          (32 x 8 blocks); per sample, in order, re-run the forward,
//          keeping per bounce the incoming ray, throughput, winner and
//          pre-bounce seed (11 words) in per-thread local memory; walk the
//          bounces in reverse through a hand-written transpose of _bounce_f
//          (step_vjp); then transpose raygen into the 18 camera sums.
//          Sequential RNG needs no stored seeds: each re-run sample's final
//          seed is the next one's start.
//   PASS 2, windowed refill (parallel RNG with the image given: raytpu's
//          rule, gradkernel.py:1557-1563): a persistent 1-D grid of `lanes`
//          threads, as many as the card keeps resident; lane l takes pixels
//          l, l + lanes, ... in turn (raytpu's multi-tile hop) and each
//          pixel's samples in order, sample s seeded fold_in(base_hash(x,
//          y), s).  A window re-runs the forward one bounce step a row, the
//          row (12 words: ray, throughput, winner, seed, flags and the hop
//          and sample) in a device-memory scratch laid out [step][word]
//          [lane], so a warp's lanes store and load one step coalesced.
//          When a sample ends the lane spawns the pixel's next sample, or
//          hops to its next pixel, at once, while a full-depth sample still
//          fits the window (raytpu's can = g + 1 + depth <= g_cap); else it
//          parks.  The reverse then walks the window's rows newest first
//          through the same step_vjp: a FIN row recomputes the sample's
//          radiance (it misses at most once, at its last step: missed ?
//          c * sky : 0), a FRESH row re-derives the sample's raygen draws
//          with gen_ray, folds the raygen transpose into the camera sums
//          and cuts the carry.  The next window resumes the parked lanes.
//          It computes the per-sample pass's terms and sums them in another
//          order: its cotangents are allclose to that pass's, not
//          bit-equal (raytpu's gradkernel.py:1541-1547).
//   Either PASS 2 replays a tape (parallel RNG, image given): each of the
//          pixel's first g_cap bounce steps takes its winner from the tape
//          and recomputes that one sphere's t instead of sweeping; later
//          steps sweep.  The tape is tape[k, pix], k the pixel's step
//          across its samples in order, which does not depend on the
//          schedule.  The winner decides the bounce, so the residuals, and
//          the gradients, are those of the untaped kernel bit for bit.
//
// Slab mode (raytpu's row0 / rows): the launch covers rows [row0, row0 +
// rows) of the cfg-sized frame; ct, the image and the tape hold those rows.
// The RNG key and fy come from the absolute row, so a slab's sums are the
// full frame's over its pixels.  Rows past the frame's last one trace
// nothing, add nothing (their cotangent is ignored) and write 0.
//
// Without a BVH every sweep is the forward's brute sweep (K1a's): up to
// kDenseMax spheres over the rows stage_dense() puts in shared memory once
// a block (kDense; every thread stages before any pass, and no thread
// returns early), past that over the scene pack (kBrute).
// With a BVH the scene arrives in leaf order (padded with NaN dummies that
// never win): the sweeps are K1c's (closest_hit_staged over the rows
// stage_flat() puts in shared memory) or K1d's (closest_hit_walk over the
// node rows in device memory), the sphere cotangents accumulate in that
// order, dummies included, and the wrapper scatters them back to input
// order.  The near-miss sweep of vis_w runs over every
// permuted row (NaN rows fail its test), as gradkernel.py:1671 bounds it by
// nk, reading each row where the closest hit does.
//
// The transpose is derived by hand, piece by piece (bounce_vjp below): the
// quadratic root with the straight-through sqrt (value from sqrtf(disc),
// gradient from the 1e-20-clamped branch), hit point and normal with the
// inv_r guard, normalize with rsqrtf, reflect, refract with the ratio
// chosen by the front face, the v2 diffuse / metal directions, the v1
// flip / fuzz branch, the glass select, the throughput products and the
// sky of the pre-scatter direction on a miss.  Discrete events stay
// detached exactly as _bounce_f marks them: the winner, front face, near
// root, TIR / Schlick coin, v1 flip and near-zero guard and every draw.
// max / min against a constant pass half the gradient at a tie, as
// jnp.maximum does.  A thread reads back only the rows it wrote in this
// sample (window), so dead or parked lanes cannot feed 0 * inf into the
// reverse, and a miss's winner (-1) never addresses a sphere.
//
// Accumulation is in f64 and cast to f32 once, by the wrapper.  The camera
// sums are deterministic: each warp sums its lanes' per-thread f64 sums
// with a fixed butterfly and writes one row of an (n_warps, 18) buffer,
// which the wrapper reduces in a fixed order.  That matters most for the
// origin cotangent, a difference of sums that cancel about 800x
// (gradkernel.py:970-973, where the TPU kernel Kahan-compensates f32).  The
// refill's lanes are one number for every tape mode of a launch's policy
// and stage (raytpu_render_vjp_refill_lanes), so a taped launch's camera
// sums equal the untaped one's bit for bit.
// Sphere cotangents go through atomicAdd(double*) (native on sm_90): lanes
// of a warp with the same winner are first summed in a fixed lane order,
// but the atomics of different warps land in whatever order the card runs
// them, so two runs may differ in the last bits of those f64 sums.  After
// the cast to f32 they are bit-equal unless a sum lies within ~1e-13 of an
// f32 rounding boundary.  chip_smoke.py phase 2b compares two runs (with
// and without PASS 1, parallel RNG) and finds them bit-equal.
//
// What bounds it on this card: the closest-hit sweeps (two per sample in
// sequential RNG, the PASS-1 and the PASS-2 one; one in parallel RNG with
// the image given, none for the steps a tape holds), with vis_w the
// near-miss sweep (every sphere at every miss), warp divergence (paths end
// at different depths, materials branch per lane), the residual traffic,
// and atomic contention on the ground sphere, which almost every diffuse
// ray hits.  Its design for SIMT:
// - Over a flat BVH every sweep (PASS 1, PASS 2's re-forward on either
//   schedule, a replay's steps past g_cap) is the forward's K1c sweep,
//   closest_hit_staged(): the leaf boxes, the outliers and as many leaves'
//   rows as fit staged in shared memory once a block (stage_flat(), planned
//   by the wrapper, k3_stage, within what keeps two blocks an SM resident
//   beside the refill's cam_sh; the rest read from the pack), a missed test
//   ended before sqrtf's slow path, each lane walking its own octant's
//   boxes and the lanes that entered a leaf sweeping it together.  Its
//   winner and t are the forward's, so the image and residuals are.
//   Over the walk every sweep is the forward's K1d sweep, closest_hit_walk():
//   the node rows in the 16-byte layout and the spheres as 16-byte rows,
//   both read through L1, the same early exit, each lane walking to its
//   next entered leaf and the lanes sweeping their leaves together; its
//   winner and t are the forward's.
// - Without a BVH every sweep is K1a's: the rows staged in shared memory
//   (a broadcast where the pack took four loads a sphere), a missed test
//   ended before sqrtf; the near-miss sweep reads the same rows.  The
//   refill's lanes count the staged bytes (64 KB at kDenseMax beside the
//   36 KB of cam_sh still keeps two blocks an SM).
// - The near-miss sweep is the warp's (near_miss_sweep), called once a
//   reverse iteration by all 32 lanes, as add_by_key: the lanes whose row
//   is a miss are taken one by one, each lane testing every 32nd sphere of
//   the broadcast ray (over a flat BVH the staged rows as one run) and two
//   warp reductions picking the winner.  A warp pays
//   500 / 32 tests a miss where it paid 500 at every iteration any lane
//   missed, which on the refill, whose lanes sit at different samples, was
//   nearly every one.
// - The per-sample pass runs each warp's forward and reverse of a sample to
//   its longest path (every lane joins the warp-level sums), while config
//   4's paths take 2.56 bounce steps on average (chip_smoke.py's census,
//   NVIDIA H100 80GB HBM3, 700.00 W); the refill keeps every lane on a live
//   step in both sweeps, and pays for it with 48 bytes of rows a step
//   through device memory (written once, read once; a window of rows is far
//   larger than L2, where the per-sample pass's local rows mostly stay),
//   with every step type of the warp (scatter, miss, spawn) in every
//   iteration, and with a persistent grid of what stays resident: two
//   blocks an SM at 128 registers.  It keeps its camera sums in shared
//   memory (one column of 18 doubles a thread) rather than in 36 registers,
//   and loads the next row while it transposes this one.  The window W is
//   sized from the wrapper's byte budget (refill_plan): a lane parks when a
//   full-depth sample no longer fits, so the last steps of a window run
//   with fewer lanes, a share of about depth / (2 W).
// - Lanes with the same winner are summed with shuffles (a full-warp
//   butterfly when all 32 agree) before one lane issues the atomics.
// The refill's rows through device memory and per-block partial sums are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

using namespace rt;

constexpr int kMaxDepth = 64;   // local residual rows; the wrapper refuses more
constexpr int kLeaves = 8;      // cx cy cz rad ar ag ab mp
constexpr int kCamSums = 18;
constexpr int kRefillBlock = 256;  // threads a block of the refill grid
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Params {
  const CamPack* cam;
  const float* scene;   // (9, n) rows: cx cy cz rad mat_type ar ag ab mat_param
  FlatBvh bvh;          // kFlat's leaf list
  FlatStage stage;      // what of it kFlat stages in shared memory
  NodeBvh walk;         // kWalk's node rows (walk.rows)
  const void* tape;     // (g_cap, rows * width) int16 / int32 (kTape)
  const float* ct;      // (rows, width, 3) image cotangent
  const float* img_in;  // (rows, width, 3) forward image, or null (PASS 1)
  uint32_t* rows_buf;   // the refill's residual rows (window, 12, lanes)
  float* img_out;       // (rows, width, 3)
  double* gsc;          // (kLeaves, n) sphere cotangents, zeroed by the caller
  double* gcam;         // (n_warps, kCamSums) camera sums, one row a warp
  int n, width, height, row0, rows, spp, depth, g_cap, tape_wide;
  int lanes, window;    // the refill's lanes and window of steps
  float t_min, inv_w, inv_h, inv_spp, gamma, vis_w;
  int parallel, v1;
};

// One bounce's state as the reverse sweep needs it: the incoming ray and
// throughput, the winner (-1 on a miss) and the pre-bounce seed.
struct Residual {
  float ox, oy, oz, dx, dy, dz, cr, cg, cb;
  int win;
  uint32_t seed;
};

// d max(x, c)/dx and d min(x, c)/dx with jnp's tie rule: half at a tie.
__device__ __forceinline__ float dmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// VJP of normalize3 at v for the output cotangent g; adds into gv.
__device__ __forceinline__ void normalize3_vjp(const float v[3],
                                               const float g[3], float gv[3]) {
  float s = dot3(v[0], v[1], v[2], v[0], v[1], v[2]);
  float m = fmaxf(s, kSafeEps);
  float inv = rsqrtf(m);
  float g_inv = dot3(g[0], g[1], g[2], v[0], v[1], v[2]);
  // d rsqrt(m)/dm = -0.5 * rsqrt(m) / m
  float g_s = g_inv * (-0.5f * inv / m) * dmax(s, kSafeEps);
  for (int k = 0; k < 3; ++k) gv[k] += g[k] * inv + 2.0f * v[k] * g_s;
}

// VJP of reflect(v, n) = v - 2 (v.n) n for the output cotangent g.
__device__ __forceinline__ void reflect_vjp(const float v[3], const float n[3],
                                            const float g[3], float gv[3],
                                            float gn[3]) {
  float d = dot3(v[0], v[1], v[2], n[0], n[1], n[2]);
  float g_d = -2.0f * dot3(g[0], g[1], g[2], n[0], n[1], n[2]);
  for (int k = 0; k < 3; ++k) {
    gv[k] += g[k] + g_d * n[k];
    gn[k] += -2.0f * d * g[k] + g_d * v[k];
  }
}

// VJP of golden._refract(u, n, ratio) for the output cotangent g.
__device__ __forceinline__ void refract_vjp(const float u[3], const float n[3],
                                            float ratio, const float g[3],
                                            float gu[3], float gn[3],
                                            float& g_ratio) {
  float cdot = dot3(-u[0], -u[1], -u[2], n[0], n[1], n[2]);
  float ct = fminf(cdot, 1.0f);
  float inner[3], pp[3];
  for (int k = 0; k < 3; ++k) {
    inner[k] = u[k] + ct * n[k];
    pp[k] = ratio * inner[k];
  }
  float w = 1.0f - dot3(pp[0], pp[1], pp[2], pp[0], pp[1], pp[2]);
  float aw = fabsf(w);
  float sq = sqrtf(fmaxf(aw, kSafeEps));
  float par = -sq;
  // out = pp + par * n
  float g_par = dot3(g[0], g[1], g[2], n[0], n[1], n[2]);
  float g_w = -g_par * (0.5f / sq) * dmax(aw, kSafeEps) *
              (w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f));
  float g_pp[3], g_in[3];
  for (int k = 0; k < 3; ++k) {
    gn[k] += par * g[k];
    g_pp[k] = g[k] - 2.0f * pp[k] * g_w;
  }
  g_ratio += dot3(g_pp[0], g_pp[1], g_pp[2], inner[0], inner[1], inner[2]);
  for (int k = 0; k < 3; ++k) g_in[k] = ratio * g_pp[k];
  float g_ct = dot3(g_in[0], g_in[1], g_in[2], n[0], n[1], n[2]);
  float g_cdot = g_ct * dmin(cdot, 1.0f);
  for (int k = 0; k < 3; ++k) {
    gu[k] += g_in[k] - g_cdot * n[k];
    gn[k] += ct * g_in[k] - g_cdot * u[k];
  }
}

// VJP of c * sky(d) (a miss's radiance) for the cotangent dacc: adds into
// the throughput and direction cotangents.
__device__ __forceinline__ void sky_vjp(const float d[3], const float c[3],
                                        const float dacc[3], float gd[3],
                                        float gc[3]) {
  float kr, kg, kb;
  sky(d[0], d[1], d[2], kr, kg, kb);
  gc[0] += dacc[0] * kr;
  gc[1] += dacc[1] * kg;
  gc[2] += dacc[2] * kb;
  float g_t = -0.5f * (c[0] * dacc[0]) - 0.3f * (c[1] * dacc[1]);
  float g_u[3] = {0.0f, 0.5f * g_t, 0.0f};
  normalize3_vjp(d, g_u, gd);
}

// Transpose of one scattering bounce (_bounce_f with scat set) against its
// winner.  g holds the cotangent of the outgoing (origin, direction,
// throughput) on entry and of the incoming one on exit; ga receives the
// winner's leaf cotangents (cx cy cz rad ar ag ab mp).
__device__ void bounce_vjp(const SceneView& s, const Residual& r, float t_min,
                           bool v1, float g[9], float ga[kLeaves]) {
  const int w = r.win;
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  const float c[3] = {r.cr, r.cg, r.cb};
  const float C[3] = {s.cx[w], s.cy[w], s.cz[w]};
  const float R = s.rad[w], mt = s.mt[w], mp = s.mp[w];
  const float alb[3] = {s.ar[w], s.ag[w], s.ab[w]};
  const bool is_d = mt == 0.0f, is_m = mt == 1.0f, is_g = mt == 2.0f;

  // -- recompute the forward (closest_hit's root, scatter's normal)
  float oc[3] = {o[0] - C[0], o[1] - C[1], o[2] - C[2]};
  float a = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
  float hb = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2];
  float cc = dot3(oc[0], oc[1], oc[2], oc[0], oc[1], oc[2]) - R * R;
  float disc = hb * hb - a * cc;
  float sqrtd = sqrtf(disc);  // the value: a hit has disc >= 0
  float sqrt_safe = sqrtf(fmaxf(disc, kSafeEps));  // the gradient's branch
  float inv_a = 1.0f / a;
  float root1 = (-hb - sqrtd) * inv_a;
  float root2 = (-hb + sqrtd) * inv_a;
  bool near = root1 >= t_min;
  float t = near ? root1 : root2;
  float p[3], q[3], n[3];
  float r_safe = R == 0.0f ? 1.0f : R;
  float inv_r = 1.0f / r_safe;
  for (int k = 0; k < 3; ++k) {
    p[k] = o[k] + t * d[k];
    q[k] = p[k] - C[k];
    n[k] = q[k] * inv_r;
  }
  bool front = dot3(d[0], d[1], d[2], n[0], n[1], n[2]) < 0.0f;
  float sgn = front ? 1.0f : -1.0f;
  for (int k = 0; k < 3; ++k) n[k] = n[k] * sgn;
  uint32_t sd = r.seed;
  uint32_t nd = draw(sd);
  float sv[3];
  unit_sphere(nd, sv[0], sv[1], sv[2]);

  // -- throughput: n_c = c * at
  float g_o[3] = {0.0f, 0.0f, 0.0f};
  float g_nd[3] = {g[3], g[4], g[5]};
  float g_d[3] = {0.0f, 0.0f, 0.0f};
  float g_n[3] = {0.0f, 0.0f, 0.0f};
  float g_c[3];
  float g_p[3] = {g[0], g[1], g[2]};  // the new origin is the hit point
  float g_mp = 0.0f;
  for (int k = 0; k < 3; ++k) {
    g_c[k] = g[6 + k] * (is_g ? 1.0f : alb[k]);
    ga[4 + k] = is_g ? 0.0f : g[6 + k] * c[k];
  }

  // -- the selected direction's transpose
  if (is_g) {
    float ior = fmaxf(mp, 1e-3f);
    float u[3] = {d[0], d[1], d[2]};
    normalize3(u[0], u[1], u[2]);
    float ratio = front ? 1.0f / ior : ior;
    float cosine = fminf(dot3(-u[0], -u[1], -u[2], n[0], n[1], n[2]), 1.0f);
    float sine = sqrtf(fmaxf(1.0f - cosine * cosine, 0.0f));
    bool cannot = ratio * sine > 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    float m = 1.0f - cosine;
    float schlick = r0 + (1.0f - r0) * (m * m * m * m * m);
    float g_u[3] = {0.0f, 0.0f, 0.0f};
    if (cannot || schlick > hash1_of(nd)) {
      reflect_vjp(u, n, g_nd, g_u, g_n);
    } else {
      float g_ratio = 0.0f;
      refract_vjp(u, n, ratio, g_nd, g_u, g_n, g_ratio);
      float g_ior = front ? -g_ratio / (ior * ior) : g_ratio;
      g_mp += g_ior * dmax(mp, 1e-3f);
    }
    normalize3_vjp(d, g_u, g_d);
  } else if (v1) {
    if (is_d) {  // near0 ? n : n + hemisphere: n takes it either way
      for (int k = 0; k < 3; ++k) g_n[k] += g_nd[k];
    } else {  // reflect(normalize(d), n) + saturate(fuzz) * hemisphere
      bool flip = dot3(sv[0], sv[1], sv[2], n[0], n[1], n[2]) > 0.0f;
      float hh[3];
      for (int k = 0; k < 3; ++k) hh[k] = flip ? sv[k] : -sv[k];
      float u1[3] = {d[0], d[1], d[2]};
      normalize3(u1[0], u1[1], u1[2]);
      float g_fz = dot3(g_nd[0], g_nd[1], g_nd[2], hh[0], hh[1], hh[2]);
      g_mp += g_fz * dmin(fmaxf(mp, 0.0f), 1.0f) * dmax(mp, 0.0f);
      float g_u1[3] = {0.0f, 0.0f, 0.0f};
      reflect_vjp(u1, n, g_nd, g_u1, g_n);
      normalize3_vjp(d, g_u1, g_d);
    }
  } else if (is_d) {  // normalize(n + s)
    float qd[3] = {n[0] + sv[0], n[1] + sv[1], n[2] + sv[2]};
    normalize3_vjp(qd, g_nd, g_n);
  } else {  // normalize(reflect(d, n) + fuzz * s)
    float rv[3];
    reflect(d[0], d[1], d[2], n[0], n[1], n[2], rv[0], rv[1], rv[2]);
    float q2[3] = {rv[0] + mp * sv[0], rv[1] + mp * sv[1], rv[2] + mp * sv[2]};
    float g_q2[3] = {0.0f, 0.0f, 0.0f};
    normalize3_vjp(q2, g_nd, g_q2);
    g_mp += dot3(g_q2[0], g_q2[1], g_q2[2], sv[0], sv[1], sv[2]);
    reflect_vjp(d, n, g_q2, g_d, g_n);
  }

  // -- normal: n = (p - C) * inv_r * sgn
  float g_inv_r = 0.0f, g_C[3];
  for (int k = 0; k < 3; ++k) {
    float g_nr = g_n[k] * sgn;
    float g_q = g_nr * inv_r;
    g_inv_r += g_nr * q[k];
    g_p[k] += g_q;
    g_C[k] = -g_q;
  }
  float g_R = R != 0.0f ? -g_inv_r / (r_safe * r_safe) : 0.0f;

  // -- hit point: p = o + t * d
  float g_t = dot3(g_p[0], g_p[1], g_p[2], d[0], d[1], d[2]);
  for (int k = 0; k < 3; ++k) {
    g_o[k] += g_p[k];
    g_d[k] += t * g_p[k];
  }

  // -- root: t = (-hb -/+ sqrtd) * inv_a, straight-through sqrt
  float g_hb = -g_t * inv_a;
  float g_sq = (near ? -g_t : g_t) * inv_a;
  float g_inva = g_t * (near ? (-hb - sqrtd) : (-hb + sqrtd));
  float g_a = -g_inva * inv_a * inv_a;
  float g_disc = g_sq * (0.5f / sqrt_safe) * dmax(disc, kSafeEps);
  g_hb += 2.0f * hb * g_disc;
  g_a += -cc * g_disc;
  float g_cc = -a * g_disc;
  g_R += -2.0f * R * g_cc;
  for (int k = 0; k < 3; ++k) {
    float g_oc = 2.0f * oc[k] * g_cc + g_hb * d[k];
    g_d[k] += g_hb * oc[k] + 2.0f * d[k] * g_a;
    g_o[k] += g_oc;
    g_C[k] -= g_oc;
  }

  for (int k = 0; k < 3; ++k) {
    g[k] = g_o[k];
    g[3 + k] = g_d[k];
    g[6 + k] = g_c[k];
    ga[k] = g_C[k];
  }
  ga[3] = g_R;
  ga[7] = g_mp;
}

// raytpu's soft-coverage boundary term for sphere (C, R) along ray (o, d):
// d(sigmoid(disc / (a vis_w))) scaled by the radiance jump's cotangent.
// Adds into gb = (d cx, d cy, d cz, d rad).
__device__ __forceinline__ void boundary(const float o[3], const float d[3],
                                         float a, const float C[3], float R,
                                         const float jump[3],
                                         const float dacc[3], float vis_w,
                                         float gb[4]) {
  float oc[3] = {o[0] - C[0], o[1] - C[1], o[2] - C[2]};
  float hb = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2];
  float c = dot3(oc[0], oc[1], oc[2], oc[0], oc[1], oc[2]) - R * R;
  float disc = hb * hb - a * c;
  float sref = a * vis_w;
  float sig = 1.0f / (1.0f + expf(-disc / sref));
  float dsig = sig * (1.0f - sig) / sref;
  float w_ct = dacc[0] * jump[0] + dacc[1] * jump[1] + dacc[2] * jump[2];
  float f = dsig * w_ct;
  // d disc / d center = 2a*oc - 2hb*d ; d disc / d radius = 2aR
  for (int k = 0; k < 3; ++k) gb[k] += f * (2.0f * a * oc[k] - 2.0f * hb * d[k]);
  gb[3] += f * (2.0f * a * R);
}

// The near-miss test of sphere j, read from row q of `rows` (the scene
// pack, or the rows stage_flat() or stage_dense() staged), against ray r
// into the lane's running best: a forward-facing miss (hb < 0, disc < 0; a
// NaN row fails both) with the largest discriminant, strict >, so among
// equal ones the first tested wins.  disc_at()'s arithmetic, golden's.
template <class Rows>
__device__ __forceinline__ void near_miss_test(const Rows& rows, const Ray& r,
                                               float a, int q, int j,
                                               float& best, int& m) {
  float hb;
  const float disc = disc_at(rows, r, a, q, hb);
  if (hb < 0.0f && disc < 0.0f && disc > best) {
    best = disc;
    m = j;
  }
}

// Lane `lane`'s share of the near-miss sweep of ray r over the kernel's n
// spheres, each tested once by one lane of the warp and read where the
// closest hit reads it, a lane's spheres in increasing order.  Under the
// flat BVH: the staged leaves' rows lane, lane + 32, ... as one run (leaf
// i's row of sphere j is j + i; the unused row after each leaf is NaN, see
// render_vjp), then spheres from the first unstaged one on, the staged
// outliers from their rows and the rest from the pack; else spheres lane,
// lane + 32, ... from the rows stage_dense() staged (kDense) or the pack.
template <int kHit>
__device__ __forceinline__ void near_miss_share(const Params& p,
                                                const SceneView& s,
                                                const Ray& r, float a,
                                                int lane, float& best,
                                                int& m) {
  int j = lane;
  if constexpr (kHit == kFlat) {
    const int ls = p.bvh.leaf_size, rows = p.stage.leaves * (ls + 1);
    const StagedRows staged{flat_rows};
    for (int q = lane; q < rows; q += 32)
      near_miss_test(staged, r, a, q, q, best, m);
    if (m >= 0) m -= m / (ls + 1);  // the winning row's sphere
    j = p.stage.leaves * ls + lane;
    if (p.stage.outliers) {
      for (; j < p.bvh.out_base; j += 32)
        near_miss_test(SceneRows{s}, r, a, j, j, best, m);
      const int out_row = rows - p.bvh.out_base;
      for (; j < s.n; j += 32)
        near_miss_test(staged, r, a, out_row + j, j, best, m);
      return;
    }
  }
  if constexpr (kHit == kDense) {
    for (; j < s.n; j += 32) near_miss_test(DenseRows{}, r, a, j, j, best, m);
    return;
  }
  for (; j < s.n; j += 32) near_miss_test(SceneRows{s}, r, a, j, j, best, m);
}

// The near-miss sphere of every lane of the warp whose row is a miss
// (`miss`; r its residual row): the nearest forward-facing near miss,
// argmax of the negative discriminant over all n spheres, the first on
// ties (the sequential strict-> loop's, torch.max's and jnp.argmax's).
// All 32 lanes call it together.  The misses go one after another: the
// lane's ray is broadcast,
// each lane tests every 32nd sphere (near_miss_share), and two warp
// reductions take the largest discriminant, then the lowest index among
// the lanes that hold it (-inf: none).  A lane's best is -inf or negative,
// and complementing the bits of such floats orders them as their values,
// so the first reduction is an unsigned max; equal values have equal bits.
// Returns the lane's own sphere, or -1 (none, or not a miss).
template <int kHit>
__device__ __forceinline__ int near_miss_sweep(const Params& p,
                                               const SceneView& s, bool miss,
                                               const Residual& r) {
  const int lane = threadIdx.x & 31;
  int mine = -1;
  for (unsigned todo = __ballot_sync(kFull, miss); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const Ray q{__shfl_sync(kFull, r.ox, src), __shfl_sync(kFull, r.oy, src),
                __shfl_sync(kFull, r.oz, src), __shfl_sync(kFull, r.dx, src),
                __shfl_sync(kFull, r.dy, src), __shfl_sync(kFull, r.dz, src)};
    const float a = dot3(q.dx, q.dy, q.dz, q.dx, q.dy, q.dz);
    float best = __int_as_float(0xff800000);  // -inf
    int m = -1;
    near_miss_share<kHit>(p, s, q, a, lane, best, m);
    const unsigned key = ~__float_as_uint(best);
    const unsigned top = __reduce_max_sync(kFull, key);
    const unsigned first = __reduce_min_sync(
        kFull, key == top ? static_cast<unsigned>(m) : 0xFFFFFFFFu);
    if (lane == src) mine = static_cast<int>(first);  // -1 for none
  }
  return mine;
}

// The miss side of the silhouette terms for a missed row r whose near-miss
// sphere is m: m gaining coverage, with raytpu's one-bounce radiance
// estimate by material.  Adds m's (cx cy cz rad) cotangent into gb.
__device__ void near_miss_boundary(const SceneView& s, const Residual& r,
                                   int m, const float v[3],
                                   const float dacc[3], float vis_w,
                                   float gb[4]) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  const float c[3] = {r.cr, r.cg, r.cb};
  const float a = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
  const float C[3] = {s.cx[m], s.cy[m], s.cz[m]};
  const float alb[3] = {s.ar[m], s.ag[m], s.ab[m]};
  const float mt = s.mt[m];
  float mo[3] = {o[0] - C[0], o[1] - C[1], o[2] - C[2]};
  float hb_m = mo[0] * d[0] + mo[1] * d[1] + mo[2] * d[2];
  float t_ca = -hb_m / a;  // closest approach along the ray
  float nb[3] = {mo[0] + t_ca * d[0], mo[1] + t_ca * d[1],
                 mo[2] + t_ca * d[2]};
  normalize3(nb[0], nb[1], nb[2]);
  float ud[3] = {d[0], d[1], d[2]};
  normalize3(ud[0], ud[1], ud[2]);
  float rf[3];
  reflect(ud[0], ud[1], ud[2], nb[0], nb[1], nb[2], rf[0], rf[1], rf[2]);
  float skn[3], skf[3];
  sky(nb[0], nb[1], nb[2], skn[0], skn[1], skn[2]);
  sky(rf[0], rf[1], rf[2], skf[0], skf[1], skf[2]);
  float jump[3];
  for (int k = 0; k < 3; ++k) {
    float est = mt == 0.0f ? alb[k] * skn[k]
                           : (mt == 2.0f ? skf[k] : alb[k] * skf[k]);
    jump[k] = c[k] * est - v[k];
  }
  boundary(o, d, a, C, s.rad[m], jump, dacc, vis_w, gb);
}

// Adds k values per lane into acc[i * n + key] for every lane whose key is
// >= 0.  All 32 lanes of the warp must call it together.  Lanes with the
// same key are summed in f64 in a fixed lane order (a butterfly when the
// whole warp agrees), and one lane of each group issues the atomics.
template <int k>
__device__ __forceinline__ void add_by_key(double* acc, int n, int key,
                                           const float* v) {
  const unsigned peers = __match_any_sync(kFull, key);
  if (key < 0) return;
  const int lane = threadIdx.x & 31;
  double sum[k];
  if (peers == kFull) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      double x = static_cast<double>(v[i]);
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
      sum[i] = x;
    }
  } else {
#pragma unroll
    for (int i = 0; i < k; ++i) sum[i] = 0.0;
    unsigned rest = peers;
    while (rest) {
      int src = __ffs(rest) - 1;
      rest &= rest - 1;
#pragma unroll
      for (int i = 0; i < k; ++i)
        sum[i] += __shfl_sync(peers, static_cast<double>(v[i]), src);
    }
  }
  if (lane == __ffs(peers) - 1) {
#pragma unroll
    for (int i = 0; i < k; ++i)
      if (sum[i] != 0.0) atomicAdd(acc + static_cast<size_t>(i) * n + key, sum[i]);
  }
}

// The cotangent of a pixel's linear sample sum from its image `img` and
// the image cotangent at element `pix` (gradkernel.py:878-888's order):
// d_acc = ct * exp(log(img) * (1 - gamma)) / gamma * inv_spp, 0 where
// img <= 0.
__device__ __forceinline__ void sum_cotangent(const Params& p, size_t pix,
                                              const float img[3],
                                              float dacc[3]) {
  const float one_m_g = 1.0f - p.gamma;
  for (int k = 0; k < 3; ++k) {
    float dd = img[k] > 0.0f ? expf(logf(img[k]) * one_m_g) / p.gamma : 0.0f;
    dacc[k] = p.ct[pix + k] * dd * p.inv_spp;
  }
}

// The silhouette terms' miss side for the warp's rows of one reverse
// iteration: each missed row's (`miss`) near-miss sphere (near_miss_sweep)
// gains its coverage cotangent (near_miss_boundary), added by key.  All 32
// lanes call it together, as add_by_key.
template <int kHit>
__device__ __forceinline__ void add_near_miss(const Params& p,
                                              const SceneView& s, bool miss,
                                              const Residual& r,
                                              const float v[3],
                                              const float dacc[3]) {
  const int m = near_miss_sweep<kHit>(p, s, miss, r);
  float gb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (m >= 0) near_miss_boundary(s, r, m, v, dacc, p.vis_w, gb);
  add_by_key<4>(p.gsc, p.n, m, gb);
}

// The transpose of one bounce step, residual r, of a sample whose radiance
// is v (used by the silhouette terms only).  g carries the cotangent of the
// step's outgoing (origin, direction, throughput) on entry and of its
// incoming one on exit.  The winner's leaf cotangents land in ga under key
// (-1: no sphere); an absorbing step passes g through and adds nothing.  A
// miss's silhouette term is the warp's (add_near_miss).
__device__ __forceinline__ void step_vjp(const SceneView& s, const Residual& r,
                                         float t_min, bool v1, float vis_w,
                                         const float v[3],
                                         const float dacc[3], float g[9],
                                         int& key, float ga[kLeaves]) {
  if (r.win < 0) {  // miss: radiance c * sky(d); the state passes
    const float dv[3] = {r.dx, r.dy, r.dz};
    const float cv[3] = {r.cr, r.cg, r.cb};
    float gd[3] = {g[3], g[4], g[5]}, gc[3] = {g[6], g[7], g[8]};
    sky_vjp(dv, cv, dacc, gd, gc);
    for (int k = 0; k < 3; ++k) {
      g[3 + k] = gd[k];
      g[6 + k] = gc[k];
    }
    return;
  }
  const float mt = s.mt[r.win];
  if (!(mt == 0.0f || mt == 1.0f || mt == 2.0f)) return;  // absorbed
  bounce_vjp(s, r, t_min, v1, g, ga);
  key = r.win;
  if (vis_w > 0.0f) {  // hit side: v turns into thr * sky
    const float o3[3] = {r.ox, r.oy, r.oz};
    const float d3[3] = {r.dx, r.dy, r.dz};
    const float C[3] = {s.cx[key], s.cy[key], s.cz[key]};
    float kr, kg, kb;
    sky(r.dx, r.dy, r.dz, kr, kg, kb);
    const float jump[3] = {v[0] - r.cr * kr, v[1] - r.cg * kg,
                           v[2] - r.cb * kb};
    float gh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    boundary(o3, d3, dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz), C, s.rad[key],
             jump, dacc, vis_w, gh);
    for (int k = 0; k < 4; ++k) ga[k] += gh[k];
  }
}

// The raygen transpose of a sample whose first step's incoming cotangent
// is g: d = L + uH + vV - o consumes o with weight -1, so everything the
// origin feeds (camera origin, lens offset) sees d_o - d_d.
__device__ __forceinline__ void raygen_vjp(const float g[9], const RayGen& gr,
                                           double cam_acc[kCamSums]) {
  const float eo[3] = {g[0] - g[3], g[1] - g[4], g[2] - g[5]};
  for (int k = 0; k < 3; ++k) {
    cam_acc[k] += eo[k];
    cam_acc[3 + k] += g[3 + k];
    cam_acc[6 + k] += gr.u * g[3 + k];
    cam_acc[9 + k] += gr.v * g[3 + k];
    cam_acc[12 + k] += gr.ldx * eo[k];
    cam_acc[15 + k] += gr.ldy * eo[k];
  }
}

// One bounce step of K3 (golden.bounce_step's, with K3's closest hit): the
// winner from the tape while it holds the step (kTape), its t recomputed
// for that one sphere; else swept by the forward's closest_hit()
// (render_common.cuh): over the flat BVH closest_hit_staged() on the rows
// stage_flat() put in shared memory (K1c's sweep), over the walk
// closest_hit_walk() (K1d's), else closest_hit_brute(), K1a's brute sweep
// over the staged rows (kDense) or the pack (kBrute); then shade().
// kStore writes the step's Residual to *res.
template <bool kStore, int kHit, bool kTape>
__device__ __forceinline__ bool k3_step(const Params& p, const SceneView& s,
                                        Ray& r, uint32_t& sd, bool v1,
                                        float& cr, float& cg, float& cb,
                                        float& rr, float& rg, float& rb,
                                        Residual* res, TapeCursor& tc) {
  float tb;
  int win;
  Census cn{};  // unused: K3 does not count
  if (kTape && tc.k < tc.g_cap) {
    win = tc.get();
    if (win >= 0) {
      const float a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
      tb = sphere_root(s, r, a, 1.0f / a, p.t_min, win);
    } else {
      tb = kInf;
    }
  } else {
    win = closest_hit<kHit, false>(s, p.bvh, p.stage, p.walk, r, p.t_min, tb,
                                   cn);
  }
  if (kTape) ++tc.k;
  if (kStore) {
    *res = Residual{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, cr, cg, cb, win, sd};
  }
  return shade(s, win, tb, v1, sd, r, cr, cg, cb, rr, rg, rb);
}

// One sample of K3 for at most p.depth bounces through k3_step(), stopping
// at the first miss, absorption or the depth cap: returns the bounces
// taken (rows of res written when kStore); sd ends as the sample's final
// seed, (rr, rg, rb) as its radiance; tc advances one step a bounce.
template <bool kStore, int kHit, bool kTape>
__device__ __forceinline__ int k3_trace(const Params& p, const SceneView& s,
                                        Ray r, uint32_t& sd, bool v1,
                                        float& rr, float& rg, float& rb,
                                        Residual* res, TapeCursor& tc) {
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  rr = 0.0f;
  rg = 0.0f;
  rb = 0.0f;
  for (int d = 0; d < p.depth; ++d) {
    if (!k3_step<kStore, kHit, kTape>(p, s, r, sd, v1, cr, cg, cb, rr, rg,
                                      rb, kStore ? res + d : nullptr, tc))
      return d + 1;
  }
  return p.depth;  // depth cap: rr, rg, rb are still 0 (black)
}

// PASS 1 and the per-sample PASS 2 of the thread's pixel (a 2-D grid of
// 32 x 8 blocks over the slab); the raygen sums land in cam_acc.
template <int kHit, bool kTape>
__device__ __forceinline__ void per_sample_pass(const Params& p,
                                                double cam_acc[kCamSums]) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;  // row in the slab
  const int y = p.row0 + ly;                              // row in the frame
  // lanes outside the slab's buffers, or on a row past the frame, stay to
  // the end: every warp-level sum needs all 32 lanes; they trace nothing
  // and add nothing
  const bool valid = x < p.width && ly < p.rows;
  const bool live = valid && y < p.height;
  const int spp = live ? p.spp : 0;

  const CamPack cam = *p.cam;
  const SceneView s = scene_view(p.scene, p.n);
  const bool v1 = p.v1 != 0;
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  const uint32_t seed0 = base_hash(static_cast<uint32_t>(x),
                                   static_cast<uint32_t>(y));
  const size_t pix = valid ? (static_cast<size_t>(ly) * p.width + x) * 3 : 0;

  // -- PASS 1: the image (K1a's samples), or the given one
  float img[3] = {0.0f, 0.0f, 0.0f};
  if (p.img_in != nullptr) {
    if (live)
      for (int k = 0; k < 3; ++k) img[k] = p.img_in[pix + k];
  } else {
    uint32_t chain = seed0;
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
    for (int smp = 0; smp < spp; ++smp) {
      uint32_t sd = p.parallel ? fold_in(seed0, static_cast<uint32_t>(smp))
                               : chain;
      RayGen gr;
      Ray r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, gr);
      float rr, rg, rb;
      TapeCursor none{nullptr, 0, 0, 0, 0, 0};
      k3_trace<false, kHit, false>(p, s, r, sd, v1, rr, rg, rb, nullptr,
                                   none);
      acc_r = acc_r + rr;
      acc_g = acc_g + rg;
      acc_b = acc_b + rb;
      if (!p.parallel) chain = sd;
    }
    img[0] = to_gamma(acc_r * p.inv_spp, p.gamma);
    img[1] = to_gamma(acc_g * p.inv_spp, p.gamma);
    img[2] = to_gamma(acc_b * p.inv_spp, p.gamma);
  }
  float dacc[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    for (int k = 0; k < 3; ++k) p.img_out[pix + k] = img[k];  // 0 past the frame
    if (live) sum_cotangent(p, pix, img, dacc);
  }

  // -- PASS 2: per sample, re-forward with residuals, then reverse
  Residual res[kMaxDepth];
  uint32_t chain = seed0;
  // the pixel's tape: step k of its samples in order, as the forward wrote
  TapeCursor tc{const_cast<void*>(p.tape),
                static_cast<size_t>(p.width) * p.rows, pix / 3, p.g_cap,
                0, p.tape_wide};
  for (int smp = 0; smp < p.spp; ++smp) {  // warp-uniform trip count
    int len = 0;
    float v[3] = {0.0f, 0.0f, 0.0f};
    RayGen gr = {0.0f, 0.0f, 0.0f, 0.0f};
    if (smp < spp) {
      uint32_t sd = p.parallel ? fold_in(seed0, static_cast<uint32_t>(smp))
                               : chain;
      Ray r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, gr);
      len = k3_trace<true, kHit, kTape>(p, s, r, sd, v1, v[0], v[1], v[2],
                                        res, tc);
      if (!p.parallel) chain = sd;
    }
    float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int warp_len = __reduce_max_sync(kFull, len);
    for (int it = 0; it < warp_len; ++it) {
      const int d = len - 1 - it;
      const Residual& rd = res[d >= 0 ? d : 0];  // read only where d >= 0
      int key = -1;
      float ga[kLeaves] = {};
      if (d >= 0)
        step_vjp(s, rd, p.t_min, v1, p.vis_w, v, dacc, g, key, ga);
      add_by_key<kLeaves>(p.gsc, p.n, key, ga);
      if (p.vis_w > 0.0f)
        add_near_miss<kHit>(p, s, d >= 0 && rd.win < 0, rd, v, dacc);
    }
    raygen_vjp(g, gr, cam_acc);
  }
}

// ---- the windowed refill (parallel RNG, the image given) -----------------

// One pixel of a refill lane: its element in the slab's buffers (pixel
// index q, image and ct at 3q), its screen coordinates and RNG key.
struct LanePixel {
  size_t q;
  float fx, fy;
  uint32_t seed0;
};

__device__ __forceinline__ LanePixel pixel_of(const Params& p, size_t q) {
  const int ly = static_cast<int>(q / p.width);
  const int x = static_cast<int>(q % p.width);
  const int y = p.row0 + ly;
  return LanePixel{q, static_cast<float>(x), static_cast<float>(y),
                   base_hash(static_cast<uint32_t>(x),
                             static_cast<uint32_t>(y))};
}

// Lane `lane`'s pixel of hop m is lane + m * lanes.  Advances m to the
// lane's first hop from m on whose pixel lies in the frame and returns
// true, or false when the lane has none left; writes each passed pixel's
// output (the given image; 0 on a row past the frame, which adds nothing).
__device__ __forceinline__ bool take_pixel(const Params& p, size_t n_pix,
                                           size_t lane, int& m,
                                           LanePixel& px) {
  for (;; ++m) {
    const size_t q = lane + static_cast<size_t>(m) * p.lanes;
    if (q >= n_pix) return false;
    const bool live = p.row0 + static_cast<int>(q / p.width) < p.height;
    for (int k = 0; k < 3; ++k)
      p.img_out[3 * q + k] = live ? p.img_in[3 * q + k] : 0.0f;
    if (live) {
      px = pixel_of(p, q);
      return true;
    }
  }
}

// The residual rows of the refill: word w of step g of lane l at
// buf[(g * kRowWords + w) * lanes + l].  The lanes of a warp store and
// load the same step together, so they touch consecutive words.  A row:
// the incoming ray and throughput, the winner (-1 on a miss), the
// pre-bounce seed, and meta = flags | (m * spp + s) << 4, the hop and
// sample the step belongs to (the wrapper keeps hops * spp < 2^28).
constexpr int kRowWords = 12;
constexpr uint32_t kFScat = 1u, kFMiss = 2u, kFFresh = 4u, kFFin = 8u;

struct RowStore {
  uint32_t* buf;
  size_t lanes, lane;

  __device__ __forceinline__ uint32_t* at(int g, int w) const {
    return buf + (static_cast<size_t>(g) * kRowWords + w) * lanes + lane;
  }
  __device__ __forceinline__ void put(int g, const Residual& r,
                                      uint32_t meta) const {
    const float f[9] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.cr, r.cg, r.cb};
#pragma unroll
    for (int w = 0; w < 9; ++w) *at(g, w) = __float_as_uint(f[w]);
    *at(g, 9) = static_cast<uint32_t>(r.win);
    *at(g, 10) = r.seed;
    *at(g, 11) = meta;
  }
  __device__ __forceinline__ void load(int g, uint32_t w[kRowWords]) const {
#pragma unroll
    for (int i = 0; i < kRowWords; ++i) w[i] = *at(g, i);
  }
};

__device__ __forceinline__ Residual row_residual(const uint32_t w[kRowWords]) {
  return Residual{__uint_as_float(w[0]), __uint_as_float(w[1]),
                  __uint_as_float(w[2]), __uint_as_float(w[3]),
                  __uint_as_float(w[4]), __uint_as_float(w[5]),
                  __uint_as_float(w[6]), __uint_as_float(w[7]),
                  __uint_as_float(w[8]), static_cast<int>(w[9]), w[10]};
}

// PASS 2 on the windowed-refill schedule (raytpu's p2_refill branch,
// gradkernel.py:999-1518), one persistent lane a thread of a 1-D grid of
// p.lanes threads.  The lane takes its pixels in turn and each pixel's
// samples in order (sample s seeded fold_in(base_hash(x, y), s)).  A window
// re-runs the forward one bounce step a row for at most p.window steps:
// when a sample ends the lane spawns its pixel's next sample, or hops to
// its next pixel, at once, while a full-depth sample still fits the window
// (raytpu's can = g + 1 + depth <= g_cap); else it parks until the next
// window.  The reverse then walks the window's rows newest first: a FIN
// row's radiance is recomputed (a sample misses at most once, at its last
// step), a FRESH row folds the raygen transpose into cam_acc and cuts the
// carry.  The reverse's trip count is the warp's most rows, so every lane
// joins add_by_key's shuffles; a lane reads back only rows it wrote in
// this window.
template <int kHit, bool kTape>
__device__ __forceinline__ void refill_pass(const Params& p,
                                            double cam_acc[kCamSums]) {
  // the lane's raygen sums live in shared memory (one column a thread), not
  // in 36 registers, for the whole launch
  __shared__ double cam_sh[kCamSums][kRefillBlock];
#pragma unroll
  for (int i = 0; i < kCamSums; ++i) cam_sh[i][threadIdx.x] = 0.0;
  const size_t lane = static_cast<size_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const size_t n_pix = static_cast<size_t>(p.rows) * p.width;
  const CamPack cam = *p.cam;
  const SceneView s = scene_view(p.scene, p.n);
  const bool v1 = p.v1 != 0;
  const RowStore store{p.rows_buf, static_cast<size_t>(p.lanes), lane};

  // the sample in flight, or the next to spawn: sample smp of hop m
  int m = 0, smp = 0;
  LanePixel px{0, 0.0f, 0.0f, 0u};
  bool done = !take_pixel(p, n_pix, lane, m, px);
  // the pixel's tape: step k of its samples in order; k runs on across
  // windows and restarts at a hop
  TapeCursor tc{const_cast<void*>(p.tape), n_pix, px.q, p.g_cap, 0,
                p.tape_wide};
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t sd = 0u;
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  int d = 0;
  bool alive = false, fresh = false;
  auto spawn = [&]() {
    sd = fold_in(px.seed0, static_cast<uint32_t>(smp));
    RayGen gr;
    r = gen_ray(cam, px.fx, px.fy, p.inv_w, p.inv_h, sd, gr);
    cr = cg = cb = 1.0f;
    d = 0;
    alive = fresh = true;
  };

  while (!__all_sync(kFull, done)) {
    // -- the window's forward: one bounce step a row
    if (!done) spawn();
    int used = 0;
    for (int g = 0; g < p.window && __any_sync(kFull, alive); ++g) {
      if (!alive) continue;
      Residual res;
      float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // the reverse recomputes it
      const bool scat = k3_step<true, kHit, kTape>(p, s, r, sd, v1, cr, cg,
                                                   cb, rr, rg, rb, &res, tc);
      ++d;
      const bool fin = !scat || d >= p.depth;
      const uint32_t flags = (scat ? kFScat : 0u) |
                             (res.win < 0 ? kFMiss : 0u) |
                             (fresh ? kFFresh : 0u) | (fin ? kFFin : 0u);
      store.put(g, res,
                flags | (static_cast<uint32_t>(m * p.spp + smp) << 4));
      used = g + 1;
      fresh = false;
      if (fin) {
        alive = false;
        if (++smp == p.spp) {  // the pixel's samples are done: hop
          smp = 0;
          ++m;
          done = !take_pixel(p, n_pix, lane, m, px);
          tc.pix = px.q;
          tc.k = 0;
        }
        if (!done && g + 1 + p.depth <= p.window) spawn();
      }
    }

    // -- the window's reverse, newest row first, the next row's load in
    // flight while this one is transposed
    const int warp_used = __reduce_max_sync(kFull, used);
    float g9[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float v[3] = {0.0f, 0.0f, 0.0f}, dacc[3] = {0.0f, 0.0f, 0.0f};
    int dacc_m = -1;
    uint32_t next[kRowWords];
    if (used > 0 && used == warp_used) store.load(used - 1, next);
    for (int g = warp_used - 1; g >= 0; --g) {
      int key = -1;
      float ga[kLeaves] = {};
      uint32_t row[kRowWords];
#pragma unroll
      for (int i = 0; i < kRowWords; ++i) row[i] = next[i];
      if (g >= 1 && g - 1 < used) store.load(g - 1, next);
      const Residual res = row_residual(row);  // read only where g < used
      if (g < used) {
        const uint32_t meta = row[11];
        const uint32_t ord = meta >> 4;  // hop * spp + sample
        const int hm = static_cast<int>(ord / static_cast<uint32_t>(p.spp));
        const size_t q = lane + static_cast<size_t>(hm) * p.lanes;
        if (hm != dacc_m) {  // the row's pixel: its cotangent scale
          const float img[3] = {p.img_in[3 * q], p.img_in[3 * q + 1],
                                p.img_in[3 * q + 2]};
          sum_cotangent(p, 3 * q, img, dacc);
          dacc_m = hm;
        }
        if (meta & kFFin) {  // the sample's radiance, c * sky at its miss
          float kr, kg, kb;
          sky(res.dx, res.dy, res.dz, kr, kg, kb);
          const bool missed = (meta & kFMiss) != 0u;
          v[0] = missed ? res.cr * kr : 0.0f;
          v[1] = missed ? res.cg * kg : 0.0f;
          v[2] = missed ? res.cb * kb : 0.0f;
        }
        step_vjp(s, res, p.t_min, v1, p.vis_w, v, dacc, g9, key, ga);
        if (meta & kFFresh) {  // the sample's first step: raygen, cut
          const LanePixel hp = pixel_of(p, q);
          uint32_t sd0 = fold_in(hp.seed0, ord % static_cast<uint32_t>(p.spp));
          RayGen gr;
          gen_ray(cam, hp.fx, hp.fy, p.inv_w, p.inv_h, sd0, gr);
          double terms[kCamSums];
#pragma unroll
          for (int i = 0; i < kCamSums; ++i) terms[i] = 0.0;
          raygen_vjp(g9, gr, terms);
#pragma unroll
          for (int i = 0; i < kCamSums; ++i) cam_sh[i][threadIdx.x] += terms[i];
          for (int k = 0; k < 9; ++k) g9[k] = 0.0f;
        }
      }
      add_by_key<kLeaves>(p.gsc, p.n, key, ga);
      if (p.vis_w > 0.0f)
        add_near_miss<kHit>(p, s, g < used && res.win < 0, res, v, dacc);
    }
  }
#pragma unroll
  for (int i = 0; i < kCamSums; ++i) cam_acc[i] = cam_sh[i][threadIdx.x];
}

// The kernel body under either schedule: PASS 1 and PASS 2, then the
// warp's row of camera sums.
template <int kHit, bool kTape, bool kRefill>
__device__ __forceinline__ void render_vjp(const Params& p) {
  // over a flat BVH every sweep reads what stage_flat() stages, without
  // one up to kDenseMax spheres what stage_dense() stages; every thread of
  // the block reaches its barrier (none returns early).  Before stage_flat,
  // the row it leaves unused after each staged leaf is set to NaN, so the
  // near-miss sweep reads the staged leaves' rows as one run.
  if constexpr (kHit == kDense) stage_dense(p.scene, p.n);
  if constexpr (kHit == kFlat) {
    const int ls = p.bvh.leaf_size;
    const float nan = __int_as_float(0x7fc00000);
    for (int i = threadIdx.x + blockDim.x * threadIdx.y; i < p.stage.leaves;
         i += blockDim.x * blockDim.y)
      flat_rows[i * (ls + 1) + ls] = make_float4(nan, nan, nan, nan);
    stage_flat(p.scene, p.n, p.bvh, p.stage);
  }
  double cam_acc[kCamSums];
#pragma unroll
  for (int i = 0; i < kCamSums; ++i) cam_acc[i] = 0.0;
  if constexpr (kRefill)
    refill_pass<kHit, kTape>(p, cam_acc);
  else
    per_sample_pass<kHit, kTape>(p, cam_acc);

  // camera sums: one f64 butterfly per warp, lane 0 writes the warp's row
  const size_t warp =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
          (blockDim.x * blockDim.y / 32) +
      (threadIdx.y * blockDim.x + threadIdx.x) / 32;
#pragma unroll
  for (int i = 0; i < kCamSums; ++i) {
    double xs = cam_acc[i];
    for (int off = 16; off > 0; off >>= 1) xs += __shfl_xor_sync(kFull, xs, off);
    if ((threadIdx.x & 31) == 0) p.gcam[warp * kCamSums + i] = xs;
  }
}

// The per-sample grid: one thread a pixel, blocks streamed through the SMs.
template <int kHit, bool kTape>
__global__ void __launch_bounds__(256) render_vjp_kernel(Params p) {
  render_vjp<kHit, kTape, false>(p);
}

// The refill's persistent grid keeps its lanes resident for the whole
// launch, so it asks for two blocks an SM (128 registers, some spills).
template <int kHit, bool kTape>
__global__ void __launch_bounds__(kRefillBlock, 2)
render_vjp_refill_kernel(Params p) {
  render_vjp<kHit, kTape, true>(p);
}

// The refill's static shared memory a block (cam_sh).
constexpr size_t kCamShBytes = sizeof(double) * kCamSums * kRefillBlock;

// Lets `kernel` take `shmem` bytes of dynamic shared memory beside its
// `fixed` static bytes: past 48 KB a block only after it opts in.
template <class Kernel>
cudaError_t allow_shmem(Kernel kernel, size_t shmem, size_t fixed) {
  if (shmem + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shmem));
}

// Blocks of `threads` threads of `kernel` one SM keeps resident with
// `shmem` dynamic bytes beside `fixed` static ones; 0 on an error.
template <class Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t shmem, size_t fixed) {
  int nb = 0;
  if (allow_shmem(kernel, shmem, fixed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, threads,
                                                    shmem) != cudaSuccess)
    return 0;
  return nb;
}

template <int kHit, bool kTape, bool kRefill>
int launch(const Params& p, cudaStream_t stream) {
  // the staged rows: the brute sweep's (stage_dense) or the flat sweep's
  // (stage_flat)
  const size_t shmem =
      kHit == kDense  ? sizeof(float4) * p.n
      : kHit == kFlat ? sizeof(float4) * flat_stage_rows(p.stage,
                                                         p.bvh.leaf_size)
                      : 0;
  if constexpr (kRefill) {
    auto kernel = render_vjp_refill_kernel<kHit, kTape>;
    const cudaError_t e = allow_shmem(kernel, shmem, kCamShBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<p.lanes / kRefillBlock, kRefillBlock, shmem, stream>>>(p);
  } else {
    auto kernel = render_vjp_kernel<kHit, kTape>;
    const cudaError_t e = allow_shmem(kernel, shmem, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 block(32, 8);
    dim3 grid((p.width + block.x - 1) / block.x,
              (p.rows + block.y - 1) / block.y);
    kernel<<<grid, block, shmem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the closest-hit policy `hit` for one variant.
template <bool kTape, bool kRefill>
int launch_hit(int hit, const Params& p, cudaStream_t stream) {
  if (hit == kFlat) return launch<kFlat, kTape, kRefill>(p, stream);
  if (hit == kWalk) return launch<kWalk, kTape, kRefill>(p, stream);
  if (hit == kDense) return launch<kDense, kTape, kRefill>(p, stream);
  return launch<kBrute, kTape, kRefill>(p, stream);
}

// Blocks of the refill instantiation (kHit, kTape) one SM keeps resident,
// kFlat's and kDense's with `shmem` bytes staged.
template <int kHit, bool kTape>
int refill_blocks_per_sm(int shmem) {
  return blocks_per_sm(render_vjp_refill_kernel<kHit, kTape>, kRefillBlock,
                       kHit == kFlat || kHit == kDense ? shmem : 0,
                       kCamShBytes);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() so a refused launch is reported.
// It covers rows [row0, row0 + rows) of the width x height frame; ct,
// img_in, img_out and the tape hold those rows.  img_in may be null: PASS 1
// then renders the image.  gsc is a zeroed f64 (8, n) buffer; gcam an f64
// (n_warps, 18) buffer: the per-sample grid's raytpu_render_vjp_warps of
// width and rows, or lanes / 32 with the refill.  `flat` non-null: the flat
// BVH sweep over the scene in leaf order (n permuted rows); `nodes`
// non-null: the skip-pointer walk of its `copies` copies of n_trav nodes,
// likewise; both: refused; neither: the brute sweep, over the rows it
// stages in shared memory (16 n bytes) up to kDenseMax spheres (kDense),
// else over the scene pack (kBrute).  `tape_read`: the replay of a winner-index
// tape of g_cap steps a pixel (int32 when tape_wide; null only when g_cap is
// 0); it needs parallel RNG and img_in.  `refill`: PASS 2 on the windowed
// refill schedule, `lanes` threads (a multiple of 256) and a window of `window`
// >= depth steps, residual rows in `rows_buf` (window * 12 * lanes words); it
// needs parallel RNG and img_in, and hops * spp < 2^28, hops the pixels a lane
// takes.  The flat sweep stages stage_leaves leaves,
// stage_outliers outlier rows (0 or out_cnt) and stage_boxes box rows (0
// or 16 n_leaves) in shared memory (FlatStage: the wrapper plans it within
// raytpu_render_vjp_device's limits); the refill's lanes are
// raytpu_render_vjp_refill_lanes of the staged bytes.  The walk's `nodes`
// are in the 16-byte layout (WalkRow in render_common.cuh), over the
// permuted scene's rows (cx, cy, cz, rad * rad) in `spheres`.
extern "C" int raytpu_render_vjp(const void* cam, const void* scene, int n,
                                 const void* flat, int n_leaves,
                                 int leaf_size, const void* nodes,
                                 int n_trav, int copies, int out_base,
                                 int out_cnt, int stage_leaves,
                                 int stage_outliers, int stage_boxes,
                                 int tape_read,
                                 const void* tape, int g_cap,
                                 int tape_wide, const void* ct,
                                 const void* img_in, void* img_out,
                                 void* gsc, void* gcam, int width,
                                 int height, int row0, int rows, int spp,
                                 int depth, float t_min,
                                 float inv_w, float inv_h, float inv_spp,
                                 float gamma, float vis_w, int parallel,
                                 int v1, int refill, int lanes, int window,
                                 void* rows_buf, const void* spheres,
                                 void* stream) {
  if (depth > kMaxDepth || rows < 1 || row0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((tape_read || refill) && (!parallel || img_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((flat != nullptr && nodes != nullptr) ||
      (nodes != nullptr &&
       (n_trav < 1 || (copies != 1 && copies != 8) ||
        spheres == nullptr)) ||
      (flat != nullptr &&
       (stage_leaves < 0 || stage_leaves > n_leaves ||
        (stage_outliers != 0 && stage_outliers != out_cnt) ||
        (stage_boxes != 0 && stage_boxes != 16 * n_leaves))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (refill) {
    if (lanes < kRefillBlock || lanes % kRefillBlock != 0 ||
        window < depth || rows_buf == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long hops =
        (static_cast<long long>(rows) * width + lanes - 1) / lanes;
    if (hops * spp >= (1LL << 28))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.cam = static_cast<const CamPack*>(cam);
  p.scene = static_cast<const float*>(scene);
  p.bvh = FlatBvh{static_cast<const float*>(flat), n_leaves, leaf_size,
                  out_base, out_cnt};
  p.stage = FlatStage{stage_leaves, stage_outliers, stage_boxes};
  p.walk = NodeBvh{n_trav, copies, out_base, out_cnt,
                   static_cast<const float4*>(nodes),
                   static_cast<const float4*>(spheres)};
  p.tape = tape;
  p.ct = static_cast<const float*>(ct);
  p.img_in = static_cast<const float*>(img_in);
  p.rows_buf = static_cast<uint32_t*>(rows_buf);
  p.img_out = static_cast<float*>(img_out);
  p.gsc = static_cast<double*>(gsc);
  p.gcam = static_cast<double*>(gcam);
  p.n = n;
  p.width = width;
  p.height = height;
  p.row0 = row0;
  p.rows = rows;
  p.spp = spp;
  p.depth = depth;
  p.g_cap = g_cap;
  p.tape_wide = tape_wide;
  p.lanes = lanes;
  p.window = window;
  p.t_min = t_min;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  p.inv_spp = inv_spp;
  p.gamma = gamma;
  p.vis_w = vis_w;
  p.parallel = parallel;
  p.v1 = v1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hit = flat != nullptr    ? kFlat
                  : nodes != nullptr ? kWalk
                  : n <= kDenseMax   ? kDense
                                     : kBrute;
  if (refill)
    return tape_read ? launch_hit<true, true>(hit, p, st)
                     : launch_hit<false, true>(hit, p, st);
  return tape_read ? launch_hit<true, false>(hit, p, st)
                   : launch_hit<false, false>(hit, p, st);
}

// Rows of the camera-sum buffer raytpu_render_vjp needs for a per-sample
// launch of `rows` rows of this width.
extern "C" int raytpu_render_vjp_warps(int width, int rows) {
  return ((width + 31) / 32) * ((rows + 7) / 8) * 8;
}

// The refill's lane cap on the current device: its SMs times the blocks of
// 256 threads one SM keeps resident of the refill instantiation that keeps
// the fewest, the flat sweep's and the staged brute sweep's with `shmem`
// bytes staged (a taped and an untaped launch of one scene get the same
// lanes, so the taped one sums the camera terms in the untaped one's
// order); 0 on an error.
extern "C" int raytpu_render_vjp_refill_lanes(int shmem) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int per_sm[8] = {refill_blocks_per_sm<kBrute, false>(shmem),
                         refill_blocks_per_sm<kFlat, false>(shmem),
                         refill_blocks_per_sm<kWalk, false>(shmem),
                         refill_blocks_per_sm<kDense, false>(shmem),
                         refill_blocks_per_sm<kBrute, true>(shmem),
                         refill_blocks_per_sm<kFlat, true>(shmem),
                         refill_blocks_per_sm<kWalk, true>(shmem),
                         refill_blocks_per_sm<kDense, true>(shmem)};
  int least = per_sm[0];
  for (int i = 1; i < 8; ++i) least = per_sm[i] < least ? per_sm[i] : least;
  return sms * least * kRefillBlock;
}

// What bounds the stage of a K3 launch over a flat BVH on the current
// device: the opt-in shared memory a block (*optin), an SM's shared memory
// (*per_sm), what the runtime reserves of it a block (*reserved), the
// blocks of K3's flat instantiations an SM keeps resident with nothing
// staged (*blocks: the fewest of the four; registers bound them) and the
// refill's static shared memory a block (*fixed, cam_sh).  Returns a CUDA
// error code.
extern "C" int raytpu_render_vjp_device(int* optin, int* per_sm,
                                        int* reserved, int* blocks,
                                        int* fixed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm_blocks[4] = {
      blocks_per_sm(render_vjp_kernel<kFlat, false>, 256, 0, 0),
      blocks_per_sm(render_vjp_kernel<kFlat, true>, 256, 0, 0),
      refill_blocks_per_sm<kFlat, false>(0),
      refill_blocks_per_sm<kFlat, true>(0)};
  *blocks = per_sm_blocks[0];
  for (int i = 1; i < 4; ++i)
    *blocks = per_sm_blocks[i] < *blocks ? per_sm_blocks[i] : *blocks;
  *fixed = static_cast<int>(kCamShBytes);
  return *blocks > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
