// Winner recompute from merged-table rows, and its vector-Jacobian product,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package recomputes each ray's hit record
// from its winner's merged-table row in elementwise code
// (ray_tracer_tpu/ops/intersect.py: hit_attributes_from_rows), which XLA
// fuses into the program around it. The port's plain version
// (ray_tracer_tpu_torch/ops/intersect.py: hit_attributes_from_rows) runs it
// as ~155 elementwise launches a call, and autograd's backward of it as ~440
// more, with a zero-filled (26, R) tensor for every row column it selects
// and one add of each into the rows' gradient. These two kernels do each in
// one launch, on untextured rows (26 columns).
//
// What each computes, per lane r (one thread each):
//   * hit_record_kernel: t, point, normal, albedo, emission, emission
//     strength, smoothness and the hit flag of the lane's winner. Its row
//     (column c at rows[c * R + r]) is a sphere's when prim_id < the padded
//     sphere count, else a triangle's; only that branch is computed, with
//     the plain version's operations in its order and with its guards: the
//     sums (x*x + y*y) + z*z, a sphere root only where disc > 0, the
//     triangle's 1 / det with |det| < 1e-20 replaced by 1e-20, the
//     normalisation that leaves a vector of squared norm <= 1e-24 as it is,
//     and t = 0 on miss lanes (whose normal comes from their zero row). With
//     -fmad=false and IEEE division and square root (utils/build.py), and
//     rsqrtf as torch.rsqrt calls it, the outputs are bit-equal to the plain
//     version's on the card.
//   * hit_record_vjp_kernel: the cotangents of the rows (26, R), of o and of
//     d (R, 3) from those of the seven float outputs, any of which may be
//     absent (a null pointer reads as zero), as autograd computes them
//     through the plain version: a where's unselected branch gets zero, so
//     the columns the lane's branch does not read get zero, and t's
//     cotangent stops at a miss lane. It recomputes the branch's forward
//     values and writes each wanted output once (null: not wanted).
//
// What bounds them on this card: bytes, once they are one launch each. At
// 1080p (2,073,600 lanes) the forward reads 26 row columns, o, d, the id
// and the miss flag (133 B a lane) and writes 15 floats and the hit flag
// (61 B): 402 MB, 0.12 ms at 3.35 TB/s. The VJP reads the same inputs and
// up to 15 cotangent floats and writes 32 floats (321 B): 0.20 ms. What
// the design does about it:
//   * one thread per lane, so a warp reads each row column as 32
//     consecutive floats; a lane reads only its branch's columns (12 of a
//     sphere's, 26 of a triangle's);
//   * o, d and the (R, 3) outputs keep the layouts the renderer holds, so
//     nothing is transposed and the elementwise ops downstream keep their
//     vectorised kernels;
//   * the VJP writes the whole (26, R) cotangent once, zeros included,
//     where autograd's backward wrote a zero-filled (26, R) tensor per
//     selected column and summed them;
//   * the VJP's arithmetic runs in double on the forward's float values,
//     which costs a kernel bound by bytes nothing: autograd's float32
//     chain through 1/det^2 cancels on grazing triangle hits, and the
//     double one keeps the kernel's own rounding out of that gap.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // lanes per thread block, one a thread
constexpr int kCols = 26;          // untextured merged-table row
constexpr float kDetEps = 1e-20f;  // the triangle's |det| guard
constexpr float kNormEps = 1e-24f; // the normalisation's squared-norm guard

template <typename T>
struct Vec {
  T x, y, z;
};
using V3 = Vec<float>;   // the forward's values
using D3 = Vec<double>;  // the VJP's

template <typename T>
__device__ __forceinline__ Vec<T> add(Vec<T> a, Vec<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ Vec<T> sub(Vec<T> a, Vec<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ Vec<T> scale(Vec<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}
// (a.x*b.x + a.y*b.y) + a.z*b.z: the plain version's association
template <typename T>
__device__ __forceinline__ T dot(Vec<T> a, Vec<T> b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ Vec<T> cross(Vec<T> a, Vec<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ D3 wide(V3 v) { return {v.x, v.y, v.z}; }

__device__ __forceinline__ V3 load3(const float* p, long long r) {
  return {p[3 * r], p[3 * r + 1], p[3 * r + 2]};
}
__device__ __forceinline__ void store3(float* p, long long r, V3 v) {
  p[3 * r] = v.x;
  p[3 * r + 1] = v.y;
  p[3 * r + 2] = v.z;
}
__device__ __forceinline__ void store3(float* p, long long r, D3 v) {
  store3(p, r, V3{static_cast<float>(v.x), static_cast<float>(v.y),
                  static_cast<float>(v.z)});
}
// an optional cotangent: zero where absent
__device__ __forceinline__ D3 cot3(const float* p, long long r) {
  return p ? wide(load3(p, r)) : D3{0.0, 0.0, 0.0};
}
__device__ __forceinline__ double cot1(const float* p, long long r) {
  return p ? p[r] : 0.0;
}

// Row column c of lane r, and three consecutive ones as a vector.
struct Row {
  const float* rows;
  long long R, r;
  __device__ __forceinline__ float operator[](int c) const {
    return rows[c * R + r];
  }
  __device__ __forceinline__ V3 v3(int c) const {
    return {(*this)[c], (*this)[c + 1], (*this)[c + 2]};
  }
};

// The plain version's _norm3: v * rsqrt(|v|^2) where |v|^2 > 1e-24, else v.
__device__ __forceinline__ V3 norm3(V3 v) {
  const float sq = dot(v, v);
  if (!(sq > kNormEps)) return v;
  return scale(v, rsqrtf(sq));
}

// The cotangent of norm3's input from its output's g: rsqrt's derivative
// at the forward's own rsqrtf, as autograd takes it.
__device__ __forceinline__ D3 norm3_vjp(V3 v, D3 g) {
  const float sq = dot(v, v);
  if (!(sq > kNormEps)) return g;
  const double inv = rsqrtf(sq);
  const D3 vw = wide(v);
  return sub(scale(g, inv), scale(vw, dot(g, vw) * (inv * inv * inv)));
}

// The sphere recompute (columns 0:3 centre, 3 radius squared): the near
// root of |o + t d - c|^2 = r2, and the vector q from the centre to the
// point at that t, which the normal normalises.
struct Sphere {
  V3 oc, q;
  float a, b, cc, disc, root, t;
};

__device__ __forceinline__ Sphere sphere_fwd(V3 o, V3 d, V3 c, float r2) {
  Sphere s;
  s.oc = sub(o, c);
  s.a = dot(d, d);
  s.b = 2.0f * dot(s.oc, d);
  s.cc = dot(s.oc, s.oc) - r2;
  s.disc = s.b * s.b - 4.0f * s.a * s.cc;
  s.root = s.disc > 0.0f ? sqrtf(s.disc) : 0.0f;
  s.t = (-s.b - s.root) / (2.0f * s.a);
  s.q = sub(add(o, scale(d, s.t)), c);
  return s;
}

// The triangle recompute (columns 0:3 v0, 3:6 e1, 6:9 e2, 9:18 the vertex
// normals n0 n1 n2): Moller-Trumbore's t, u, v without its tests, and the
// barycentric blend of the vertex normals.
struct Tri {
  V3 e1, e2, ng, ao, da, nb;
  float inv, dist, uq, vp, t, u, v, w;  // dist = ao.ng, uq = e2.da, vp = e1.da
  bool small;                           // |det| < 1e-20
};

__device__ __forceinline__ Tri tri_fwd(V3 o, V3 d, const Row& row) {
  Tri g;
  g.e1 = row.v3(3);
  g.e2 = row.v3(6);
  g.ng = cross(g.e1, g.e2);
  g.ao = sub(o, row.v3(0));
  g.da = cross(g.ao, d);
  const float det = -dot(d, g.ng);
  g.small = fabsf(det) < kDetEps;
  g.inv = 1.0f / (g.small ? kDetEps : det);
  g.dist = dot(g.ao, g.ng);
  g.t = g.dist * g.inv;
  g.uq = dot(g.e2, g.da);
  g.u = g.uq * g.inv;
  g.vp = dot(g.e1, g.da);
  g.v = -g.vp * g.inv;
  g.w = 1.0f - g.u - g.v;
  const V3 n0 = row.v3(9), n1 = row.v3(12), n2 = row.v3(15);
  g.nb = {n0.x * g.w + n1.x * g.u + n2.x * g.v,
          n0.y * g.w + n1.y * g.u + n2.y * g.v,
          n0.z * g.w + n1.z * g.u + n2.z * g.v};
  return g;
}

__global__ void __launch_bounds__(kThreads)
hit_record_kernel(const float* __restrict__ rows, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const int* __restrict__ prim_id,
                  const bool* __restrict__ miss, int R, int padded_spheres,
                  float* __restrict__ t_out, float* __restrict__ point,
                  float* __restrict__ normal, float* __restrict__ albedo,
                  float* __restrict__ emission,
                  float* __restrict__ strength,
                  float* __restrict__ smoothness, bool* __restrict__ hit) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (r >= R) return;
  const Row row{rows, R, r};
  const V3 ov = load3(o, r), dv = load3(d, r);
  const bool is_miss = miss[r];
  float t;
  V3 n;
  int c_alb;  // the branch's albedo column; emission, strength and
              // smoothness follow it
  if (prim_id[r] >= padded_spheres) {
    const Tri g = tri_fwd(ov, dv, row);
    t = g.t;
    n = norm3(g.nb);
    c_alb = 18;
  } else {
    const Sphere s = sphere_fwd(ov, dv, row.v3(0), row[3]);
    t = s.t;
    n = norm3(s.q);
    c_alb = 4;
  }
  if (is_miss) t = 0.0f;
  t_out[r] = t;
  store3(point, r, add(ov, scale(dv, t)));
  store3(normal, r, n);
  store3(albedo, r, row.v3(c_alb));
  store3(emission, r, row.v3(c_alb + 3));
  strength[r] = row[c_alb + 6];
  smoothness[r] = row[c_alb + 7];
  hit[r] = !is_miss;
}

__global__ void __launch_bounds__(kThreads)
hit_record_vjp_kernel(
    const float* __restrict__ rows, const float* __restrict__ o,
    const float* __restrict__ d, const int* __restrict__ prim_id,
    const bool* __restrict__ miss, int R, int padded_spheres,
    const float* __restrict__ g_t, const float* __restrict__ g_point,
    const float* __restrict__ g_normal, const float* __restrict__ g_albedo,
    const float* __restrict__ g_emission,
    const float* __restrict__ g_strength,
    const float* __restrict__ g_smoothness, float* __restrict__ g_rows,
    float* __restrict__ g_o, float* __restrict__ g_d) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (r >= R) return;
  const Row row{rows, R, r};
  const V3 ov = load3(o, r), dv = load3(d, r);
  const D3 dw = wide(dv);
  const bool is_miss = miss[r];
  const D3 gp = cot3(g_point, r), gn = cot3(g_normal, r);
  // t's cotangent, its own and the point's (point = o + d t), stops at a
  // miss lane's where
  const double gt_sel = is_miss ? 0.0 : cot1(g_t, r) + dot(gp, dw);
  D3 go = gp, gd;
  float gc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) gc[c] = 0.0f;
  int c_alb;
  if (prim_id[r] >= padded_spheres) {
    const Tri g = tri_fwd(ov, dv, row);
    const D3 e1 = wide(g.e1), e2 = wide(g.e2), ng = wide(g.ng),
             ao = wide(g.ao), da = wide(g.da);
    const double inv = g.inv;
    gd = scale(gp, is_miss ? 0.0 : double(g.t));
    // normal = norm3(nb), nb = n0 w + n1 u + n2 v
    const D3 gnb = norm3_vjp(g.nb, gn);
    const D3 n0 = wide(row.v3(9)), n1 = wide(row.v3(12)),
             n2 = wide(row.v3(15));
    const double gw = dot(gnb, n0);
    const double gu = dot(gnb, n1) - gw;  // w = 1 - u - v
    const double gv = dot(gnb, n2) - gw;
    // t = dist inv, u = uq inv, v = -vp inv, inv = 1 / det (guarded)
    const double ginv = gt_sel * g.dist + gu * g.uq - gv * g.vp;
    const double gdist = gt_sel * inv, guq = gu * inv, gvp = -(gv * inv);
    const double gdet = g.small ? 0.0 : -(ginv * (inv * inv));
    // det = -d.ng, dist = ao.ng, uq = e2.da, vp = e1.da
    const D3 gng = add(scale(dw, -gdet), scale(ao, gdist));
    gd = add(gd, scale(ng, -gdet));
    D3 gao = scale(ng, gdist);
    const D3 gda = add(scale(e2, guq), scale(e1, gvp));
    D3 ge1 = scale(da, gvp), ge2 = scale(da, guq);
    // da = ao x d, ng = e1 x e2, ao = o - v0
    gao = add(gao, cross(dw, gda));
    gd = add(gd, cross(gda, ao));
    ge1 = add(ge1, cross(e2, gng));
    ge2 = add(ge2, cross(gng, e1));
    go = add(go, gao);
    const D3 cols[6] = {scale(gao, -1.0), ge1, ge2, scale(gnb, double(g.w)),
                        scale(gnb, double(g.u)), scale(gnb, double(g.v))};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      gc[3 * k] = static_cast<float>(cols[k].x);
      gc[3 * k + 1] = static_cast<float>(cols[k].y);
      gc[3 * k + 2] = static_cast<float>(cols[k].z);
    }
    c_alb = 18;
  } else {
    const Sphere s = sphere_fwd(ov, dv, row.v3(0), row[3]);
    const D3 oc = wide(s.oc);
    const double t = s.t, a = s.a, b = s.b, cc = s.cc;
    gd = scale(gp, is_miss ? 0.0 : t);
    // normal = norm3(q), q = o + d t - c
    const D3 gq = norm3_vjp(s.q, gn);
    go = add(go, gq);
    gd = add(gd, scale(gq, t));
    const double gts = gt_sel + dot(gq, dw);
    // t = (-b - root) / (2 a), root = sqrt(disc) where disc > 0
    const double den = 2.0 * a;
    const double gnum = gts / den;
    double ga = 2.0 * (-(gts * t) / den);
    double gb = -gnum;
    const double gdisc = s.disc > 0.0f ? -gnum / (2.0 * s.root) : 0.0;
    // disc = b b - 4 a cc, cc = oc.oc - r2, b = 2 oc.d, a = d.d
    gb += 2.0 * b * gdisc;
    ga += -4.0 * cc * gdisc;
    const double gcc = -4.0 * a * gdisc;
    const D3 goc = add(scale(oc, 2.0 * gcc), scale(dw, 2.0 * gb));
    gd = add(gd, add(scale(oc, 2.0 * gb), scale(dw, 2.0 * ga)));
    go = add(go, goc);
    const D3 gcen = sub(scale(gq, -1.0), goc);
    gc[0] = static_cast<float>(gcen.x);
    gc[1] = static_cast<float>(gcen.y);
    gc[2] = static_cast<float>(gcen.z);
    gc[3] = static_cast<float>(-gcc);
    c_alb = 4;
  }
  if (g_rows) {
    // albedo, emission, strength and smoothness are the branch's columns
    // as they are
    const V3 ga = g_albedo ? load3(g_albedo, r) : V3{0.0f, 0.0f, 0.0f};
    const V3 ge = g_emission ? load3(g_emission, r) : V3{0.0f, 0.0f, 0.0f};
    const float tail[8] = {ga.x, ga.y, ga.z, ge.x, ge.y, ge.z,
                           g_strength ? g_strength[r] : 0.0f,
                           g_smoothness ? g_smoothness[r] : 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c_alb == 18) gc[18 + k] = tail[k];
      else gc[4 + k] = tail[k];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      g_rows[c * static_cast<long long>(R) + r] = gc[c];
  }
  if (g_o) store3(g_o, r, go);
  if (g_d) store3(g_d, r, gd);
}

inline unsigned blocks(int R) {
  return static_cast<unsigned>((R + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The hit record of R lanes on `stream`. Device pointers: rows (26, R),
// o and d (R, 3) f32, prim_id (R,) i32, miss (R,) bool; outputs t,
// strength and smoothness (R,) f32, point, normal, albedo and emission
// (R, 3) f32, hit (R,) bool. All contiguous. Returns cudaGetLastError()
// (0 = ok).
int rtt_hit_record(const float* rows, const float* o, const float* d,
                   const int* prim_id, const bool* miss, int R,
                   int padded_spheres, float* t, float* point, float* normal,
                   float* albedo, float* emission, float* strength,
                   float* smoothness, bool* hit, void* stream) {
  if (R > 0)
    hit_record_kernel<<<blocks(R), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rows, o, d, prim_id, miss, R, padded_spheres, t, point, normal,
        albedo, emission, strength, smoothness, hit);
  return static_cast<int>(cudaGetLastError());
}

// Its vector-Jacobian product on `stream`: the inputs as above; the seven
// cotangents in the outputs' shapes, each null where absent (zero); g_rows
// (26, R), g_o and g_d (R, 3) f32, each null where not wanted. Returns
// cudaGetLastError() (0 = ok).
int rtt_hit_record_vjp(const float* rows, const float* o, const float* d,
                       const int* prim_id, const bool* miss, int R,
                       int padded_spheres, const float* g_t,
                       const float* g_point, const float* g_normal,
                       const float* g_albedo, const float* g_emission,
                       const float* g_strength, const float* g_smoothness,
                       float* g_rows, float* g_o, float* g_d, void* stream) {
  if (R > 0)
    hit_record_vjp_kernel<<<blocks(R), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, o, d, prim_id, miss, R, padded_spheres, g_t, g_point,
        g_normal, g_albedo, g_emission, g_strength, g_smoothness, g_rows,
        g_o, g_d);
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
