// The refined solve's float64 KKT step (phase `solver.kkt64`) for NVIDIA
// Hopper (sm_90a): from the float32 stage-1 state, the dual-side KKT
// residual at the stage-1 point, the delta problem, the original problem's
// tolerance scales and the delta state of every problem in one launch,
// written as float32 in the trailing-batch layout the fused ADMM kernel and
// the eager loop read.
//
// Replaces no TPU kernel.  loik_tpu's step is plain jnp inside
// `_delta_duals_jit` (loik_tpu/solver/refine.py), which XLA compiles into a
// few fused loops.  The port's plain version
// (loik_tpu_torch/solver/refine.py::_kkt64_plain) casts the state to
// float64, prepares the float64 problem, runs `solve.kkt_residual`, a
// Python loop over the joints, and casts the delta problem back: inside a
// captured graph 470 to 1700 elementwise nodes of about 2 us each for a few
// tens of MB of work.  This kernel is added for that.
//
// What bounds it on this card: bytes.  A launch reads the stage-1 state and
// liMi (float32) and writes the delta problem and the delta state (float32,
// its zeroed leaves included); the problem's leaves, shared by all problems
// in the planners' use, are a few hundred words.  At panda_arm's B 16384
// that is 32 MB, at talos' B 4096 63 MB and at solo12's B 10240 67 MB:
// 9.4, 18.7 and 20.0 us at 3.35 TB/s (without the zeroed leaves, a third
// of the bytes: 21, 43 and 45 MB, 6.3, 12.8 and 13.5 us).  The arithmetic,
// a few hundred float64 products a joint, is far below the roof.  So the design is one
// thread per (problem, joint) with b the fastest index: a warp reads and
// writes one word of one joint for 32 neighbouring problems, 128
// contiguous bytes, and reads the joint's shared problem leaves at one
// address.  A block holds KKT_PROBLEMS problems and as many rows of threads
// as the tree has joints (at most KKT_THREADS / KKT_PROBLEMS; a row then
// takes every rows-th joint); constraint k is taken by row k mod rows.
// Two steps, one barrier: each thread computes act_force(liMi_c, f_c) of
// each child c of its joints and sums them in order (a child has one
// parent, so each is computed once), issuing the loads of its nu block
// first so that their round trips overlap the rest; then the four
// per-problem maxima (the scales and the two new norms) are reduced over
// the rows in shared memory.  Measured on the H100 (700 W,
// tools/kkt64_check.py): 18.1, 34.7 and 45.9 us a launch at those shapes,
// 52, 54 and 44% of the byte bound (35, 37 and 30% of the bound without the
// zeroed leaves); the plain step as a graph 1.20, 3.84 and 2.03 ms.
//
// Same numbers as the plain step, bit for bit.  Every sum is taken term by
// term in the index order of `batched_spatial.mv` / `mtv` / `act_force` and
// of `kkt_residual`, each product and sum rounded on its own (the library is
// built with -fmad=false, so no multiply and add are contracted into one):
// - fdpa of joint i starts as A'y of the LAST constraint on its link (the
//   list assignment of `kkt_residual`, where a later constraint overwrites),
//   else 0; then adds act_force(liMi_c, f_c) of each child c in DESCENDING
//   index order (the order the reversed joint loop reaches them), then
//   subtracts f_i.
// - The motion subspaces are computed here from the joint type, the axis
//   and the pitch as `KinematicTree.joint_S` computes them on the float64
//   tree (the pitch times the widened axis in float64), zeros included, so
//   S'f sums all six terms as `mtv` does.
// - z - nu of the delta state is taken in float32, as the plain step takes
//   it on the float32 state; every other output is rounded once from
//   float64.  Maxima of absolute values are exact in any order; a NaN
//   propagates, as `amax` and `maximum` propagate it.
//
// Inputs, each through a pointer and four strides (index, row, column,
// problem; a problem stride of 0 for a leaf shared by all problems), so a
// graph replayed on another tree or problem of its key reads that one's
// tensors: the float32 stage-1 state (liMi, vis, fis, nu, z, w, A'y), the
// problem's leaves as the caller gave them (float32 or float64, shared or
// one per problem) and the tree's axes.  The loads are typed: one
// instantiation per dtype of the problem and of the axes, so no load waits
// on a branch.  The topology table (`kernels/kkt64.py::_topology`) holds
// per joint its type, dofs, first dof, children and last constraint, the
// children in descending order, and the constraints' links.
//
// Rehearsal without a card: with LOIK_REHEARSAL defined (the stub
// cuda_runtime.h of tools/rehearse/) the same source compiles with g++ and
// a launch becomes a loop over the blocks, each a loop over its threads for
// the step before the barrier and for the one after it
// (tests/test_torch_kkt64_kernel.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// joint type codes of model/tree.py (the constant-subspace ones)
enum {
  REVOLUTE = 0, PRISMATIC = 1, FREE_FLYER = 2, SPHERICAL = 3,
  REVOLUTE_UNBOUNDED = 4, TRANSLATION = 5, PLANAR = 6, HELICAL = 8
};

// the words of one joint in the topology table (kernels/kkt64.py::_topology)
enum { W_TYPE, W_NV, W_IDX_V, W_CHILD0, W_NCHILD, W_CON, W_PITCH, KKT_WORDS };

// the per-problem maxima a thread keeps, in the order of their outputs
enum { M_PRIMAL, M_DUAL, M_HV, M_B, KKT_MAXIMA };

// the outputs, float32, contiguous, problem last (kernels/kkt64.py::_OUTPUTS)
enum {
  O_HV, O_FDPA_HAT, O_VIS0, O_FIS0, O_FDPA0,          // (N, 6, B)
  O_LB, O_UB, O_R_OFFSET, O_Z, O_NU0, O_W0, O_STFW0,  // (N, K, B)
  O_B, O_ATB, O_YIS0, O_ATY0,                         // (NC, 6, B)
  O_SCALE_P, O_SCALE_D, O_HV_INF, O_B_INF,            // (B,), as M_*
  KKT_OUTS
};

constexpr int KKT_PROBLEMS = 32;  // problems a block: one warp a row of threads
constexpr int KKT_THREADS = 512;  // the most threads a block (128 registers a thread)

}  // namespace

// One input: element (index i, row r, column c, problem b) at
// ptr[i * s0 + r * s1 + c * s2 + b * sb]; f64: float64, else float32.
struct KktLeaf {
  const void* ptr;
  long long s0, s1, s2, sb, f64;
};

// One launch (kernels/kkt64.py::_KktArgs mirrors it field for field).  The
// problem's leaves share one dtype (the wrapper widens a mixed set to
// float64, exactly); the axes have the tree's.
struct KktArgs {
  long long B, N, K, NC;
  const long long* topo;
  KktLeaf liMi_R, liMi_p, vis, fis, nu, z, w, Aty;  // stage-1 state, float32
  KktLeaf H_ref, v_ref, A, b, lb, ub, axis;         // problem and geometry
  float* out[KKT_OUTS];
};

namespace {

__device__ __forceinline__ double word_double(long long w) {
#ifdef LOIK_REHEARSAL
  double d;
  memcpy(&d, &w, sizeof d);
  return d;
#else
  return __longlong_as_double(w);
#endif
}

// A read through the read-only path: nothing the launch writes is read, so
// the loads may run ahead of the stores.
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
#ifdef LOIK_REHEARSAL
  return *p;
#else
  return __ldg(p);
#endif
}

// The elements (r, c) of one index i and problem b of a leaf of scalar type
// T: the 64-bit offset taken once, the small ones in 32 bits (the wrapper
// keeps them below 2^31).
template <typename T>
struct View {
  const T* p;
  int s1, s2;
  __device__ __forceinline__ T raw(int r, int c = 0) const { return ldg(p + (r * s1 + c * s2)); }
  __device__ __forceinline__ double operator()(int r, int c = 0) const { return (double)raw(r, c); }
};

template <typename T>
__device__ __forceinline__ View<T> view(const KktLeaf& L, long long i, long long b) {
  return View<T>{static_cast<const T*>(L.ptr) + (i * L.s0 + b * L.sb), (int)L.s1, (int)L.s2};
}

// a leaf of one index per row (lb, ub: index iv + r)
template <typename T>
__device__ __forceinline__ View<T> run(const KktLeaf& L, long long iv, long long b) {
  return View<T>{static_cast<const T*>(L.ptr) + (iv * L.s0 + b * L.sb), (int)L.s0, 0};
}

// the larger, a NaN on either side kept
__device__ __forceinline__ double mx(double m, double x) { return (x > m || x != x) ? x : m; }

// Output o from element e0 (its index before the problem axis) of problem
// b on: element e0 + r at [r * B].
struct Out {
  float* p;
  int B;
  __device__ __forceinline__ void operator()(int r, float x) const { p[r * B] = x; }
};

__device__ __forceinline__ Out out(const KktArgs& A, int o, long long e0, long long b) {
  return Out{A.out[o] + (e0 * A.B + b), (int)A.B};
}

// Column c of the motion subspace of a constant-subspace joint, as
// KinematicTree.joint_S makes it on the float64 tree (a: the axis widened,
// h: the pitch), zeros where it has them.
__device__ __forceinline__ void s_column(int type, int c, const double* a, double h,
                                         double* col) {
#pragma unroll
  for (int r = 0; r < 6; ++r) col[r] = 0.0;
  switch (type) {
    case REVOLUTE:
    case REVOLUTE_UNBOUNDED:
#pragma unroll
      for (int r = 0; r < 3; ++r) col[3 + r] = a[r];
      break;
    case PRISMATIC:
#pragma unroll
      for (int r = 0; r < 3; ++r) col[r] = a[r];
      break;
    case HELICAL:
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        col[r] = h * a[r];
        col[3 + r] = a[r];
      }
      break;
    case SPHERICAL:
      col[3 + c] = 1.0;
      break;
    case PLANAR:  // columns e0, e1, e5 of the identity
      col[c == 2 ? 5 : c] = 1.0;
      break;
    default:  // FREE_FLYER, TRANSLATION: columns of the identity
      col[c] = 1.0;
      break;
  }
}

// act_force(liMi_i, f_i) of joint i of problem b (batched_spatial.act_force:
// lin = R f_lin, ang = R f_ang + p x lin), into af
__device__ __forceinline__ void act_force(const KktArgs& A, long long i, long long b, double* af) {
  const View<float> Rv = view<float>(A.liMi_R, i, b), pv = view<float>(A.liMi_p, i, b),
                    fv = view<float>(A.fis, i, b);
  double R[9], p[3], f[6], lin[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = Rv(e / 3, e % 3);
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = pv(r);
#pragma unroll
  for (int r = 0; r < 6; ++r) f[r] = fv(r);
#pragma unroll
  for (int r = 0; r < 3; ++r) lin[r] = (R[3 * r] * f[0] + R[3 * r + 1] * f[1]) + R[3 * r + 2] * f[2];
  const double cr[3] = {p[1] * lin[2] - p[2] * lin[1], p[2] * lin[0] - p[0] * lin[2],
                        p[0] * lin[1] - p[1] * lin[0]};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    af[r] = lin[r];
    af[3 + r] = ((R[3 * r] * f[3] + R[3 * r + 1] * f[4]) + R[3 * r + 2] * f[5]) + cr[r];
  }
}

// joint i of problem b: fdpa_hat, d0_v and the delta problem's Hv, the nu
// block (r_offset, bounds, z), the zeroed state of the joint.  P: the
// problem's scalar type, G: the axes'.  The loads of the nu block go first,
// so that their round trips overlap the rest.
template <typename P, typename G>
__device__ void kkt_joint(const KktArgs& A, long long i, long long b, double* m) {
  const long long* w = A.topo + i * KKT_WORDS;
  const int type = (int)w[W_TYPE];
  const int nv = (int)w[W_NV], nkids = (int)w[W_NCHILD], K = (int)A.K;
  const long long con = w[W_CON];
  const long long* kids = A.topo + A.N * KKT_WORDS + w[W_CHILD0];
  const View<float> nuv = view<float>(A.nu, i, b), zv = view<float>(A.z, i, b),
                    wv = view<float>(A.w, i, b);
  const View<P> lbv = run<P>(A.lb, w[W_IDX_V], b), ubv = run<P>(A.ub, w[W_IDX_V], b);
  float nu32[6], z32[6], w32[6];
  P lb[6], ub[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const bool slot = c < K, dof = c < nv;
    nu32[c] = slot ? nuv.raw(c) : 0.0f;
    z32[c] = slot ? zv.raw(c) : 0.0f;
    w32[c] = dof ? wv.raw(c) : 0.0f;
    lb[c] = dof ? lbv.raw(c) : P(0);
    ub[c] = dof ? ubv.raw(c) : P(0);
  }
  double fd[6];
  if (con >= 0) {
    const View<float> yv = view<float>(A.Aty, con, b);
#pragma unroll
    for (int r = 0; r < 6; ++r) fd[r] = yv(r);
  } else {
#pragma unroll
    for (int r = 0; r < 6; ++r) fd[r] = 0.0;
  }
  for (int n = 0; n < nkids; ++n) {
    double af[6];
    act_force(A, kids[n], b, af);
#pragma unroll
    for (int r = 0; r < 6; ++r) fd[r] = fd[r] + af[r];
  }
  const View<float> fv = view<float>(A.fis, i, b), vv = view<float>(A.vis, i, b);
  const View<P> vrv = view<P>(A.v_ref, i, b), H = view<P>(A.H_ref, i, b);
  float fi[6], vi[6];
  P vr[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    fi[r] = fv.raw(r);
    vi[r] = vv.raw(r);
    vr[r] = vrv.raw(r);
    fd[r] = fd[r] - (double)fi[r];
  }
  const Out o_hv = out(A, O_HV, i * 6, b), o_fd = out(A, O_FDPA_HAT, i * 6, b),
            o_vis = out(A, O_VIS0, i * 6, b), o_fis = out(A, O_FIS0, i * 6, b),
            o_fdpa = out(A, O_FDPA0, i * 6, b);
#pragma unroll 1
  for (int r = 0; r < 6; ++r) {
    // H_ref v (mv) and H_ref' v_ref (mtv, prepare_problem's Hv)
    double hv = H(r, 0) * (double)vi[0];
    double ht = H(0, r) * (double)vr[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) {
      hv = hv + H(r, j) * (double)vi[j];
      ht = ht + H(j, r) * (double)vr[j];
    }
    const double d0 = (hv - ht) + fd[r];
    o_hv(r, (float)-d0);
    o_fd(r, (float)fd[r]);
    o_vis(r, 0.0f);
    o_fis(r, 0.0f);
    o_fdpa(r, 0.0f);
    m[M_HV] = mx(m[M_HV], fabs(d0));
    m[M_DUAL] = mx(mx(mx(m[M_DUAL], fabs(hv)), fabs(ht)), fabs(fd[r]));
  }
  double a[3] = {0.0, 0.0, 0.0};
  if (type == REVOLUTE || type == REVOLUTE_UNBOUNDED || type == PRISMATIC || type == HELICAL) {
    const View<G> axv = view<G>(A.axis, i, b);
#pragma unroll
    for (int r = 0; r < 3; ++r) a[r] = axv(r);
  }
  const double h = word_double(w[W_PITCH]);
  const long long e0 = i * K;
  const Out o_off = out(A, O_R_OFFSET, e0, b), o_lb = out(A, O_LB, e0, b),
            o_ub = out(A, O_UB, e0, b), o_z = out(A, O_Z, e0, b), o_nu = out(A, O_NU0, e0, b),
            o_w = out(A, O_W0, e0, b), o_stfw = out(A, O_STFW0, e0, b);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (c >= K) break;
    const float n32 = nu32[c], zc = z32[c];
    const double nu = (double)n32;
    double d0 = 0.0, lo = 0.0, hi = 0.0;
    if (c < nv) {
      double col[6];
      s_column(type, c, a, h, col);
      double s = col[0] * (double)fi[0];
#pragma unroll
      for (int r = 1; r < 6; ++r) s = s + col[r] * (double)fi[r];
      d0 = s + (double)w32[c];
      lo = (double)lb[c];
      hi = (double)ub[c];
    }
    o_off(c, (float)d0);
    o_lb(c, (float)(lo - nu));
    o_ub(c, (float)(hi - nu));
    o_z(c, zc - n32);
    o_nu(c, 0.0f);
    o_w(c, 0.0f);
    o_stfw(c, 0.0f);
    m[M_DUAL] = mx(m[M_DUAL], fabs(d0));
    m[M_PRIMAL] = mx(m[M_PRIMAL], fabs(nu));
  }
}

// constraint k of problem b: A v_hat, the delta problem's b and A'b
template <typename P>
__device__ void kkt_constraint(const KktArgs& A, long long k, long long b, double* m) {
  const View<float> vv = view<float>(A.vis, A.topo[A.N * KKT_WORDS + A.N + k], b);
  const View<P> Ak = view<P>(A.A, k, b), bk = view<P>(A.b, k, b);
  const Out o_b = out(A, O_B, k * 6, b), o_y = out(A, O_YIS0, k * 6, b),
            o_aty = out(A, O_ATY0, k * 6, b), o_atb = out(A, O_ATB, k * 6, b);
  double v[6], bd[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) v[r] = vv(r);
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    double av = Ak(r, 0) * v[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) av = av + Ak(r, j) * v[j];
    const double bo = bk(r);
    bd[r] = bo - av;
    o_b(r, (float)bd[r]);
    o_y(r, 0.0f);
    o_aty(r, 0.0f);
    m[M_PRIMAL] = mx(mx(m[M_PRIMAL], fabs(av)), fabs(bo));
    m[M_B] = mx(m[M_B], fabs(bd[r]));
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    double s = Ak(0, r) * bd[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s = s + Ak(j, r) * bd[j];
    o_atb(r, (float)s);
  }
}

// Before the barrier: thread (x, row) takes its joints and constraints of
// the problem and leaves its maxima in part[(v * rows + row) * KKT_PROBLEMS + x].
template <typename P, typename G>
__device__ void kkt_thread(const KktArgs& A, long long blk, int x, int row, int rows,
                           double* part) {
  double m[KKT_MAXIMA] = {0.0, 0.0, 0.0, 0.0};
  const long long b = blk * KKT_PROBLEMS + x;
  if (b < A.B) {
    for (long long i = row; i < A.N; i += rows) kkt_joint<P, G>(A, i, b, m);
    for (long long k = row; k < A.NC; k += rows) kkt_constraint<P>(A, k, b, m);
  }
#pragma unroll
  for (int v = 0; v < KKT_MAXIMA; ++v) part[(v * rows + row) * KKT_PROBLEMS + x] = m[v];
}

// After the barrier: row v < KKT_MAXIMA reduces maximum v over the rows.
__device__ void kkt_reduce(const KktArgs& A, long long blk, int x, int row, int rows,
                           const double* part) {
  const long long b = blk * KKT_PROBLEMS + x;
  if (b >= A.B) return;
  for (int v = row; v < KKT_MAXIMA; v += rows) {
    double acc = part[v * rows * KKT_PROBLEMS + x];
    for (int r = 1; r < rows; ++r) acc = mx(acc, part[(v * rows + r) * KKT_PROBLEMS + x]);
    out(A, O_SCALE_P + v, 0, b)(0, (float)acc);
  }
}

}  // namespace

// In the global namespace, as a trace and a graph's node list name it.
#ifndef LOIK_REHEARSAL
template <typename P, typename G>
__global__ void __launch_bounds__(KKT_THREADS) kkt64_kernel(const __grid_constant__ KktArgs A) {
  extern __shared__ double part[];
  const int rows = (int)blockDim.y;
  kkt_thread<P, G>(A, blockIdx.x, threadIdx.x, threadIdx.y, rows, part);
  __syncthreads();
  kkt_reduce(A, blockIdx.x, threadIdx.x, threadIdx.y, rows, part);
}
#endif

namespace {

// One block per KKT_PROBLEMS problems, a row of threads per joint up to
// KKT_THREADS / KKT_PROBLEMS rows, the rows' maxima in shared memory (16 KB
// at most).
template <typename P, typename G>
int launch(const KktArgs* A, void* stream) {
  const long long blocks = (A->B + KKT_PROBLEMS - 1) / KKT_PROBLEMS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long most = KKT_THREADS / KKT_PROBLEMS;
  const int rows = (int)(A->N < most ? A->N : most);
  const size_t smem = sizeof(double) * KKT_MAXIMA * rows * KKT_PROBLEMS;
#ifdef LOIK_REHEARSAL
  const KktArgs args = *A;
  loik_rehearsal_run((int)blocks, KKT_PROBLEMS * rows, smem, [&] {
    double* part = reinterpret_cast<double*>(loik_rehearsal_smem);
    const long long blk = blockIdx.x;
    for (int row = 0; row < rows; ++row)
      for (int x = 0; x < KKT_PROBLEMS; ++x) kkt_thread<P, G>(args, blk, x, row, rows, part);
    for (int row = 0; row < rows; ++row)
      for (int x = 0; x < KKT_PROBLEMS; ++x) kkt_reduce(args, blk, x, row, rows, part);
  });
  (void)stream;
  return 0;
#else
  const dim3 block(KKT_PROBLEMS, rows);
  kkt64_kernel<P, G><<<(unsigned)blocks, block, smem, (cudaStream_t)stream>>>(*A);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
int loik_kkt64(const KktArgs* args, void* stream) {
  if (args->B <= 0 || args->N <= 0) return 0;
  if (args->H_ref.f64)
    return args->axis.f64 ? launch<double, double>(args, stream) : launch<double, float>(args, stream);
  return args->axis.f64 ? launch<float, double>(args, stream) : launch<float, float>(args, stream);
}

// The layout the wrapper must agree with.
void loik_kkt64_abi(int* args_bytes, int* topo_words, int* outputs) {
  *args_bytes = (int)sizeof(KktArgs);
  *topo_words = KKT_WORDS;
  *outputs = KKT_OUTS;
}

}  // extern "C"
