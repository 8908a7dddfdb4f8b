// The solver's forward kinematics (phase `solver.fk`) for NVIDIA Hopper
// (sm_90a): liMi = placement_i * M_i(q) for every joint i and problem b in
// one launch, written in the trailing-batch layout the fused ADMM kernel
// and the eager loop read, liMi_R (N, 3, 3, B) and liMi_p (N, 3, B).
//
// Replaces no TPU kernel.  loik_tpu's FK is plain jnp
// (loik_tpu/model/tree.py:563, `KinematicTree.fwd_kinematics`), which XLA
// compiles into a few fused loops.  The port's plain version
// (loik_tpu_torch/model/tree.py::fwd_kinematics) is a Python loop over the
// joints; each joint issues Rodrigues' formula, two SE(3) products and a
// stack, some 20-25 device operations, so inside a captured graph a
// 33-joint tree replays about 700 nodes of a few microseconds each for a
// few MB of work.  This kernel is added for that.  It keeps no oMi: the
// solver reads only liMi.
//
// What bounds it on this card: bytes.  liMi of joint i and problem b is
// independent of every other pair: no recursion over the tree.  A launch
// reads q (B x nq words) and writes liMi (B x N x 12 words); the geometry
// (placements, axes) is a few hundred words shared by all problems.  At
// panda_arm's B 16384 (N 7, nq 7, float32) that is 0.46 + 5.5 MB, 1.8 us at
// 3.35 TB/s; at talos' B 4096 (N 33, nq 39) 0.64 + 6.5 MB, 2.1 us.  The
// arithmetic (two sines, a few dozen products a pair) is far below the
// roof.  So the design is one thread per (joint, problem) pair with b the
// fastest index: a warp writes each of the twelve outputs of one joint for
// 32 neighbouring problems, 128 contiguous bytes, and reads the joint's
// geometry at one address.  A launch this small is as long as the card
// takes to start it; the graph's single node replaces the plain FK's
// hundreds.
//
// Inputs:
// - Topology (`kernels/fk.py::_topology`): FK_WORDS int64 words a joint,
//   made once per tree (`model.tree.derived`): type, first q index, a
//   mimic pair's member types, and the float64 bits of the helical pitch
//   and the mimic multiplier and offset.  The topology is the graph's key,
//   so a graph holds the table of its own topology.
// - Geometry: read from the tree's tensors at every launch, through a
//   pointer and strides per leaf (joint, problem, row, column), never
//   copied into arguments or constant memory: a graph replayed on another
//   tree of the topology reads that tree's leaves.  A leaf with a problem
//   axis (batched geometry, the mixed super-batch) has a problem stride;
//   a shared one has 0.
// - q (B, nq) through its two strides.
//
// Same numbers as the plain FK.  Every elementwise operation of
// tree.joint_calc and spatial.se3_compose is done here in its order, each
// rounded on its own (the library is built with -fmad=false, so no multiply
// and add are contracted), cos, sin, sqrt and division as CUDA's math
// library rounds them for PyTorch.  Rodrigues is c I + s [a]x + (1 - c) a a'
// summed in that order.  The plain FK's 3 x 3 products and its norm of a
// quaternion are cuBLAS's and PyTorch's reductions, whose order of terms was
// measured on the card (tools/fk_check.py) and is written where they are
// used here (`gemm_dot`, `gemv_dot`, `quat_sq`): rotations equal the plain
// FK's bit for bit from B 333 up; cuBLAS's order for a matrix times a
// vector changes with B in float32, so translations that M(q) moves may
// differ in their last bits.
//
// Rehearsal without a card: with LOIK_REHEARSAL defined (the stub
// cuda_runtime.h of tools/rehearse/) the same source compiles with g++ and
// a launch becomes a loop over the threads (tests/test_torch_fk_kernel.py).

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

// joint type codes of model/tree.py
enum {
  REVOLUTE = 0, PRISMATIC = 1, FREE_FLYER = 2, SPHERICAL = 3,
  REVOLUTE_UNBOUNDED = 4, TRANSLATION = 5, PLANAR = 6, UNIVERSAL = 7,
  HELICAL = 8, SPHERICAL_ZYX = 9, MIMIC_PAIR = 10
};

// the words of one joint in the topology table (kernels/fk.py::_topology)
enum { W_TYPE, W_IQ, W_MASTER, W_MIMIC, W_PITCH, W_MULT, W_OFFSET, FK_WORDS };

constexpr int FK_THREADS = 256;

}  // namespace

// One geometry leaf: element (joint j, problem b, row r, column c) at
// ptr[j * sj + b * sb + r * s0 + c * s1], in elements of the scalar type.
struct FkLeaf {
  const void* ptr;
  long long sj, sb, s0, s1;
};

// One launch (kernels/fk.py::_FkArgs mirrors it field for field).
struct FkArgs {
  long long B, N;
  const long long* topo;  // (N, FK_WORDS)
  const void* q;          // q[b * q_sb + k * q_sk]
  long long q_sb, q_sk;
  FkLeaf placement_R, placement_p, axis, axis2, placement2_R, placement2_p;
  void* R;  // (N, 3, 3, B), contiguous
  void* p;  // (N, 3, B), contiguous
};

namespace {

__device__ __forceinline__ float fk_cos(float x) { return cosf(x); }
__device__ __forceinline__ double fk_cos(double x) { return cos(x); }
__device__ __forceinline__ float fk_sin(float x) { return sinf(x); }
__device__ __forceinline__ double fk_sin(double x) { return sin(x); }
__device__ __forceinline__ float fk_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double fk_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float fk_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fk_fma(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ double word_double(long long w) {
#ifdef LOIK_REHEARSAL
  double d;
  memcpy(&d, &w, sizeof d);
  return d;
#else
  return __longlong_as_double(w);
#endif
}

// x0 y0 + x1 y1 + x2 y2 as cuBLAS sums a product of 3 x 3 matrices (the
// batched gemm of `R @ R`, a shared matrix times a batch or a batch times a
// batch): a chain of fused multiply-adds over k ascending.  Measured on the
// H100 (tools/fk_check.py, CUDA 12.8): every element equal at B 333, 4096
// and 16384 in float32 and float64; at B 1 in float32 cuBLAS runs another
// kernel, whose last term is added unfused.
template <typename T>
__device__ __forceinline__ T gemm_dot(T x0, T y0, T x1, T y1, T x2, T y2) {
  return fk_fma(x2, y2, fk_fma(x1, y1, x0 * y0));
}

// The same sum as cuBLAS's batched 3 x 3 matrix times a 3-vector
// (`R @ p[..., None]`, its gemv kernel) takes it: the terms split over two
// threads, x0 y0 fused with x2 y2 on one, then x1 y1 added.  Measured as
// above: every element equal in float64 from B 333 and in float32 at
// B 16384; in float32 at B 333 and 4096 cuBLAS splits (0, 1 | 2) instead,
// so a translation may differ from the plain FK's in its last bits (the
// budget in tests/test_torch_fk_kernel.py).  No order matches every B.
template <typename T>
__device__ __forceinline__ T gemv_dot(T x0, T y0, T x1, T y1, T x2, T y2) {
  return x1 * y1 + fk_fma(x2, y2, x0 * y0);
}

// The squared norm of a quaternion as torch.linalg.norm reduces it over its
// last axis: each square rounded, then (s0 + s2) + (s1 + s3), a reduction
// over shuffles at offsets 2 and 1.  Measured as above: every element
// equal at every B, float32 and float64.
template <typename T>
__device__ __forceinline__ T quat_sq(T x, T y, T z, T w) {
  return (x * x + z * z) + (y * y + w * w);
}

// C = A B (3 x 3, row-major)
template <typename T>
__device__ __forceinline__ void mm3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = gemm_dot(A[3 * i], B[j], A[3 * i + 1], B[3 + j], A[3 * i + 2], B[6 + j]);
}

// c = a + A v (spatial.se3_compose's translation)
template <typename T>
__device__ __forceinline__ void add_mv3(const T* a, const T* A, const T* v, T* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = a[i] + gemv_dot(A[3 * i], v[0], A[3 * i + 1], v[1], A[3 * i + 2], v[2]);
}

template <typename T>
__device__ __forceinline__ void eye3(T* R) {
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = (e % 4 == 0) ? T(1) : T(0);
}

// spatial.rotation_about_axis(_cs): c I + s [a]x + (1 - c) a a', each term
// and each sum rounded in that order
template <typename T>
__device__ __forceinline__ void rodrigues(const T* a, T c, T s, T* R) {
  const T o = T(0);
  const T K[9] = {o, -a[2], a[1], a[2], o, -a[0], -a[1], a[0], o};
  const T one_c = T(1) - c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T e = (i == j) ? T(1) : T(0);
      R[3 * i + j] = (c * e + s * K[3 * i + j]) + one_c * (a[i] * a[j]);
    }
}

// spatial.quat_to_rotmat of (x, y, z, w), normalised first
template <typename T>
__device__ __forceinline__ void quat_R(T x, T y, T z, T w, T* R) {
  const T n = fk_sqrt(quat_sq(x, y, z, w));
  x = x / n;
  y = y / n;
  z = z / n;
  w = w / n;
  R[0] = T(1) - T(2) * (y * y + z * z);
  R[1] = T(2) * (x * y - z * w);
  R[2] = T(2) * (x * z + y * w);
  R[3] = T(2) * (x * y + z * w);
  R[4] = T(1) - T(2) * (x * x + z * z);
  R[5] = T(2) * (y * z - x * w);
  R[6] = T(2) * (x * z - y * w);
  R[7] = T(2) * (y * z + x * w);
  R[8] = T(1) - T(2) * (x * x + y * y);
}

// model/tree.py::_calc_1dof: a mimic pair's member, revolute or prismatic
template <typename T>
__device__ __forceinline__ void calc_1dof(int type, const T* a, T ang, T* R, T* p) {
  if (type == REVOLUTE) {
    rodrigues(a, fk_cos(ang), fk_sin(ang), R);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = T(0);
  } else {
    eye3(R);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = ang * a[k];
  }
}

template <typename T>
__device__ __forceinline__ T at(const FkLeaf& L, long long j, long long b, int r, int c = 0) {
  return static_cast<const T*>(L.ptr)[j * L.sj + b * L.sb + r * L.s0 + c * L.s1];
}

template <typename T>
__device__ __forceinline__ void load_R(const FkLeaf& L, long long j, long long b, T* R) {
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = at<T>(L, j, b, e / 3, e % 3);
}

template <typename T>
__device__ __forceinline__ void load_v(const FkLeaf& L, long long j, long long b, T* v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = at<T>(L, j, b, k);
}

// liMi of pair t = j * B + b (model/tree.py::joint_calc, then
// spatial.se3_compose(placement, M(q)))
template <typename T>
__device__ __forceinline__ void fk_limi_pair(const FkArgs& A, long long t) {
  const long long B = A.B;
  if (t >= A.N * B) return;
  const long long j = t / B, b = t - j * B;
  const long long* w = A.topo + j * FK_WORDS;
  const int type = (int)w[W_TYPE];
  const T* q = static_cast<const T*>(A.q) + b * A.q_sb + w[W_IQ] * A.q_sk;
  const long long qs = A.q_sk;
  T R[9], p[3], a[3];
  switch (type) {
    case REVOLUTE:
    case HELICAL: {
      const T ang = q[0];
      load_v(A.axis, j, b, a);
      rodrigues(a, fk_cos(ang), fk_sin(ang), R);
      if (type == HELICAL) {
        const T h = T(word_double(w[W_PITCH])) * ang;
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] = h * a[k];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] = T(0);
      }
      break;
    }
    case PRISMATIC: {
      const T d = q[0];
      load_v(A.axis, j, b, a);
      eye3(R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = d * a[k];
      break;
    }
    case FREE_FLYER:
      quat_R(q[3 * qs], q[4 * qs], q[5 * qs], q[6 * qs], R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = q[k * qs];
      break;
    case SPHERICAL:
      quat_R(q[0], q[qs], q[2 * qs], q[3 * qs], R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = T(0);
      break;
    case REVOLUTE_UNBOUNDED: {
      T c = q[0], s = q[qs];
      const T n = fk_sqrt(c * c + s * s);
      c = c / n;
      s = s / n;
      load_v(A.axis, j, b, a);
      rodrigues(a, c, s, R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = T(0);
      break;
    }
    case TRANSLATION:
      eye3(R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = q[k * qs];
      break;
    case PLANAR: {
      T c = q[2 * qs], s = q[3 * qs];
      const T n = fk_sqrt(c * c + s * s);
      c = c / n;
      s = s / n;
      R[0] = c;    R[1] = -s;   R[2] = T(0);
      R[3] = s;    R[4] = c;    R[5] = T(0);
      R[6] = T(0); R[7] = T(0); R[8] = T(1);
      p[0] = q[0];
      p[1] = q[qs];
      p[2] = T(0);
      break;
    }
    case SPHERICAL_ZYX: {
      // R = Rz(q0) Ry(q1) Rx(q2) = spatial.rpy_to_rotmat((q2, q1, q0))
      const T cr = fk_cos(q[2 * qs]), sr = fk_sin(q[2 * qs]);
      const T cp = fk_cos(q[qs]), sp = fk_sin(q[qs]);
      const T cy = fk_cos(q[0]), sy = fk_sin(q[0]);
      R[0] = cy * cp;
      R[1] = cy * sp * sr - sy * cr;
      R[2] = cy * sp * cr + sy * sr;
      R[3] = sy * cp;
      R[4] = sy * sp * sr + cy * cr;
      R[5] = sy * sp * cr - cy * sr;
      R[6] = -sp;
      R[7] = cp * sr;
      R[8] = cp * cr;
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = T(0);
      break;
    }
    case UNIVERSAL: {
      T R1[9], R2[9], a2[3];
      load_v(A.axis, j, b, a);
      load_v(A.axis2, j, b, a2);
      rodrigues(a, fk_cos(q[0]), fk_sin(q[0]), R1);
      rodrigues(a2, fk_cos(q[qs]), fk_sin(q[qs]), R2);
      mm3(R1, R2, R);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = T(0);
      break;
    }
    default: {  // MIMIC_PAIR: M_master(q1) X2 M_mimic(k q1 + o)
      T R1[9], p1[3], R2[9], p2[3], a2[3], X2[9], x2[3], Rc[9], pc[3];
      const T q1 = q[0];
      const T q2 = T(word_double(w[W_MULT])) * q1 + T(word_double(w[W_OFFSET]));
      load_v(A.axis, j, b, a);
      load_v(A.axis2, j, b, a2);
      calc_1dof((int)w[W_MASTER], a, q1, R1, p1);
      calc_1dof((int)w[W_MIMIC], a2, q2, R2, p2);
      load_R(A.placement2_R, j, b, X2);
      load_v(A.placement2_p, j, b, x2);
      mm3(X2, R2, Rc);
      add_mv3(x2, X2, p2, pc);
      mm3(R1, Rc, R);
      add_mv3(p1, R1, pc, p);
      break;
    }
  }
  T PR[9], Pp[3], oR[9], op[3];
  load_R(A.placement_R, j, b, PR);
  load_v(A.placement_p, j, b, Pp);
  mm3(PR, R, oR);
  add_mv3(Pp, PR, p, op);
  T* outR = static_cast<T*>(A.R) + j * 9 * B + b;
  T* outp = static_cast<T*>(A.p) + j * 3 * B + b;
#pragma unroll
  for (int e = 0; e < 9; ++e) outR[e * B] = oR[e];
#pragma unroll
  for (int k = 0; k < 3; ++k) outp[k * B] = op[k];
}

}  // namespace

// In the global namespace, as a trace and a graph's node list name it.
#ifndef LOIK_REHEARSAL
template <typename T>
__global__ void __launch_bounds__(FK_THREADS) fk_limi_kernel(const __grid_constant__ FkArgs A) {
  fk_limi_pair<T>(A, (long long)blockIdx.x * FK_THREADS + threadIdx.x);
}
#endif

namespace {

template <typename T>
int launch(const FkArgs* A, void* stream) {
  const long long pairs = A->N * A->B;
  if (pairs <= 0) return 0;
  const long long blocks = (pairs + FK_THREADS - 1) / FK_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#ifdef LOIK_REHEARSAL
  const FkArgs args = *A;
  loik_rehearsal_run((int)blocks, FK_THREADS, 0, [&] {
    for (long long i = 0; i < FK_THREADS; ++i)
      fk_limi_pair<T>(args, (long long)blockIdx.x * FK_THREADS + i);
  });
  return 0;
#else
  fk_limi_kernel<T><<<(unsigned)blocks, FK_THREADS, 0, (cudaStream_t)stream>>>(*A);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
int loik_fk_limi_f32(const FkArgs* args, void* stream) { return launch<float>(args, stream); }

int loik_fk_limi_f64(const FkArgs* args, void* stream) { return launch<double>(args, stream); }

// The layout the wrapper must agree with.
void loik_fk_abi(int* args_bytes, int* topo_words) {
  *args_bytes = (int)sizeof(FkArgs);
  *topo_words = FK_WORDS;
}

}  // extern "C"
