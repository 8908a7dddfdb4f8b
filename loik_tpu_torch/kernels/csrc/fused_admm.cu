// Fused ADMM solve loop for NVIDIA Hopper (sm_90a): the whole masked
// while-loop of `loik_tpu_torch.solver.solve.make_loop_body`, run to
// termination, one thread per problem.
//
// Replaces: loik_tpu/kernels/fused.py::_kernel (the Pallas TPU kernel, whose
// body is loik_tpu/solver/solve.py::make_loop_body -> _iteration + _h_sweep,
// with the k x k D blocks of loik_tpu/solver/batched_spatial.py::spd_inv).
// Written from the solver math, not from the Pallas carry plumbing.
//
// Preconditions (kernels/fused.py::fused_eligibility names the first one a
// call breaks): at most LOIK_MAX_JOINTS joints with at most LOIK_MAX_NV
// dofs in all, joints of 1 to 6 dofs whose motion subspace does not depend
// on q, at most LOIK_MAX_CONSTRAINTS constraints on distinct links, 1..1024
// threads per block; per-problem subspaces (S_all) only for chains of at
// most LOIK_SMALL_JOINTS one-dof joints.
//
// What bounds it on this card: latency, not either roof.  Counting each input
// read once and each output written once against the iterations a run
// needs, the loop's floor is set by its bytes (a few KB per problem, some
// 0.02 to 0.03 ms per launch at HBM rate; chip_smoke.py computes it), and the
// kernel sits 30 to 600 times above it.  One thread per problem gives 16384
// (panda_arm), 10240 (solo12) or 4096 (talos) threads on 132 SMs that can
// hold 2048 each, and every problem is a long, data-dependent chain of tiny
// 6x6 products and tree recursions whose per-thread arrays live in local
// memory (ptxas for sm_90a: a stack frame of 3968 B in float and 7936 B in
// double for the 16-joint instantiation, 11840 B and 23360 B for the 40-joint
// one, 153 to 168 registers, no spills; PERF.md has the report).  The tall
// frame is why talos' loop is the slowest per problem: every H, U and p it
// touches is a local-memory access.  This version does nothing about that;
// several lanes per problem (a warp-cooperative 6x6 sweep) is the planned
// next step (ROADMAP queue 2).
//
// Design:
// - Thread b owns problem b.  Element (i, ..., b) of a trailing-batch tensor
//   sits at flat_index * B + b, so the loads and stores of a warp coalesce.
//   Threads with b >= B return, which masks the ragged edge.
// - Per-problem exit.  The Pallas tile ran every problem to the tile's
//   slowest member under masked merges.  Here each thread runs its own
//   `while (running)` loop with its own counter it += K.  That gives the
//   same per-problem results: a problem that stops never restarts
//   (running_next = active & ...), a stopped problem's state is frozen by
//   the merge, and `iterations` is written only while the problem is
//   active.  Inside its own loop a thread is always active, so the masked
//   merge becomes a plain store, and the global counter the tile would have
//   used equals this thread's counter at each of its body calls.
// - In place.  The wrapper clones the input state; this kernel updates the
//   clones in place (only thread b touches column b).  The loop counter `it`
//   starts from the input state's and ends as the largest over the problems
//   (atomicMax), which is the value the eager loop's shared counter ends at.
// - Topology at run time: parents, dofs per joint and constraint links
//   arrive in the by-value config struct.  The motion subspaces S are a
//   device operand, one (N, 6, nv_max) tensor of the kernel's scalar type
//   shared by all problems (zero-padded columns past a joint's dofs), built
//   once per tree by the wrapper.  (A per-block copy in shared memory was
//   measured and gave nothing: every lane reads the same address, which the
//   L1 serves as a broadcast already.)
// - Per-problem subspaces (the TPU kernel's S_all input, loik_tpu/kernels/
//   fused.py:285-306): a tree with batched geometry leaves, the mixed
//   super-batch's padded chain, has one S per joint AND problem.  It comes
//   as one more trailing-batch operand (N, 6, 1, B), read like H_ref or
//   liMi: thread b reads element f at f * B + b, coalesced.  Shared or
//   per-problem is a template parameter (SALL) of the one-dof instantiation,
//   picked once per launch by which of the two pointers is set, so the
//   shared-S code of the flagship arm is unchanged; the general
//   instantiation does not take S_all.  A padded joint of a mixed chain has
//   S = 0: U = H S = 0 and D = mu, every product multiplies through the
//   zeros as the eager loop does, and its nu, z and w stay exactly 0.
// - Joints of k dofs.  U = H S and U D^-1 are 6 x k, stored by dof
//   (U[dof][row]); D = S'HS + mu I is k x k and D^-1 comes from the unrolled
//   Cholesky + triangular inverse + M'M of batched_spatial.spd_inv, in its
//   operation order, stored at a running offset of k^2.  Every product with
//   S multiplies through, zeros included (a free flyer's S is eye(6)), as
//   the eager loop does.  The padded (N, nv_max, B) dof tensors are read
//   and written at slots j < k only; padded slots stay as they came (zero).
// - Three instantiations per scalar type: all joints 1-dof and at most 16
//   of them (every k is the constant 1, D is a scalar, the frame is short:
//   the flagship arm) with shared S, the same with per-problem S, and the
//   general one at the caps.  `launch` picks by the tree and the operand.
// - The K > 1 hoist: the H half of the Riccati sweep (H_list, U, D^-1,
//   U D^-1) depends only on (mu_eq, mu_ineq, liMi) and is computed once per
//   body call, then shared by the K-1 check-free micro-iterations and the
//   checked one.  K = 1 computes it once too.
// - Typed arithmetic: a template on the scalar type T, every literal T(...),
//   IEEE division (no fast math).  Every sum runs term by term in the index
//   order of solver/batched_spatial.py, and the library is compiled with
//   -fmad=false (kernels/_build.py), so no multiply-add is contracted into
//   an FMA: the float instantiation rounds operation for operation like the
//   eager loop and returns the same bits.  That is what makes the two
//   comparable at all: in float32 the solver's iteration counts change
//   under a one-ulp change of the inputs.  The double instantiation exists
//   to check the kernel's logic at 1e-9.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOIK_MAX_JOINTS 40
#define LOIK_MAX_NV 48
#define LOIK_MAX_CONSTRAINTS 8
// caps of the instantiation for trees of 1-dof joints only
#define LOIK_SMALL_JOINTS 16

// Keep in step with kernels/fused.py::_LoikConfig (same order and types).
// nv_max is the dof-slot stride of the padded (N, nv_max, B) tensors and of
// the columns of S.
struct LoikConfig {
  int B, N, NC, nv_max, threads;
  int max_iter, check_interval, check_feasibility, tail_solve;
  int parents[LOIK_MAX_JOINTS];
  int nvs[LOIK_MAX_JOINTS];
  int clinks[LOIK_MAX_CONSTRAINTS];
  double rho, tol_abs, tol_rel, tol_primal_inf, tol_tail_solve, mu_eq_scale;
};

// Order of the pointer array; keep in step with kernels/fused.py (the 24
// state fields of _STATE_FIELDS, the 10 of _PROB_FIELDS, the 3 optional
// delta-stage fields, liMi, the shared motion subspaces or the per-problem
// ones (the other pointer is null), then the input state's loop counter).
enum LoikPtr {
  P_VIS, P_FIS, P_NU, P_Z, P_W, P_YIS, P_ATY, P_FDPA, P_STFW,
  P_MU, P_MU_EQ, P_MU_INEQ, P_ITERATIONS, P_TAIL_ITERATIONS,
  P_CONVERGED, P_PINF, P_DINF, P_IN_TAIL, P_RUNNING,
  P_RP, P_RD, P_DX, P_DZ, P_IT,
  P_H_REF, P_HV, P_A, P_B, P_ATA, P_ATB, P_LB, P_UB, P_B_INF, P_HV_INF,
  P_R_OFFSET, P_TOL_SCALE_PRIMAL, P_TOL_SCALE_DUAL,
  P_LIMI_R, P_LIMI_P, P_S, P_S_ALL, P_IT_IN,
  P_COUNT
};

template <typename T>
struct LoikPtrs {
  T *vis, *fis, *nu, *z, *w, *yis, *Aty, *fdpa, *stfw;
  T *mu, *mu_eq, *mu_ineq;
  int32_t *iterations, *tail_iterations;
  bool *converged, *pinf, *dinf, *in_tail, *running;
  T *rp, *rd, *dx, *dz;
  int32_t* it;  // () loop counter, raised with atomicMax
  const T *H_ref, *Hv, *A, *b, *AtA, *Atb, *lb, *ub, *b_inf, *Hv_inf;
  const T *r_offset, *tol_scale_primal, *tol_scale_dual;  // nullptr if absent
  const T *liMi_R, *liMi_p;
  const T* S;      // (N, 6, nv_max), shared by all problems; or
  const T* S_all;  // (N, 6, 1, B), one per problem (SALL instantiation)
  const int32_t* it_in;  // () the input state's loop counter
};

// NaN-propagating max, like jnp.maximum / torch.maximum / amax.
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// NaN-propagating min, like jnp.minimum / torch.clamp_max.
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }
// the routine behind torch.rsqrt on the card
__device__ __forceinline__ float rsqrtv(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrtv(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  T y = x < lo ? lo : x;  // NaN passes through, as torch.clamp
  return y > hi ? hi : y;
}

// liMi of joint i: R (3x3 row-major) and p.
template <typename T>
__device__ __forceinline__ void load_liMi(const LoikPtrs<T>& P, int B, int b,
                                          int i, T R[9], T p[3]) {
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = P.liMi_R[(size_t)(i * 9 + e) * B + b];
#pragma unroll
  for (int e = 0; e < 3; ++e) p[e] = P.liMi_p[(size_t)(i * 3 + e) * B + b];
}

// out = X* f: lin = R f_lin; ang = R f_ang + p x lin
template <typename T>
__device__ __forceinline__ void act_force(const T R[9], const T p[3],
                                          const T f[6], T out[6]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[r] = R[r * 3 + 0] * f[0] + R[r * 3 + 1] * f[1] + R[r * 3 + 2] * f[2];
    out[3 + r] = R[r * 3 + 0] * f[3] + R[r * 3 + 1] * f[4] + R[r * 3 + 2] * f[5];
  }
  out[3] += p[1] * out[2] - p[2] * out[1];
  out[4] += p[2] * out[0] - p[0] * out[2];
  out[5] += p[0] * out[1] - p[1] * out[0];
}

// out = X^-1 v: lin = R^T (v_lin - p x v_ang); ang = R^T v_ang
template <typename T>
__device__ __forceinline__ void act_inv_motion(const T R[9], const T p[3],
                                               const T v[6], T out[6]) {
  T d[3];
  d[0] = v[0] - (p[1] * v[5] - p[2] * v[4]);
  d[1] = v[1] - (p[2] * v[3] - p[0] * v[5]);
  d[2] = v[2] - (p[0] * v[4] - p[1] * v[3]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = R[0 * 3 + c] * d[0] + R[1 * 3 + c] * d[1] + R[2 * 3 + c] * d[2];
    out[3 + c] = R[0 * 3 + c] * v[3] + R[1 * 3 + c] * v[4] + R[2 * 3 + c] * v[5];
  }
}

// Hpar += X* Ha X*^T with X* = [[R, 0], [[p]x R, R]], the dense form: two
// 6x6 products (batched_spatial.act_sym6_dense, the float form).
template <typename T>
__device__ __forceinline__ void add_act_sym6_dense(const T R[9], const T p[3],
                                                   const T Ha[36], T* Hpar) {
  T X[36];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T Rrc = R[r * 3 + c];
      X[r * 6 + c] = Rrc;
      X[r * 6 + 3 + c] = T(0);
      X[(3 + r) * 6 + 3 + c] = Rrc;
    }
  }
  // rows of [p]x R: [p]x = [[0,-p2,p1],[p2,0,-p0],[-p1,p0,0]]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    X[3 * 6 + c] = p[1] * R[2 * 3 + c] - p[2] * R[1 * 3 + c];
    X[4 * 6 + c] = p[2] * R[0 * 3 + c] - p[0] * R[2 * 3 + c];
    X[5 * 6 + c] = p[0] * R[1 * 3 + c] - p[1] * R[0 * 3 + c];
  }
  T Tm[36];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T s = X[r * 6 + 0] * Ha[0 * 6 + c];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += X[r * 6 + j] * Ha[j * 6 + c];
      Tm[r * 6 + c] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T s = Tm[r * 6 + 0] * X[c * 6 + 0];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += Tm[r * 6 + j] * X[c * 6 + j];
      Hpar[r * 6 + c] += s;
    }
  }
}

// R M R^T for the 3x3 block of Ha at (row0, col0), as mmt(mm(R, M), R).
template <typename T>
__device__ __forceinline__ void rot3(const T R[9], const T Ha[36], int row0,
                                     int col0, T out[9]) {
  T RM[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      RM[i * 3 + k] = R[i * 3 + 0] * Ha[(row0 + 0) * 6 + col0 + k] +
                      R[i * 3 + 1] * Ha[(row0 + 1) * 6 + col0 + k] +
                      R[i * 3 + 2] * Ha[(row0 + 2) * 6 + col0 + k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[i * 3 + k] = RM[i * 3 + 0] * R[k * 3 + 0] + RM[i * 3 + 1] * R[k * 3 + 1] +
                       RM[i * 3 + 2] * R[k * 3 + 2];
}

// row i of [p]x M, column j: batched_spatial.skew_mm
template <typename T>
__device__ __forceinline__ T skew_mm(const T p[3], const T M[9], int i, int j) {
  if (i == 0) return p[1] * M[2 * 3 + j] - p[2] * M[1 * 3 + j];
  if (i == 1) return p[2] * M[0 * 3 + j] - p[0] * M[2 * 3 + j];
  return p[0] * M[1 * 3 + j] - p[1] * M[0 * 3 + j];
}

// entry (i, j) of M [p]x: batched_spatial.mm_skew
template <typename T>
__device__ __forceinline__ T mm_skew(const T M[9], const T p[3], int i, int j) {
  if (j == 0) return p[2] * M[i * 3 + 1] - p[1] * M[i * 3 + 2];
  if (j == 1) return p[0] * M[i * 3 + 2] - p[2] * M[i * 3 + 0];
  return p[1] * M[i * 3 + 0] - p[0] * M[i * 3 + 1];
}

// The same congruence in block form (batched_spatial.act_sym6_block, the
// double form): three 3x3 rotations and skew products, with the symmetry of
// Ha mirroring the top-right block from the bottom-left.
template <typename T>
__device__ __forceinline__ void add_act_sym6_block(const T R[9], const T p[3],
                                                   const T Ha[36], T* Hpar) {
  T A1[9], B1[9], C1[9], BL[9];
  rot3(R, Ha, 0, 0, A1);
  rot3(R, Ha, 3, 0, B1);
  rot3(R, Ha, 3, 3, C1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) BL[i * 3 + j] = skew_mm(p, A1, i, j) + B1[i * 3 + j];
  T TR[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) TR[i * 3 + j] = BL[j * 3 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Hpar[i * 6 + j] += A1[i * 3 + j];
      Hpar[i * 6 + 3 + j] += TR[i * 3 + j];
      Hpar[(3 + i) * 6 + j] += BL[i * 3 + j];
      Hpar[(3 + i) * 6 + 3 + j] +=
          skew_mm(p, TR, i, j) - mm_skew(B1, p, i, j) + C1[i * 3 + j];
    }
  }
}

// X* Ha X*^T added into the parent's H, in the form the eager loop uses for
// this scalar type (batched_spatial.act_sym6), so the two round alike.
template <typename T>
__device__ __forceinline__ void add_act_sym6(const T R[9], const T p[3],
                                             const T Ha[36], T* Hpar) {
  if constexpr (sizeof(T) == 8)
    add_act_sym6_block(R, p, Ha, Hpar);
  else
    add_act_sym6_dense(R, p, Ha, Hpar);
}

// Inverse of the SPD KK x KK block D (row-major) by unrolled Cholesky,
// triangular inverse and M^T M: batched_spatial.spd_inv, operation for
// operation (rsqrt of the pivot, L[j][j] = s * rsqrt(s)).
template <typename T, int KK>
__device__ void spd_inv_k(const T* D, T* out) {
  T L[KK * KK], M[KK * KK], Ldi[KK];
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    T s = D[j * KK + j];
#pragma unroll
    for (int p = 0; p < j; ++p) s = s - L[j * KK + p] * L[j * KK + p];
    Ldi[j] = rsqrtv(s);
    L[j * KK + j] = s * Ldi[j];
#pragma unroll
    for (int i = j + 1; i < KK; ++i) {
      T t = D[i * KK + j];
#pragma unroll
      for (int p = 0; p < j; ++p) t = t - L[i * KK + p] * L[j * KK + p];
      L[i * KK + j] = t * Ldi[j];
    }
  }
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    M[i * KK + i] = Ldi[i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      T s = L[i * KK + j] * M[j * KK + j];
#pragma unroll
      for (int p = j + 1; p < i; ++p) s = s + L[i * KK + p] * M[p * KK + j];
      M[i * KK + j] = -s * Ldi[i];
    }
  }
#pragma unroll
  for (int i = 0; i < KK; ++i) {
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const int lo = i > j ? i : j;
      T s = M[lo * KK + i] * M[lo * KK + j];
#pragma unroll
      for (int p = lo + 1; p < KK; ++p) s = s + M[p * KK + i] * M[p * KK + j];
      out[i * KK + j] = s;
    }
  }
}

template <typename T>
__device__ __forceinline__ void spd_inv(int k, const T* D, T* out) {
  switch (k) {
    case 1: out[0] = T(1) / D[0]; break;
    case 2: spd_inv_k<T, 2>(D, out); break;
    case 3: spd_inv_k<T, 3>(D, out); break;
    case 4: spd_inv_k<T, 4>(D, out); break;
    case 5: spd_inv_k<T, 5>(D, out); break;
    default: spd_inv_k<T, 6>(D, out); break;
  }
}

// MAXJ joints and MAXNV dofs at most.  MULTI = false: every joint has one
// dof (k is the constant 1, so the dof loops vanish and D is a scalar).
// SALL = true (one-dof trees only): the motion subspaces are per problem,
// read from P.S_all instead of the shared P.S.
template <typename T, int MAXJ, int MAXNV, bool MULTI, bool SALL>
__global__ void fused_admm_kernel(const __grid_constant__ LoikConfig cfg,
                                  const __grid_constant__ LoikPtrs<T> P) {
  const int B = cfg.B;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = cfg.N, NC = cfg.NC, K = cfg.check_interval;
  // dof-slot stride of the padded tensors and of S
  const int KP = MULTI ? cfg.nv_max : 1;
  if (b >= B) return;
  // element f of problem b in a trailing-batch tensor
#define AT(ptr, f) (ptr)[(size_t)(f) * B + b]
  // dofs of joint i; entry (r, c) of its 6 x k motion subspace
#define NVS(i) (MULTI ? cfg.nvs[i] : 1)
#define SS(i, r, c)                                      \
  (SALL ? P.S_all[(size_t)((i) * 6 + (r)) * B + b]       \
        : P.S[((i) * 6 + (r)) * KP + (c)])

  const T rho = T(cfg.rho);
  const T tol_abs = T(cfg.tol_abs), tol_rel = T(cfg.tol_rel);
  const T tol_pinf = T(cfg.tol_primal_inf), tol_tail = T(cfg.tol_tail_solve);
  const T eq_scale = T(cfg.mu_eq_scale);

  // the H half of the Riccati sweep, hoisted per body call; U and U D^-1
  // are stored by dof (one 6-vector per column), D^-1 at an offset of k^2
  constexpr int MAXD = MULTI ? 6 * MAXNV : MAXNV;
  T H[MAXJ][36];
  T U[MAXNV][6], UDinv[MAXNV][6], Dinv[MAXD];
  // per-iteration recursions
  T pl[MAXJ][6], rt[MAXNV], facc[MAXJ][6];
  // first dof of each joint and the offset of its D^-1 block (both are the
  // joint's index when every joint has one dof)
  int dof0[MULTI ? MAXJ : 1], blk0[MULTI ? MAXJ : 1];
  if constexpr (MULTI) {
    for (int i = 0, d = 0, q = 0; i < N; ++i) {
      dof0[i] = d;
      blk0[i] = q;
      d += cfg.nvs[i];
      q += cfg.nvs[i] * cfg.nvs[i];
    }
  }
#define DOF0(i) (MULTI ? dof0[i] : (i))
#define BLK0(i) (MULTI ? blk0[i] : (i))

  int it = *P.it_in;
  while (P.running[b]) {
    it += K;
    const T mu_eq = P.mu_eq[b], mu_ineq = P.mu_ineq[b];

    // ---------------- H sweep (solve.py::_h_sweep) ----------------------
    for (int i = 0; i < N; ++i)
      for (int e = 0; e < 36; ++e)
        H[i][e] = (e % 7 == 0 ? rho : T(0)) + AT(P.H_ref, i * 36 + e);
    for (int k = 0; k < NC; ++k) {
      const int c = cfg.clinks[k];
      for (int e = 0; e < 36; ++e) H[c][e] += mu_eq * AT(P.AtA, k * 36 + e);
    }
    for (int i = N - 1; i >= 0; --i) {
      const int k = NVS(i), d0 = DOF0(i), q0 = BLK0(i);
      // U = H S
      for (int c = 0; c < k; ++c) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T u = H[i][r * 6 + 0] * SS(i, 0, c);
#pragma unroll
          for (int j = 1; j < 6; ++j) u += H[i][r * 6 + j] * SS(i, j, c);
          U[d0 + c][r] = u;
        }
      }
      // D = S^T U + mu_ineq I, then its inverse
      T D[MULTI ? 36 : 1];
      for (int a = 0; a < k; ++a) {
        for (int c = 0; c < k; ++c) {
          T s = SS(i, 0, a) * U[d0 + c][0];
#pragma unroll
          for (int j = 1; j < 6; ++j) s += SS(i, j, a) * U[d0 + c][j];
          D[a * k + c] = s + mu_ineq * (a == c ? T(1) : T(0));
        }
      }
      if constexpr (MULTI)
        spd_inv(k, D, &Dinv[q0]);
      else
        Dinv[q0] = T(1) / D[0];
      const int par = cfg.parents[i];
      if (par >= 0) {
        T Ha[36], R[9], pp[3];
        // U D^-1
        for (int c = 0; c < k; ++c) {
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            T s = U[d0][r] * Dinv[q0 + c];
            for (int j = 1; j < k; ++j) s += U[d0 + j][r] * Dinv[q0 + j * k + c];
            UDinv[d0 + c][r] = s;
          }
        }
        // Ha = H - (U D^-1) U^T
#pragma unroll
        for (int r = 0; r < 6; ++r) {
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            T s = UDinv[d0][r] * U[d0][c];
            for (int j = 1; j < k; ++j) s += UDinv[d0 + j][r] * U[d0 + j][c];
            Ha[r * 6 + c] = H[i][r * 6 + c] - s;
          }
        }
        load_liMi(P, B, b, i, R, pp);
        add_act_sym6(R, pp, Ha, H[par]);
      }
    }

    // ---------------- K ADMM iterations (solve.py::_iteration) ----------
    // the last one computes the residuals, tolerances and certificates
    T rp = T(0), rd = T(0), dx = T(0), dz = T(0);
    T tol_p = T(0), tol_d = T(0);
    bool pinf_cond = false;
    for (int m = 0; m < K; ++m) {
      const bool checks = (m == K - 1);

      // FwdPass1
      for (int i = 0; i < N; ++i) {
        const int k = NVS(i), d0 = DOF0(i);
        for (int a = 0; a < k; ++a) {
          T r = AT(P.w, i * KP + a) - mu_ineq * AT(P.z, i * KP + a);
          if (P.r_offset) r += AT(P.r_offset, i * KP + a);
          rt[d0 + a] = r;
        }
#pragma unroll
        for (int e = 0; e < 6; ++e)
          pl[i][e] = -rho * AT(P.vis, i * 6 + e) - AT(P.Hv, i * 6 + e);
      }
      for (int k = 0; k < NC; ++k) {
        const int c = cfg.clinks[k];
#pragma unroll
        for (int e = 0; e < 6; ++e)
          pl[c][e] = pl[c][e] + AT(P.Aty, k * 6 + e) - mu_eq * AT(P.Atb, k * 6 + e);
      }

      // BwdPass: the p/r recursion, leaf to root
      for (int i = N - 1; i >= 0; --i) {
        const int k = NVS(i), d0 = DOF0(i);
        for (int a = 0; a < k; ++a) {
          T sp = SS(i, 0, a) * pl[i][0];
#pragma unroll
          for (int j = 1; j < 6; ++j) sp += SS(i, j, a) * pl[i][j];
          rt[d0 + a] = rt[d0 + a] + sp;
        }
        const int par = cfg.parents[i];
        if (par >= 0) {
          T pa[6], f[6], R[9], pp[3];
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            T s = UDinv[d0][e] * rt[d0];
            for (int j = 1; j < k; ++j) s += UDinv[d0 + j][e] * rt[d0 + j];
            pa[e] = pl[i][e] - s;
          }
          load_liMi(P, B, b, i, R, pp);
          act_force(R, pp, pa, f);
#pragma unroll
          for (int e = 0; e < 6; ++e) pl[par][e] += f[e];
        }
      }

      // FwdPass2, root to leaf; vis/fis/nu are updated in place, so a
      // parent's new velocity is read back from the state
      T dvis = T(0), dfis = T(0), dnu = T(0), nu_inf = T(0);
      for (int i = 0; i < N; ++i) {
        const int k = NVS(i), d0 = DOF0(i), q0 = BLK0(i);
        const int par = cfg.parents[i];
        T vpar[6], vloc[6], R[9], pp[3];
#pragma unroll
        for (int e = 0; e < 6; ++e) vpar[e] = par >= 0 ? AT(P.vis, par * 6 + e) : T(0);
        load_liMi(P, B, b, i, R, pp);
        act_inv_motion(R, pp, vpar, vloc);
        T rhs[MULTI ? 6 : 1], nuv[MULTI ? 6 : 1];
        for (int a = 0; a < k; ++a) {
          T s = U[d0 + a][0] * vloc[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) s += U[d0 + a][j] * vloc[j];
          rhs[a] = s + rt[d0 + a];
        }
        for (int a = 0; a < k; ++a) {
          T s = Dinv[q0 + a * k] * rhs[0];
          for (int j = 1; j < k; ++j) s += Dinv[q0 + a * k + j] * rhs[j];
          nuv[a] = -s;
        }
        T v[6];
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          T s = SS(i, e, 0) * nuv[0];
          for (int j = 1; j < k; ++j) s += SS(i, e, j) * nuv[j];
          v[e] = vloc[e] + s;
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T f = H[i][r * 6 + 0] * v[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) f += H[i][r * 6 + j] * v[j];
          f += pl[i][r];
          if (checks) {
            dvis = nmax(dvis, absv(v[r] - AT(P.vis, i * 6 + r)));
            dfis = nmax(dfis, absv(f - AT(P.fis, i * 6 + r)));
          }
          AT(P.vis, i * 6 + r) = v[r];
          AT(P.fis, i * 6 + r) = f;
        }
        for (int a = 0; a < k; ++a) {
          if (checks) {
            dnu = nmax(dnu, absv(nuv[a] - AT(P.nu, i * KP + a)));
            nu_inf = nmax(nu_inf, absv(nuv[a]));
          }
          AT(P.nu, i * KP + a) = nuv[a];
        }
      }

      // BoxProj and the box-dual update
      T slack = T(0), dw_inf = T(0), ub_dw = T(0), lb_dw = T(0);
      for (int i = 0; i < N; ++i) {
        const int k = NVS(i);
        for (int a = 0; a < k; ++a) {
          const int s = i * KP + a;
          const T nui = AT(P.nu, s), wi = AT(P.w, s);
          const T zi = clip(nui + wi / mu_ineq, AT(P.lb, s), AT(P.ub, s));
          const T dw = mu_ineq * (nui - zi);
          if (checks) {
            dz = nmax(dz, absv(zi - AT(P.z, s)));
            slack = nmax(slack, absv(nui - zi));
            dw_inf = nmax(dw_inf, absv(dw));
            ub_dw += AT(P.ub, s) * nmax(dw, T(0));
            lb_dw += AT(P.lb, s) * nmin(dw, T(0));
          }
          AT(P.z, s) = zi;
          AT(P.w, s) = wi + dw;
        }
      }

      // DualUpdate of the task duals
      T Av_inf = T(0), task = T(0), dy_inf = T(0), b_dy_plus = T(0), b_dy_minus = T(0);
      for (int k = 0; k < NC; ++k) {
        const int c = cfg.clinks[k];
        T y[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T av = AT(P.A, k * 36 + r * 6 + 0) * AT(P.vis, c * 6 + 0);
#pragma unroll
          for (int j = 1; j < 6; ++j) av += AT(P.A, k * 36 + r * 6 + j) * AT(P.vis, c * 6 + j);
          const T bk = AT(P.b, k * 6 + r);
          const T avmb = av - bk;
          const T dy = mu_eq * avmb;
          if (checks) {
            Av_inf = nmax(Av_inf, absv(av));
            task = nmax(task, absv(avmb));
            dy_inf = nmax(dy_inf, absv(dy));
            b_dy_plus += bk * nmax(dy, T(0));
            b_dy_minus += bk * nmin(dy, T(0));
          }
          y[r] = AT(P.yis, k * 6 + r) + dy;
          AT(P.yis, k * 6 + r) = y[r];
        }
#pragma unroll
        for (int cc = 0; cc < 6; ++cc) {
          T aty = AT(P.A, k * 36 + 0 * 6 + cc) * y[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) aty += AT(P.A, k * 36 + j * 6 + cc) * y[j];
          AT(P.Aty, k * 6 + cc) = aty;
        }
      }
      if (!checks) continue;

      // dual residual: the BwdPass2 recursion
      // fdpa[i] = (A^T y)_i - f_i + sum_children X* f_child ; stfw = S^T f + w
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 6; ++e) facc[i][e] = T(0);
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int e = 0; e < 6; ++e) facc[cfg.clinks[k]][e] = AT(P.Aty, k * 6 + e);
      for (int i = N - 1; i >= 0; --i) {
        T f[6];
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          f[e] = AT(P.fis, i * 6 + e);
          facc[i][e] = facc[i][e] - f[e];
        }
        const int par = cfg.parents[i];
        if (par >= 0) {
          T g[6], R[9], pp[3];
          load_liMi(P, B, b, i, R, pp);
          act_force(R, pp, f, g);
#pragma unroll
          for (int e = 0; e < 6; ++e) facc[par][e] += g[e];
        }
      }
      T dfdpa = T(0), fdpa_inf = T(0), dstfw = T(0), stfw_inf = T(0);
      T href_inf = T(0), drv = T(0);
      for (int i = 0; i < N; ++i) {
        const int k = NVS(i);
        for (int a = 0; a < k; ++a) {
          const int s = i * KP + a;
          T stf = SS(i, 0, a) * AT(P.fis, i * 6 + 0);
#pragma unroll
          for (int j = 1; j < 6; ++j) stf += SS(i, j, a) * AT(P.fis, i * 6 + j);
          stf += AT(P.w, s);
          if (P.r_offset) stf += AT(P.r_offset, s);
          dstfw = nmax(dstfw, absv(stf - AT(P.stfw, s)));
          stfw_inf = nmax(stfw_inf, absv(stf));
          AT(P.stfw, s) = stf;
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          T hv = AT(P.H_ref, i * 36 + r * 6 + 0) * AT(P.vis, i * 6 + 0);
#pragma unroll
          for (int j = 1; j < 6; ++j) hv += AT(P.H_ref, i * 36 + r * 6 + j) * AT(P.vis, i * 6 + j);
          const T fd = facc[i][r];
          href_inf = nmax(href_inf, absv(hv));
          drv = nmax(drv, absv(hv - AT(P.Hv, i * 6 + r) + fd));
          dfdpa = nmax(dfdpa, absv(fd - AT(P.fdpa, i * 6 + r)));
          fdpa_inf = nmax(fdpa_inf, absv(fd));
          AT(P.fdpa, i * 6 + r) = fd;
        }
      }

      rp = nmax(task, slack);
      rd = nmax(drv, stfw_inf);
      dx = nmax(dvis, dnu);
      // adaptive tolerances (loik-loid-optimized.hxx:540-565)
      T scale_p = nmax(nmax(Av_inf, nu_inf), P.b_inf[b]);
      T scale_d = nmax(nmax(href_inf, P.Hv_inf[b]), nmax(fdpa_inf, stfw_inf));
      if (P.tol_scale_primal) {
        scale_p = nmax(scale_p, P.tol_scale_primal[b]);
        scale_d = nmax(scale_d, P.tol_scale_dual[b]);
      }
      tol_p = tol_abs + tol_rel * scale_p;
      tol_d = tol_abs + tol_rel * scale_d;
      // infeasibility certificate (loik-loid-optimized.hxx:572-606)
      const T dy_all = nmax(dfis, nmax(dy_inf, dw_inf));
      const T At_dy = nmax(dfdpa, dstfw);
      pinf_cond = (At_dy <= tol_pinf * dy_all) &&
                  (b_dy_plus + ub_dw + b_dy_minus + lb_dw <= tol_pinf * dy_all);
    }

    // ---------------- flag transitions (solve.py:535-610) ---------------
    const bool in_tail = P.in_tail[b];
    const bool normal = !in_tail;
    const bool conv_now = normal && (rp < tol_p) && (rd < tol_d);
    const bool pinf_now = cfg.check_feasibility && normal && !conv_now &&
                          (it > 1) && pinf_cond;
    const bool in_tail_next = cfg.tail_solve ? (in_tail || pinf_now) : in_tail;
    const bool tail_done = in_tail_next && (dx < tol_tail) && (dz < tol_tail);
    if (normal && !conv_now && !pinf_now) {
      const T mu = P.mu[b];
      T mu_next = rp > T(10) * rd ? mu * T(10) : (rd > T(10) * rp ? mu * T(0.1) : mu);
      // clamp: repeated x0.1 under a residual floor underflows f32 to zero
      mu_next = clip(mu_next, T(1e-12), T(1e12));
      P.mu[b] = mu_next;
      P.mu_eq[b] = eq_scale * mu_next;
      P.mu_ineq[b] = mu_next;
    }
    const bool budget = in_tail_next ? (it + K <= cfg.max_iter)
                                     : (it + K <= cfg.max_iter - 1);
    P.rp[b] = rp;
    P.rd[b] = rd;
    P.dx[b] = dx;
    P.dz[b] = dz;
    P.converged[b] = P.converged[b] || conv_now;
    P.pinf[b] = P.pinf[b] || pinf_now;
    if (in_tail) P.tail_iterations[b] += K;
    P.in_tail[b] = in_tail_next;
    P.iterations[b] = it;
    P.running[b] = !conv_now && !tail_done && budget &&
                   (cfg.tail_solve || !pinf_now);
  }
  atomicMax(P.it, it);
#undef AT
#undef NVS
#undef SS
#undef DOF0
#undef BLK0
}

template <typename T>
static int launch(const LoikConfig* cfg, void* const* ptrs, int n_ptrs,
                  void* stream) {
  if (n_ptrs != P_COUNT || cfg->N < 1 || cfg->N > LOIK_MAX_JOINTS ||
      cfg->NC < 1 || cfg->NC > LOIK_MAX_CONSTRAINTS || cfg->B < 1 ||
      cfg->threads < 1 || cfg->threads > 1024 || cfg->check_interval < 1 ||
      cfg->nv_max < 1 || cfg->nv_max > 6)
    return (int)cudaErrorInvalidValue;
  // exactly one form of the subspaces; per-problem ones only for one-dof
  // chains of at most LOIK_SMALL_JOINTS joints
  const bool s_all = ptrs[P_S_ALL] != nullptr;
  if (s_all == (ptrs[P_S] != nullptr) ||
      (s_all && (cfg->nv_max != 1 || cfg->N > LOIK_SMALL_JOINTS)))
    return (int)cudaErrorInvalidValue;
  int nv = 0;
  for (int i = 0; i < cfg->N; ++i) {
    if (cfg->nvs[i] < 1 || cfg->nvs[i] > cfg->nv_max) return (int)cudaErrorInvalidValue;
    nv += cfg->nvs[i];
  }
  if (nv > LOIK_MAX_NV) return (int)cudaErrorInvalidValue;
  LoikPtrs<T> P;
  P.vis = (T*)ptrs[P_VIS];
  P.fis = (T*)ptrs[P_FIS];
  P.nu = (T*)ptrs[P_NU];
  P.z = (T*)ptrs[P_Z];
  P.w = (T*)ptrs[P_W];
  P.yis = (T*)ptrs[P_YIS];
  P.Aty = (T*)ptrs[P_ATY];
  P.fdpa = (T*)ptrs[P_FDPA];
  P.stfw = (T*)ptrs[P_STFW];
  P.mu = (T*)ptrs[P_MU];
  P.mu_eq = (T*)ptrs[P_MU_EQ];
  P.mu_ineq = (T*)ptrs[P_MU_INEQ];
  P.iterations = (int32_t*)ptrs[P_ITERATIONS];
  P.tail_iterations = (int32_t*)ptrs[P_TAIL_ITERATIONS];
  P.converged = (bool*)ptrs[P_CONVERGED];
  P.pinf = (bool*)ptrs[P_PINF];
  P.dinf = (bool*)ptrs[P_DINF];
  P.in_tail = (bool*)ptrs[P_IN_TAIL];
  P.running = (bool*)ptrs[P_RUNNING];
  P.rp = (T*)ptrs[P_RP];
  P.rd = (T*)ptrs[P_RD];
  P.dx = (T*)ptrs[P_DX];
  P.dz = (T*)ptrs[P_DZ];
  P.it = (int32_t*)ptrs[P_IT];
  P.H_ref = (const T*)ptrs[P_H_REF];
  P.Hv = (const T*)ptrs[P_HV];
  P.A = (const T*)ptrs[P_A];
  P.b = (const T*)ptrs[P_B];
  P.AtA = (const T*)ptrs[P_ATA];
  P.Atb = (const T*)ptrs[P_ATB];
  P.lb = (const T*)ptrs[P_LB];
  P.ub = (const T*)ptrs[P_UB];
  P.b_inf = (const T*)ptrs[P_B_INF];
  P.Hv_inf = (const T*)ptrs[P_HV_INF];
  P.r_offset = (const T*)ptrs[P_R_OFFSET];
  P.tol_scale_primal = (const T*)ptrs[P_TOL_SCALE_PRIMAL];
  P.tol_scale_dual = (const T*)ptrs[P_TOL_SCALE_DUAL];
  P.liMi_R = (const T*)ptrs[P_LIMI_R];
  P.liMi_p = (const T*)ptrs[P_LIMI_P];
  P.S = (const T*)ptrs[P_S];
  P.S_all = (const T*)ptrs[P_S_ALL];
  P.it_in = (const int32_t*)ptrs[P_IT_IN];
  const int blocks = (cfg->B + cfg->threads - 1) / cfg->threads;
  if (s_all)
    fused_admm_kernel<T, LOIK_SMALL_JOINTS, LOIK_SMALL_JOINTS, false, true>
        <<<blocks, cfg->threads, 0, (cudaStream_t)stream>>>(*cfg, P);
  else if (cfg->nv_max == 1 && cfg->N <= LOIK_SMALL_JOINTS)
    fused_admm_kernel<T, LOIK_SMALL_JOINTS, LOIK_SMALL_JOINTS, false, false>
        <<<blocks, cfg->threads, 0, (cudaStream_t)stream>>>(*cfg, P);
  else
    fused_admm_kernel<T, LOIK_MAX_JOINTS, LOIK_MAX_NV, true, false>
        <<<blocks, cfg->threads, 0, (cudaStream_t)stream>>>(*cfg, P);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
int loik_fused_admm_f32(const LoikConfig* cfg, void* const* ptrs, int n_ptrs,
                        void* stream) {
  return launch<float>(cfg, ptrs, n_ptrs, stream);
}

int loik_fused_admm_f64(const LoikConfig* cfg, void* const* ptrs, int n_ptrs,
                        void* stream) {
  return launch<double>(cfg, ptrs, n_ptrs, stream);
}

// The compile-time layout the wrapper must agree with.
void loik_fused_admm_abi(int* max_joints, int* max_nv, int* max_constraints,
                         int* small_joints, int* n_ptrs, int* config_bytes) {
  *max_joints = LOIK_MAX_JOINTS;
  *max_nv = LOIK_MAX_NV;
  *max_constraints = LOIK_MAX_CONSTRAINTS;
  *small_joints = LOIK_SMALL_JOINTS;
  *n_ptrs = P_COUNT;
  *config_bytes = (int)sizeof(LoikConfig);
}

const char* loik_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
