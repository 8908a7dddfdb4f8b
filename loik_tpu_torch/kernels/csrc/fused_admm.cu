// Fused ADMM solve loop for NVIDIA Hopper (sm_90a): the whole masked
// while-loop of `loik_tpu_torch.solver.solve.make_loop_body`, run to
// termination, one thread per problem.
//
// Replaces: loik_tpu/kernels/fused.py::_kernel (the Pallas TPU kernel, whose
// body is loik_tpu/solver/solve.py::make_loop_body -> _iteration + _h_sweep).
// Written from the solver math (solve.py:135-653), not from the Pallas carry
// plumbing.
//
// What bounds it on this card: at the flagship batch (B = 16384 problems of
// a 7-joint arm) one thread per problem gives ~124 threads per SM on 132
// SMs, far below the 2048 an SM can hold, and every problem is a long,
// data-dependent chain of tiny 6x6 products and tree recursions.  The kernel
// is latency- and occupancy-bound, not bandwidth-bound: the working set is a
// few KB per problem (~45 MB in total, inside the 50 MB L2), and the per-
// thread arrays below live in local memory.  This first version does nothing
// about that; several lanes per problem (a warp-cooperative 6x6 sweep) is the
// planned next step (ROADMAP queue 2).
//
// Design:
// - Thread b owns problem b.  Element (i, ..., b) of a trailing-batch tensor
//   sits at flat_index * B + b, so the loads and stores of a warp coalesce.
//   Threads with b >= B return, which masks the ragged edge.
// - Per-problem exit.  The Pallas tile ran every problem to the tile's
//   slowest member under masked merges.  Here each thread runs its own
//   `while (running)` loop with its own counter it += K.  That gives the
//   same per-problem results: a problem that stops never restarts
//   (running_next = active & ..., solve.py:588), a stopped problem's state
//   is frozen by the merge, and `iterations` is written only while the
//   problem is active.  Inside its own loop a thread is always active, so
//   the masked merge becomes a plain store, and the global counter the tile
//   would have used equals this thread's counter at each of its body calls.
// - In place.  The wrapper clones the input state; this kernel updates the
//   clones in place (only thread b touches column b).  The loop counter `it`
//   starts from the input state's and ends as the largest over the problems
//   (atomicMax), which is the value the eager loop's shared counter ends at.
// - Topology at run time: parents, constraint links and the per-joint motion
//   subspace S (N, 6) arrive in the by-value config struct.  S is
//   iteration-constant data computed on the host by KinematicTree.joint_S.
//   1-dof joints only, so D and D^-1 are scalars.
// - The K > 1 hoist (solve.py:516-528): the H half of the Riccati sweep
//   (H_list, U, D^-1, U D^-1) depends only on (mu_eq, mu_ineq, liMi) and is
//   computed once per body call, then shared by the K-1 check-free
//   micro-iterations and the checked one.  K = 1 computes it once too.
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

#define LOIK_MAX_JOINTS 16
#define LOIK_MAX_CONSTRAINTS 8

// Keep in step with kernels/fused.py::_LoikConfig (same order and types).
struct LoikConfig {
  int B, N, NC, threads;
  int max_iter, check_interval, check_feasibility, tail_solve;
  int parents[LOIK_MAX_JOINTS];
  int clinks[LOIK_MAX_CONSTRAINTS];
  double S[LOIK_MAX_JOINTS][6];
  double rho, tol_abs, tol_rel, tol_primal_inf, tol_tail_solve, mu_eq_scale;
};

// Order of the pointer array; keep in step with kernels/fused.py (the 24
// state fields of _STATE_FIELDS, the 10 of _PROB_FIELDS, the 3 optional
// delta-stage fields, liMi, then the input state's loop counter).
enum LoikPtr {
  P_VIS, P_FIS, P_NU, P_Z, P_W, P_YIS, P_ATY, P_FDPA, P_STFW,
  P_MU, P_MU_EQ, P_MU_INEQ, P_ITERATIONS, P_TAIL_ITERATIONS,
  P_CONVERGED, P_PINF, P_DINF, P_IN_TAIL, P_RUNNING,
  P_RP, P_RD, P_DX, P_DZ, P_IT,
  P_H_REF, P_HV, P_A, P_B, P_ATA, P_ATB, P_LB, P_UB, P_B_INF, P_HV_INF,
  P_R_OFFSET, P_TOL_SCALE_PRIMAL, P_TOL_SCALE_DUAL,
  P_LIMI_R, P_LIMI_P, P_IT_IN,
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

template <typename T>
__global__ void fused_admm_kernel(const __grid_constant__ LoikConfig cfg,
                                  const __grid_constant__ LoikPtrs<T> P) {
  const int B = cfg.B;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = cfg.N, NC = cfg.NC, K = cfg.check_interval;
  // element f of problem b in a trailing-batch tensor
#define AT(ptr, f) (ptr)[(size_t)(f) * B + b]

  const T rho = T(cfg.rho);
  const T tol_abs = T(cfg.tol_abs), tol_rel = T(cfg.tol_rel);
  const T tol_pinf = T(cfg.tol_primal_inf), tol_tail = T(cfg.tol_tail_solve);
  const T eq_scale = T(cfg.mu_eq_scale);

  // the H half of the Riccati sweep, hoisted per body call
  T H[LOIK_MAX_JOINTS][36];
  T U[LOIK_MAX_JOINTS][6], UDinv[LOIK_MAX_JOINTS][6], Dinv[LOIK_MAX_JOINTS];
  // per-iteration recursions
  T pl[LOIK_MAX_JOINTS][6], rt[LOIK_MAX_JOINTS], facc[LOIK_MAX_JOINTS][6];

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
      T s[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) s[j] = T(cfg.S[i][j]);
      T D = T(0);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T u = H[i][r * 6 + 0] * s[0];
#pragma unroll
        for (int j = 1; j < 6; ++j) u += H[i][r * 6 + j] * s[j];
        U[i][r] = u;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) D += s[j] * U[i][j];
      Dinv[i] = T(1) / (D + mu_ineq);
      const int par = cfg.parents[i];
      if (par >= 0) {
        T Ha[36], R[9], pp[3];
#pragma unroll
        for (int r = 0; r < 6; ++r) UDinv[i][r] = U[i][r] * Dinv[i];
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = 0; c < 6; ++c)
            Ha[r * 6 + c] = H[i][r * 6 + c] - UDinv[i][r] * U[i][c];
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
        T r = AT(P.w, i) - mu_ineq * AT(P.z, i);
        if (P.r_offset) r += AT(P.r_offset, i);
        rt[i] = r;
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
        T sp = T(cfg.S[i][0]) * pl[i][0];
#pragma unroll
        for (int j = 1; j < 6; ++j) sp += T(cfg.S[i][j]) * pl[i][j];
        rt[i] = rt[i] + sp;
        const int par = cfg.parents[i];
        if (par >= 0) {
          T pa[6], f[6], R[9], pp[3];
#pragma unroll
          for (int e = 0; e < 6; ++e) pa[e] = pl[i][e] - UDinv[i][e] * rt[i];
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
        const int par = cfg.parents[i];
        T vpar[6], vloc[6], R[9], pp[3];
#pragma unroll
        for (int e = 0; e < 6; ++e) vpar[e] = par >= 0 ? AT(P.vis, par * 6 + e) : T(0);
        load_liMi(P, B, b, i, R, pp);
        act_inv_motion(R, pp, vpar, vloc);
        T rhs = U[i][0] * vloc[0];
#pragma unroll
        for (int j = 1; j < 6; ++j) rhs += U[i][j] * vloc[j];
        rhs += rt[i];
        const T nui = -(Dinv[i] * rhs);
        T v[6];
#pragma unroll
        for (int e = 0; e < 6; ++e) v[e] = vloc[e] + T(cfg.S[i][e]) * nui;
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
        if (checks) {
          dnu = nmax(dnu, absv(nui - AT(P.nu, i)));
          nu_inf = nmax(nu_inf, absv(nui));
        }
        AT(P.nu, i) = nui;
      }

      // BoxProj and the box-dual update
      T slack = T(0), dw_inf = T(0), ub_dw = T(0), lb_dw = T(0);
      for (int i = 0; i < N; ++i) {
        const T nui = AT(P.nu, i), wi = AT(P.w, i);
        const T zi = clip(nui + wi / mu_ineq, AT(P.lb, i), AT(P.ub, i));
        const T dw = mu_ineq * (nui - zi);
        if (checks) {
          dz = nmax(dz, absv(zi - AT(P.z, i)));
          slack = nmax(slack, absv(nui - zi));
          dw_inf = nmax(dw_inf, absv(dw));
          ub_dw += AT(P.ub, i) * nmax(dw, T(0));
          lb_dw += AT(P.lb, i) * nmin(dw, T(0));
        }
        AT(P.z, i) = zi;
        AT(P.w, i) = wi + dw;
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
        T stf = T(cfg.S[i][0]) * AT(P.fis, i * 6 + 0);
#pragma unroll
        for (int j = 1; j < 6; ++j) stf += T(cfg.S[i][j]) * AT(P.fis, i * 6 + j);
        stf += AT(P.w, i);
        if (P.r_offset) stf += AT(P.r_offset, i);
        dstfw = nmax(dstfw, absv(stf - AT(P.stfw, i)));
        stfw_inf = nmax(stfw_inf, absv(stf));
        AT(P.stfw, i) = stf;
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
}

template <typename T>
static int launch(const LoikConfig* cfg, void* const* ptrs, int n_ptrs,
                  void* stream) {
  if (n_ptrs != P_COUNT || cfg->N < 1 || cfg->N > LOIK_MAX_JOINTS ||
      cfg->NC < 1 || cfg->NC > LOIK_MAX_CONSTRAINTS || cfg->B < 1 ||
      cfg->threads < 1 || cfg->threads > 1024 || cfg->check_interval < 1)
    return (int)cudaErrorInvalidValue;
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
  P.it_in = (const int32_t*)ptrs[P_IT_IN];
  const int blocks = (cfg->B + cfg->threads - 1) / cfg->threads;
  fused_admm_kernel<T><<<blocks, cfg->threads, 0, (cudaStream_t)stream>>>(*cfg, P);
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
void loik_fused_admm_abi(int* max_joints, int* max_constraints, int* n_ptrs,
                         int* config_bytes) {
  *max_joints = LOIK_MAX_JOINTS;
  *max_constraints = LOIK_MAX_CONSTRAINTS;
  *n_ptrs = P_COUNT;
  *config_bytes = (int)sizeof(LoikConfig);
}

const char* loik_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
