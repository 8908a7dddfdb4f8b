// Fused ADMM solve loop for NVIDIA Hopper (sm_90a): the whole masked
// while-loop of `loik_tpu_torch.solver.solve.make_loop_body`, run to
// termination, a group of LOIK_LANES lanes per problem with the problem's
// working set in shared memory.
//
// Replaces: loik_tpu/kernels/fused.py::_kernel (the Pallas TPU kernel, whose
// body is loik_tpu/solver/solve.py::make_loop_body -> _iteration + _h_sweep,
// with the k x k D blocks of loik_tpu/solver/batched_spatial.py::spd_inv).
// Written from the solver math, not from the Pallas carry plumbing.
//
// Preconditions (kernels/fused.py::fused_eligibility names the first one a
// call breaks): at most LOIK_MAX_JOINTS joints with at most LOIK_MAX_NV
// dofs in all, joints of 1 to 6 dofs whose motion subspace does not depend
// on q, at most LOIK_MAX_CONSTRAINTS constraints on distinct links, a tile
// of problems per block with tile * LOIK_LANES <= 1024 threads whose frames
// fit the block's shared memory; per-problem subspaces (S_all) only for
// chains of at most LOIK_SMALL_JOINTS one-dof joints.
//
// What bounds it on this card: latency, not either roof.  Counting each input
// read once and each output written once against the iterations a run
// needs, the loop's floor is set by its bytes (a few KB per problem, some
// 0.02 to 0.03 ms per launch at HBM rate; chip_smoke.py computes it).  Every
// problem is a long, data-dependent chain of tiny 6x6 products and tree
// recursions, and a launch lasts as long as its slowest problem, so what
// the design shortens is the time ONE problem needs for ONE iteration:
// - the chain is split over lanes: lane r owns row r of every 6-vector and
//   6x6 of its problem, so a 6x6 product costs one lane 6 outputs, not 36;
// - the working set (H, U, U D^-1, D^-1, p, r, the joint transforms and the
//   whole iterate) lives in shared memory, sized by the tree (N joints, nv
//   dofs, NC constraints), not by the caps; device memory is read once on
//   the way in and written once on the way out.  H_ref and AtA, read once
//   per body call (and H_ref once more in the checks), stay in device
//   memory with several loads in flight: in the frame they made the long
//   problems 8% faster and, by the room they take from other problems, the
//   full launches 7 to 20% slower (PERF.md);
// - no thread has a joint-indexed array of its own, so there is no
//   local-memory frame.
// Tensor cores (wgmma) and TMA do not fit: the products are 6x6, chained
// through a tree, in float32 without FMA (every sum must round term by term
// like the eager loop), and the operands of one problem are a few hundred
// scattered words, not tiles.
//
// Design:
// - Lanes.  Threads g * LOIK_LANES .. g * LOIK_LANES + LOIK_LANES - 1 of a
//   block are the lanes of its problem g; LOIK_LANES = 8 divides a warp, six
//   lanes carry the rows, all eight share dof-indexed work (dof modulo
//   lanes).  The body is a sequence of PHASES; between two phases the warp
//   synchronises (__syncwarp) and a group exchanges through its frame in
//   shared memory.  Within a phase a lane reads only what an
//   earlier phase wrote or what it wrote itself, and writes nothing another
//   lane reads in that phase.  Where a small result is needed by all lanes
//   (a one-dof joint's D, r and nu, the parent's velocity in the joint's
//   frame) every lane computes it itself, the same bits, instead of waiting
//   for one more exchange.
// - Same bits.  Every output element is computed by ONE lane as the same sum
//   in the same term order as solver/batched_spatial.py and the eager loop;
//   lanes split outputs, never a sum.  The inf-norms are maxima (NaN
//   propagating from either side), which do not depend on the order, so each
//   lane keeps partial maxima and the group reduces them through shared
//   memory.  The four ordered sums of the infeasibility certificate (ub_dw,
//   lb_dw, b_dy_plus, b_dy_minus) are not: their terms are gathered to
//   shared memory and added by one lane in index order.
// - Frame.  `loik_layout` gives every field's offset in words of the scalar
//   type; kernels/fused.py::frame_words mirrors it, and the wrapper chooses
//   the problems per block (cfg.tile) from the same count.  The frame's
//   stride is odd in words, so the lanes of a warp's groups fall on
//   different banks.  Dof-indexed fields are compact (nv slots, not
//   N * nv_max); the block's loads map them from the padded tensors.
// - Coalescing.  Operands are trailing-batch (element f of problem b at
//   f * B + b).  A block loads them with ALL its threads striding over
//   (field, problem in block), problem innermost, so neighbouring threads
//   read neighbouring b, and hands them to the groups through shared memory;
//   the write-back goes the same way.  Problems b >= B are masked.
// - Per-problem exit.  Each problem has its own `running` flag and its own
//   counter it += K; a group whose problem has stopped skips every phase
//   (it only keeps the warp's synchronisations), so the problems of one
//   warp leave at different iterations and the warp leaves with the last.
//   That gives the masked loop's results: a problem that stops never
//   restarts, a stopped problem's state is frozen, and `iterations` is
//   written only while the problem is active.  The loop counter `it` ends
//   as the largest over the problems (atomicMax by one lane per group),
//   the value the eager loop's shared counter ends at.  A block ends with
//   its slowest problem.
// - In place.  The wrapper clones the input state; this kernel writes the
//   clones (only group b touches column b).
// - Topology at run time: parents, dofs per joint and constraint links
//   arrive in the by-value config struct.  The motion subspaces S are one
//   (N, 6, nv_max) tensor shared by all problems (zero-padded columns past
//   a joint's dofs), copied once per block to shared memory; or per problem
//   (the TPU kernel's S_all input, loik_tpu/kernels/fused.py:285-306: the
//   mixed super-batch's padded chain), one more trailing-batch operand
//   (N, 6, 1, B) loaded into the frame.  Shared or per-problem is a template
//   parameter (SALL) of the one-dof instantiation.  A padded joint of a
//   mixed chain has S = 0: U = H S = 0 and D = mu, every product multiplies
//   through the zeros as the eager loop does, and its nu, z and w stay
//   exactly 0.
// - Joints of k dofs.  U = H S and U D^-1 are 6 x k, stored by dof
//   (U[dof][row]); D = S'HS + mu I is k x k and D^-1 comes from the unrolled
//   Cholesky + triangular inverse + M'M of batched_spatial.spd_inv, in its
//   operation order, on one lane (the trees here have one such joint, the
//   free-flyer root), stored at a running offset of k^2.  Every product with
//   S multiplies through, zeros included.  Padded dof slots of the
//   (N, nv_max, B) tensors are neither read nor written.
// - Three instantiations per scalar type: all joints 1-dof (every k is the
//   constant 1, D is a scalar) with shared S, the same with per-problem S,
//   and the general one.  `launch` picks by the tree and the operand.
// - The K > 1 hoist: the H half of the Riccati sweep (H_list, U, D^-1,
//   U D^-1) depends only on (mu_eq, mu_ineq, liMi) and is computed once per
//   body call, then shared by the K-1 check-free micro-iterations and the
//   checked one.  The rows of [p]x R of every joint transform are computed
//   once per launch.
// - Typed arithmetic: a template on the scalar type T, every literal T(...),
//   IEEE division (no fast math), and the library is compiled with
//   -fmad=false (kernels/_build.py), so no multiply-add is contracted into
//   an FMA: the float instantiation rounds operation for operation like the
//   eager loop and returns the same bits.  That is what makes the two
//   comparable at all: in float32 the solver's iteration counts change
//   under a one-ulp change of the inputs.  The double instantiation uses
//   the block form of the congruence (batched_spatial.act_sym6_block) on one
//   lane; it exists to check the kernel's logic at 1e-9.
// - Rehearsal without a card.  With LOIK_REHEARSAL defined (by the stub
//   cuda_runtime.h of tools/rehearse/) the same source compiles with g++: a
//   phase becomes a loop over the lanes of a group, in ascending or
//   descending order, so a missing synchronisation shows as a wrong bit;
//   tools/rehearse_kernel.py drives it through the real ctypes wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOIK_MAX_JOINTS 40
#define LOIK_MAX_NV 48
#define LOIK_MAX_CONSTRAINTS 8
// cap of the one-dof instantiation that takes per-problem subspaces
#define LOIK_SMALL_JOINTS 16
// lanes per problem: a power of two that divides a warp
#define LOIK_LANES 8
// partial maxima each lane keeps for the checks (enum LoikAcc)
#define LOIK_NACC 16
// shared memory one block may use on sm_90
#define LOIK_MAX_SMEM_BYTES 232448

// Keep in step with kernels/fused.py::_LoikConfig (same order and types).
// nv_max is the dof-slot stride of the padded (N, nv_max, B) tensors and of
// the columns of S; tile is the number of problems per block.
struct LoikConfig {
  int B, N, NC, nv_max, tile;
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

// One problem's frame in shared memory: offsets in words of the scalar
// type.  kernels/fused.py::frame_words computes the same `stride`.
struct LoikLayout {
  // the H half of the Riccati sweep; the checks' partial maxima reuse H
  int H, U, UDinv, Dinv;
  // per-iteration recursions
  int pl, facc, rt;
  // joint transforms: R (9), p (3) and the rows of [p]x R (9) per joint
  int R, p, pxR;
  // the iterate and the problem, by row
  int vis, fis, fdpa, Hv, yis, Aty, Atb, A, b;
  // the same by dof, compact
  int nu, z, w, stfw, lb, ub, roff;
  // scratch: Ha (36; also p_a and the reduced maxima), D (36), the terms of
  // the four ordered sums
  int Ha, D, tub, tlb, tbp, tbm;
  int S;    // per-problem subspaces (SALL), N * 6
  int sc;   // group scalars (enum LoikScalar)
  int stride;
  int blockS;  // words of the shared S ahead of the block's frames
  int nv;
  // first dof of each joint, offset of its D^-1 block; per compact dof its
  // slot in the padded (N, nv_max) tensors and its joint
  int dof0[LOIK_MAX_JOINTS], blk0[LOIK_MAX_JOINTS];
  int slot[LOIK_MAX_NV], jof[LOIK_MAX_NV];
};

enum LoikScalar { SC_RUNNING, SC_MU_EQ, SC_MU_INEQ, SC_COUNT };

enum LoikAcc {
  A_DVIS, A_DFIS, A_DNU, A_NU_INF, A_DZ, A_SLACK, A_DW_INF, A_AV_INF, A_TASK,
  A_DY_INF, A_DFDPA, A_FDPA_INF, A_DSTFW, A_STFW_INF, A_HREF_INF, A_DRV
};

static LoikLayout loik_layout(const LoikConfig& c, bool s_all) {
  LoikLayout o;
  const int N = c.N, NC = c.NC;
  int nv = 0, nd = 0;
  for (int i = 0; i < N; ++i) {
    o.dof0[i] = nv;
    o.blk0[i] = nd;
    for (int a = 0; a < c.nvs[i]; ++a) {
      o.slot[nv + a] = i * c.nv_max + a;
      o.jof[nv + a] = i;
    }
    nv += c.nvs[i];
    nd += c.nvs[i] * c.nvs[i];
  }
  o.nv = nv;
  int at = 0;
#define LOIK_FIELD(name, words) o.name = at; at += (words)
  const int hw = N * 36 > LOIK_NACC * LOIK_LANES ? N * 36 : LOIK_NACC * LOIK_LANES;
  LOIK_FIELD(H, hw);
  LOIK_FIELD(U, nv * 6);
  LOIK_FIELD(UDinv, nv * 6);
  LOIK_FIELD(Dinv, nd);
  LOIK_FIELD(pl, N * 6);
  LOIK_FIELD(facc, N * 6);
  LOIK_FIELD(rt, nv);
  LOIK_FIELD(R, N * 9);
  LOIK_FIELD(p, N * 3);
  LOIK_FIELD(pxR, N * 9);
  LOIK_FIELD(vis, N * 6);
  LOIK_FIELD(fis, N * 6);
  LOIK_FIELD(fdpa, N * 6);
  LOIK_FIELD(Hv, N * 6);
  LOIK_FIELD(yis, NC * 6);
  LOIK_FIELD(Aty, NC * 6);
  LOIK_FIELD(Atb, NC * 6);
  LOIK_FIELD(A, NC * 36);
  LOIK_FIELD(b, NC * 6);
  LOIK_FIELD(nu, nv);
  LOIK_FIELD(z, nv);
  LOIK_FIELD(w, nv);
  LOIK_FIELD(stfw, nv);
  LOIK_FIELD(lb, nv);
  LOIK_FIELD(ub, nv);
  LOIK_FIELD(roff, nv);
  LOIK_FIELD(Ha, 36);
  LOIK_FIELD(D, 36);
  LOIK_FIELD(tub, nv);
  LOIK_FIELD(tlb, nv);
  LOIK_FIELD(tbp, NC * 6);
  LOIK_FIELD(tbm, NC * 6);
  LOIK_FIELD(S, s_all ? N * 6 : 0);
  LOIK_FIELD(sc, SC_COUNT);
#undef LOIK_FIELD
  o.stride = at | 1;
  o.blockS = s_all ? 0 : N * 6 * c.nv_max;
  return o;
}

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


// ---- how a phase runs ------------------------------------------------------
// On the card every lane of a live group runs the phase's code and the warp
// meets after it: the groups of a warp (32 / LOIK_LANES problems) go through
// the phases together, as one converged warp, until the last of them has
// left the loop; a group whose problem has stopped is not live and skips
// the phases' code.  (Each group synchronising on its own lanes only, so
// that the groups of a warp run as separate diverged paths, was measured 2
// to 7% slower, PERF.md.)  In the rehearsal a phase is a loop over the
// lanes, a block-wide pass a loop over the block's threads, and the groups
// of a block run one after another.
#ifdef LOIK_REHEARSAL
#define LOIK_LANES_BEGIN                                              \
  if (live_)                                                          \
    for (int lane_i_ = 0; lane_i_ < LOIK_LANES; ++lane_i_) {          \
      const int lane = loik_rehearsal_descending ? LOIK_LANES - 1 - lane_i_ : lane_i_;
#define LOIK_LANES_END }
#define LOIK_LANE_SLOT lane
#define LOIK_LANE_SLOTS LOIK_LANES
#define LOIK_THREADS_BEGIN                                            \
  for (int tid = 0, nthr = (int)blockDim.x; tid < nthr; ++tid) {
#define LOIK_THREADS_END }
#define LOIK_GROUPS_BEGIN                                             \
  for (int grp = 0; grp < (int)blockDim.x / LOIK_LANES; ++grp) {      \
    const int lane = 0;                                               \
    const unsigned mask = 0u;
#define LOIK_GROUPS_END }
#define LOIK_ANY_LIVE(mask, live) (live)
#else
#define LOIK_LANES_BEGIN if (live_) {
#define LOIK_LANES_END } __syncwarp(mask);
#define LOIK_LANE_SLOT 0
#define LOIK_LANE_SLOTS 1
#define LOIK_THREADS_BEGIN {                                          \
    const int tid = (int)threadIdx.x, nthr = (int)blockDim.x;
#define LOIK_THREADS_END } __syncthreads();
#define LOIK_ANY_LIVE(mask, live) __any_sync(mask, live)
// the warp is converged here (after the block's barrier): mask = its threads
#define LOIK_GROUPS_BEGIN {                                           \
    const int grp = (int)threadIdx.x / LOIK_LANES;                    \
    const int lane = (int)threadIdx.x % LOIK_LANES;                   \
    const unsigned mask = __activemask();
#define LOIK_GROUPS_END } __syncthreads();
#endif
// The group's loop: `live_` says whether this group's problem is still in
// it; the loop ends when no group of the warp is.
#define LOIK_WHILE(running)                                           \
  for (;;) {                                                          \
    live_ = valid_ && (running);                                      \
    if (!LOIK_ANY_LIVE(mask, live_)) break;
#define LOIK_END_WHILE                                                \
  }                                                                   \
  live_ = valid_;

// Built with -DLOIK_PROFILE (tools/kernel_sections.py), lane 0 of problem 0
// adds up the cycles (clock64) between the marks LOIK_MARK(section) and
// prints them when the problem leaves the loop.  Off otherwise.
enum LoikSection {
  SEC_H_INIT, SEC_U, SEC_D_HA, SEC_CONGRUENCE, SEC_P_INIT, SEC_BWD_R, SEC_BWD_P,
  SEC_FWD, SEC_BOX_DUAL, SEC_RESIDUAL, SEC_REDUCE, SEC_FLAGS, SEC_EMPTY8, SEC_LDS8, SEC_LDC8, SEC_DIV8, SEC_FADD8, SEC_RMW8, SEC_RMW8_SIX, SEC_COUNT
};
#if defined(LOIK_PROFILE) && !defined(LOIK_REHEARSAL)
#include <stdio.h>
#define LOIK_MARK(section)                        \
  if (lane == 0 && b == 0) {                      \
    const long long t_ = clock64();               \
    prof_[section] += t_ - prof_last_;            \
    prof_last_ = t_;                              \
  }
#else
#define LOIK_MARK(section)
#endif

// What a lane keeps between phases: its partial maxima and, on lane 0, the
// problem's scalars and flags.
template <typename T>
struct LoikLane {
  T acc[LOIK_NACC];
  T mu, b_inf, Hv_inf, tsp, tsd, rp, rd, dx, dz;
  int it, tail_iterations;
  bool in_tail, converged, pinf, ran;
};

// entry e of X* f = [R f_lin ; R f_ang + p x (R f_lin)]
// (batched_spatial.act_force).  No branch on e: the lanes of a group call it
// with different e, and a branch would run their paths one after another.
template <typename T>
__device__ __forceinline__ T act_force_row(const T* R, const T* p, const T* f, int e) {
  const int r = e < 3 ? e : e - 3;
  const T* Rr = R + r * 3;
  const T* fe = e < 3 ? f : f + 3;
  const T base = Rr[0] * fe[0] + Rr[1] * fe[1] + Rr[2] * fe[2];
  // row r of p x l with l = R f_lin: p[a] l[c] - p[c] l[a], a = r + 1, c = r + 2 mod 3
  const int a = r == 2 ? 0 : r + 1, c = r == 0 ? 2 : r - 1;
  const T la = R[a * 3 + 0] * f[0] + R[a * 3 + 1] * f[1] + R[a * 3 + 2] * f[2];
  const T lc = R[c * 3 + 0] * f[0] + R[c * 3 + 1] * f[1] + R[c * 3 + 2] * f[2];
  const T cross = p[a] * lc - p[c] * la;
  return e < 3 ? base : base + cross;
}

// out = X^-1 v: lin = R^T (v_lin - p x v_ang); ang = R^T v_ang
// (batched_spatial.act_inv_motion)
template <typename T>
__device__ __forceinline__ void act_inv_motion(const T* R, const T* p, const T v[6],
                                               T out[6]) {
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

// entry (c, j) of X* = [[R, 0], [[p]x R, R]] from R and the rows of [p]x R
template <typename T>
__device__ __forceinline__ T xstar(const T* R, const T* pxR, int c, int j) {
  if (c < 3) return j < 3 ? R[c * 3 + j] : T(0);
  return j < 3 ? pxR[(c - 3) * 3 + j] : R[(c - 3) * 3 + j - 3];
}

// Row r of Hpar += X* Ha X*^T, the dense form: two 6x6 products
// (batched_spatial.act_sym6_dense, the float form).  The lane reads all of
// Ha and writes its own row of Hpar.
template <typename T>
__device__ __forceinline__ void add_act_sym6_dense_row(const T* R, const T* pxR,
                                                       const T* Ha, T* Hpar, int r) {
  T X[36];
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int j = 0; j < 6; ++j) X[c * 6 + j] = xstar(R, pxR, c, j);
  // the lane's own row, without a branch on r
  const T* lo = r < 3 ? R + r * 3 : pxR + (r - 3) * 3;
  const T* hi = R + (r < 3 ? r : r - 3) * 3;
  T Xr[6], Tm[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    Xr[j] = lo[j];
    Xr[3 + j] = r < 3 ? T(0) : hi[j];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T s = Xr[0] * Ha[0 * 6 + c];
#pragma unroll
    for (int j = 1; j < 6; ++j) s += Xr[j] * Ha[j * 6 + c];
    Tm[c] = s;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    T s = Tm[0] * X[c * 6 + 0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s += Tm[j] * X[c * 6 + j];
    Hpar[r * 6 + c] += s;
  }
}

// BwdPass at one joint of k <= KM dofs, on every lane (the same bits):
// r = w - mu_ineq z (+ r_offset) + S^T p, kept by lane a for dof a; then, if
// the joint has a parent, the lane's row of p_a = p - (U D^-1) r.  Si[j * sj
// + a] is entry (j, a) of the joint's S; w, z, roff and rt start at the
// joint's first dof.
template <typename T, int KM>
__device__ __forceinline__ void bwd_joint(int k, int lane, bool upward, bool has_roff,
                                          T mu_ineq, const T* Si, int sj, const T* w,
                                          const T* z, const T* roff, const T* pli,
                                          const T* UDi, T* rt, T* pa) {
  T rtv[KM];
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (KM == 1 || a < k) {
      T r = w[a] - mu_ineq * z[a];
      if (has_roff) r += roff[a];
      T sp = Si[a] * pli[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) sp += Si[j * sj + a] * pli[j];
      rtv[a] = r + sp;
      if (lane == a) rt[a] = rtv[a];
    }
  }
  if (upward && lane < 6) {
    T s = UDi[lane] * rtv[0];
#pragma unroll
    for (int j = 1; j < KM; ++j)
      if (j < k) s += UDi[j * 6 + lane] * rtv[j];
    pa[lane] = pli[lane] - s;
  }
}

// FwdPass2 at one joint of k <= KM dofs, lanes 0..5: every lane forms the
// joint's rate nu = -D^-1 (U^T X^-1 v_parent + r) (the same bits) and its own
// row of the link velocity v = X^-1 v_parent + S nu; lane a keeps nu[a].
// vpar is the parent's new velocity (nullptr at a root).
template <typename T, int KM>
__device__ __forceinline__ void fwd_joint(int k, int lane, bool checks, const T* Si, int sj,
                                          const T* R, const T* p, const T* vparp,
                                          const T* Ui, const T* Di, const T* rt, T* vis,
                                          T* nu, T* acc) {
  T vpar[6], vloc[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) vpar[e] = vparp ? vparp[e] : T(0);
  act_inv_motion(R, p, vpar, vloc);
  T rhs[KM], nuv[KM];
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (KM == 1 || a < k) {
      T s = Ui[a * 6 + 0] * vloc[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) s += Ui[a * 6 + j] * vloc[j];
      rhs[a] = s + rt[a];
    }
  }
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if (KM == 1 || a < k) {
      T s = Di[a * k] * rhs[0];
#pragma unroll
      for (int j = 1; j < KM; ++j)
        if (j < k) s += Di[a * k + j] * rhs[j];
      nuv[a] = -s;
    }
  }
  T s = Si[lane * sj] * nuv[0];
#pragma unroll
  for (int j = 1; j < KM; ++j)
    if (j < k) s += Si[lane * sj + j] * nuv[j];
  const T v = vloc[lane] + s;
  if (checks) acc[A_DVIS] = nmax(acc[A_DVIS], absv(v - vis[lane]));
  vis[lane] = v;
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    if ((KM == 1 || a < k) && lane == a) {
      if (checks) {
        acc[A_DNU] = nmax(acc[A_DNU], absv(nuv[a] - nu[a]));
        acc[A_NU_INF] = nmax(acc[A_NU_INF], absv(nuv[a]));
      }
      nu[a] = nuv[a];
    }
  }
}

// All threads of a block copy `n` elements per problem between a
// trailing-batch tensor and the block's frames, problem innermost, so that
// neighbouring threads touch neighbouring b.  `slot` maps a compact dof to
// its slot in the padded tensor (nullptr: element f is slot f).
template <typename T, bool STORE>
__device__ __forceinline__ void block_copy(T* frames, int stride, int off, T* g,
                                           int n, const int* slot, int tile, int b0,
                                           int B, int tid, int nthr) {
  for (int idx = tid; idx < n * tile; idx += nthr) {
    const int pb = idx % tile, f = idx / tile;
    const int b = b0 + pb;
    if (b >= B) continue;
    const size_t at = (size_t)(slot ? slot[f] : f) * B + b;
    if (STORE)
      g[at] = frames[(size_t)pb * stride + off + f];
    else
      frames[(size_t)pb * stride + off + f] = g[at];
  }
}

#ifdef LOIK_REHEARSAL
#define LOIK_DYNAMIC_SMEM(T) reinterpret_cast<T*>(loik_rehearsal_smem)
#else
extern __shared__ __align__(16) unsigned char loik_smem_raw[];
#define LOIK_DYNAMIC_SMEM(T) reinterpret_cast<T*>(loik_smem_raw)
#endif

// MULTI = false: every joint has one dof (k is the constant 1, so the dof
// loops vanish and D is a scalar).  SALL = true (one-dof trees only): the
// motion subspaces are per problem, in the frame, instead of the block's
// shared copy.
template <typename T, bool MULTI, bool SALL>
__global__ void fused_admm_kernel(const __grid_constant__ LoikConfig cfg,
                                  const __grid_constant__ LoikPtrs<T> P,
                                  const __grid_constant__ LoikLayout o) {
  constexpr int G = LOIK_LANES;
  constexpr int KMAX = MULTI ? 6 : 1;
  const int B = cfg.B, N = cfg.N, NC = cfg.NC, K = cfg.check_interval;
  const int nv = o.nv, tile = cfg.tile;
  // dof-slot stride of S
  const int KP = MULTI ? cfg.nv_max : 1;
  const int b0 = (int)blockIdx.x * tile;
  T* const blockS = LOIK_DYNAMIC_SMEM(T);
  T* const frames = blockS + o.blockS;
  const bool has_roff = P.r_offset != nullptr;
  // dofs of joint i, its first dof, the offset of its D^-1 block
#define NVS(i) (MULTI ? cfg.nvs[i] : 1)
#define DOF0(i) (MULTI ? o.dof0[i] : (i))
#define BLK0(i) (MULTI ? o.blk0[i] : (i))
  // entry (r, c) of joint i's 6 x k motion subspace
#define SS(i, r, c) (SALL ? F[o.S + (i) * 6 + (r)] : blockS[((i) * 6 + (r)) * KP + (c)])

  // ---------------- the block's operands, device memory -> frames ---------
  LOIK_THREADS_BEGIN
  if (!SALL)
    for (int e = tid; e < o.blockS; e += nthr) blockS[e] = P.S[e];
  const int* slot = MULTI ? o.slot : nullptr;
#define LOAD(off, ptr, n, map) \
  block_copy<T, false>(frames, o.stride, off, const_cast<T*>(ptr), n, map, tile, b0, B, tid, nthr)
  LOAD(o.vis, P.vis, N * 6, nullptr);
  LOAD(o.fis, P.fis, N * 6, nullptr);
  LOAD(o.fdpa, P.fdpa, N * 6, nullptr);
  LOAD(o.Hv, P.Hv, N * 6, nullptr);
  LOAD(o.R, P.liMi_R, N * 9, nullptr);
  LOAD(o.p, P.liMi_p, N * 3, nullptr);
  LOAD(o.yis, P.yis, NC * 6, nullptr);
  LOAD(o.Aty, P.Aty, NC * 6, nullptr);
  LOAD(o.Atb, P.Atb, NC * 6, nullptr);
  LOAD(o.A, P.A, NC * 36, nullptr);
  LOAD(o.b, P.b, NC * 6, nullptr);
  LOAD(o.nu, P.nu, nv, slot);
  LOAD(o.z, P.z, nv, slot);
  LOAD(o.w, P.w, nv, slot);
  LOAD(o.stfw, P.stfw, nv, slot);
  LOAD(o.lb, P.lb, nv, slot);
  LOAD(o.ub, P.ub, nv, slot);
  if (has_roff) LOAD(o.roff, P.r_offset, nv, slot);
  if (SALL) LOAD(o.S, P.S_all, N * 6, nullptr);
#undef LOAD
  LOIK_THREADS_END

  LOIK_GROUPS_BEGIN
  const int b = b0 + grp;
  {
    // a group past the end of the batch has a frame but no problem: it is
    // never live
    const bool valid_ = b < B;
    bool live_ = valid_;
    T* const F = frames + (size_t)grp * o.stride;
    // element f of problem b in a trailing-batch tensor
#define AT(ptr, f) (ptr)[(size_t)(f) * B + b]
    const T rho = T(cfg.rho);
    LoikLane<T> lanes_[LOIK_LANE_SLOTS];
#define LN lanes_[LOIK_LANE_SLOT]

    // the problem's scalars (lane 0) and the rows of [p]x R of every joint
    LOIK_LANES_BEGIN
    if (lane == 0) {
      LN.it = *P.it_in;
      LN.mu = P.mu[b];
      LN.b_inf = P.b_inf[b];
      LN.Hv_inf = P.Hv_inf[b];
      LN.tsp = P.tol_scale_primal ? P.tol_scale_primal[b] : T(0);
      LN.tsd = P.tol_scale_primal ? P.tol_scale_dual[b] : T(0);
      LN.rp = LN.rd = LN.dx = LN.dz = T(0);
      LN.tail_iterations = P.tail_iterations[b];
      LN.in_tail = P.in_tail[b];
      LN.converged = P.converged[b];
      LN.pinf = P.pinf[b];
      LN.ran = false;
      F[o.sc + SC_RUNNING] = P.running[b] ? T(1) : T(0);
      F[o.sc + SC_MU_EQ] = P.mu_eq[b];
      F[o.sc + SC_MU_INEQ] = P.mu_ineq[b];
    }
    for (int i = lane; i < N; i += G) {
      const T* R = F + o.R + i * 9;
      const T* p = F + o.p + i * 3;
      T* x = F + o.pxR + i * 9;
      // [p]x = [[0,-p2,p1],[p2,0,-p0],[-p1,p0,0]]
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[0 * 3 + c] = p[1] * R[2 * 3 + c] - p[2] * R[1 * 3 + c];
        x[1 * 3 + c] = p[2] * R[0 * 3 + c] - p[0] * R[2 * 3 + c];
        x[2 * 3 + c] = p[0] * R[1 * 3 + c] - p[1] * R[0 * 3 + c];
      }
    }
    LOIK_LANES_END

#if defined(LOIK_PROFILE) && !defined(LOIK_REHEARSAL)
    long long prof_[SEC_COUNT] = {0};
    long long prof_last_ = clock64();
    const long long prof_start_ = prof_last_;
#endif
    LOIK_WHILE(F[o.sc + SC_RUNNING] != T(0))
      LOIK_MARK(SEC_FLAGS)
#if defined(LOIK_PROFILE) && !defined(LOIK_REHEARSAL)
      // the price of a phase with nothing in it, eight times
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        LOIK_LANES_BEGIN
        LOIK_LANES_END
      }
      LOIK_MARK(SEC_EMPTY8)
      // eight phases that add one to a word per lane (Ha is scratch here),
      // on all lanes and on six of the eight
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        LOIK_LANES_BEGIN
        F[o.Ha + lane] = F[o.Ha + ((lane + 1) & 7)] + T(1);
        LOIK_LANES_END
      }
      LOIK_MARK(SEC_RMW8)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        LOIK_LANES_BEGIN
        if (lane < 6) F[o.Ha + lane] = F[o.Ha + 8 + ((lane + 1) & 7)] + F[o.Ha + 16 + lane] * T(3);
        LOIK_LANES_END
      }
      LOIK_MARK(SEC_RMW8_SIX)
      // and of eight dependent steps of what the phases are made of: a
      // shared-memory load, an indexed load from the kernel's parameters, a
      // division, an addition (results kept alive through the frame)
      {
        int at = 1;  // SC_RUNNING holds 1 here: each load's address needs the last load
#pragma unroll
        for (int e = 0; e < 8; ++e) at = (int)F[o.sc + SC_RUNNING + at - 1];
        LOIK_MARK(SEC_LDS8)
        int j = N - 1;
#pragma unroll
        for (int e = 0; e < 8; ++e) j = cfg.parents[j < 0 ? 0 : j] + at;
        LOIK_MARK(SEC_LDC8)
        T x = F[o.sc + SC_MU_INEQ] + T(j);
#pragma unroll
        for (int e = 0; e < 8; ++e) x = T(1) / (x + T(1));
        LOIK_MARK(SEC_DIV8)
#pragma unroll
        for (int e = 0; e < 8; ++e) x = x + F[o.sc + SC_MU_INEQ];
        LOIK_MARK(SEC_FADD8)
        if (x == T(-12345)) F[o.sc + SC_RUNNING] = x;
      }
#endif
      const T mu_eq = F[o.sc + SC_MU_EQ], mu_ineq = F[o.sc + SC_MU_INEQ];

      // ---------------- H sweep (solve.py::_h_sweep) --------------------
      // H = rho I + H_ref, + mu_eq AtA on the constrained links, straight
      // from device memory: sixteen loads in flight per lane, and flat entry
      // e of H is the same lane's (e modulo the lanes) in both steps
      LOIK_LANES_BEGIN
      const int n36 = N * 36;
      for (int base = lane; base < n36; base += 16 * G) {
        T h[16];
        // every load unconditional (past the end: the last entry again), so
        // that all sixteen are in flight before the first is used
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = base + u * G;
          h[u] = AT(P.H_ref, e < n36 ? e : n36 - 1);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = base + u * G;
          if (e < n36) F[o.H + e] = (e % 36 % 7 == 0 ? rho : T(0)) + h[u];
        }
      }
      for (int k = 0; k < NC; ++k) {
        const int c = cfg.clinks[k];
        const int e0 = (lane + G - c * 36 % G) % G;
        T a[(36 + G - 1) / G];
#pragma unroll
        for (int u = 0; u < (36 + G - 1) / G; ++u) {
          const int e = e0 + u * G;
          a[u] = AT(P.AtA, k * 36 + (e < 36 ? e : 35));
        }
#pragma unroll
        for (int u = 0; u < (36 + G - 1) / G; ++u)
          if (e0 + u * G < 36) F[o.H + c * 36 + e0 + u * G] += mu_eq * a[u];
      }
      LOIK_LANES_END
      LOIK_MARK(SEC_H_INIT)
      for (int i = N - 1; i >= 0; --i) {
        const int k = NVS(i), d0 = DOF0(i), q0 = BLK0(i);
        const int par = cfg.parents[i];
        T* const Hi = F + o.H + i * 36;
        T* const Ui = F + o.U + d0 * 6;
        T* const UDi = F + o.UDinv + d0 * 6;
        T* const Di = F + o.Dinv + q0;
        // U = H S, by row
        LOIK_LANES_BEGIN
        if (lane < 6) {
          for (int c = 0; c < k; ++c) {
            T u = Hi[lane * 6 + 0] * SS(i, 0, c);
#pragma unroll
            for (int j = 1; j < 6; ++j) u += Hi[lane * 6 + j] * SS(i, j, c);
            Ui[c * 6 + lane] = u;
          }
        }
        LOIK_LANES_END
        LOIK_MARK(SEC_U)
        if (k == 1) {
          // D = S^T U + mu_ineq and 1 / D on every lane (the same bits),
          // then U D^-1 and Ha = H - (U D^-1) U^T by row
          LOIK_LANES_BEGIN
          T s = SS(i, 0, 0) * Ui[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) s += SS(i, j, 0) * Ui[j];
          const T Dinv = T(1) / (s + mu_ineq * T(1));
          if (lane == 0) Di[0] = Dinv;
          if (par >= 0 && lane < 6) {
            const T ud = Ui[lane] * Dinv;
            UDi[lane] = ud;
#pragma unroll
            for (int c = 0; c < 6; ++c)
              F[o.Ha + lane * 6 + c] = Hi[lane * 6 + c] - ud * Ui[c];
          }
          LOIK_LANES_END
        } else if constexpr (MULTI) {
          // D = S^T U + mu_ineq I, its entries over the lanes
          LOIK_LANES_BEGIN
          for (int e = lane; e < k * k; e += G) {
            const int a = e / k, c = e % k;
            T s = SS(i, 0, a) * Ui[c * 6 + 0];
#pragma unroll
            for (int j = 1; j < 6; ++j) s += SS(i, j, a) * Ui[c * 6 + j];
            F[o.D + e] = s + mu_ineq * (a == c ? T(1) : T(0));
          }
          LOIK_LANES_END
          LOIK_LANES_BEGIN
          if (lane == 0) spd_inv(k, F + o.D, Di);
          LOIK_LANES_END
          if (par >= 0) {
            // U D^-1 and Ha = H - (U D^-1) U^T by row
            LOIK_LANES_BEGIN
            if (lane < 6) {
              for (int c = 0; c < k; ++c) {
                T s = Ui[lane] * Di[c];
                for (int j = 1; j < k; ++j) s += Ui[j * 6 + lane] * Di[j * k + c];
                UDi[c * 6 + lane] = s;
              }
#pragma unroll
              for (int c = 0; c < 6; ++c) {
                T s = UDi[lane] * Ui[c];
                for (int j = 1; j < k; ++j) s += UDi[j * 6 + lane] * Ui[j * 6 + c];
                F[o.Ha + lane * 6 + c] = Hi[lane * 6 + c] - s;
              }
            }
            LOIK_LANES_END
          }
        }
        LOIK_MARK(SEC_D_HA)
        if (par >= 0) {
          // H[par] += X* Ha X*^T in the form the eager loop uses for this
          // scalar type (batched_spatial.act_sym6), so the two round alike
          LOIK_LANES_BEGIN
          if constexpr (sizeof(T) == 8) {
            if (lane == 0)
              add_act_sym6_block(F + o.R + i * 9, F + o.p + i * 3, F + o.Ha,
                                 F + o.H + par * 36);
          } else {
            if (lane < 6)
              add_act_sym6_dense_row(F + o.R + i * 9, F + o.pxR + i * 9, F + o.Ha,
                                     F + o.H + par * 36, lane);
          }
          LOIK_LANES_END
          LOIK_MARK(SEC_CONGRUENCE)
        }
      }

      // ---------------- K ADMM iterations (solve.py::_iteration) --------
      // the last one computes the residuals, tolerances and certificates
      for (int m = 0; m < K; ++m) {
        const bool checks = (m == K - 1);

        // FwdPass1: p by row (r is formed where the BwdPass needs it)
        LOIK_LANES_BEGIN
        if (checks) {
#pragma unroll
          for (int a = 0; a < LOIK_NACC; ++a) LN.acc[a] = T(0);
        }
        if (lane < 6) {
          for (int i = 0; i < N; ++i)
            F[o.pl + i * 6 + lane] = -rho * F[o.vis + i * 6 + lane] - F[o.Hv + i * 6 + lane];
          for (int k = 0; k < NC; ++k) {
            const int c = cfg.clinks[k];
            F[o.pl + c * 6 + lane] = F[o.pl + c * 6 + lane] + F[o.Aty + k * 6 + lane] -
                                     mu_eq * F[o.Atb + k * 6 + lane];
          }
        }
        LOIK_LANES_END
        LOIK_MARK(SEC_P_INIT)

        // BwdPass: the p/r recursion, leaf to root
        for (int i = N - 1; i >= 0; --i) {
          const int k = NVS(i), d0 = DOF0(i);
          const int par = cfg.parents[i];
          const T* const pli = F + o.pl + i * 6;
          // r = w - mu_ineq z (+ r_offset) + S^T p on every lane (the same
          // bits), then p_a = p - (U D^-1) r by row
          LOIK_LANES_BEGIN
          const T* const Si = SALL ? F + o.S + i * 6 : blockS + i * 6 * KP;
          if (!MULTI || k == 1)
            bwd_joint<T, 1>(1, lane, par >= 0, has_roff, mu_ineq, Si, KP, F + o.w + d0,
                            F + o.z + d0, F + o.roff + d0, pli, F + o.UDinv + d0 * 6,
                            F + o.rt + d0, F + o.Ha);
          else
            bwd_joint<T, KMAX>(k, lane, par >= 0, has_roff, mu_ineq, Si, KP, F + o.w + d0,
                               F + o.z + d0, F + o.roff + d0, pli, F + o.UDinv + d0 * 6,
                               F + o.rt + d0, F + o.Ha);
          LOIK_LANES_END
          LOIK_MARK(SEC_BWD_R)
          if (par >= 0) {
            // p[par] += X* p_a by row
            LOIK_LANES_BEGIN
            if (lane < 6)
              F[o.pl + par * 6 + lane] +=
                  act_force_row(F + o.R + i * 9, F + o.p + i * 3, F + o.Ha, lane);
            LOIK_LANES_END
            LOIK_MARK(SEC_BWD_P)
          }
        }

        // FwdPass2, root to leaf.  Every lane forms the joint's rate nu from
        // the parent's new velocity (the same bits) and its own row of the
        // link velocity; the force row of the joint before it, which needs
        // all of that joint's velocity and is on no one's critical path,
        // follows in the same phase.
        for (int i = 0; i <= N; ++i) {
          LOIK_LANES_BEGIN
          if (i < N && lane < 6) {
            const int k = NVS(i), d0 = DOF0(i), q0 = BLK0(i);
            const int par = cfg.parents[i];
            const T* const Si = SALL ? F + o.S + i * 6 : blockS + i * 6 * KP;
            const T* const vparp = par >= 0 ? F + o.vis + par * 6 : nullptr;
            if (!MULTI || k == 1)
              fwd_joint<T, 1>(1, lane, checks, Si, KP, F + o.R + i * 9, F + o.p + i * 3, vparp,
                              F + o.U + d0 * 6, F + o.Dinv + q0, F + o.rt + d0,
                              F + o.vis + i * 6, F + o.nu + d0, LN.acc);
            else
              fwd_joint<T, KMAX>(k, lane, checks, Si, KP, F + o.R + i * 9, F + o.p + i * 3,
                                 vparp, F + o.U + d0 * 6, F + o.Dinv + q0, F + o.rt + d0,
                                 F + o.vis + i * 6, F + o.nu + d0, LN.acc);
          }
          if (i > 0 && lane < 6) {
            const int h = i - 1;
            const T* v = F + o.vis + h * 6;
            T f = F[o.H + h * 36 + lane * 6 + 0] * v[0];
#pragma unroll
            for (int j = 1; j < 6; ++j) f += F[o.H + h * 36 + lane * 6 + j] * v[j];
            f += F[o.pl + h * 6 + lane];
            if (checks)
              LN.acc[A_DFIS] = nmax(LN.acc[A_DFIS], absv(f - F[o.fis + h * 6 + lane]));
            F[o.fis + h * 6 + lane] = f;
          }
          LOIK_LANES_END
        }
        LOIK_MARK(SEC_FWD)

        // BoxProj and the box-dual update by dof; DualUpdate of the task
        // duals by row.  The terms of the ordered sums go to scratch.
        LOIK_LANES_BEGIN
        for (int d = lane; d < nv; d += G) {
          const T nui = F[o.nu + d], wi = F[o.w + d];
          const T zi = clip(nui + wi / mu_ineq, F[o.lb + d], F[o.ub + d]);
          const T dw = mu_ineq * (nui - zi);
          if (checks) {
            LN.acc[A_DZ] = nmax(LN.acc[A_DZ], absv(zi - F[o.z + d]));
            LN.acc[A_SLACK] = nmax(LN.acc[A_SLACK], absv(nui - zi));
            LN.acc[A_DW_INF] = nmax(LN.acc[A_DW_INF], absv(dw));
            F[o.tub + d] = F[o.ub + d] * nmax(dw, T(0));
            F[o.tlb + d] = F[o.lb + d] * nmin(dw, T(0));
          }
          F[o.z + d] = zi;
          F[o.w + d] = wi + dw;
        }
        if (lane < 6) {
          for (int k = 0; k < NC; ++k) {
            const T* A = F + o.A + k * 36 + lane * 6;
            const T* vc = F + o.vis + cfg.clinks[k] * 6;
            T av = A[0] * vc[0];
#pragma unroll
            for (int j = 1; j < 6; ++j) av += A[j] * vc[j];
            const T bk = F[o.b + k * 6 + lane];
            const T avmb = av - bk;
            const T dy = mu_eq * avmb;
            if (checks) {
              LN.acc[A_AV_INF] = nmax(LN.acc[A_AV_INF], absv(av));
              LN.acc[A_TASK] = nmax(LN.acc[A_TASK], absv(avmb));
              LN.acc[A_DY_INF] = nmax(LN.acc[A_DY_INF], absv(dy));
              F[o.tbp + k * 6 + lane] = bk * nmax(dy, T(0));
              F[o.tbm + k * 6 + lane] = bk * nmin(dy, T(0));
            }
            F[o.yis + k * 6 + lane] = F[o.yis + k * 6 + lane] + dy;
          }
        }
        LOIK_LANES_END
        LOIK_MARK(SEC_BOX_DUAL)
        LOIK_LANES_BEGIN
        if (lane < 6) {
          for (int k = 0; k < NC; ++k) {
            const T* A = F + o.A + k * 36;
            const T* y = F + o.yis + k * 6;
            T aty = A[0 * 6 + lane] * y[0];
#pragma unroll
            for (int j = 1; j < 6; ++j) aty += A[j * 6 + lane] * y[j];
            F[o.Aty + k * 6 + lane] = aty;
          }
        }
        if (checks) {
          // dual residual: the BwdPass2 recursion, every row on its own
          // fdpa[i] = (A^T y)_i - f_i + sum_children X* f_child ; stfw = S^T f + w
          if (lane < 6) {
            for (int i = 0; i < N; ++i) F[o.facc + i * 6 + lane] = T(0);
            for (int k = 0; k < NC; ++k)
              F[o.facc + cfg.clinks[k] * 6 + lane] = F[o.Aty + k * 6 + lane];
            for (int i = N - 1; i >= 0; --i) {
              F[o.facc + i * 6 + lane] = F[o.facc + i * 6 + lane] - F[o.fis + i * 6 + lane];
              const int par = cfg.parents[i];
              if (par >= 0)
                F[o.facc + par * 6 + lane] += act_force_row(
                    F + o.R + i * 9, F + o.p + i * 3, F + o.fis + i * 6, lane);
            }
            // row `lane` of H_ref of four joints at a time from device memory,
            // every load unconditional (past the end: the last joint again)
            for (int i0 = 0; i0 < N; i0 += 4) {
              T Hr[4][6];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int i = i0 + u < N ? i0 + u : N - 1;
#pragma unroll
                for (int j = 0; j < 6; ++j) Hr[u][j] = AT(P.H_ref, i * 36 + lane * 6 + j);
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int i = i0 + u;
                if (i < N) {
                  const T* v = F + o.vis + i * 6;
                  T hv = Hr[u][0] * v[0];
#pragma unroll
                  for (int j = 1; j < 6; ++j) hv += Hr[u][j] * v[j];
                  const T fd = F[o.facc + i * 6 + lane];
                  LN.acc[A_HREF_INF] = nmax(LN.acc[A_HREF_INF], absv(hv));
                  LN.acc[A_DRV] = nmax(LN.acc[A_DRV], absv(hv - F[o.Hv + i * 6 + lane] + fd));
                  LN.acc[A_DFDPA] = nmax(LN.acc[A_DFDPA], absv(fd - F[o.fdpa + i * 6 + lane]));
                  LN.acc[A_FDPA_INF] = nmax(LN.acc[A_FDPA_INF], absv(fd));
                  F[o.fdpa + i * 6 + lane] = fd;
                }
              }
            }
          }
          for (int d = lane; d < nv; d += G) {
            const int i = MULTI ? o.jof[d] : d;
            const int a = d - DOF0(i);
            const T* f = F + o.fis + i * 6;
            T stf = SS(i, 0, a) * f[0];
#pragma unroll
            for (int j = 1; j < 6; ++j) stf += SS(i, j, a) * f[j];
            stf += F[o.w + d];
            if (has_roff) stf += F[o.roff + d];
            LN.acc[A_DSTFW] = nmax(LN.acc[A_DSTFW], absv(stf - F[o.stfw + d]));
            LN.acc[A_STFW_INF] = nmax(LN.acc[A_STFW_INF], absv(stf));
            F[o.stfw + d] = stf;
          }
          // H is dead until the next body call: the lanes' partial maxima
#pragma unroll
          for (int a = 0; a < LOIK_NACC; ++a) F[o.H + a * G + lane] = LN.acc[a];
        }
        LOIK_LANES_END
        LOIK_MARK(SEC_RESIDUAL)
        if (!checks) continue;

        // maxima over the lanes (any order), the four sums in index order
        LOIK_LANES_BEGIN
        for (int a = lane; a < LOIK_NACC; a += G) {
          T v = F[o.H + a * G];
#pragma unroll
          for (int l = 1; l < G; ++l) v = nmax(v, F[o.H + a * G + l]);
          F[o.Ha + a] = v;
        }
        if (lane < 4) {
          const int n = lane < 2 ? nv : NC * 6;
          const T* t = F + (lane == 0 ? o.tub : lane == 1 ? o.tlb : lane == 2 ? o.tbp : o.tbm);
          T s = T(0);
          for (int e = 0; e < n; ++e) s += t[e];
          F[o.Ha + LOIK_NACC + lane] = s;
        }
        LOIK_LANES_END
        LOIK_MARK(SEC_REDUCE)

        // ------------- flag transitions (solve.py:535-610), lane 0 ---------
        LOIK_LANES_BEGIN
        if (lane == 0) {
          const T* r = F + o.Ha;
          const T tol_abs = T(cfg.tol_abs), tol_rel = T(cfg.tol_rel);
          const T tol_pinf = T(cfg.tol_primal_inf), tol_tail = T(cfg.tol_tail_solve);
          const T ub_dw = r[LOIK_NACC + 0], lb_dw = r[LOIK_NACC + 1];
          const T b_dy_plus = r[LOIK_NACC + 2], b_dy_minus = r[LOIK_NACC + 3];
          const T rp = nmax(r[A_TASK], r[A_SLACK]);
          const T rd = nmax(r[A_DRV], r[A_STFW_INF]);
          const T dx = nmax(r[A_DVIS], r[A_DNU]);
          const T dz = r[A_DZ];
          // adaptive tolerances (loik-loid-optimized.hxx:540-565)
          T scale_p = nmax(nmax(r[A_AV_INF], r[A_NU_INF]), LN.b_inf);
          T scale_d = nmax(nmax(r[A_HREF_INF], LN.Hv_inf), nmax(r[A_FDPA_INF], r[A_STFW_INF]));
          if (P.tol_scale_primal) {
            scale_p = nmax(scale_p, LN.tsp);
            scale_d = nmax(scale_d, LN.tsd);
          }
          const T tol_p = tol_abs + tol_rel * scale_p;
          const T tol_d = tol_abs + tol_rel * scale_d;
          // infeasibility certificate (loik-loid-optimized.hxx:572-606)
          const T dy_all = nmax(r[A_DFIS], nmax(r[A_DY_INF], r[A_DW_INF]));
          const T At_dy = nmax(r[A_DFDPA], r[A_DSTFW]);
          const bool pinf_cond =
              (At_dy <= tol_pinf * dy_all) &&
              (b_dy_plus + ub_dw + b_dy_minus + lb_dw <= tol_pinf * dy_all);

          LN.it += K;
          const int it = LN.it;
          const bool in_tail = LN.in_tail;
          const bool normal = !in_tail;
          const bool conv_now = normal && (rp < tol_p) && (rd < tol_d);
          const bool pinf_now = cfg.check_feasibility && normal && !conv_now &&
                                (it > 1) && pinf_cond;
          const bool in_tail_next = cfg.tail_solve ? (in_tail || pinf_now) : in_tail;
          const bool tail_done = in_tail_next && (dx < tol_tail) && (dz < tol_tail);
          if (normal && !conv_now && !pinf_now) {
            const T mu = LN.mu;
            T mu_next = rp > T(10) * rd ? mu * T(10) : (rd > T(10) * rp ? mu * T(0.1) : mu);
            // clamp: repeated x0.1 under a residual floor underflows f32 to zero
            mu_next = clip(mu_next, T(1e-12), T(1e12));
            LN.mu = mu_next;
            F[o.sc + SC_MU_EQ] = T(cfg.mu_eq_scale) * mu_next;
            F[o.sc + SC_MU_INEQ] = mu_next;
          }
          const bool budget = in_tail_next ? (it + K <= cfg.max_iter)
                                           : (it + K <= cfg.max_iter - 1);
          LN.rp = rp;
          LN.rd = rd;
          LN.dx = dx;
          LN.dz = dz;
          LN.converged = LN.converged || conv_now;
          LN.pinf = LN.pinf || pinf_now;
          if (in_tail) LN.tail_iterations += K;
          LN.in_tail = in_tail_next;
          LN.ran = true;
          const bool running = !conv_now && !tail_done && budget &&
                               (cfg.tail_solve || !pinf_now);
          F[o.sc + SC_RUNNING] = running ? T(1) : T(0);
        }
        LOIK_LANES_END
      }
    LOIK_END_WHILE

#if defined(LOIK_PROFILE) && !defined(LOIK_REHEARSAL)
    if (lane == 0 && b == 0) {
      LOIK_MARK(SEC_FLAGS)
      printf("LOIK_PROFILE cycles total %lld:", prof_last_ - prof_start_);
      for (int e = 0; e < SEC_COUNT; ++e) printf(" %lld", prof_[e]);
      printf("\n");
    }
#endif
    // the problem's scalars, written if the loop ran at all
    LOIK_LANES_BEGIN
    if (lane == 0) {
      if (LN.ran) {
        P.mu[b] = LN.mu;
        P.mu_eq[b] = F[o.sc + SC_MU_EQ];
        P.mu_ineq[b] = F[o.sc + SC_MU_INEQ];
        P.rp[b] = LN.rp;
        P.rd[b] = LN.rd;
        P.dx[b] = LN.dx;
        P.dz[b] = LN.dz;
        P.converged[b] = LN.converged;
        P.pinf[b] = LN.pinf;
        P.tail_iterations[b] = LN.tail_iterations;
        P.in_tail[b] = LN.in_tail;
        P.iterations[b] = LN.it;
        P.running[b] = false;
      }
      atomicMax(P.it, LN.it);
    }
    LOIK_LANES_END
#undef AT
#undef LN
  }
  LOIK_GROUPS_END

  // ---------------- the iterate, frames -> device memory -------------------
  LOIK_THREADS_BEGIN
  const int* slot = MULTI ? o.slot : nullptr;
#define STORE(off, ptr, n, map) \
  block_copy<T, true>(frames, o.stride, off, ptr, n, map, tile, b0, B, tid, nthr)
  STORE(o.vis, P.vis, N * 6, nullptr);
  STORE(o.fis, P.fis, N * 6, nullptr);
  STORE(o.fdpa, P.fdpa, N * 6, nullptr);
  STORE(o.yis, P.yis, NC * 6, nullptr);
  STORE(o.Aty, P.Aty, NC * 6, nullptr);
  STORE(o.nu, P.nu, nv, slot);
  STORE(o.z, P.z, nv, slot);
  STORE(o.w, P.w, nv, slot);
  STORE(o.stfw, P.stfw, nv, slot);
#undef STORE
  LOIK_THREADS_END
#undef NVS
#undef DOF0
#undef BLK0
#undef SS
}

// Launch one instantiation with `smem` bytes of dynamic shared memory.  Above
// 48 KB a block the kernel has to be allowed its size first: every launch
// allows it the most a block has, LOIK_MAX_SMEM_BYTES.  The attribute only
// permits and never changes, so a CUDA graph's launch node, replayed after
// launches of other sizes, stays allowed; under a capture the call is no
// stream operation and is not recorded.  A launch the card refuses never
// runs and shows in the returned code.
template <typename T, bool MULTI, bool SALL>
static int launch_kernel(int blocks, int threads, size_t smem, void* stream,
                         const LoikConfig& cfg, const LoikPtrs<T>& P,
                         const LoikLayout& lay) {
#ifdef LOIK_REHEARSAL
  loik_rehearsal_run(blocks, threads, smem,
                     [&] { fused_admm_kernel<T, MULTI, SALL>(cfg, P, lay); });
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(fused_admm_kernel<T, MULTI, SALL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         LOIK_MAX_SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  fused_admm_kernel<T, MULTI, SALL>
      <<<blocks, threads, smem, (cudaStream_t)stream>>>(cfg, P, lay);
  return (int)cudaGetLastError();
#endif
}

static bool valid_config(const LoikConfig* cfg) {
  if (cfg->N < 1 || cfg->N > LOIK_MAX_JOINTS || cfg->NC < 1 ||
      cfg->NC > LOIK_MAX_CONSTRAINTS || cfg->B < 1 || cfg->tile < 1 ||
      cfg->tile * LOIK_LANES > 1024 || cfg->check_interval < 1 ||
      cfg->nv_max < 1 || cfg->nv_max > 6)
    return false;
  int nv = 0;
  for (int i = 0; i < cfg->N; ++i) {
    if (cfg->nvs[i] < 1 || cfg->nvs[i] > cfg->nv_max) return false;
    nv += cfg->nvs[i];
  }
  return nv <= LOIK_MAX_NV;
}

template <typename T>
static int launch(const LoikConfig* cfg, void* const* ptrs, int n_ptrs,
                  void* stream) {
  if (n_ptrs != P_COUNT || !valid_config(cfg)) return (int)cudaErrorInvalidValue;
  // exactly one form of the subspaces; per-problem ones only for one-dof
  // chains of at most LOIK_SMALL_JOINTS joints
  const bool s_all = ptrs[P_S_ALL] != nullptr;
  if (s_all == (ptrs[P_S] != nullptr) ||
      (s_all && (cfg->nv_max != 1 || cfg->N > LOIK_SMALL_JOINTS)))
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
  P.S = (const T*)ptrs[P_S];
  P.S_all = (const T*)ptrs[P_S_ALL];
  P.it_in = (const int32_t*)ptrs[P_IT_IN];
  const LoikLayout lay = loik_layout(*cfg, s_all);
  const size_t smem = ((size_t)lay.blockS + (size_t)cfg->tile * lay.stride) * sizeof(T);
  const int blocks = (cfg->B + cfg->tile - 1) / cfg->tile;
  const int threads = cfg->tile * LOIK_LANES;
  if (s_all)
    return launch_kernel<T, false, true>(blocks, threads, smem, stream, *cfg, P, lay);
  if (cfg->nv_max == 1)
    return launch_kernel<T, false, false>(blocks, threads, smem, stream, *cfg, P, lay);
  return launch_kernel<T, true, false>(blocks, threads, smem, stream, *cfg, P, lay);
}

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
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
                         int* small_joints, int* n_ptrs, int* config_bytes,
                         int* lanes, int* max_smem_bytes) {
  *max_joints = LOIK_MAX_JOINTS;
  *max_nv = LOIK_MAX_NV;
  *max_constraints = LOIK_MAX_CONSTRAINTS;
  *small_joints = LOIK_SMALL_JOINTS;
  *n_ptrs = P_COUNT;
  *config_bytes = (int)sizeof(LoikConfig);
  *lanes = LOIK_LANES;
  *max_smem_bytes = LOIK_MAX_SMEM_BYTES;
}

// Words of the scalar type in one problem's frame and in the block's shared
// copy of S, as the kernel lays them out for this tree (cfg->tile is not
// read); -1 for a config the kernel does not take.
int loik_fused_admm_frame(const LoikConfig* cfg, int s_all, int* frame_words,
                          int* block_words) {
  LoikConfig c = *cfg;
  c.tile = 1;
  if (!valid_config(&c)) return -1;
  const LoikLayout lay = loik_layout(c, s_all != 0);
  *frame_words = lay.stride;
  *block_words = lay.blockS;
  return 0;
}

const char* loik_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
