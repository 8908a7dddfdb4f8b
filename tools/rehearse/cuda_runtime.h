// Stand-in for <cuda_runtime.h> that lets g++ compile the CUDA sources of
// loik_tpu_torch/kernels/csrc for a rehearsal on the host
// (tools/rehearse_kernel.py puts this directory ahead on the include path).
//
// It defines LOIK_REHEARSAL, under which a source runs a phase of a group as
// a loop over the group's lanes and a block as a loop over its threads, and
// the few CUDA names the sources use.  A launch becomes a loop over blocks,
// each with a fresh "shared memory" buffer filled with 0xFF bytes (NaNs), so
// that a read of a word no one wrote shows in the results.  With the
// environment variable LOIK_REHEARSAL_DESCENDING=1 the lanes of a phase run
// from the last to the first: a phase that is right only in one order is
// missing a synchronisation.
#pragma once
#define LOIK_REHEARSAL 1

#include <cmath>
#include <cstdlib>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __grid_constant__

struct LoikRehearsalDim { unsigned x, y, z; };
static LoikRehearsalDim blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };

static inline const char* cudaGetErrorString(cudaError_t code) {
  return code == cudaSuccess ? "no error" : "invalid argument";
}

static inline int atomicMax(int* p, int v) {
  const int old = *p;
  if (v > old) *p = v;
  return old;
}

static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline double rsqrt(double x) { return 1.0 / sqrt(x); }

static unsigned char* loik_rehearsal_smem;
static int loik_rehearsal_descending;

// Run `kernel` once per block.
template <typename Kernel>
static void loik_rehearsal_run(int blocks, int threads, size_t smem, Kernel kernel) {
  const char* order = getenv("LOIK_REHEARSAL_DESCENDING");
  loik_rehearsal_descending = order && order[0] == '1';
  loik_rehearsal_smem = (unsigned char*)malloc(smem ? smem : 1);
  blockDim.x = (unsigned)threads;
  for (int blk = 0; blk < blocks; ++blk) {
    memset(loik_rehearsal_smem, 0xFF, smem);
    blockIdx.x = (unsigned)blk;
    kernel();
  }
  free(loik_rehearsal_smem);
  loik_rehearsal_smem = nullptr;
}
