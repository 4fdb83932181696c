// K5 schur_gather: assemble the border system of a BBD Schur solve.
//
// Replaces the padded scatter-adds of the JAX package's BBD solves:
// s_pad.at[bsel[:, :, None], bsel[:, None, :]].add(-contrib) and
// r_red.at[bsel].add(rhs_part) in juliagrid_tpu/powerflow/newton_bbd.py
// (:340-348), ops/bbd.py::bbd_solve_local (:302-308) and
// estimation/acse_bbd.py::_gn_increment_bbd (:331-336). There each block's
// (L x L) Schur contribution and L-long right-hand side part scatter into a
// (nb + 1)^2 buffer through the block's local-to-global border map `bsel`,
// whose pad slots point at the extra row and column nb.
//
// Mapping: a gather instead of a scatter, by one of two kernels that sum
// in the same order. The host inverts `bsel` once
// (schur_gather.py::schur_route): for border slot g, the blocks that reach
// it in ascending order and g's local slot in each,
// slot_blk/slot_loc[slot_ptr[g] .. slot_ptr[g + 1]).
//
// - Where the real contributions outweigh the border (sum over blocks of
//   their real slots squared >= nb^2, the estimators' borders), a thread
//   block owns one row i of the border matrix (the extra row nb is the
//   right-hand side) over a chunk of up to kChunk columns, with a sum and a
//   reached flag per column in shared memory. For each (block b, local
//   slot l_i) on i's list, in ascending block order, its threads read the
//   contribution row contrib[b, l_i, :] contiguously and add element l to
//   the sum of column bsel[b, l] (pad slots, bsel = nb, are skipped); a
//   block names a border slot once, so no two threads add to one sum, and a
//   barrier separates two blocks. The right-hand side walks every block's
//   parts the same way. Each real contribution is read once, in order.
// - Elsewhere (the Newton-Raphson borders, where the output is most of the
//   bytes), a thread owns one column j and kRows rows: element (i, j)
//   merges the lists of i and j (both ascending and short: a slot is on a
//   few blocks' borders) and sums contrib[b, l_i, l_j] over their common
//   blocks in ascending order; the extra row sums j's list of parts. No
//   barrier, and neighbouring threads write neighbouring columns.
//
// Both write base + scale * sum where a block reached the element and the
// base alone elsewhere, with the base the masked border block (a_bb, r_bb)
// or zero. One launch writes every output element once: no copy of the
// base first, no atomics, and the result does not depend on scheduling.
// (scripts/k3_k5_pair.py times both kernels on each border.)
//
// Rounding: a sum starts at 0.0 and adds in ascending block order, then
// base + scale * sum with each operation rounded on its own (__dmul_rn,
// __dadd_rn: no contraction into a fused multiply-add), so that both
// kernels give the bits of schur_gather.py::schur_gather_lists, the same
// arithmetic in plain PyTorch.
//
// Bound: bytes. A launch reads the real contributions and parts, the base,
// and writes the nb^2 + nb border system once (11.9 MB at nb = 1,220, the
// 10k grid's NR border at k = 16; the tables are O(nb + sum of L_b) ints).

#include <cuda_runtime.h>

#include <cstdint>

// The per-slot lists of one route, built once on the host
// (schur_gather.py::_Tables). At file scope, so that the extern "C"
// launcher that takes it keeps its external linkage.
struct SchurTables {
  const int* slot_ptr;    // [nb + 1]
  const int* slot_blk;    // [sum of real slots] ascending within a slot
  const int* slot_loc;    // local slot of the border slot in that block
  const int64_t* bsel;    // [k, L] local slot -> border slot (pad nb)
  int nb;
  int k;
  int width;              // L
  int by_rows;            // 1: the row kernel, 0: the merge kernel
};

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // columns of a row kernel's thread block
constexpr int kRows = 2;      // rows of a merge kernel's thread

__global__ void __launch_bounds__(kThreads)
schur_rows_kernel(SchurTables t, const double* __restrict__ contrib,
                  const double* __restrict__ parts,
                  const double* __restrict__ a_bb,
                  const double* __restrict__ r_bb, double scale,
                  double* __restrict__ schur, double* __restrict__ rhs) {
  // a sum and a reached flag per column of the chunk
  extern __shared__ double sum[];
  const int nb = t.nb;
  const int64_t width = t.width;
  const int i = blockIdx.y;  // nb: the right-hand side
  const bool vec = i == nb;
  const int j0 = blockIdx.x * kChunk;
  const int cols = min(kChunk, nb - j0);
  unsigned char* hit =
      reinterpret_cast<unsigned char*>(sum + min(kChunk, nb));
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    sum[c] = 0.0;
    hit[c] = 0;
  }
  __syncthreads();
  const int p0 = vec ? 0 : t.slot_ptr[i];
  const int p1 = vec ? t.k : t.slot_ptr[i + 1];
  for (int p = p0; p < p1; ++p) {
    const int b = vec ? p : t.slot_blk[p];
    const double* src =
        vec ? parts + b * width
            : contrib + (b * width + t.slot_loc[p]) * width;
    const int64_t* dst = t.bsel + b * width;
    for (int l = threadIdx.x; l < width; l += kThreads) {
      const int64_t c = dst[l] - j0;
      if (c >= 0 && c < cols) {
        sum[c] = __dadd_rn(sum[c], src[l]);
        hit[c] = 1;
      }
    }
    __syncthreads();
  }
  const double* base = vec ? r_bb : a_bb;
  const int64_t at = (vec ? 0 : static_cast<int64_t>(i) * nb) + j0;
  double* out = (vec ? rhs : schur) + at;
#pragma unroll 4
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const double b0 = base != nullptr ? base[at + c] : 0.0;
    out[c] = hit[c] ? __dadd_rn(b0, __dmul_rn(scale, sum[c])) : b0;
  }
}

__global__ void __launch_bounds__(kThreads)
schur_merge_kernel(SchurTables t, const double* __restrict__ contrib,
                   const double* __restrict__ parts,
                   const double* __restrict__ a_bb,
                   const double* __restrict__ r_bb, double scale,
                   double* __restrict__ schur, double* __restrict__ rhs) {
  const int nb = t.nb;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nb) return;
  const int64_t width = t.width;
  const int jb = t.slot_ptr[j];
  const int je = t.slot_ptr[j + 1];
  const int i0 = blockIdx.y * kRows;
  // the bases of the thread's rows first, so that their loads are in
  // flight together
  double base[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = i0 + u;
    const double* src = i == nb ? r_bb : a_bb;
    const int64_t d = i == nb ? j : static_cast<int64_t>(i) * nb + j;
    base[u] = i <= nb && src != nullptr ? src[d] : 0.0;
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = i0 + u;
    if (i > nb) break;
    double sum = 0.0;
    bool reached = false;
    if (i == nb) {  // the right-hand side
      for (int q = jb; q < je; ++q) {
        sum = __dadd_rn(sum, parts[t.slot_blk[q] * width + t.slot_loc[q]]);
      }
      reached = jb < je;
    } else {
      int p = t.slot_ptr[i];
      const int pe = t.slot_ptr[i + 1];
      int q = jb;
      while (p < pe && q < je) {
        const int bi = t.slot_blk[p];
        const int bj = t.slot_blk[q];
        if (bi == bj) {
          sum = __dadd_rn(sum, contrib[(bi * width + t.slot_loc[p]) * width
                                       + t.slot_loc[q]]);
          reached = true;
          ++p;
          ++q;
        } else if (bi < bj) {
          ++p;
        } else {
          ++q;
        }
      }
    }
    const double out =
        reached ? __dadd_rn(base[u], __dmul_rn(scale, sum)) : base[u];
    if (i == nb) {
      rhs[j] = out;
    } else {
      schur[static_cast<int64_t>(i) * nb + j] = out;
    }
  }
}

}  // namespace

// Launch K5 on `stream`: schur = a_bb + scale * gathered contributions
// ([nb, nb]) and rhs = r_bb + scale * gathered parts ([nb]) from the
// [k, L, L] contributions and [k, L] parts through the per-slot lists `t`.
// a_bb and r_bb may be null for a zero base. Returns a cudaError_t code.
extern "C" int schur_gather_launch(const SchurTables* t,
                                   const double* contrib, const double* parts,
                                   const double* a_bb, const double* r_bb,
                                   double scale, double* schur, double* rhs,
                                   void* stream) {
  if (t == nullptr || t->nb <= 0 || t->k <= 0 || t->width <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t->by_rows) {
    const dim3 grid((t->nb + kChunk - 1) / kChunk, t->nb + 1);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    const size_t shared =
        (sizeof(double) + 1) *
        static_cast<size_t>(t->nb < kChunk ? t->nb : kChunk);
    schur_rows_kernel<<<grid, kThreads, shared, s>>>(
        *t, contrib, parts, a_bb, r_bb, scale, schur, rhs);
  } else {
    const dim3 grid((t->nb + kThreads - 1) / kThreads,
                    (t->nb + kRows) / kRows);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    schur_merge_kernel<<<grid, kThreads, 0, s>>>(
        *t, contrib, parts, a_bb, r_bb, scale, schur, rhs);
  }
  return cudaGetLastError();
}

extern "C" const char* schur_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
