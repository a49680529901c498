// Keyed segment fold for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pallas_fold.py
// `_fold_kernel` (with its merge in `update_fields_pallas`) and the XLA
// scatter-combines ops/segment.py `update_fields`,
// `update_fields_vocab` and `update_fields_packed`: fold a micro-batch
// of rows into every field (sum / count / min / max) of one keyed
// aggregation's slot table, in place.
//
// Rows come from one of three sources:
//   SRC_SLOT    int32 slot ids and values of the accumulator type;
//   SRC_EXT16,
//   SRC_EXT32   int16 / int32 external ids through a device id->slot
//               table, and values of the accumulator type;
//   SRC_PACKED  one [2, n] int16 buffer: row 0 external ids, row 1
//               fixed-point values (value = float(q) * scale).
// Accumulators are float32 or int32 (integer atomics are exact).  A
// count field adds 1.  Rows whose slot is the scratch slot
// (capacity - 1), or lies outside the table, fold nothing.
//
// What bounds it: the rows are read once (4 B a row packed, 8 B a row
// slot + value, plus the gather from a table that stays in L1/L2), so
// at the card's 3.35 TB/s the floor is a few microseconds per 2^20
// rows.  What really limits it is atomic contention: 1BRC folds 2^20
// rows into ~400 slots, so each slot's fields see thousands of atomics
// per batch, serialised in L2.
//
// Design.  The TPU kernel builds a one-hot [tile, capacity] mask and
// reduces it because a TPU has no scatter; that is what capped it at
// 4096 slots and float32.  On the card every row scatters itself: a
// grid-stride loop over rows, atomicAdd for add fields, atomicMin /
// atomicMax for int32, and a compare-and-swap loop on the bit pattern
// for float32 min/max that reads first and writes only when the row
// improves the extremum (after the first rows almost none do, so the
// extrema cost a read, not an atomic).  No capacity limit.  A
// per-block shared-memory copy of the table is the next step.
//
// The host wrapper (ops/fold_kernel.py) checks every argument, passes
// PyTorch's current stream, and raises on a non-zero return, which is
// the launch's cudaGetLastError().  Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { SRC_SLOT = 0, SRC_EXT16 = 1, SRC_EXT32 = 2, SRC_PACKED = 3 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
constexpr int kCountBit = 4;
constexpr int kMaxFields = 4;
constexpr int kThreads = 256;

struct Fields {
  void* ptr[kMaxFields];
  int code[kMaxFields];  // op | kCountBit
  int n;
};

__device__ __forceinline__ void atomic_add(float* a, float v) { atomicAdd(a, v); }
__device__ __forceinline__ void atomic_add(int* a, int v) { atomicAdd(a, v); }
__device__ __forceinline__ void atomic_min(int* a, int v) { atomicMin(a, v); }
__device__ __forceinline__ void atomic_max(int* a, int v) { atomicMax(a, v); }

// Float min/max: compare-and-swap on the bit pattern.  A row that does
// not improve the stored value (NaN included) never writes.
template <bool kMin>
__device__ __forceinline__ void atomic_extremum(float* a, float v) {
  unsigned int* bits = reinterpret_cast<unsigned int*>(a);
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(bits);
  while (kMin ? (v < __uint_as_float(old)) : (v > __uint_as_float(old))) {
    unsigned int seen = atomicCAS(bits, old, __float_as_uint(v));
    if (seen == old) break;
    old = seen;
  }
}
__device__ __forceinline__ void atomic_min(float* a, float v) { atomic_extremum<true>(a, v); }
__device__ __forceinline__ void atomic_max(float* a, float v) { atomic_extremum<false>(a, v); }

template <typename T>
__device__ __forceinline__ T from_float(float x) { return static_cast<T>(x); }

// External id -> slot, as the JAX gather does it: a negative id counts
// from the end of the table, then the id clamps into the table.
__device__ __forceinline__ long long gather_slot(const int* map, long long n_map, long long e) {
  if (e < 0) e += n_map;
  e = e < 0 ? 0 : (e >= n_map ? n_map - 1 : e);
  return map[e];
}

template <typename T, int kSrc>
__global__ void __launch_bounds__(kThreads)
fold_kernel(Fields f, const void* __restrict__ rows, const T* __restrict__ vals,
            const int* __restrict__ map, long long n_map, float scale,
            long long n, long long capacity) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long slot;
    T v;
    if (kSrc == SRC_SLOT) {
      slot = static_cast<const int*>(rows)[i];
      v = vals[i];
    } else if (kSrc == SRC_EXT16) {
      slot = gather_slot(map, n_map, static_cast<const short*>(rows)[i]);
      v = vals[i];
    } else if (kSrc == SRC_EXT32) {
      slot = gather_slot(map, n_map, static_cast<const int*>(rows)[i]);
      v = vals[i];
    } else {  // SRC_PACKED
      const short* packed = static_cast<const short*>(rows);
      slot = gather_slot(map, n_map, packed[i]);
      v = from_float<T>(static_cast<float>(packed[n + i]) * scale);
    }
    if (slot < 0 || slot >= capacity - 1) continue;
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k) {
      if (k >= f.n) break;
      T* a = static_cast<T*>(f.ptr[k]) + slot;
      const int code = f.code[k];
      const T c = (code & kCountBit) ? static_cast<T>(1) : v;
      switch (code & 3) {
        case OP_ADD: atomic_add(a, c); break;
        case OP_MIN: atomic_min(a, c); break;
        default: atomic_max(a, c); break;
      }
    }
  }
}

template <typename T>
cudaError_t launch(int source, const Fields& f, const void* rows, const void* vals,
                   const int* map, long long n_map, float scale, long long n,
                   long long capacity, int blocks, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  switch (source) {
    case SRC_SLOT:
      fold_kernel<T, SRC_SLOT><<<blocks, kThreads, 0, stream>>>(f, rows, v, map, n_map, scale, n, capacity);
      break;
    case SRC_EXT16:
      fold_kernel<T, SRC_EXT16><<<blocks, kThreads, 0, stream>>>(f, rows, v, map, n_map, scale, n, capacity);
      break;
    case SRC_EXT32:
      fold_kernel<T, SRC_EXT32><<<blocks, kThreads, 0, stream>>>(f, rows, v, map, n_map, scale, n, capacity);
      break;
    case SRC_PACKED:
      fold_kernel<T, SRC_PACKED><<<blocks, kThreads, 0, stream>>>(f, rows, v, map, n_map, scale, n, capacity);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Fold n rows into n_fields state arrays of `capacity` elements each.
// field_codes holds 3 bits per field, field k at bits 3k..3k+2: the op
// (0 add, 1 min, 2 max) and bit 2 for a count field.  acc_int selects
// int32 accumulators (and int32 values), else float32.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int bw_segment_fold(int source, int acc_int, int n_fields, int field_codes,
                               void* f0, void* f1, void* f2, void* f3,
                               const void* rows, const void* vals, const void* map,
                               long long n_map, float scale, long long n,
                               long long capacity, int blocks, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n < 0 || capacity < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Fields f;
  void* ptrs[kMaxFields] = {f0, f1, f2, f3};
  for (int k = 0; k < kMaxFields; ++k) {
    f.ptr[k] = ptrs[k];
    f.code[k] = (field_codes >> (3 * k)) & 7;
  }
  f.n = n_fields;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(map);
  cudaError_t err = acc_int
      ? launch<int>(source, f, rows, vals, m, n_map, scale, n, capacity, blocks, s)
      : launch<float>(source, f, rows, vals, m, n_map, scale, n, capacity, blocks, s);
  return static_cast<int>(err);
}
