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
// Accumulators are float32 or int32.  A count field adds 1.  Rows whose
// slot is the scratch slot (capacity - 1), or lies outside the table,
// fold nothing.  float32 min/max follow the reference on NaN: a NaN row
// replaces any number, and a stored NaN is never replaced.
//
// What bounds it.  The rows are read once (4 B a row packed, 8 B a row
// slot + value, plus the gather from a table that stays in L1/L2), so
// at the card's 3.35 TB/s the floor is about 1.3 us per 2^20 rows.
// What limits a one-thread-per-row scatter is atomic contention in L2:
// 1BRC folds 2^20 rows into ~400 slots, so every field of a slot takes
// thousands of global atomics a batch, one after another.
//
// Design.  The TPU kernel folded a tile of rows into a private
// [fields, capacity] partial (a one-hot mask reduced on the MXU) and
// merged once.  Here each block of fold_shared keeps that partial in
// shared memory: it sets its shared table to the fold identities, folds
// a tile of rows into it with shared-memory atomics, then merges every
// entry that left the identity into the state with one global atomic.
// A table larger than kSplitBytes splits into equal ranges over
// blockIdx.y: each block reads the whole tile (from L2 after the first)
// and folds only the rows whose slot falls in its range.  Global atomics
// per slot and field drop from one per row (thousands a batch at 1BRC's
// ~400 stations) to one per block that saw the slot.
//
// Two alternatives were measured slower at both main-path shapes
// (PERF.md) and removed: global atomics with the lanes of a warp that
// share a slot combined first (__match_any_sync), and a deterministic
// merge, a second kernel over a [blocks, fields, capacity] partial
// buffer.  So float32 sums depend on the order in which blocks merge.
//
// Packed rows with a float accumulator and a finite non-zero scale fold
// q itself in int32 (sum, count, min and max are exact integer atomics)
// and apply the scale at the merge: fl(q * s) is monotonic in q for
// s > 0, so min and max are exact, and a negative scale swaps them.  A
// tile holds at most kMaxTileRows rows, so an int32 sum of int16 q
// cannot overflow.
//
// Launch geometry: 1024-thread blocks, kSharedBlocksPerSm on every SM
// (__launch_bounds__ holds a thread to 32 registers, and two tables of
// at most kSplitBytes fit an SM's shared memory), one wave shared among
// the ranges.  The host wrapper (ops/fold_kernel.py) checks every
// argument, passes PyTorch's current stream, and raises on a non-zero
// return, which is the launch's cudaGetLastError().  Nothing is
// allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>
#include <type_traits>

namespace {

enum { SRC_SLOT = 0, SRC_EXT16 = 1, SRC_EXT32 = 2, SRC_PACKED = 3 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
constexpr int kCountBit = 4;
constexpr int kMaxFields = 4;
constexpr int kThreads = 1024;
// Two blocks of kThreads fill an SM's 2048 threads (at most 32
// registers a thread).
constexpr int kSharedBlocksPerSm = 2;
// Rows each thread has in flight.
constexpr int kUnroll = 4;
// Shared table bytes per block; a larger table splits over blockIdx.y.
constexpr long long kSplitBytes = 64 * 1024;
// More ranges than this loop inside the blocks.
constexpr long long kMaxGridY = 65535;
constexpr long long kMinTileRows = 4096;
// 32768 rows of |q| <= 32768 sum to at most 2^30 in int32.
constexpr long long kMaxTileRows = 32768;

struct Fields {
  void* ptr[kMaxFields];
  int codes;  // 3 bits per field: op | kCountBit
  int n;
};

__device__ __forceinline__ int op_of(int codes, int k) { return (codes >> (3 * k)) & 3; }
__device__ __forceinline__ bool is_count(int codes, int k) {
  return ((codes >> (3 * k)) & kCountBit) != 0;
}

template <typename S>
struct Lim;
template <>
struct Lim<float> {
  __device__ static float hi() { return __int_as_float(0x7f800000); }  // +inf
  __device__ static float lo() { return __int_as_float(0xff800000); }  // -inf
};
template <>
struct Lim<int> {
  __device__ static int hi() { return 0x7fffffff; }
  __device__ static int lo() { return -0x7fffffff - 1; }
};

template <typename S>
__device__ __forceinline__ S identity(int op) {
  return op == OP_MIN ? Lim<S>::hi() : (op == OP_MAX ? Lim<S>::lo() : S(0));
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_nan(int) { return false; }

// Whether v replaces old in a min or max: a NaN row replaces any
// number, a stored NaN is never replaced, and otherwise v must compare
// strictly below (above) old.
template <typename S>
__device__ __forceinline__ bool improves(int op, S v, S old) {
  if (is_nan(old)) return false;
  if (is_nan(v)) return true;
  return op == OP_MIN ? v < old : v > old;
}

__device__ __forceinline__ void atomic_fold(int op, int* a, int v) {
  if (op == OP_ADD) {
    atomicAdd(a, v);
  } else if (op == OP_MIN) {
    atomicMin(a, v);
  } else {
    atomicMax(a, v);
  }
}

// float min/max: compare-and-swap on the bit pattern, read first, so a
// row that does not improve the stored value costs a read.  Works on
// shared and on global memory.
__device__ __forceinline__ void atomic_fold(int op, float* a, float v) {
  if (op == OP_ADD) {
    atomicAdd(a, v);
    return;
  }
  unsigned int* bits = reinterpret_cast<unsigned int*>(a);
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(bits);
  while (improves(op, v, __uint_as_float(old))) {
    const unsigned int seen = atomicCAS(bits, old, __float_as_uint(v));
    if (seen == old) break;
    old = seen;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  return static_cast<T>(x);
}

// External id -> slot, as the JAX gather does it: a negative id counts
// from the end of the table, then the id clamps into the table.
__device__ __forceinline__ int gather_slot(const int* map, long long n_map, long long e) {
  if (e < 0) e += n_map;
  e = e < 0 ? 0 : (e >= n_map ? n_map - 1 : e);
  return map[e];
}

// What a row folds: q itself (kQ) or a value of the accumulator type.
template <typename T, bool kQ>
using FoldT = typename std::conditional<kQ, int, T>::type;

// Row i's slot, and its value into v.
template <typename T, int kSrc, bool kQ>
__device__ __forceinline__ int read_row(const void* __restrict__ rows, const T* __restrict__ vals,
                                        const int* __restrict__ map, long long n_map, float scale,
                                        long long n, long long i, FoldT<T, kQ>& v) {
  if constexpr (kSrc == SRC_SLOT) {
    v = vals[i];
    return static_cast<const int*>(rows)[i];
  } else if constexpr (kSrc == SRC_EXT16) {
    v = vals[i];
    return gather_slot(map, n_map, static_cast<const short*>(rows)[i]);
  } else if constexpr (kSrc == SRC_EXT32) {
    v = vals[i];
    return gather_slot(map, n_map, static_cast<const int*>(rows)[i]);
  } else {
    const short* packed = static_cast<const short*>(rows);
    const short q = packed[n + i];
    if constexpr (kQ) {
      v = q;
    } else {
      v = from_float<T>(static_cast<float>(q) * scale);
    }
    return gather_slot(map, n_map, packed[i]);
  }
}

// A shared-table entry that left the identity, as the state's value:
// with kQ, q scaled back (a count stays a count).
template <typename T, bool kQ>
__device__ __forceinline__ T to_state(FoldT<T, kQ> a, bool count, float scale) {
  if constexpr (kQ) {
    return count ? static_cast<float>(a) : static_cast<float>(a) * scale;
  } else {
    return a;
  }
}

template <typename T, int kSrc, bool kQ>
__global__ void __launch_bounds__(kThreads, kSharedBlocksPerSm)
fold_shared(Fields f, const void* __restrict__ rows, const T* __restrict__ vals,
            const int* __restrict__ map, long long n_map, float scale, long long n, int width,
            int span, long long tile_rows) {
  using S = FoldT<T, kQ>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* table = reinterpret_cast<S*>(smem);
  // The op each field folds with in the table: folding q with a
  // negative scale turns a min of q * scale into a max of q.
  int eff = f.codes;
  if (kQ && scale < 0.f) {
    for (int k = 0; k < kMaxFields; ++k) {
      if (op_of(f.codes, k) != OP_ADD) eff ^= (OP_MIN ^ OP_MAX) << (3 * k);
    }
  }
  // Range r of the table is slots [r * span, r * span + span); a
  // block in y folds every gridDim.y-th range.
  const int n_ranges = (width - 1) / span + 1;
  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int r = blockIdx.y; r < n_ranges; r += gridDim.y) {
    const int lo = r * span;
    const int w = min(span, width - lo);
    const int hi = lo + w;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
#pragma unroll
      for (int k = 0; k < kMaxFields; ++k) {
        if (k >= f.n) break;
        const S ident = identity<S>(op_of(eff, k));
        for (int j = threadIdx.x; j < w; j += kThreads) table[k * span + j] = ident;
      }
      __syncthreads();
      const long long begin = t * tile_rows;
      const long long end = min(n, begin + tile_rows);
      for (long long i0 = begin + threadIdx.x; i0 < end;
           i0 += static_cast<long long>(kThreads) * kUnroll) {
        int slot[kUnroll];
        S v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long i = i0 + static_cast<long long>(u) * kThreads;
          slot[u] = -1;
          v[u] = S(0);
          if (i < end) slot[u] = read_row<T, kSrc, kQ>(rows, vals, map, n_map, scale, n, i, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // lo >= 0 drops negative slots; hi <= width drops the scratch
          // slot and anything past the table.
          if (slot[u] < lo || slot[u] >= hi) continue;
          const int j = slot[u] - lo;
#pragma unroll
          for (int k = 0; k < kMaxFields; ++k) {
            if (k >= f.n) break;
            atomic_fold(op_of(eff, k), &table[k * span + j], is_count(eff, k) ? S(1) : v[u]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxFields; ++k) {
        if (k >= f.n) break;
        const int op = op_of(f.codes, k);
        const int eop = op_of(eff, k);
        const bool count = is_count(f.codes, k);
        T* state = static_cast<T*>(f.ptr[k]) + lo;
        for (int j = threadIdx.x; j < w; j += kThreads) {
          const S a = table[k * span + j];
          // An entry still at the identity changes nothing (a NaN entry
          // never equals it).
          if (a == identity<S>(eop)) continue;
          atomic_fold(op, state + j, to_state<T, kQ>(a, count, scale));
        }
      }
      __syncthreads();
    }
  }
}

// Launch fold_shared<T, kSrc, kQ>.  The first launch on a device lets
// the kernel take up to kSplitBytes of dynamic shared memory (past
// 48 KB a kernel must opt in).
template <typename T, int kSrc, bool kQ>
cudaError_t launch_shared(const Fields& f, const void* rows, const T* vals, const int* map,
                          long long n_map, float scale, long long n, int width, int span,
                          long long tile_rows, dim3 grid, size_t smem, int device,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> opted_in{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  if ((opted_in.load(std::memory_order_relaxed) & bit) == 0) {
    const cudaError_t err = cudaFuncSetAttribute(fold_shared<T, kSrc, kQ>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kSplitBytes));
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  fold_shared<T, kSrc, kQ><<<grid, kThreads, smem, stream>>>(f, rows, vals, map, n_map, scale, n,
                                                             width, span, tile_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int source, bool q, const Fields& f, const void* rows, const void* vals,
                   const int* map, long long n_map, float scale, long long n, int width,
                   int span, long long tile_rows, dim3 grid, size_t smem, int device,
                   cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
#define BW_LAUNCH(SRC, Q) \
  launch_shared<T, SRC, Q>(f, rows, v, map, n_map, scale, n, width, span, tile_rows, grid, \
                           smem, device, stream)
  switch (source) {
    case SRC_SLOT: return BW_LAUNCH(SRC_SLOT, false);
    case SRC_EXT16: return BW_LAUNCH(SRC_EXT16, false);
    case SRC_EXT32: return BW_LAUNCH(SRC_EXT32, false);
    case SRC_PACKED:
      if constexpr (std::is_same<T, float>::value) {
        if (q) return BW_LAUNCH(SRC_PACKED, true);
      }
      return BW_LAUNCH(SRC_PACKED, false);
    default: return cudaErrorInvalidValue;
  }
#undef BW_LAUNCH
}

// Packed rows fold q in int32 when the scale keeps fl(q * scale)
// monotonic in q: float accumulators, a finite non-zero scale.
bool qfold(int source, int acc_int, float scale) {
  return source == SRC_PACKED && !acc_int && std::isfinite(scale) && scale != 0.f;
}

}  // namespace

// Fold n rows into n_fields state arrays of `capacity` elements each,
// on the current device.  field_codes holds 3 bits per field, field k
// at bits 3k..3k+2: the op (0 add, 1 min, 2 max) and bit 2 for a count
// field.  acc_int selects int32 accumulators (and int32 values), else
// float32.  Returns the launch's cudaError_t (0 on success).
extern "C" int bw_segment_fold(int source, int acc_int, int n_fields, int field_codes,
                               void* f0, void* f1, void* f2, void* f3,
                               const void* rows, const void* vals, const void* map,
                               long long n_map, float scale, long long n,
                               long long capacity, void* stream) {
  if (source < SRC_SLOT || source > SRC_PACKED || n_fields < 1 || n_fields > kMaxFields ||
      n < 0 || capacity < 1 || capacity - 1 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || capacity == 1) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // The table splits into equal ranges of at most kSplitBytes.
  const long long width = capacity - 1;
  const long long span_max = kSplitBytes / (4LL * n_fields);
  long long ranges = (width + span_max - 1) / span_max;
  const long long span = (width + ranges - 1) / ranges;
  ranges = (width + span - 1) / span;
  const long long grid_y = ranges < kMaxGridY ? ranges : kMaxGridY;
  // One wave: kSharedBlocksPerSm blocks on every SM, shared among the
  // ranges, each folding tiles of kMinTileRows..kMaxTileRows rows
  // (fewer, longer tiles make fewer merge atomics).
  long long blocks_x = static_cast<long long>(kSharedBlocksPerSm) * sms / grid_y;
  if (blocks_x < 1) blocks_x = 1;
  long long tile = (n + blocks_x - 1) / blocks_x;
  tile = tile < kMinTileRows ? kMinTileRows : (tile > kMaxTileRows ? kMaxTileRows : tile);
  const long long tiles = (n + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned int>(blocks_x < tiles ? blocks_x : tiles),
                  static_cast<unsigned int>(grid_y));
  const size_t smem = static_cast<size_t>(n_fields) * span * 4;
  Fields f;
  void* ptrs[kMaxFields] = {f0, f1, f2, f3};
  for (int k = 0; k < kMaxFields; ++k) f.ptr[k] = ptrs[k];
  f.codes = field_codes;
  f.n = n_fields;
  const bool q = qfold(source, acc_int, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(map);
  const int w = static_cast<int>(width);
  const int sp = static_cast<int>(span);
  err = acc_int ? launch<int>(source, q, f, rows, vals, m, n_map, scale, n, w, sp, tile, grid,
                              smem, device, s)
                : launch<float>(source, q, f, rows, vals, m, n_map, scale, n, w, sp, tile,
                                grid, smem, device, s);
  return static_cast<int>(err);
}
