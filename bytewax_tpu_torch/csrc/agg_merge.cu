// Dequantize-and-merge of one gsync round's partial-aggregate frames,
// for Hopper (sm_90a).
//
// Replaces the JAX package's jitted XLA program engine/xla.py
// `agg_merge_fn` (:657, and the table it folds into, `agg_merge_table`
// :702): the cluster-wide exchange tier's quantized mode ships each
// process's per-key partial aggregates inside the gsync metadata round,
// and every process folds every peer's frame into device-resident merge
// tables, one table a state field.  The JAX package runs one program a
// (frame, field); here one launch folds a whole round, every frame and
// every field:
//
//   for each frame f, in peer order:
//     for i < n_f, each field k:
//       table_k[gidx_f[i]] = combine_k(table_k[gidx_f[i]], value_fk(i))
//
// where value_fk(i) dequantizes row i of frame f's part of field k:
//   ENC_RAW   the value as it is, already in the table's dtype;
//   ENC_INT8  float(q[i]) * scales[i / 1024] (one f32 product), then
//             cast to the table's dtype;
//   ENC_BF16  the float whose upper 16 bits are hi[i], then cast.
// Tables are float32 or int32.  The cast from float to int32 truncates
// toward zero, saturates, and takes NaN to 0, as XLA's convert does
// (PTX cvt.rzi.s32.f32).  combine is add, min or max; float min and max
// propagate NaN as jnp's .at[].min/.max do: a NaN row replaces any
// number, a stored NaN is never replaced (segment_fold.cu's rule).
// Integer adds wrap, as XLA's do.  The product is __fmul_rn, so it is
// never contracted into an FMA with an add.
//
// Rows i >= n_f are padding: the JAX program folds the identity into
// their target (shard 0's scratch slot); here they are not read, which
// leaves every real slot, and a scratch slot at its identity, the same.
//
// Determinism.  Every process must end a round with bit-identical
// tables, so there are no atomics on the tables: within one frame the
// real rows' targets are unique (each frame is one peer's chunk,
// pre-reduced per key), so one thread a row reads, combines and writes
// its slot, every field of the row in turn; and frame f + 1 starts only
// after every row of frame f is written, so a slot that two frames hit
// takes them in peer order.  The kernel holds the uniqueness rather
// than assume it: each row sets its target's bit in a bitmap of the
// table, one check a frame for all its fields, and a row that finds the
// bit set already, or a target outside the table, counts itself in the
// error words (and the first frame at fault) and writes nothing.  The
// host wrapper (ops/merge_kernel.py) reads the words back once a round
// and raises, naming the frame.
//
// Design: one launch a round, of up to 16 thread-block clusters of
// kCluster = 8 blocks (the portable cluster size) of 1024 threads.
// Cluster q owns slice q of the tables (a contiguous run of slots) and
// alone writes it: every cluster reads every frame's targets (4 B a
// row, coalesced) and folds the rows whose target lies in its slice.
// Frame order only matters slot by slot, so the barrier between frames
// is the cluster's own, cluster.sync(), a hardware barrier: no grid-wide
// barrier is needed, and the random table accesses, which one
// cluster's 8 SMs would take one by one, spread over up to 128 SMs.
// The grid takes a cluster for each 1,024 rows of the largest frame, at
// most 16 and at most as many as the card holds at once.  The slice's uniqueness bitmap lives in the cluster's
// distributed shared memory: word w of it in block w % 8, set with
// atomicOr through map_shared_rank.  Two bitmaps alternate, so a block
// clears the next frame's while the current one runs, and a frame costs
// one barrier.  The 8,190-slot table of two processes needs 1 KB of
// bitmap, 64 shards of 4,096 slots 32 KB, split over the clusters; the
// wrapper refuses a table whose bitmaps would not fit one cluster's
// shared memory (about 7 million slots).  A cooperative grid sync would
// cost microseconds a barrier and need the bitmap in device memory,
// cleared between frames.  Each thread loads kBatch targets before it
// uses one, and reads a row's values and table slots together, before
// its bitmap check (which they do not depend on).  The stats kind's
// four fields are the most a round carries (kMaxFields), which keeps a
// frame's descriptor and a row in registers at 1,024 threads a block.
// Each cluster counts errors in its own three words, cleared before its
// first barrier, so no cluster waits on another.  The tables are read
// and written with ld.cg / st.cg (through L2, which every SM sees), so
// a frame never reads a stale L1 line of a slot the frame before wrote
// on another SM; cluster.sync() orders the writes (release) before the
// next frame's reads (acquire).
//
// What bounds it.  A frame's bytes (4 B of target and 1-4 B of part a
// row a field, 8 B of table read and written a row a field) take well
// under a microsecond at 3.35 TB/s, so the call is bound by its launch,
// its barriers and the latency of its scattered slot accesses; one
// launch a round instead of one a (frame, field).
//
// The round arrives as one buffer: a descriptor block of int64 words,
// [n_frames][2 + 3 * n_fields] = (gidx, n, then (enc, part 0, part 1)
// a field), where gidx and the parts are byte offsets from `base`
// (engine/xla.py `pack_merge_round` lays it out; a single frame's
// descriptor may hold device addresses with base 0).  The host wrapper
// checks every argument, allocates the error words (the kernel clears
// them, a cluster its own), passes PyTorch's current stream, and raises
// on a non-zero return, which is the launch's cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum { ENC_RAW = 0, ENC_INT8 = 1, ENC_BF16 = 2 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
constexpr int kQBlock = 1024;
constexpr int kThreads = 1024;
constexpr int kCluster = 8;
constexpr int kMaxFields = 4;  // the stats kind's min, max, sum, count
constexpr int kMaxClusters = 16;  // 128 of the card's 132 SMs
constexpr int kRowsPerCluster = 1024;  // rows of the largest frame a cluster
constexpr int kBatch = 4;  // a thread's targets loaded at once
constexpr long long kMaxSmem = 227 * 1024;

struct Round {
  void* table[kMaxFields];
  int table_int[kMaxFields];
  int op[kMaxFields];
  int n_fields;
  int n_frames;
  long long size;
  const long long* desc;
  const char* base;
  unsigned* err;  // a cluster: [repeated, outside, first frame at fault]
  int slice;      // table slots a cluster owns (a multiple of 32)
  int share;      // bitmap words a block holds
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// Row i of a part, dequantized and cast to its table's type (int32
// where is_int), as the table's 32 bits.
__device__ __forceinline__ uint32_t value_bits(int enc, int is_int, const char* p0, const char* p1,
                                               long long i) {
  if (enc == ENC_RAW) return __ldg(reinterpret_cast<const uint32_t*>(p0) + i);
  float v;
  if (enc == ENC_INT8) {
    const float scale = __ldg(reinterpret_cast<const float*>(p0) + i / kQBlock);
    const float q = static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p1) + i));
    // __fmul_rn: the product is rounded on its own, never contracted
    // into an FMA with the add below (XLA rounds it on its own too).
    v = __fmul_rn(q, scale);
  } else {
    const uint32_t hi = __ldg(reinterpret_cast<const unsigned short*>(p0) + i);
    v = __uint_as_float(hi << 16);
  }
  return is_int ? static_cast<uint32_t>(__float2int_rz(v)) : __float_as_uint(v);
}

__device__ __forceinline__ uint32_t combine_bits(int op, int is_int, uint32_t old_bits, uint32_t v_bits) {
  if (is_int) {
    if (op == OP_ADD) return old_bits + v_bits;  // wraps, as XLA's add does
    const int old = static_cast<int>(old_bits);
    const int v = static_cast<int>(v_bits);
    return (op == OP_MIN ? v < old : v > old) ? v_bits : old_bits;
  }
  const float old = __uint_as_float(old_bits);
  const float v = __uint_as_float(v_bits);
  if (op == OP_ADD) return __float_as_uint(__fadd_rn(old, v));
  if (is_nan(old)) return old_bits;
  if (is_nan(v)) return v_bits;
  return (op == OP_MIN ? v < old : v > old) ? v_bits : old_bits;
}

// One frame's descriptor, in registers.
struct Frame {
  const int* gidx;
  long long n;
  int enc[kMaxFields];
  const char* p0[kMaxFields];
  const char* p1[kMaxFields];
};

__device__ __forceinline__ Frame frame_of(const Round& r, int f) {
  const long long* d = r.desc + static_cast<long long>(f) * (2 + 3 * r.n_fields);
  Frame fr;
  fr.gidx = reinterpret_cast<const int*>(r.base + __ldg(d));
  fr.n = __ldg(d + 1);
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k < r.n_fields) {
      fr.enc[k] = static_cast<int>(__ldg(d + 2 + 3 * k));
      fr.p0[k] = r.base + __ldg(d + 3 + 3 * k);
      fr.p1[k] = r.base + __ldg(d + 4 + 3 * k);
    }
  }
  return fr;
}

// Fold row i of frame f (target g, in this cluster's slice from `lo`):
// its values and its slots read together (none waits on another, nor on
// the uniqueness check), its bit set in the slice's bitmap, then each
// field's slot written, or an error counted.
__device__ __forceinline__ void fold_row(const Round& r, const Frame& fr, cg::cluster_group& cluster,
                                         unsigned* bitmap, unsigned* err, int g, int lo, long long i,
                                         int f) {
  uint32_t v[kMaxFields];
  uint32_t old[kMaxFields];
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k < r.n_fields) {
      v[k] = value_bits(fr.enc[k], r.table_int[k], fr.p0[k], fr.p1[k], i);
      old[k] = __ldcg(static_cast<const unsigned*>(r.table[k]) + g);
    }
  }
  const unsigned word = static_cast<unsigned>(g - lo) >> 5;
  unsigned* at = cluster.map_shared_rank(bitmap + word / kCluster, word % kCluster);
  const unsigned bit = 1u << (g & 31);
  if (atomicOr(at, bit) & bit) {
    atomicAdd(&err[0], 1u);
    atomicMin(&err[2], static_cast<unsigned>(f));
    return;
  }
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k < r.n_fields) {
      __stcg(static_cast<unsigned*>(r.table[k]) + g, combine_bits(r.op[k], r.table_int[k], old[k], v[k]));
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    merge_round(Round r) {
  extern __shared__ unsigned bits[];  // two bitmaps of `share` words
  cg::cluster_group cluster = cg::this_cluster();
  // This cluster's slice of the tables: it alone writes these slots.
  const int q = static_cast<int>(blockIdx.x / kCluster);
  const int lo = q * r.slice;
  const long long hi = lo + static_cast<long long>(r.slice) < r.size ? lo + r.slice : r.size;
  const long long first = static_cast<long long>(cluster.block_rank()) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(kCluster) * kThreads;
  // This cluster's error words, cleared before its first barrier.
  unsigned* err = r.err + 3 * q;
  for (int w = threadIdx.x; w < r.share; w += kThreads) bits[w] = 0;
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    err[0] = 0;
    err[1] = 0;
    err[2] = 0xffffffffu;
  }
  cluster.sync();
  for (int f = 0; f < r.n_frames; ++f) {
    unsigned* cur = bits + (f & 1) * r.share;
    unsigned* next = bits + ((f + 1) & 1) * r.share;
    for (int w = threadIdx.x; w < r.share; w += kThreads) next[w] = 0;
    const Frame fr = frame_of(r, f);
    for (long long i0 = first; i0 < fr.n; i0 += stride * kBatch) {
      // The targets of kBatch rows, loaded before any is used.
      int g[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long i = i0 + j * stride;
        g[j] = i < fr.n ? __ldg(fr.gidx + i) : lo;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long i = i0 + j * stride;
        if (i >= fr.n) continue;
        if (g[j] < 0 || g[j] >= r.size) {
          if (q == 0) {  // every cluster sees the row; one counts it
            atomicAdd(&err[1], 1u);
            atomicMin(&err[2], static_cast<unsigned>(f));
          }
        } else if (g[j] >= lo && g[j] < hi) {
          fold_row(r, fr, cluster, cur, err, g[j], lo, i, f);
        }
      }
    }
    // Every row of frame f in this slice written, and the next bitmap
    // clear, before frame f + 1; the last barrier also keeps every
    // block's shared memory alive until no other block reads it.
    cluster.sync();
  }
}

}  // namespace

extern "C" {

// Fold one round of n_frames frames into n_fields tables of `size`
// slots (tables[k] float32, or int32 where table_int[k]; ops[k] the
// field's combine), on `stream` of CUDA device `device` (the calling
// thread's current device is left as it was).  max_rows is the most
// real rows of a frame (it sizes the grid); desc and base as in the
// header.  err holds 3 words for each of up to kMaxClusters clusters;
// *n_clusters receives the grid's clusters, and cluster q's words the
// repeated-target count, the outside-table count and the first frame
// at fault (0xffffffff for none) of its slice.  Returns the launch's
// cudaError_t (0 on success).
int bw_agg_merge_round(void* const* tables, const int* table_int, const int* ops, int n_fields,
                       long long size, int n_frames, long long max_rows, const void* desc,
                       const void* base, void* err, int* n_clusters, void* stream, int device) {
  if (n_fields < 1 || n_fields > kMaxFields || size < 1 || size > 0x7fffffffLL ||
      n_frames < 0 || max_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Round r;
  for (int k = 0; k < kMaxFields; ++k) {
    const bool live = k < n_fields;
    if (live && (ops[k] < OP_ADD || ops[k] > OP_MAX)) return static_cast<int>(cudaErrorInvalidValue);
    r.table[k] = live ? tables[k] : nullptr;
    r.table_int[k] = live ? table_int[k] : 0;
    r.op[k] = live ? ops[k] : OP_ADD;
  }
  r.n_fields = n_fields;
  r.n_frames = n_frames;
  r.size = size;
  r.desc = static_cast<const long long*>(desc);
  r.base = static_cast<const char*>(base);
  r.err = static_cast<unsigned*>(err);
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (current != device && (e = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(e);
  // Clusters the card holds at once (a cluster needs 8 free SMs of one
  // GPC): more would run after the first ones, a second wave.
  static int resident[64] = {};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * kMaxClusters);
    cfg.blockDim = dim3(kThreads);
    int held = 0;
    e = cudaOccupancyMaxActiveClusters(&held, merge_round, &cfg);
    if (e != cudaSuccess) {
      if (current != device) cudaSetDevice(current);
      return static_cast<int>(e);
    }
    resident[device] = held > 0 ? held : 1;
  }
  long long clusters = (max_rows + kRowsPerCluster - 1) / kRowsPerCluster;
  if (clusters < 1) clusters = 1;
  if (clusters > kMaxClusters) clusters = kMaxClusters;
  if (clusters > resident[device]) clusters = resident[device];
  const long long slice = (((size + clusters - 1) / clusters) + 31) / 32 * 32;
  clusters = (size + slice - 1) / slice;
  *n_clusters = static_cast<int>(clusters);
  r.slice = static_cast<int>(slice);
  r.share = static_cast<int>((slice / 32 + kCluster - 1) / kCluster);
  const long long smem = 2LL * r.share * 4;
  if (smem > kMaxSmem) {
    if (current != device) cudaSetDevice(current);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(merge_round, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    merge_round<<<static_cast<unsigned>(clusters * kCluster), kThreads, static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(r);
    e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

}  // extern "C"
