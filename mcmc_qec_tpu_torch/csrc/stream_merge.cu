// Merge one stream window of the counting decoders into every row's
// bounded buffer of unique chains, on Hopper (sm_90a): one block a row.
//
// Replaces no TPU kernel.  The JAX package merges with two lax.sorts
// (mcmc_qec_tpu/decoders/streaming.py:87-112), and the port's plain version,
// decoders/streaming.py::_merge_row, with two segmented sorts of the buffer
// and the window together: one by key to find duplicates and one by rank to
// order the survivors.  This kernel gives the same five outputs bit for bit
// (the C smallest unique (rank, key) entries in (rank, key) order, and per
// row the new chains found, whether the buffer overflowed and the rank in
// its last slot when full), from one sort of the window alone.
//
// Why one sort is enough: a rank is a function of the chain's content, so
// every copy of a chain carries the same (rank, key), and any one copy
// stands for all.  Sorted by the composite (rank, key), the survivors are
// in the order the buffer keeps; the buffer is in that order already, so
// it is merged, not sorted again.
//
// What bounds it on this card: at the STDC cell's shape (16,384 rows, 4096
// slots and 4096 candidates a row) the bytes are 2.95 GB a window (the
// candidates' key halves and ranks, 20 bytes each, the buffer read and
// written, 12 bytes a slot each way), 0.9 ms at 3.35 TB/s; the sort of
// 16-byte items a block in shared memory sets the pace.  The design:
//   - An item is two 64-bit words, compared as one 128-bit integer: the
//     rank mapped to an order-preserving 32-bit integer (-0.0 as +0.0,
//     since torch.sort ties them), the key's 64 bits (its int64 sort key
//     with the sign bit flipped), and the rank's own bits last, so that the
//     output keeps -0.0.  A dead candidate (a rank that is not finite:
//     conv_mult's invalid steps, an infinite weight) is all ones and sorts
//     last.
//   - The window's candidates are read coalesced and packed from K1's key
//     halves.  One copy of each chain is kept, the first to enter an
//     open-addressing set of the window's keys in shared memory.  When the
//     buffer is full, a copy above its last entry (the tail) can take no
//     slot and is new (the buffer holds nothing of its rank): it is only
//     counted.  The rest (the head: all of them while the buffer has room,
//     few once it is full, since most of a new window's chains rank above
//     the C best of the windows before) is staged and sorted with CUB's
//     block merge sort at the least width that holds it (1, 2, 4 or 8
//     items a thread), then kept in shared memory.
//   - A head candidate is new when no buffer entry has its key.  Each
//     buffer entry finds its place among the sorted head (its lower bound
//     p: a thread takes 8 consecutive entries, a binary search for the
//     first, then steps up from the last p), marks the candidate at p when
//     that one has its key, and adds one to a count at p.  One block scan
//     over the positions then gives, packed in one 32-bit word, the new
//     candidates before each position and the buffer entries at or before
//     it: a new candidate's slot is the sum of the two, a buffer entry's
//     its own index plus the new candidates before its p.  Slots below C
//     are written, the rest filled with the empty entry (the sentinel key,
//     +inf).
// The buffer's counts share the scan word with the candidates', 16 bits
// each: up to 65,535 slots and 8192 candidates a row
// (ops/stream_merge.py::merge_kernel_fits routes larger shapes to the
// plain version).
//
// Built by mcmc_qec_tpu_torch/ops/_build.py and bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/block/block_merge_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace mqt {

constexpr int kItemsPerThread = 8;         // ops/stream_merge.py::ITEMS_PER_THREAD
constexpr int kMaxCapacity = 0xFFFF;       // ops/stream_merge.py::MAX_CAPACITY
constexpr int kRun = 8;                    // consecutive buffer entries a thread places
constexpr int64_t kSentinelKey = 0x7FFFFFFFFFFFFFFFLL;  // streaming.py::_SENTINEL_KEY
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr unsigned long long kSignBit = 1ull << 63;

// Must match ops/stream_merge.py::_Params field for field.
struct MergeParams {
  int32_t R;      // rows, one block each
  int32_t C;      // buffer slots a row
  int32_t S;      // window candidates a row
  int32_t items;  // sort width: a power of two from 1024 to 8192, >= S
};

// Must match ops/stream_merge.py::_Buffers.
struct MergeBuffers {
  const int64_t* key_in;   // (R, C) buffer sort keys in (rank, key) order
  const uint32_t* r_in;    // (R, C) their f32 ranks' bits, +inf empty
  const int64_t* halves;   // (R, S, 2) candidate key halves, values in [0, 2**32)
  const uint32_t* rank;    // (R, S) candidate f32 ranks' bits
  const uint8_t* valid;    // (R, S) bool, or null: every candidate valid
  int64_t* key_out;        // (R, C)
  uint32_t* r_out;         // (R, C)
  int32_t* disc;           // (R,) new unique chains of the window
  uint8_t* overflowed;     // (R,) bool: more unique chains than slots
  uint32_t* max_kept;      // (R,) rank in slot C - 1 when full, else +inf
};

struct Item {
  unsigned long long hi, lo;
};

struct ItemLess {
  __device__ __forceinline__ bool operator()(const Item& x, const Item& y) const {
    return x.hi < y.hi || (x.hi == y.hi && x.lo < y.lo);
  }
};

__device__ __forceinline__ bool finite_bits(uint32_t b) {
  return (b & kInfBits) != kInfBits;
}

// An order-preserving map of a finite f32 to u32, with -0.0 as +0.0.
__device__ __forceinline__ uint32_t rank_order(uint32_t b) {
  if ((b << 1) == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The item of a chain with rank bits ``rb`` and key order ``u`` (the int64
// sort key with its sign bit flipped); all ones when the rank is not finite.
__device__ __forceinline__ Item make_item(uint32_t rb, unsigned long long u) {
  if (!finite_bits(rb)) return Item{~0ull, ~0ull};
  return Item{((unsigned long long)rank_order(rb) << 32) | (u >> 32), (u << 32) | rb};
}

__device__ __forceinline__ bool is_dead(const Item& x) { return (x.hi >> 32) == 0xFFFFFFFFull; }
__device__ __forceinline__ unsigned long long key_of(const Item& x) { return (x.hi << 32) | (x.lo >> 32); }

// The first index of the sorted s[0, n) whose item is not below x.
__device__ __forceinline__ int lower_bound(const Item* s, int n, const Item& x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (ItemLess()(s[lo + half], x)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The first index of the sorted s[lo, n) whose item is not below x, when
// every item before lo is below it: steps up from lo, doubling, then
// searches the last step.  Consecutive buffer entries find their places
// among the candidates close together.
__device__ __forceinline__ int lower_bound_from(const Item* s, int lo, int n, const Item& x) {
  int hi = lo, step = 1;
  while (hi < n && ItemLess()(s[hi], x)) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  if (hi > n) hi = n;
  return lo + lower_bound(s + lo, hi - lo, x);
}

template <int T, int IPT = kItemsPerThread>
using BlockSort = cub::BlockMergeSort<Item, T, IPT>;

// Bytes of the region that serves in turn as the set of the window's keys
// (2 N slots of 8 bytes), the staged items, the sort's storage and the
// sorted items.
template <int T>
__host__ __device__ constexpr size_t sort_bytes() {
  constexpr size_t a = sizeof(typename BlockSort<T>::TempStorage);
  constexpr size_t b = sizeof(Item) * T * kItemsPerThread;
  return ((a > b ? a : b) + 15) / 16 * 16;
}

// Dynamic shared memory of a block: that region, then one 32-bit scan word
// a position.
template <int T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sort_bytes<T>() + sizeof(uint32_t) * T * kItemsPerThread;
}

constexpr unsigned long long kEmptySlot = ~0ull;  // a slot of the set with no key

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n >> 1) : 0; }

// Put the key order ``u`` in the open-addressing set of SLOTS slots; true
// when it was not there yet.  The one key equal to the empty slot's mark
// has a flag of its own.
template <int SLOTS>
__device__ __forceinline__ bool insert_key(unsigned long long* set, unsigned long long u,
                                           int* all_ones) {
  constexpr int kShift = 32 - ilog2(SLOTS);
  if (u == kEmptySlot) return atomicExch(all_ones, 1) == 0;
  unsigned h = (((uint32_t)u ^ (uint32_t)(u >> 32)) * 0x9E3779B1u) >> kShift;
  while (true) {
    const unsigned long long prev = atomicCAS(&set[h], kEmptySlot, u);
    if (prev == kEmptySlot) return true;
    if (prev == u) return false;
    h = (h + 1) & (SLOTS - 1);
  }
}

// Sort the ``n`` items staged at the start of ``region`` (n <= T * IPT) by
// (rank, key) and store them there, padded with dead items up to T * IPT,
// which it returns.
template <int T, int IPT>
__device__ __forceinline__ int sort_staged(unsigned char* region, int n) {
  using Sort = BlockSort<T, IPT>;
  Item* s = reinterpret_cast<Item*>(region);
  Item keys[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = threadIdx.x * IPT + k;
    keys[k] = i < n ? s[i] : Item{~0ull, ~0ull};
  }
  __syncthreads();
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(region)).Sort(keys, ItemLess());
  __syncthreads();
#pragma unroll
  for (int k = 0; k < IPT; ++k) s[threadIdx.x * IPT + k] = keys[k];
  return T * IPT;
}

template <int T>
__global__ void __launch_bounds__(T, 1024 / T)
    stream_merge_kernel(const MergeParams P, const MergeBuffers buf) {
  constexpr int N = T * kItemsPerThread;
  constexpr int kSlots = 2 * N;
  using Scan = cub::BlockScan<uint32_t, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_set = reinterpret_cast<unsigned long long*>(smem);
  Item* s_items = reinterpret_cast<Item*>(smem);
  // bits 16-31: buffer entries whose lower bound is this position; bit 0:
  // the candidate here has a buffer entry's key.  After the scan: the new
  // candidates before this position.
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(smem + sort_bytes<T>());
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_before, s_ones;

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int C = P.C, S = P.S;
  const longlong2* halves = reinterpret_cast<const longlong2*>(buf.halves) + row * S;
  const uint32_t* rank = buf.rank + row * S;
  const uint8_t* valid = buf.valid ? buf.valid + row * S : nullptr;
  const int64_t* key_in = buf.key_in + row * C;
  const uint32_t* r_in = buf.r_in + row * C;
  int64_t* key_out = buf.key_out + row * C;
  uint32_t* r_out = buf.r_out + row * C;

  for (int i = tid; i < kSlots; i += T) s_set[i] = kEmptySlot;
  for (int i = tid; i < N; i += T) s_cnt[i] = 0;
  if (tid == 0) {
    s_before = 0;
    s_ones = 0;
  }
  // the buffer's last entry: a buffer whose last slot is taken is full,
  // and a candidate above that entry can take no slot (dead when not full)
  const Item last = make_item(r_in[C - 1], (unsigned long long)key_in[C - 1] ^ kSignBit);
  const bool full = !is_dead(last);

  // 1. the window's candidates, read coalesced
  Item it[kItemsPerThread];
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int i = k * T + tid;
    it[k] = Item{~0ull, ~0ull};
    if (i < S && (valid == nullptr || valid[i])) {
      const longlong2 h = halves[i];
      // streaming.py::_pack's (k1 - 2**31) * 2**32 + k2, sign bit flipped
      const unsigned long long u =
          ((unsigned long long)h.x << 32) + (unsigned long long)h.y;
      it[k] = make_item(rank[i], u);
    }
  }
  __syncthreads();  // the set is empty

  // 2. one copy of each chain, the first into the set.  A copy above a full
  //    buffer's last entry (the tail) is new, since the buffer holds no
  //    chain of its rank and key, and takes no slot: it is only counted.
  //    The others (the head) go on to the sort.
  unsigned head = 0;
  uint32_t n_tail = 0;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    if (is_dead(it[k]) || !insert_key<kSlots>(s_set, key_of(it[k]), &s_ones)) continue;
    if (full && ItemLess()(last, it[k]))
      ++n_tail;
    else
      head |= 1u << k;
  }
  uint32_t off, counts;
  Scan(scan_tmp).ExclusiveSum((n_tail << 16) | (uint32_t)__popc(head), off, counts);
  const int n_head = (int)(counts & 0xFFFFu);
  const int n_tail_new = (int)(counts >> 16);
  __syncthreads();  // the set is read no more

  // 3. the head, staged and sorted by (rank, key) at the least width that
  //    holds it
  off &= 0xFFFFu;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k)
    if ((head >> k) & 1u) s_items[off++] = it[k];
  __syncthreads();
  int M;
  if (n_head <= T)
    M = sort_staged<T, 1>(smem, n_head);
  else if (n_head <= 2 * T)
    M = sort_staged<T, 2>(smem, n_head);
  else if (n_head <= 4 * T)
    M = sort_staged<T, 4>(smem, n_head);
  else
    M = sort_staged<T, 8>(smem, n_head);
  __syncthreads();

  // 4. each buffer entry's lower bound p among the sorted head.  A thread
  //    takes runs of kRun consecutive entries (the finite ones are the
  //    buffer's prefix): a binary search for the first, then steps up from
  //    the last p, and one atomic a distinct p.
  int mine = 0;
  for (int j0 = tid * kRun; j0 < C; j0 += T * kRun) {
    int p = 0, at = -1;
    uint32_t add = 0;
    for (int j = j0; j < C && j < j0 + kRun; ++j) {
      const uint32_t rb = r_in[j];
      if (!finite_bits(rb)) break;
      ++mine;
      if (p == M) continue;  // above the whole head, as the rest of the run
      const unsigned long long u = (unsigned long long)key_in[j] ^ kSignBit;
      const Item x = make_item(rb, u);
      p = j == j0 ? lower_bound(s_items, M, x) : lower_bound_from(s_items, p, M, x);
      if (p == M) continue;
      if (p != at) {
        if (add) atomicAdd(&s_cnt[at], add);
        at = p;
        add = 0;
      }
      const Item& c = s_items[p];
      add += (1u << 16) | (uint32_t)(!is_dead(c) && key_of(c) == u);
    }
    if (add) atomicAdd(&s_cnt[at], add);
  }
  if (mine) atomicAdd(&s_before, mine);
  __syncthreads();

  // 5. new in the head: alive and not in the buffer (the keys are distinct
  //    now); one scan of (buffer entries at p, new at p)
  uint32_t v[kItemsPerThread];
  unsigned fresh = 0;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int i = tid * kItemsPerThread + k;
    const uint32_t c = i < M ? s_cnt[i] : 0u;
    const bool f = i < M && !is_dead(s_items[i]) && !(c & 1u);
    fresh |= (unsigned)f << k;
    v[k] = (c & 0xFFFF0000u) | (uint32_t)f;
  }
  uint32_t total;
  Scan(scan_tmp).InclusiveSum(v, v, total);
  const int n_head_new = (int)(total & 0xFFFFu);
  const int n_new = n_head_new + n_tail_new;
  const int n_all = s_before + n_new;

  // 6. the new head candidates' slots
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int i = tid * kItemsPerThread + k;
    if (i >= M) break;
    const bool f = (fresh >> k) & 1u;
    s_cnt[i] = (v[k] & 0xFFFFu) - (uint32_t)f;
    if (!f) continue;
    const int slot = (int)(v[k] & 0xFFFFu) - 1 + (int)(v[k] >> 16);
    if (slot < C) {
      const Item x = s_items[i];
      key_out[slot] = (int64_t)(key_of(x) ^ kSignBit);
      r_out[slot] = (uint32_t)x.lo;
      if (slot == C - 1) buf.max_kept[row] = (uint32_t)x.lo;
    }
  }
  __syncthreads();

  // 7. the buffer entries' slots: own index plus the new head candidates
  //    below (the tail lies above every buffer entry)
  for (int j0 = tid * kRun; j0 < C; j0 += T * kRun) {
    int p = 0;
    for (int j = j0; j < C && j < j0 + kRun; ++j) {
      const uint32_t rb = r_in[j];
      if (!finite_bits(rb)) break;
      const int64_t key = key_in[j];
      if (p < M) {
        const Item x = make_item(rb, (unsigned long long)key ^ kSignBit);
        p = j == j0 ? lower_bound(s_items, M, x) : lower_bound_from(s_items, p, M, x);
      }
      const int slot = j + (p < M ? (int)s_cnt[p] : n_head_new);
      if (slot < C) {
        key_out[slot] = key;
        r_out[slot] = rb;
        if (slot == C - 1) buf.max_kept[row] = rb;
      }
    }
  }

  // 8. the empty slots and the row's counts
  for (int j = n_all + tid; j < C; j += T) {
    key_out[j] = kSentinelKey;
    r_out[j] = kInfBits;
  }
  if (tid == 0) {
    buf.disc[row] = n_new;
    buf.overflowed[row] = n_all > C;
    if (n_all < C) buf.max_kept[row] = kInfBits;
  }
}

template <int T>
int launch(const MergeParams& P, const MergeBuffers& buf, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T>();
  static_assert(smem <= 227 * 1024, "a block's shared memory exceeds the 227 KB of an sm_90 block");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stream_merge_kernel<T><<<P.R, T, smem, st>>>(P, buf);
  return (int)cudaGetLastError();
}

}  // namespace mqt

// Merge the window into every row's buffer on ``stream``; returns the
// cudaError_t of the launch (0 on success).  Asynchronous.
extern "C" int mqt_stream_merge(const mqt::MergeParams* P, const mqt::MergeBuffers* buf,
                                void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  if (P->R <= 0 || P->C <= 0 || P->C > mqt::kMaxCapacity || P->S <= 0 || P->S > P->items)
    return (int)cudaErrorInvalidValue;
  if (!buf->key_in || !buf->r_in || !buf->halves || !buf->rank || !buf->key_out ||
      !buf->r_out || !buf->disc || !buf->overflowed || !buf->max_kept)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P->items) {
    case 1024: return mqt::launch<128>(*P, *buf, st);
    case 2048: return mqt::launch<256>(*P, *buf, st);
    case 4096: return mqt::launch<512>(*P, *buf, st);
    case 8192: return mqt::launch<1024>(*P, *buf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
