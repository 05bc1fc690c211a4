// The quorum plane's wave scan with the fused wave's digest gate, written for
// Hopper (sm_90a).
//
// quorum_accumulate_kernel replaces two plain-JAX programs in one launch:
// - the quorum scan (mirbft_tpu/ops/quorum.py:66, `_kernel`, exported as
//   `accumulate_body` and jitted by `device_accumulate`): per wave of a
//   stream, OR the wave's source bit into each touched (slot, digest) mask
//   word, count the touches whose bit was new, and return every touch's
//   post-count and newbit;
// - the digest gate of the fused wave (mirbft_tpu/ops/fused.py:113-118):
//   a touch with digest_rows >= 0 counts only if row clip(digest_rows) of
//   [prev_words; digests] equals its 8 claimed words and that row's group
//   tag equals the touch's.  The concatenation is never built: row r reads
//   prev_words[r] below P and digests[r - P] from there.  With no rows at
//   all (P + B = 0, the tables `device_accumulate` passes, whose digest_rows
//   are all -1) a gated touch fails closed.
//
// What it computes, bit for bit with the JAX program (not with the numpy
// `host_accumulate`, which raises on what JAX clamps or drops):
// - The source's word and bit are its floor quotient and remainder by 32
//   (an arithmetic shift and a mask), so source -1 is word -1, bit 31.
// - Every index is taken from the end when negative.  Reads (the old mask
//   word, the post-count) then clamp to the edge; writes (the OR, the count
//   add) still out of range are dropped.  So a slot >= W reads row W-1's
//   word and count and changes nothing; a source of 300 reads word 7 and
//   leaves the masks alone while its count still grows.
// - Every touch of a wave reads its old word before any touch writes, so a
//   (slot, digest) pair touched twice in one wave is new twice and counts
//   twice, as the JAX scan's vectorised gather then scatter does.  The mask
//   word changes only where a touch is new, and then to old | bit: the JAX
//   program's scatter-max of old | bit writes exactly that.
// The result is the same whatever order the atomics run in: OR and integer
// add commute.
//
// What bounds it.  Not bytes (a stream of N waves of K touches moves ~100 B
// a touch) nor operations, but the chain of the scan: the waves are a
// sequential scan, each reading the words and counts the last one wrote,
// so one CTA runs a stream.  The kernel's first version kept the state in
// device memory and made each wave about five dependent round trips to L2
// (the touch and gate loads, the old word, the atomics, the count), ~1.56
// us a wave.  The state (512 KiB of masks at W = 4,096, D = 4) cannot sit
// in one SM, but a stream touches at most N x K of its rows, and nothing
// but the scan itself depends on the quorum state.  So a launch runs in four stages:
//
// 1. Staging, for every touch of a chunk at once, over the whole block: the
//    gate, the read row read_index(w) * D + read_index(d) (a read-clamped
//    touch keys to the row it reads), whether the write indices are in
//    range, and the source's word and bit, packed into one word a touch
//    (`TouchInfo`); and the touch's row (8 mask words and the count),
//    staged in the touch's own column of the table.  A row's entry is one
//    touch that reads it: with the direct map (W x D <= kDirectRows, 32 KiB
//    of u16) every touch stores its index at its row, a plain store of
//    which one lands; above that, a shared-memory open-addressing table
//    (atomicCAS on the key, linear probing) keeps the inserting touch's.
//    Every load is independent of the quorum state and issued before any
//    is used: two dependent round trips (the touch, then its row and gate
//    rows), not N.
// 2. Each touch's row or slot becomes its entry and the place of its mask
//    word; with one warp a wave (K <= 32), each touch's group too: the
//    wave's touches of its entry share the old word and count, and the
//    group's count of valid in-range touches is what the wave adds when the
//    bit was clear.
// 3. The scan, on shared memory.  K <= 32: one warp, two phases a wave
//    split by __syncwarp and no atomics: every touch reads the old word and
//    count and takes post = count + (bit clear ? group count : 0); the
//    group's first touch alone writes the word and count.  32 < K <= 1024:
//    the warps that hold a wave, three phases split by a named barrier
//    (old word and newbit; shared atomicOr and atomicAdd where the writes
//    are in range; the post-count).  Posts and newbits stay in shared
//    memory: a store to device memory before a barrier holds the barrier
//    until it lands.
// 4. Write-back: each entry the scan wrote stores its words and count (its
//    row recomputed from its touch's indices), and every touch its
//    post-count and newbit, coalesced.
// A chunk where no touch passes its gate with its writes in range (every
// path launch so far: one all-invalid wave) skips stages 2-4 but the
// posts and newbits, which it takes from the rows stage 1 staged.
//
// What bounds it now (NVIDIA H100 80GB HBM3, clock64 stamps of an
// instrumented copy): the scan's chain, ~310 cycles a wave with one warp
// and ~510 with a block; and staging, which waits on the SM's L1 for
// ~9 requests a touch to scattered rows (mask row, count, digest row,
// claim, group tags): ~8 cycles a touch at 2,560 touches, one SM's rate.
// The launch floor (an empty kernel, ~2 us back to back) is the rest.
//
// The table holds a chunk of whole waves of at most `capacity` touches
// (kCapacity on the card), so its entries never exceed it; a longer stream
// runs chunk after chunk inside the one launch, each staged, scanned and
// written back before the next.  The hash table has the next power of two
// >= 2x the chunk's touches in slots, and the shared memory is sized to the
// chunk.  A stream whose waves are wider than the capacity or a block (or
// whose W x D rows do not fit a 32-bit key) runs the first version's global
// phases on device memory instead, in the same kernel.  Nothing the JAX
// program takes is refused.
//
// Outside the kernel and its launcher the code is plain C++: built for the
// host with a C++ compiler (outside __CUDACC__), `accumulate_host` runs the
// same stages (the direct map or the hash table, chunks, both scans and the
// global branch), each over every index in turn where the card has a
// barrier and with plain stores where it has atomics, at any capacity,
// which is how the design is checked without a card.
//
// Plain C interface for ctypes: the launcher takes device pointers, the
// sizes and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns cudaGetLastError().  `mirbft_quorum_plan` reports
// a launch's table, chunks, shared memory and block size.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <vector>
#endif
#include <stdint.h>

namespace quorum {

constexpr int kMaskWords = 8;
constexpr int kMaxThreads = 1024;
// Touches a chunk holds on the card: 221,184 bytes of shared memory, under
// the 227 KiB (232,448 bytes) a Hopper block may opt into.
constexpr long long kCapacity = 4096;
// A touch's slot or row, then its mask word's place, must fit TouchInfo's
// 16 bits.
constexpr long long kMaxCapacity = 1 << 13;
// State of at most this many rows (W x D) finds its entries through a
// direct map of rows in shared memory (32 KiB), larger state through the
// hash table.
constexpr long long kDirectRows = 1 << 14;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

// One launch's tensors and sizes (masks and counts are updated in place).
struct Stream {
  uint32_t* masks;  // [W, D, 8]
  int32_t* counts;  // [W, D]
  long long W, D;
  const int32_t* sources;  // [N]
  const int32_t* touches;  // [N, K, 2]
  const uint8_t* valid;    // [N, K]
  long long N, K;
  const uint32_t* prev_words;  // [P, 8]
  long long P;
  const uint32_t* digests;  // [B, 8]
  long long B;
  const int32_t* digest_rows;   // [N, K], -1: ungated
  const uint32_t* claimed;      // [N, K, 8]
  const int32_t* row_groups;    // [P + B]
  const int32_t* touch_groups;  // [N, K]
  int32_t* posts;               // [N, K]
  uint8_t* newbits;             // [N, K]
};

// A gather index: from the end when negative, then clamped.
__host__ __device__ inline long long read_index(long long i, long long size) {
  if (i < 0) i += size;
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// A scatter index: from the end when negative; -1 when still out of range.
__host__ __device__ inline long long write_index(long long i, long long size) {
  if (i < 0) i += size;
  return i >= 0 && i < size ? i : -1;
}

__host__ __device__ inline uint32_t load_u32(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

__host__ __device__ inline int32_t load_i32(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// Eight words of one row (a mask row, a digest, a claim): two 16-byte
// accesses where the row is 16-byte aligned, else eight 4-byte ones.  A
// thread loading whole rows at scattered places makes one L1 request per
// access, and one SM's L1 request rate is what a block of such loads waits
// on.
__host__ __device__ inline void load8(const uint32_t* p, uint32_t* out, bool cached) {
#ifdef __CUDA_ARCH__
  if (((uintptr_t)p & 15) == 0) {
    const uint4* q = (const uint4*)p;
    const uint4 a = cached ? __ldcg(q) : __ldg(q), b = cached ? __ldcg(q + 1) : __ldg(q + 1);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
    return;
  }
  for (int w = 0; w < 8; ++w) out[w] = cached ? __ldcg(p + w) : __ldg(p + w);
#else
  (void)cached;
  for (int w = 0; w < 8; ++w) out[w] = p[w];
#endif
}

__host__ __device__ inline void store8(uint32_t* p, const uint32_t* in) {
#ifdef __CUDA_ARCH__
  if (((uintptr_t)p & 15) == 0) {
    uint4* q = (uint4*)p;
    q[0] = make_uint4(in[0], in[1], in[2], in[3]);
    q[1] = make_uint4(in[4], in[5], in[6], in[7]);
    return;
  }
#endif
  for (int w = 0; w < 8; ++w) p[w] = in[w];
}

// The word index (floor quotient) and bit (floor remainder) of a source.
struct Source {
  long long word;
  uint32_t bit;
};

__host__ __device__ inline Source source_of(const Stream& s, long long n) {
  const int32_t src = s.sources[n];
  return Source{(long long)(src >> 5), 1u << (src & 31)};
}

// The digest gate of touch t (index n * K + k).
__host__ __device__ inline bool gated_valid(const Stream& s, long long t) {
  if (!s.valid[t]) return false;
  const int32_t dr = s.digest_rows[t];
  if (dr < 0) return true;
  const long long rows = s.P + s.B;
  if (rows == 0) return false;
  const long long r = dr >= rows ? rows - 1 : dr;
  const uint32_t* row = r < s.P ? s.prev_words + r * 8 : s.digests + (r - s.P) * 8;
  const uint32_t* claim = s.claimed + t * 8;
  bool eq = true;
  for (int w = 0; w < 8; ++w) eq &= row[w] == claim[w];
  return eq && s.row_groups[r] == s.touch_groups[t];
}

// ---------------------------------------------------------------------------
// The global branch: the first version's phases on device memory, for
// waves wider than the table.
// ---------------------------------------------------------------------------

// Phase 1: the gate, the old word (clamped read) and the newbit.
__host__ __device__ inline void read_phase(const Stream& s, Source src, long long t) {
  const bool ok = gated_valid(s, t);
  const long long w = read_index(s.touches[2 * t], s.W);
  const long long d = read_index(s.touches[2 * t + 1], s.D);
  const long long word = read_index(src.word, kMaskWords);
  const uint32_t old = load_u32(s.masks + (w * s.D + d) * kMaskWords + word);
  s.newbits[t] = ok && (old & src.bit) == 0;
}

// Phase 2: a new touch ORs its bit into its word and adds one to its count,
// each where its index is in range.  Only the touch's own thread reads the
// newbit it wrote in phase 1.
__host__ __device__ inline void write_phase(const Stream& s, Source src, long long t) {
  if (!s.newbits[t]) return;
  const long long w = write_index(s.touches[2 * t], s.W);
  const long long d = write_index(s.touches[2 * t + 1], s.D);
  if (w < 0 || d < 0) return;
  const long long word = write_index(src.word, kMaskWords);
  uint32_t* mask = s.masks + (w * s.D + d) * kMaskWords + word;
  int32_t* count = s.counts + w * s.D + d;
#ifdef __CUDA_ARCH__
  if (word >= 0) atomicOr(mask, src.bit);
  atomicAdd(count, 1);
#else
  if (word >= 0) *mask |= src.bit;
  *count += 1;
#endif
}

// Phase 3: the post-count (clamped read) after every add of the wave.
__host__ __device__ inline void post_phase(const Stream& s, long long t) {
  const long long w = read_index(s.touches[2 * t], s.W);
  const long long d = read_index(s.touches[2 * t + 1], s.D);
  s.posts[t] = load_i32(s.counts + w * s.D + d);
}

// ---------------------------------------------------------------------------
// The staged branch: the stream's touched rows in a shared-memory table.
// ---------------------------------------------------------------------------

// How one launch runs: chunk_waves == 0 takes the global branch.
struct Plan {
  long long capacity;     // touches a chunk may hold
  long long chunk_waves;  // whole waves a chunk
  long long chunks;
  long long rows;         // touches of the largest chunk (each may own an entry)
  long long slots;        // hash slots: a power of two >= 2 * rows
  int shift;              // 32 - log2(slots): the hash keeps the top bits
  long long stride;       // a mask word's row in shared memory: a power of two >= rows
  int stride_log;
  long long map_rows;     // W x D with the direct map, else 0 (the hash table)
  long long smem_bytes;   // the table's shared memory
  long long threads;      // the block
};

__host__ __device__ inline long long round_threads(long long n) {
  n = (n + 31) / 32 * 32;
  return n < 32 ? 32 : (n > kMaxThreads ? kMaxThreads : n);
}

// The table's shared memory: region A (the hash table's keys, u32 [slots],
// or the direct map, u16 [W x D]); the u32 arrays (masks [8][stride]
// word-major; counts and touch infos [rows]); region B (the hash table's
// slot -> entry, u16 [slots], and, once the entries are resolved, the
// touches' groups, u32 [rows] over it); then the u8 arrays (dirty flags of
// the entries, newbits of the touches [rows]).
__host__ __device__ inline long long region_a_bytes(const Plan& p) {
  return p.map_rows > 0 ? (2 * p.map_rows + 15) / 16 * 16 : 4 * p.slots;
}

__host__ __device__ inline long long table_bytes(const Plan& p) {
  return region_a_bytes(p) + 4 * kMaskWords * p.stride + 4 * 2 * p.rows + 2 * p.slots +
         2 * p.rows;
}

__host__ __device__ inline Plan plan_of(long long W, long long D, long long N, long long K,
                                        long long capacity, long long direct_rows = kDirectRows) {
  Plan p{};
  if (capacity > kMaxCapacity) capacity = kMaxCapacity;
  p.capacity = capacity;
  const bool keys_fit = W * D < (long long)kEmpty;
  if (N <= 0 || K <= 0 || K > capacity || K > kMaxThreads || !keys_fit) {
    p.threads = round_threads(K);
    return p;  // the global branch
  }
  p.chunk_waves = capacity / K < N ? capacity / K : N;
  p.chunks = (N + p.chunk_waves - 1) / p.chunk_waves;
  p.rows = p.chunk_waves * K;
  p.slots = 2;
  p.shift = 31;
  while (p.slots < 2 * p.rows) {
    p.slots *= 2;
    p.shift -= 1;
  }
  p.stride = 1;
  while (p.stride < p.rows) {
    p.stride *= 2;
    p.stride_log += 1;
  }
  // A row in the direct map must fit the 16 bits TouchInfo keeps of it.
  p.map_rows = W * D <= direct_rows && W * D <= (1 << 16) ? W * D : 0;
  p.smem_bytes = table_bytes(p);
  p.threads = round_threads(p.rows);
  return p;
}

// A touch's staged form, one word: its row (direct map) or slot (hash
// table) in stage 1, then the place of its mask word in shared memory,
// word * stride + entry (stage 2), in the low 16 bits; the gate; whether
// its writes are in range; whether its source's word is in range for
// writing; the word; the bit; and (in the block scan) its newbit.  After
// the scan the word holds its post-count instead.
struct TouchInfo {
  static constexpr uint32_t kIndex = 0xFFFFu;
  static constexpr int kOk = 16, kInRange = 17, kWordOk = 18, kWord = 19, kBit = 22, kNew = 31;
};

// A touch's group in its wave, one word: how many of the wave's touches of
// its entry are valid with their writes in range (what the wave adds to
// the count when the bit was clear), and whether it is the first of them.
struct Group {
  static constexpr uint32_t kCount = 0xFFFFu;
  static constexpr int kLeader = 16;
};

__host__ __device__ inline uint32_t info_index(uint32_t info) { return info & TouchInfo::kIndex; }
__host__ __device__ inline uint32_t info_bit(uint32_t info) {
  return 1u << ((info >> TouchInfo::kBit) & 31u);
}
__host__ __device__ inline bool info_flag(uint32_t info, int flag) {
  return (info >> flag) & 1u;
}

// Views of the table's shared memory (a host buffer in the host build).
// Indices into it are 32-bit: a chunk holds at most kMaxCapacity touches.
// A row's entry is the chunk index of one touch that reads it, whose own
// column of masks and counts then holds the row.
struct Table {
  uint32_t* keys;        // [slots] row, or kEmpty (hash table, stage 1)
  uint16_t* map;         // [W x D] a touch of each row read (direct map, stage 1)
  uint32_t* masks;       // [8][stride]
  int32_t* counts;       // [rows]
  uint32_t* touch;       // [rows] TouchInfo, then the post-count
  uint16_t* slot_entry;  // [slots] (hash table, stage 1)
  uint32_t* group;       // [rows] Group, over slot_entry (stages 2-3)
  uint8_t* dirty;        // [rows] per entry
  uint8_t* newbit;       // [rows] per touch
  uint32_t rows, slots, stride;
  int shift, stride_log;
  bool direct;
};

__host__ __device__ inline Table table_at(unsigned char* base, const Plan& p) {
  Table tb;
  tb.rows = (uint32_t)p.rows;
  tb.slots = (uint32_t)p.slots;
  tb.stride = (uint32_t)p.stride;
  tb.shift = p.shift;
  tb.stride_log = p.stride_log;
  tb.direct = p.map_rows > 0;
  tb.keys = (uint32_t*)base;
  tb.map = (uint16_t*)base;
  tb.masks = (uint32_t*)(base + region_a_bytes(p));
  tb.counts = (int32_t*)(tb.masks + kMaskWords * p.stride);
  tb.touch = (uint32_t*)(tb.counts + p.rows);
  tb.slot_entry = (uint16_t*)(tb.touch + p.rows);
  tb.group = (uint32_t*)tb.slot_entry;
  tb.dirty = (uint8_t*)(tb.slot_entry + p.slots);
  tb.newbit = tb.dirty + p.rows;
  return tb;
}

__host__ __device__ inline uint32_t info_entry(const Table& tb, uint32_t info) {
  return info_index(info) & (tb.stride - 1);
}

__host__ __device__ inline void clear_slot(const Table& tb, uint32_t i) { tb.keys[i] = kEmpty; }

// The hash table's slot of `key`, inserting it for chunk touch i if absent
// (then the key's entry is i).  The table has at least twice the slots of
// the chunk's touches, so a probe always ends.
__host__ __device__ inline uint32_t insert_key(const Table& tb, uint32_t key, uint32_t i) {
  const uint32_t mask = tb.slots - 1;
  uint32_t slot = (key * 2654435761u) >> tb.shift;
  for (;;) {
#ifdef __CUDA_ARCH__
    const uint32_t prev = atomicCAS(tb.keys + slot, kEmpty, key);
#else
    const uint32_t prev = tb.keys[slot];
    if (prev == kEmpty) tb.keys[slot] = key;
#endif
    if (prev == kEmpty) tb.slot_entry[slot] = (uint16_t)i;
    if (prev == kEmpty || prev == key) return slot;
    slot = (slot + 1) & mask;
  }
}

// A touch's read row: its clamped indices.
__host__ __device__ inline uint32_t row_key(const Stream& s, long long t) {
  return (uint32_t)(read_index(s.touches[2 * t], s.W) * s.D +
                    read_index(s.touches[2 * t + 1], s.D));
}

// Stage 1, touch i of the chunk that starts at wave n0: key, flags, word
// and gate.  It stages its row (8 mask words and the count) in its own
// column, and finds its row's entry: with the direct map it stores its
// index at its row (a plain store: of the touches of one row, one store
// lands, and after the barrier they all read it); with the hash table it
// inserts its row and keeps the slot.  Every load is issued first: the
// touch's own (the first round trip), then its row and, for a gated touch,
// its claim and digest row (the second).  Returns whether the touch may
// write: it passes the gate and its writes are in range.
__host__ __device__ inline bool stage_touch(const Stream& s, const Table& tb, long long n0,
                                            uint32_t i) {
  const uint32_t k = (uint32_t)s.K;
  const long long t = n0 * s.K + i;
  const bool valid = s.valid[t];
  const int32_t dr = s.digest_rows[t];
  const long long w = s.touches[2 * t], d = s.touches[2 * t + 1];
  const int32_t src = s.sources[n0 + i / k];
  const long long rows = s.P + s.B;
  const bool gated = valid && dr >= 0 && rows > 0;
  const uint32_t key = row_key(s, t);
  uint32_t words[kMaskWords], row[8], claim[8];
  load8(s.masks + (long long)key * kMaskWords, words, true);
  const int32_t count = load_i32(s.counts + key);
  int32_t row_group = 0, touch_group = 0;
  if (gated) {
    const long long r = dr >= rows ? rows - 1 : dr;
    load8(r < s.P ? s.prev_words + r * 8 : s.digests + (r - s.P) * 8, row, false);
    load8(s.claimed + t * 8, claim, false);
    row_group = s.row_groups[r];
    touch_group = s.touch_groups[t];
  }
  const bool in_range = write_index(w, s.W) >= 0 && write_index(d, s.D) >= 0;
  const long long word = (long long)(src >> 5);
  uint32_t found = key;
  if (tb.direct) {
    tb.map[key] = (uint16_t)i;
  } else {
    found = insert_key(tb, key, i);
  }
  for (int j = 0; j < kMaskWords; ++j) tb.masks[j * tb.stride + i] = words[j];
  tb.counts[i] = count;
  tb.dirty[i] = 0;
  bool ok = valid && dr < 0;
  if (gated) {
    bool eq = row_group == touch_group;
    for (int j = 0; j < 8; ++j) eq &= row[j] == claim[j];
    ok = eq;
  }
  tb.touch[i] = found | (uint32_t)ok << TouchInfo::kOk | (uint32_t)in_range << TouchInfo::kInRange |
                (uint32_t)(write_index(word, kMaskWords) >= 0) << TouchInfo::kWordOk |
                (uint32_t)read_index(word, kMaskWords) << TouchInfo::kWord |
                (uint32_t)(src & 31) << TouchInfo::kBit;
  return ok && in_range;
}

// A chunk where no touch may write (the paths' waves, all invalid, are such
// chunks) changes nothing: after stage 1, each touch's post is its row's
// count and its newbit its gate and its bit's being clear, both from the
// row it staged in its own column.
__host__ __device__ inline void write_quiet_touch(const Stream& s, const Table& tb, long long n0,
                                                  uint32_t i) {
  const uint32_t info = tb.touch[i];
  const uint32_t old = tb.masks[((info >> TouchInfo::kWord) & 7u) * tb.stride + i];
  const long long t = n0 * s.K + i;
  s.posts[t] = tb.counts[i];
  s.newbits[t] = info_flag(info, TouchInfo::kOk) && (old & info_bit(info)) == 0;
}

// Stage 2 (after every insert): the touch's row or slot becomes the place
// of its mask word, word * stride + entry.
__host__ __device__ inline void resolve_touch(const Table& tb, uint32_t i) {
  const uint32_t info = tb.touch[i];
  const uint32_t word = (info >> TouchInfo::kWord) & 7u;
  const uint32_t entry = tb.direct ? tb.map[info_index(info)] : tb.slot_entry[info_index(info)];
  tb.touch[i] = (info & ~TouchInfo::kIndex) | (word << tb.stride_log | entry);
}

// Stage 2 for one warp a wave (after every resolve, which the groups
// overwrite): touch i's group in its wave, from the wave's K infos.  Every
// touch of a wave on one entry shares its word (the
// wave's source's) and so its old word and count; with the bit clear each
// valid touch is new and each of them with its writes in range adds one.
__host__ __device__ inline void group_touch(const Table& tb, uint32_t k, uint32_t i) {
  const uint32_t wave = i - i % k, mine = info_index(tb.touch[i]);
  uint32_t adds = 0;
  bool leader = true;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
  for (uint32_t j = wave; j < wave + k; ++j) {
    const uint32_t info = tb.touch[j];
    if (info_index(info) != mine) continue;
    adds += info_flag(info, TouchInfo::kOk) && info_flag(info, TouchInfo::kInRange);
    leader &= j >= i;
  }
  tb.group[i] = adds | (uint32_t)leader << Group::kLeader;
}

// Stage 3 with one warp a wave (K <= 32), in two phases split by a
// barrier, with no atomics: the groups were counted in stage 2.  Read: the
// touch's old word and its entry's count before the wave, and from them its
// newbit and its post, the count plus what the wave adds (its group's count if the
// bit was clear).  Write: the post and newbit, and the group's first touch
// alone writes the entry (old | bit where the word is in range, and the
// post).  Every touch of a group reads before its leader writes.
struct Read {
  uint32_t old;
  int32_t post;
  bool adds;
};

__host__ __device__ inline Read scan_read(const Table& tb, uint32_t info, uint32_t group) {
  const uint32_t old = tb.masks[info_index(info)];
  const int32_t count = tb.counts[info_entry(tb, info)];
  const uint32_t adds = (old & info_bit(info)) == 0 ? group & Group::kCount : 0;
  return Read{old, count + (int32_t)adds, adds > 0};
}

__host__ __device__ inline void scan_write(const Table& tb, uint32_t i, uint32_t info,
                                           uint32_t group, Read r) {
  tb.touch[i] = (uint32_t)r.post;
  tb.newbit[i] = info_flag(info, TouchInfo::kOk) && (r.old & info_bit(info)) == 0;
  if (info_flag(group, Group::kLeader) && r.adds) {
    const uint32_t e = info_entry(tb, info);
    if (info_flag(info, TouchInfo::kWordOk)) tb.masks[info_index(info)] = r.old | info_bit(info);
    tb.counts[e] = r.post;
    tb.dirty[e] = 1;
  }
}

// Stage 3 with a block a wave (32 < K <= 1024), where a wave's touches of
// one entry may sit in different warps: three phases split by two
// barriers.  Read: the old word and the newbit.  Write: a new touch whose
// writes are in range ORs its bit (where its word is in range) and adds
// one to its entry's count, as shared atomics.  Post: the count after the
// wave.
__host__ __device__ inline uint32_t block_read(const Table& tb, uint32_t i, uint32_t info) {
  const bool newbit = info_flag(info, TouchInfo::kOk) &&
                      (tb.masks[info_index(info)] & info_bit(info)) == 0;
  tb.newbit[i] = newbit;
  return info | (uint32_t)newbit << TouchInfo::kNew;
}

__host__ __device__ inline void block_write(const Table& tb, uint32_t info) {
  if (!info_flag(info, TouchInfo::kNew) || !info_flag(info, TouchInfo::kInRange)) return;
  const uint32_t e = info_entry(tb, info);
#ifdef __CUDA_ARCH__
  if (info_flag(info, TouchInfo::kWordOk)) atomicOr(tb.masks + info_index(info), info_bit(info));
  atomicAdd(tb.counts + e, 1);
#else
  if (info_flag(info, TouchInfo::kWordOk)) tb.masks[info_index(info)] |= info_bit(info);
  tb.counts[e] += 1;
#endif
  tb.dirty[e] = 1;
}

__host__ __device__ inline void block_post(const Table& tb, uint32_t i, uint32_t info) {
  tb.touch[i] = (uint32_t)tb.counts[info_entry(tb, info)];
}

// Stage 4: entry e (the chunk touch whose index its row's lookup gave)
// back to device memory, if written: its row from that touch's indices.
__host__ __device__ inline void write_back_entry(const Stream& s, const Table& tb, long long n0,
                                                 uint32_t e) {
  if (!tb.dirty[e]) return;
  const long long row = row_key(s, n0 * s.K + e);
  uint32_t words[kMaskWords];
  for (int w = 0; w < kMaskWords; ++w) words[w] = tb.masks[w * tb.stride + e];
  store8(s.masks + row * kMaskWords, words);
  s.counts[row] = tb.counts[e];
}

// Stage 4: chunk touch i's post-count and newbit out, coalesced.
__host__ __device__ inline void write_out_touch(const Stream& s, const Table& tb, long long n0,
                                                uint32_t i) {
  const long long t = n0 * s.K + i;
  s.posts[t] = (int32_t)tb.touch[i];
  s.newbits[t] = tb.newbit[i];
}

#ifndef __CUDACC__
// The launch on the host: the same stages, each over every index in turn
// where the card puts a barrier, at any capacity.
inline void accumulate_host(const Stream& s, long long capacity = kCapacity,
                            long long direct_rows = kDirectRows) {
  const Plan p = plan_of(s.W, s.D, s.N, s.K, capacity, direct_rows);
  if (p.chunk_waves == 0) {
    for (long long n = 0; n < s.N; ++n) {
      const Source src = source_of(s, n);
      for (long long k = 0; k < s.K; ++k) read_phase(s, src, n * s.K + k);
      for (long long k = 0; k < s.K; ++k) write_phase(s, src, n * s.K + k);
      for (long long k = 0; k < s.K; ++k) post_phase(s, n * s.K + k);
    }
    return;
  }
  std::vector<uint32_t> buffer((p.smem_bytes + 3) / 4);
  const Table tb = table_at((unsigned char*)buffer.data(), p);
  const uint32_t k = (uint32_t)s.K;
  std::vector<Read> read(k);
  for (long long n0 = 0; n0 < s.N; n0 += p.chunk_waves) {
    const long long n1 = n0 + p.chunk_waves < s.N ? n0 + p.chunk_waves : s.N;
    const uint32_t touches = (uint32_t)((n1 - n0) * s.K);
    for (uint32_t i = 0; !tb.direct && i < tb.slots; ++i) clear_slot(tb, i);
    bool writes = false;
    for (uint32_t i = 0; i < touches; ++i) writes |= stage_touch(s, tb, n0, i);
    if (!writes) {
      for (uint32_t i = 0; i < touches; ++i) write_quiet_touch(s, tb, n0, i);
      continue;
    }
    for (uint32_t i = 0; i < touches; ++i) resolve_touch(tb, i);
    for (uint32_t i = 0; k <= 32 && i < touches; ++i) group_touch(tb, k, i);
    for (uint32_t wave = 0; wave < touches; wave += k) {
      if (k <= 32) {
        for (uint32_t j = 0; j < k; ++j)
          read[j] = scan_read(tb, tb.touch[wave + j], tb.group[wave + j]);
        for (uint32_t j = 0; j < k; ++j)
          scan_write(tb, wave + j, tb.touch[wave + j], tb.group[wave + j], read[j]);
      } else {
        for (uint32_t j = wave; j < wave + k; ++j) tb.touch[j] = block_read(tb, j, tb.touch[j]);
        for (uint32_t j = wave; j < wave + k; ++j) block_write(tb, tb.touch[j]);
        for (uint32_t j = wave; j < wave + k; ++j) block_post(tb, j, tb.touch[j]);
      }
    }
    for (uint32_t e = 0; e < touches; ++e) write_back_entry(s, tb, n0, e);
    for (uint32_t i = 0; i < touches; ++i) write_out_touch(s, tb, n0, i);
  }
}
#endif  // !__CUDACC__

}  // namespace quorum

// A launch's plan: out = [capacity, chunk_waves, chunks, rows, slots,
// map_rows, smem_bytes, threads]; capacity <= 0 takes the card's.
extern "C" int mirbft_quorum_plan(long long W, long long D, long long N, long long K,
                                  long long capacity, long long* out) {
  const quorum::Plan p =
      quorum::plan_of(W, D, N, K, capacity > 0 ? capacity : quorum::kCapacity);
  const long long values[8] = {p.capacity, p.chunk_waves, p.chunks,     p.rows,
                               p.slots,    p.map_rows,    p.smem_bytes, p.threads};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

#ifdef __CUDACC__

namespace {

// The global branch: one wave's three phases over the block, two barriers a
// wave (the post phase of wave n and the read phase of wave n + 1 share one).
__device__ void global_scan(const quorum::Stream& s) {
  const long long step = blockDim.x;
  quorum::Source src = quorum::source_of(s, 0);
  for (long long k = threadIdx.x; k < s.K; k += step) quorum::read_phase(s, src, k);
  __syncthreads();
  for (long long n = 0; n < s.N; ++n) {
    const long long base = n * s.K;
    for (long long k = threadIdx.x; k < s.K; k += step) quorum::write_phase(s, src, base + k);
    __syncthreads();
    const bool more = n + 1 < s.N;
    const quorum::Source next = more ? quorum::source_of(s, n + 1) : src;
    for (long long k = threadIdx.x; k < s.K; k += step) {
      quorum::post_phase(s, base + k);
      if (more) quorum::read_phase(s, next, base + s.K + k);
    }
    __syncthreads();
    src = next;
  }
}

// The scan of one chunk by one warp, a touch a lane (K <= 32): each
// wave's info and group are read in the wave before, and __syncwarp splits
// the wave's read and write and ends it.
__device__ __forceinline__ void warp_scan(const quorum::Table& tb, uint32_t k, uint32_t touches) {
  const uint32_t lane = threadIdx.x;
  const bool have = lane < k;
  uint32_t info = have ? tb.touch[lane] : 0, group = have ? tb.group[lane] : 0;
  for (uint32_t wave = 0; wave < touches; wave += k) {  // the same trips on every lane
    const uint32_t i = wave + lane;
    const bool more = have && i + k < touches;
    const uint32_t next_info = more ? tb.touch[i + k] : 0;
    const uint32_t next_group = more ? tb.group[i + k] : 0;
    quorum::Read r{};
    if (have) r = quorum::scan_read(tb, info, group);
    __syncwarp();
    if (have) quorum::scan_write(tb, i, info, group, r);
    __syncwarp();
    info = next_info;
    group = next_group;
  }
}

// The scan of one chunk by the first `threads` threads, a touch a thread
// (32 < K <= 1024): each touch's info stays in a register through its
// wave's phases, split by a named barrier over those warps only.
__device__ __forceinline__ void block_scan(const quorum::Table& tb, uint32_t k, uint32_t touches,
                                           uint32_t threads) {
  const uint32_t tid = threadIdx.x;
  const bool have = tid < k;
  uint32_t info = have ? tb.touch[tid] : 0;
  for (uint32_t wave = 0; wave < touches; wave += k) {
    const uint32_t i = wave + tid;
    if (have) info = quorum::block_read(tb, i, info);
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
    if (have) quorum::block_write(tb, info);
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
    if (have) {
      const uint32_t next = i + k < touches ? tb.touch[i + k] : 0;
      quorum::block_post(tb, i, info);
      info = next;
    }
  }
}

__global__ void __launch_bounds__(quorum::kMaxThreads)
quorum_accumulate_kernel(const quorum::Stream s, const quorum::Plan p) {
  if (p.chunk_waves == 0) {
    global_scan(s);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const quorum::Table tb = quorum::table_at(smem, p);
  const uint32_t tid = threadIdx.x, step = blockDim.x, k = (uint32_t)s.K;
  const uint32_t scan_threads = (uint32_t)quorum::round_threads(k);
  for (long long n0 = 0; n0 < s.N; n0 += p.chunk_waves) {
    const long long n1 = n0 + p.chunk_waves < s.N ? n0 + p.chunk_waves : s.N;
    const uint32_t touches = (uint32_t)((n1 - n0) * s.K);
    if (!tb.direct) {
      for (uint32_t i = tid; i < tb.slots; i += step) quorum::clear_slot(tb, i);
      __syncthreads();
    }
    int writes = 0;
    for (uint32_t i = tid; i < touches; i += step) writes |= quorum::stage_touch(s, tb, n0, i);
    if (!__syncthreads_or(writes)) {
      for (uint32_t i = tid; i < touches; i += step) quorum::write_quiet_touch(s, tb, n0, i);
      // A thread keeps its touches' columns from chunk to chunk; the next
      // chunk's clear and stores wait for these reads all the same.
      if (n1 < s.N) __syncthreads();
      continue;
    }
    for (uint32_t i = tid; i < touches; i += step) quorum::resolve_touch(tb, i);
    __syncthreads();  // the groups overwrite slot_entry, and read every info
    if (k <= 32) {
      for (uint32_t i = tid; i < touches; i += step) quorum::group_touch(tb, k, i);
      __syncthreads();
      if (tid < 32) warp_scan(tb, k, touches);
    } else if (tid < scan_threads) {
      block_scan(tb, k, touches, scan_threads);
    }
    __syncthreads();
    for (uint32_t e = tid; e < touches; e += step) quorum::write_back_entry(s, tb, n0, e);
    for (uint32_t i = tid; i < touches; i += step) quorum::write_out_touch(s, tb, n0, i);
    // The next chunk clears the keys, and stages rows these stores wrote.
    if (n1 < s.N) __syncthreads();
  }
}

}  // namespace

extern "C" int mirbft_quorum_accumulate(
    void* masks, void* counts, long long W, long long D, const void* sources,
    const void* touches, const void* valid, long long N, long long K,
    const void* prev_words, long long P, const void* digests, long long B,
    const void* digest_rows, const void* claimed, const void* row_groups,
    const void* touch_groups, void* posts, void* newbits, void* stream) {
  const quorum::Stream s{
      (uint32_t*)masks,          (int32_t*)counts,          W, D,
      (const int32_t*)sources,   (const int32_t*)touches,   (const uint8_t*)valid,
      N,                         K,                         (const uint32_t*)prev_words,
      P,                         (const uint32_t*)digests,  B,
      (const int32_t*)digest_rows, (const uint32_t*)claimed, (const int32_t*)row_groups,
      (const int32_t*)touch_groups, (int32_t*)posts,         (uint8_t*)newbits};
  if (N <= 0 || K <= 0) return 0;
  const quorum::Plan p = quorum::plan_of(W, D, N, K, quorum::kCapacity);
  // Opt in to more than 48 KiB of shared memory once, at the largest size
  // a launch can ask for (a full chunk with the direct map).
  static long long opted = 48 * 1024;
  if (p.smem_bytes > opted) {
    const long long most =
        quorum::plan_of(quorum::kDirectRows, 1, quorum::kCapacity, 1, quorum::kCapacity).smem_bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        quorum_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    opted = most;
  }
  quorum_accumulate_kernel<<<1, (unsigned)p.threads, (size_t)p.smem_bytes,
                             (cudaStream_t)stream>>>(s, p);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
