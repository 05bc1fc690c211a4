// Native fast-path cluster engine: a C++ twin of the Python testengine
// (mirbft_tpu_torch/testengine/{recorder,queue}.py + the state machine under
// mirbft_tpu_torch/statemachine/) for the protocol's green envelope.
//
// Purpose (docs/PERFORMANCE.md §5 "Roadmap to 100k", step 1): the simulated
// 64-replica cluster is host-bound in the Python interpreter at ~44 us per
// replica-request with no single hot loop left.  This engine moves the WHOLE
// steady-state simulation — event queue, scheduling, and every green-path
// protocol component — into C++, leaving Python in charge of configuration,
// device-crypto waves, and everything outside the envelope.
//
// Equivalence contract (enforced by tests/test_fastengine.py):
//   The engine is a BIT-IDENTICAL twin of the Python engine on supported
//   configs: same simulation step counts, same fake-time, same per-node app
//   hash chains, same checkpoint sequence/values, same epoch numbers, same
//   committed-request maps.  Every method below is a faithful transcription
//   of its Python counterpart (cited by file/class); any divergence is a bug.
//
// Supported envelope (outside it, construction or stepping raises
// RuntimeError and callers fall back to the Python engine; the single
// source of truth is docs/FastEngine.md):
//   * <= 256 nodes (4-word replica bitmasks), dense ids 0..n-1
//   * all five DSL mangler actions (drop/jitter/duplicate/delay/
//     crash-and-restart) under For/Until/After with the full matcher set,
//     via a CPython-compatible MT19937 stream (PyRandom above), plus the
//     send-side structured DropMessages
//   * restarts (crash-and-restart WAL recovery, mid-epoch resume) and
//     state transfer (incl. app-level failure injection + retry backoff)
//   * signed-request mode via precomputed verdicts (the device auth plane
//     verifies envelopes; the engine consumes the verdict bitmap)
//   * reconfiguration at checkpoint boundaries (add/remove client, new
//     config changing bucket count / max epoch length), incl. crashes
//     across the FEntry boundary — nodes, f, and checkpoint interval
//     must stay unchanged
//   * still outside: reconfiguration changing nodes/f/checkpoint-interval;
//     device-paced modes combined with a consume-time (generic) mangler;
//     defer_unready crypto
//
// Device crypto: protocol digests are SHA-256 over the same bytes either
// way, so the engine hashes inline (host) and mirrors every wave-eligible
// message (same rule as testengine/crypto.py::_host_fast's complement) into
// a wave log; the Python wrapper dispatches those waves to the TPU hasher
// asynchronously during the run and verifies the device digests match.
//
// CPython C API only (no pybind11 in the image) — same build scheme as
// ackplane.cpp.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <x86intrin.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <queue>
#include <set>
#include <shared_mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::deque;
using std::map;
using std::set;
using std::shared_ptr;
using std::string;
using std::vector;
using i32 = int32_t;
using i64 = int64_t;
using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;

// Process-wide profiling counters (0 ackbatch, 1 votes, 2 fixpoint,
// 3 coalesce): cumulative across all engines — never dangle, safe under
// concurrent engines (relaxed atomics; profiling only).
std::atomic<u64> g_parts[6] = {};

// CPython-compatible Mersenne Twister (MT19937, Matsumoto & Nishimura's
// public reference algorithm with init_by_array seeding — the exact scheme
// CPython's random.Random uses for int seeds).  The generic manglers draw
// one 62-bit value per first-touch event consumption, exactly like the
// Python engine's ``rand.getrandbits(62)`` (testengine/queue.py), so the
// random streams — and with them jitter/duplicate/percent decisions — are
// bit-identical across engines.
struct PyRandom {
    u32 mt[624];
    int mti = 625;

    void init_genrand(u32 s) {
        mt[0] = s;
        for (mti = 1; mti < 624; mti++)
            mt[mti] = 1812433253u * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) +
                      (u32)mti;
    }

    void init_by_array(const std::vector<u32> &key) {
        init_genrand(19650218u);
        int i = 1, j = 0;
        int k = 624 > (int)key.size() ? 624 : (int)key.size();
        for (; k; k--) {
            mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u)) +
                    key[(size_t)j] + (u32)j;
            i++;
            j++;
            if (i >= 624) {
                mt[0] = mt[623];
                i = 1;
            }
            if (j >= (int)key.size()) j = 0;
        }
        for (k = 623; k; k--) {
            mt[i] =
                (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) -
                (u32)i;
            i++;
            if (i >= 624) {
                mt[0] = mt[623];
                i = 1;
            }
        }
        mt[0] = 0x80000000u;
        mti = 624;
    }

    // CPython random_seed(int): the absolute seed split into 32-bit words,
    // least-significant first; seed 0 keys on [0].
    void seed_from_u64(u64 n) {
        std::vector<u32> key;
        if (n == 0) key.push_back(0);
        while (n) {
            key.push_back((u32)(n & 0xffffffffu));
            n >>= 32;
        }
        init_by_array(key);
    }

    u32 genrand() {
        static const u32 mag01[2] = {0u, 0x9908b0dfu};
        u32 y;
        if (mti >= 624) {
            int kk;
            for (kk = 0; kk < 624 - 397; kk++) {
                y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7fffffffu);
                mt[kk] = mt[kk + 397] ^ (y >> 1) ^ mag01[y & 1u];
            }
            for (; kk < 623; kk++) {
                y = (mt[kk] & 0x80000000u) | (mt[kk + 1] & 0x7fffffffu);
                mt[kk] = mt[kk + (397 - 624)] ^ (y >> 1) ^ mag01[y & 1u];
            }
            y = (mt[623] & 0x80000000u) | (mt[0] & 0x7fffffffu);
            mt[623] = mt[396] ^ (y >> 1) ^ mag01[y & 1u];
            mti = 0;
        }
        y = mt[mti++];
        y ^= (y >> 11);
        y ^= (y << 7) & 0x9d2c5680u;
        y ^= (y << 15) & 0xefc60000u;
        y ^= (y >> 18);
        return y;
    }

    // CPython getrandbits(62): two words, least-significant first, the
    // second shifted down to its remaining 30 bits.
    u64 getrandbits62() {
        u32 lo = genrand();
        u32 hi = genrand() >> 2;
        return (u64)lo | ((u64)hi << 32);
    }
};

struct EngineError : std::runtime_error {
    explicit EngineError(const string &what) : std::runtime_error(what) {}
};

// ---------------------------------------------------------------------------
// SHA-256 (streaming; standard FIPS 180-4 implementation).
// ---------------------------------------------------------------------------

struct Sha256 {
    u32 h[8];
    u64 len = 0;
    u8 buf[64];
    size_t buflen = 0;

    Sha256() { reset(); }

    void reset() {
        static const u32 iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                  0xa54ff53a, 0x510e527f, 0x9b05688c,
                                  0x1f83d9ab, 0x5be0cd19};
        std::memcpy(h, iv, sizeof(iv));
        len = 0;
        buflen = 0;
    }

    static u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

    void block(const u8 *p) {
        static const u32 K[64] = {
            0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
            0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
            0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
            0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
            0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
            0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
            0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
            0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
            0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
            0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
            0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
            0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
            0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
        u32 w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (u32(p[i * 4]) << 24) | (u32(p[i * 4 + 1]) << 16) |
                   (u32(p[i * 4 + 2]) << 8) | u32(p[i * 4 + 3]);
        for (int i = 16; i < 64; i++) {
            u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
            g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            u32 ch = (e & f) ^ (~e & g);
            u32 t1 = hh + S1 + ch + K[i] + w[i];
            u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            u32 maj = (a & b) ^ (a & c) ^ (b & c);
            u32 t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const void *data, size_t n) {
        const u8 *p = (const u8 *)data;
        len += n;
        if (buflen) {
            size_t take = std::min(n, 64 - buflen);
            std::memcpy(buf + buflen, p, take);
            buflen += take;
            p += take;
            n -= take;
            if (buflen == 64) {
                block(buf);
                buflen = 0;
            }
        }
        while (n >= 64) {
            block(p);
            p += 64;
            n -= 64;
        }
        if (n) {
            std::memcpy(buf, p, n);
            buflen = n;
        }
    }

    void update(const string &s) { update(s.data(), s.size()); }

    // Non-destructive finalize (Python hashlib .digest() semantics).
    string digest() const {
        Sha256 c = *this;
        u64 bits = c.len * 8;
        u8 pad = 0x80;
        c.update(&pad, 1);
        u8 zero = 0;
        while (c.buflen != 56) c.update(&zero, 1);
        u8 lb[8];
        for (int i = 0; i < 8; i++) lb[i] = (u8)(bits >> (56 - 8 * i));
        c.update(lb, 8);
        string out(32, '\0');
        for (int i = 0; i < 8; i++) {
            out[i * 4] = (char)(c.h[i] >> 24);
            out[i * 4 + 1] = (char)(c.h[i] >> 16);
            out[i * 4 + 2] = (char)(c.h[i] >> 8);
            out[i * 4 + 3] = (char)(c.h[i]);
        }
        return out;
    }
};

string sha256(const string &data) {
    Sha256 h;
    h.update(data);
    return h.digest();
}

// ---------------------------------------------------------------------------
// Byte-string interner: digests / checkpoint values / payloads by id.
// id 0 is always the empty string (the null digest).
// ---------------------------------------------------------------------------

struct Interner {
    // deque: element addresses are stable under growth, so get() may hand
    // out references that stay valid across later put()s — including, in
    // threaded PDES runs, references taken under the shared lock and used
    // after it is released.
    std::deque<string> vals;
    std::unordered_map<string, i32> ids;
    // Set only for the duration of a THREADED PdES run; serial runs (and
    // the sequential engine) stay lock-free.
    std::shared_mutex *mu = nullptr;

    Interner() { vals.push_back(string()); ids.emplace(string(), 0); }

    i32 put(const string &s) {
        if (mu) {
            std::unique_lock<std::shared_mutex> lk(*mu);
            return put_unlocked(s);
        }
        return put_unlocked(s);
    }

    i32 put_unlocked(const string &s) {
        auto it = ids.find(s);
        if (it != ids.end()) return it->second;
        i32 id = (i32)vals.size();
        vals.push_back(s);
        ids.emplace(s, id);
        return id;
    }

    const string &get(i32 id) const {
        if (mu) {
            std::shared_lock<std::shared_mutex> lk(*mu);
            return vals[(size_t)id];
        }
        return vals[(size_t)id];
    }
};

// ---------------------------------------------------------------------------
// Schema structs (mirbft_tpu_torch/messages.py).  Digests and opaque byte values
// are interner ids.
// ---------------------------------------------------------------------------

struct AckS {
    i64 client;
    i64 reqno;
    i32 dig;
    bool operator==(const AckS &o) const {
        return client == o.client && reqno == o.reqno && dig == o.dig;
    }
    bool operator<(const AckS &o) const {
        if (client != o.client) return client < o.client;
        if (reqno != o.reqno) return reqno < o.reqno;
        return dig < o.dig;
    }
};

struct AckHash {
    size_t operator()(const AckS &a) const {
        u64 x = (u64)a.client * 0x9e3779b97f4a7c15ULL;
        x ^= (u64)a.reqno + 0x9e3779b97f4a7c15ULL + (x << 6) + (x >> 2);
        x ^= (u64)(u32)a.dig + (x << 6) + (x >> 2);
        return (size_t)x;
    }
};

struct ClientStateS {
    i64 id, width, wclc, lw;
    string mask;
    bool operator==(const ClientStateS &o) const {
        return id == o.id && width == o.width && wclc == o.wclc &&
               lw == o.lw && mask == o.mask;
    }
};

struct NetConfigS {
    vector<i32> nodes;
    i64 ci, mel, nb, f;
    bool operator==(const NetConfigS &o) const {
        return nodes == o.nodes && ci == o.ci && mel == o.mel &&
               nb == o.nb && f == o.f;
    }
};
using NetCfgP = shared_ptr<const NetConfigS>;

// Reconfiguration variants (messages.py ReconfigNewClient/RemoveClient/
// NewConfig).  Engine envelope: a NewConfig may change number_of_buckets
// and max_epoch_length only — the node set, f, and checkpoint_interval are
// fixed engine-wide (enforced at construction; anything else falls back to
// the Python engine).
struct ReconfigS {
    enum RT : u8 { NewClient, RemoveClient, NewConfig } t;
    i64 id = 0, width = 0;  // NewClient / RemoveClient
    NetCfgP config;         // NewConfig
};

struct NetStateS {
    NetCfgP config;  // always set (the active consensused config)
    vector<ClientStateS> clients;
    vector<ReconfigS> pending;  // pending_reconfigurations
};
using NetStateP = shared_ptr<const NetStateS>;

struct EpochCfgS {
    i64 number;
    vector<i32> leaders;
    i64 planned_expiration;
    bool operator==(const EpochCfgS &o) const {
        return number == o.number && leaders == o.leaders &&
               planned_expiration == o.planned_expiration;
    }
};

struct NewEpochCfgS {
    EpochCfgS config;
    i64 cp_seq;
    i32 cp_value;
    vector<i32> final_preprepares;
    bool operator==(const NewEpochCfgS &o) const {
        return config == o.config && cp_seq == o.cp_seq &&
               cp_value == o.cp_value &&
               final_preprepares == o.final_preprepares;
    }
};
using NewEpochCfgP = shared_ptr<const NewEpochCfgS>;

struct ECSetEntryS {
    i64 epoch, seq;
    i32 dig;
};

struct EpochChangeS {
    i64 new_epoch;
    vector<std::pair<i64, i32>> checkpoints;  // (seq_no, value id)
    vector<ECSetEntryS> p_set, q_set;
    // Hash-data caches (lazily built; shared by every receiver of the same
    // broadcast EC object).  At 128+ nodes the hash data spans thousands of
    // parts per message — rebuilding it per ack was the dominant cost of
    // cascaded view changes.
    mutable string hash_joined_cache;  // plain concat (the digest preimage)
    mutable string hash_key_cache;     // length-prefixed join (memo key)
    mutable bool hash_cache_done = false;
};
using EpochChangeP = shared_ptr<const EpochChangeS>;

enum class MT : u8 {
    Preprepare, Prepare, Commit, Checkpoint, Suspect,
    EpochChange, EpochChangeAck, NewEpoch, NewEpochEcho, NewEpochReady,
    FetchBatch, ForwardBatch, FetchRequest, AckMsg, AckBatch, MsgBatch,
};

struct MsgS;
using MsgP = shared_ptr<const MsgS>;

struct MsgS {
    MT t;
    i64 seq = 0, epoch = 0;
    i32 dig = 0;              // Prepare/Commit digest, Checkpoint value, Fetch*/Forward* digest
    vector<AckS> acks;        // Preprepare batch / AckBatch / ForwardBatch; AckMsg+FetchRequest use acks[0]
    EpochChangeP ec;          // EpochChange / EpochChangeAck
    i32 originator = 0;       // EpochChangeAck
    NewEpochCfgP necfg;       // NewEpoch / Echo / Ready
    vector<std::pair<i32, i32>> remote_changes;  // NewEpoch (node_id, digest)
    vector<MsgP> inner;       // MsgBatch
    mutable i64 wire_size_cache = -1;
    // Ack-wave ledger registration id (AckBatch/AckMsg broadcast sends
    // only; -1 = unregistered, consumed via the classic per-ack path).
    mutable i64 wave_id = -1;
};

// QEntry / PEntry and the persisted-entry union (messages.py Persistent).
struct QEntryS {
    i64 seq;
    i32 dig;
    vector<AckS> reqs;
};
using QEntryP = shared_ptr<const QEntryS>;

enum class PET : u8 { Q, P, C, N, F, EC, Suspect, T };

struct PersistEntS {
    PET t;
    QEntryP q;                 // Q
    i64 seq = 0;               // P / C / N / T
    i32 dig = 0;               // P digest / C value / T value
    NetStateP netstate;        // C
    EpochCfgS epoch_config;    // N / F
    i64 num = 0;               // EC epoch_number / Suspect epoch
};
using PersistEntP = shared_ptr<const PersistEntS>;

// ---------------------------------------------------------------------------
// Wire codec (encode only) — must match mirbft_tpu_torch/wire.py byte-for-byte:
// uvarint tags from _REGISTRY_ORDER, fields in dataclass declaration order.
// Used for (a) checkpoint snapshot values, which embed
// wire.encode(NetworkState), and (b) msg_size() buffer accounting.
// ---------------------------------------------------------------------------

enum WireTag : u32 {
    TAG_NetworkConfig = 0, TAG_ClientState = 1, TAG_ReconfigNewClient = 2,
    TAG_ReconfigRemoveClient = 3, TAG_ReconfigNewConfig = 4,
    TAG_NetworkState = 5,
    TAG_RequestAck = 6, TAG_EpochConfig = 8, TAG_CheckpointMsg = 9,
    TAG_EpochChangeSetEntry = 10, TAG_EpochChange = 11,
    TAG_EpochChangeAck = 12, TAG_NewEpochConfig = 13,
    TAG_RemoteEpochChange = 14, TAG_NewEpoch = 15, TAG_Preprepare = 16,
    TAG_Prepare = 17, TAG_Commit = 18, TAG_Suspect = 19,
    TAG_NewEpochEcho = 20, TAG_NewEpochReady = 21, TAG_FetchBatch = 22,
    TAG_ForwardBatch = 23, TAG_FetchRequest = 24, TAG_AckMsg = 26,
    TAG_AckBatch = 60, TAG_MsgBatch = 61,
};

void enc_uv(string &buf, u64 v) {
    while (true) {
        u8 b = v & 0x7f;
        v >>= 7;
        if (v) buf.push_back((char)(b | 0x80));
        else { buf.push_back((char)b); return; }
    }
}

void enc_bytes(string &buf, const string &s) {
    enc_uv(buf, s.size());
    buf.append(s);
}

struct Wire {
    const Interner *in;

    void net_config(string &buf, const NetConfigS &c) const {
        enc_uv(buf, TAG_NetworkConfig);
        enc_uv(buf, c.nodes.size());
        for (i32 n : c.nodes) enc_uv(buf, (u64)n);
        enc_uv(buf, (u64)c.ci);
        enc_uv(buf, (u64)c.mel);
        enc_uv(buf, (u64)c.nb);
        enc_uv(buf, (u64)c.f);
    }

    void client_state(string &buf, const ClientStateS &c) const {
        enc_uv(buf, TAG_ClientState);
        enc_uv(buf, (u64)c.id);
        enc_uv(buf, (u64)c.width);
        enc_uv(buf, (u64)c.wclc);
        enc_uv(buf, (u64)c.lw);
        enc_bytes(buf, c.mask);
    }

    void net_state(string &buf, const NetStateS &s) const {
        enc_uv(buf, TAG_NetworkState);
        net_config(buf, *s.config);
        enc_uv(buf, s.clients.size());
        for (const auto &c : s.clients) client_state(buf, c);
        enc_uv(buf, s.pending.size());
        for (const auto &r : s.pending) {
            if (r.t == ReconfigS::NewClient) {
                enc_uv(buf, TAG_ReconfigNewClient);
                enc_uv(buf, (u64)r.id);
                enc_uv(buf, (u64)r.width);
            } else if (r.t == ReconfigS::RemoveClient) {
                enc_uv(buf, TAG_ReconfigRemoveClient);
                enc_uv(buf, (u64)r.id);
            } else {
                enc_uv(buf, TAG_ReconfigNewConfig);
                net_config(buf, *r.config);
            }
        }
    }

    void ack(string &buf, const AckS &a) const {
        enc_uv(buf, TAG_RequestAck);
        enc_uv(buf, (u64)a.client);
        enc_uv(buf, (u64)a.reqno);
        enc_bytes(buf, in->get(a.dig));
    }

    void epoch_config(string &buf, const EpochCfgS &c) const {
        enc_uv(buf, TAG_EpochConfig);
        enc_uv(buf, (u64)c.number);
        enc_uv(buf, c.leaders.size());
        for (i32 n : c.leaders) enc_uv(buf, (u64)n);
        enc_uv(buf, (u64)c.planned_expiration);
    }

    void checkpoint_msg(string &buf, i64 seq, i32 value) const {
        enc_uv(buf, TAG_CheckpointMsg);
        enc_uv(buf, (u64)seq);
        enc_bytes(buf, in->get(value));
    }

    void ec_set_entry(string &buf, const ECSetEntryS &e) const {
        enc_uv(buf, TAG_EpochChangeSetEntry);
        enc_uv(buf, (u64)e.epoch);
        enc_uv(buf, (u64)e.seq);
        enc_bytes(buf, in->get(e.dig));
    }

    void epoch_change(string &buf, const EpochChangeS &e) const {
        enc_uv(buf, TAG_EpochChange);
        enc_uv(buf, (u64)e.new_epoch);
        enc_uv(buf, e.checkpoints.size());
        for (const auto &cp : e.checkpoints) checkpoint_msg(buf, cp.first, cp.second);
        enc_uv(buf, e.p_set.size());
        for (const auto &p : e.p_set) ec_set_entry(buf, p);
        enc_uv(buf, e.q_set.size());
        for (const auto &q : e.q_set) ec_set_entry(buf, q);
    }

    void new_epoch_config(string &buf, const NewEpochCfgS &c) const {
        enc_uv(buf, TAG_NewEpochConfig);
        epoch_config(buf, c.config);
        checkpoint_msg(buf, c.cp_seq, c.cp_value);
        enc_uv(buf, c.final_preprepares.size());
        for (i32 d : c.final_preprepares) enc_bytes(buf, in->get(d));
    }

    void msg(string &buf, const MsgS &m) const {
        switch (m.t) {
            case MT::Preprepare:
                enc_uv(buf, TAG_Preprepare);
                enc_uv(buf, (u64)m.seq);
                enc_uv(buf, (u64)m.epoch);
                enc_uv(buf, m.acks.size());
                for (const auto &a : m.acks) ack(buf, a);
                break;
            case MT::Prepare:
            case MT::Commit:
                enc_uv(buf, m.t == MT::Prepare ? TAG_Prepare : TAG_Commit);
                enc_uv(buf, (u64)m.seq);
                enc_uv(buf, (u64)m.epoch);
                enc_bytes(buf, in->get(m.dig));
                break;
            case MT::Checkpoint:
                checkpoint_msg(buf, m.seq, m.dig);
                break;
            case MT::Suspect:
                enc_uv(buf, TAG_Suspect);
                enc_uv(buf, (u64)m.epoch);
                break;
            case MT::EpochChange:
                epoch_change(buf, *m.ec);
                break;
            case MT::EpochChangeAck:
                enc_uv(buf, TAG_EpochChangeAck);
                enc_uv(buf, (u64)m.originator);
                epoch_change(buf, *m.ec);
                break;
            case MT::NewEpoch:
                enc_uv(buf, TAG_NewEpoch);
                new_epoch_config(buf, *m.necfg);
                enc_uv(buf, m.remote_changes.size());
                for (const auto &rc : m.remote_changes) {
                    enc_uv(buf, TAG_RemoteEpochChange);
                    enc_uv(buf, (u64)rc.first);
                    enc_bytes(buf, in->get(rc.second));
                }
                break;
            case MT::NewEpochEcho:
            case MT::NewEpochReady:
                enc_uv(buf, m.t == MT::NewEpochEcho ? TAG_NewEpochEcho
                                                    : TAG_NewEpochReady);
                new_epoch_config(buf, *m.necfg);
                break;
            case MT::FetchBatch:
                enc_uv(buf, TAG_FetchBatch);
                enc_uv(buf, (u64)m.seq);
                enc_bytes(buf, in->get(m.dig));
                break;
            case MT::ForwardBatch:
                enc_uv(buf, TAG_ForwardBatch);
                enc_uv(buf, (u64)m.seq);
                enc_uv(buf, m.acks.size());
                for (const auto &a : m.acks) ack(buf, a);
                enc_bytes(buf, in->get(m.dig));
                break;
            case MT::FetchRequest:
                enc_uv(buf, TAG_FetchRequest);
                ack(buf, m.acks[0]);
                break;
            case MT::AckMsg:
                enc_uv(buf, TAG_AckMsg);
                ack(buf, m.acks[0]);
                break;
            case MT::AckBatch:
                enc_uv(buf, TAG_AckBatch);
                enc_uv(buf, m.acks.size());
                for (const auto &a : m.acks) ack(buf, a);
                break;
            case MT::MsgBatch:
                enc_uv(buf, TAG_MsgBatch);
                enc_uv(buf, m.inner.size());
                for (const auto &im : m.inner) msg(buf, *im);
                break;
        }
    }

    i64 msg_size(const MsgS &m) const {
        if (m.wire_size_cache >= 0) return m.wire_size_cache;
        string buf;
        msg(buf, m);
        m.wire_size_cache = (i64)buf.size();
        return m.wire_size_cache;
    }
};

// ---------------------------------------------------------------------------
// Hash origins, actions, events (mirbft_tpu_torch/state.py).
// ---------------------------------------------------------------------------

enum class OT : u8 { Batch, EpochChange, VerifyBatch };

struct HashOriginS {
    OT t;
    i32 source = 0;
    i64 epoch = 0;   // Batch
    i64 seq = 0;     // Batch / VerifyBatch
    vector<AckS> request_acks;  // Batch / VerifyBatch
    i32 origin = 0;             // EpochChange: originating node
    EpochChangeP ec;            // EpochChange
    i32 expected_digest = 0;    // VerifyBatch
};

struct HashReqS {
    vector<string> parts;
    HashOriginS origin;
    // Deep-scan memo (device-authoritative pauses): joined key + state so
    // repeated pauses never re-join or re-probe an action
    // (0 = unjoined, 1 = joined, 2 = settled: host-floor or supplied).
    mutable string scan_join;
    mutable u8 scan_state = 0;
};
using HashReqP = shared_ptr<const HashReqS>;

enum class AT : u8 {
    Send, Hash, Persist, Truncate, Commit, Checkpoint,
    AllocatedRequest, CorrectRequest, ForwardRequest, StateApplied,
    StateTransfer,  // a = seq_no, b = checkpoint value interner id
};

using Targets = shared_ptr<const vector<i32>>;

// One type-erased payload pointer per action (exactly one payload kind is
// ever set per action type), keeping the struct small enough that the
// pervasive batch moves/concats are cheap.
struct ActionS {
    AT t;
    AckS ack{0, 0, 0};          // CorrectRequest / ForwardRequest
    i64 a = 0;                  // Persist/Truncate index; Checkpoint/StateApplied seq; AllocatedRequest client
    i64 b = 0;                  // AllocatedRequest reqno; StateTransfer value id
    Targets targets;            // Send / ForwardRequest
    NetCfgP cfg;                // Checkpoint: the post-checkpoint config
    shared_ptr<const void> payload;  // per-kind (see accessors)

    // kind-checked accessors (type safety rests on the AT tag)
    MsgP msg() const { return std::static_pointer_cast<const MsgS>(payload); }
    const MsgS *msg_raw() const {
        return static_cast<const MsgS *>(payload.get());
    }
    HashReqP hash() const {
        return std::static_pointer_cast<const HashReqS>(payload);
    }
    PersistEntP entry() const {
        return std::static_pointer_cast<const PersistEntS>(payload);
    }
    QEntryP qentry() const {
        return std::static_pointer_cast<const QEntryS>(payload);
    }
    shared_ptr<const vector<ClientStateS>> cstates() const {
        return std::static_pointer_cast<const vector<ClientStateS>>(payload);
    }
    NetStateP netstate() const {
        return std::static_pointer_cast<const NetStateS>(payload);
    }
};

using Actions = vector<ActionS>;

enum class ET : u8 {
    InitialParameters, LoadPersistedEntry, LoadCompleted,
    HashResult, CheckpointResult, RequestPersisted,
    Step, TickElapsed, ActionsReceived,
    StateTransferComplete,  // a = seq, digest = value id, payload = netstate
    StateTransferFailed,    // a = seq, digest = value id
};

// Same slimming as ActionS: one type-erased payload per event.
struct EventS {
    ET t;
    i32 digest = 0;    // HashResult digest; CheckpointResult value; Step source
    i64 a = 0;         // LoadPersistedEntry index; CheckpointResult seq
    AckS ack{0, 0, 0};  // RequestPersisted
    shared_ptr<const void> payload;  // entry / origin / netstate / msg

    PersistEntP entry() const {
        return std::static_pointer_cast<const PersistEntS>(payload);
    }
    shared_ptr<const HashOriginS> origin() const {
        return std::static_pointer_cast<const HashOriginS>(payload);
    }
    NetStateP netstate() const {
        return std::static_pointer_cast<const NetStateS>(payload);
    }
    MsgP msg() const { return std::static_pointer_cast<const MsgS>(payload); }
};

using Events = vector<EventS>;

// ---------------------------------------------------------------------------
// Simulation event queue (testengine/queue.py; no mangler in the envelope).
// ---------------------------------------------------------------------------

struct InitParms {
    i32 id;
    i64 batch_size, heartbeat_ticks, suspect_ticks, new_epoch_timeout_ticks,
        buffer_size;
    // This node consumes the ack ledger's canonical streams only if it was
    // live from the start (a late-started or restarted node misses stream
    // prefixes).
    bool led_classic = false;
};

enum class SK : u8 {
    Initialize, MsgReceived, ClientProposal, Tick,
    ProcessWal, ProcessNet, ProcessHash, ProcessClient, ProcessApp,
    ProcessReqStore, ProcessResult,
};

struct SimEv {
    i64 time;
    i64 ctr;
    // Birth time (PDES runs only; docs/PERFORMANCE.md §7.1).  The
    // sequential engine orders same-time events by a global insertion
    // counter; a partitioned run cannot assign that counter online, but
    // the SAME total order is reproduced by the key (time, bt, ctr) where
    // ``bt`` is the simulated time the event was INSERTED and ``ctr`` is
    // its rank in the global insertion sequence at that birth time
    // (insertions happen in global processing order, which is
    // time-monotone, so (bt, rank-at-bt) increases exactly like the
    // sequential counter).  Ranks are provisional (partition-local,
    // order-preserving) during a window and finalized at the barrier
    // replay.  Sequential runs keep bt == 0 and ctr == counter++, which
    // is the identical order.
    i64 bt = 0;
    SK kind;
    i32 target;
    i32 src = 0;
    MsgP msg;
    i64 client = 0, reqno = 0;
    i32 data = 0;                        // payload interner id (proposal)
    shared_ptr<Actions> actions;         // Process{Wal,Net,Hash,Client,App}
    shared_ptr<Events> events;           // Process{ReqStore,Result}
    // Generic-mangler state: an event already touched by the mangler is
    // delivered as-is on next pop (the Python engine's _mangled id-pin).
    bool mangled = false;
    // Restart parameters carried by a crash-and-restart Initialize event
    // (null on the genesis Initialize, which uses the node's config).
    shared_ptr<const InitParms> init;
};

struct SimEvCmp {
    bool operator()(const SimEv &a, const SimEv &b) const {
        if (a.time != b.time) return a.time > b.time;
        if (a.bt != b.bt) return a.bt > b.bt;
        return a.ctr > b.ctr;
    }
};

// ---------------------------------------------------------------------------
// Generic mangler (testengine/manglers.py compiled by fastengine.py): one
// filter conjunction under a For/Until/After combinator, driving one of the
// five reference actions.  Message-scoped predicates use the same envelope
// expansion as the Python DSL (any bundled message satisfying all of them
// matches; of_type(AckMsg) also matches AckBatch).
// ---------------------------------------------------------------------------

// Epoch/seq extraction mirrors manglers.py _msg_epoch/_msg_seq_no.
inline bool mangler_msg_epoch(const MsgS &m, i64 *out) {
    switch (m.t) {
        case MT::Preprepare:
        case MT::Prepare:
        case MT::Commit:
        case MT::Suspect:
            *out = m.epoch;
            return true;
        case MT::EpochChange:
        case MT::EpochChangeAck:
            *out = m.ec->new_epoch;
            return true;
        case MT::NewEpoch:
        case MT::NewEpochEcho:
        case MT::NewEpochReady:
            *out = m.necfg->config.number;
            return true;
        default:
            return false;
    }
}

inline bool mangler_msg_seq(const MsgS &m, i64 *out) {
    switch (m.t) {
        case MT::Preprepare:
        case MT::Prepare:
        case MT::Commit:
        case MT::Checkpoint:
        case MT::FetchBatch:
        case MT::ForwardBatch:
            *out = m.seq;
            return true;
        default:
            return false;
    }
}

struct MPredD {
    enum K : u8 {
        Msgs, NodeStartup, ClientProposalEv, FromSelf, FromNodes, ToNodes,
        AtPercent, WithSequence, WithEpoch, OfType, FromClient,
    } k;
    vector<i64> ids;    // FromNodes / ToNodes
    i64 value = 0;      // AtPercent / WithSequence / WithEpoch / FromClient
    u32 type_mask = 0;  // OfType: bit per MT value

    bool msg_scoped() const {
        return k == WithSequence || k == WithEpoch || k == OfType;
    }

    bool event_match(u64 r, const SimEv &e) const {
        switch (k) {
            case Msgs:
                return e.kind == SK::MsgReceived;
            case NodeStartup:
                return e.kind == SK::Initialize;
            case ClientProposalEv:
                return e.kind == SK::ClientProposal;
            case FromSelf:
                return e.kind == SK::MsgReceived && e.src == e.target;
            case FromNodes: {
                if (e.kind != SK::MsgReceived || e.src == e.target)
                    return false;
                for (i64 id : ids)
                    if (id == e.src) return true;
                return false;
            }
            case ToNodes: {
                for (i64 id : ids)
                    if (id == e.target) return true;
                return false;
            }
            case AtPercent:
                return (i64)(r % 100) <= value;
            case FromClient:
                return e.kind == SK::ClientProposal && e.client == value;
            default:
                throw EngineError("msg-scoped predicate in event position");
        }
    }

    bool msg_match(const MsgS &m) const {
        switch (k) {
            case WithSequence: {
                i64 seq;
                return mangler_msg_seq(m, &seq) && seq == value;
            }
            case WithEpoch: {
                i64 epoch;
                return mangler_msg_epoch(m, &epoch) && epoch == value;
            }
            case OfType: {
                if (type_mask & (1u << (u32)m.t)) return true;
                // AckBatch is the batched transport form of AckMsg.
                return m.t == MT::AckBatch &&
                       (type_mask & (1u << (u32)MT::AckMsg));
            }
            default:
                throw EngineError("event-scoped predicate in msg position");
        }
    }
};

struct ManglerG {
    enum W : u8 { WFor, WUntil, WAfter } wrap = WFor;
    bool latch = false;
    vector<MPredD> preds;
    enum A : u8 { Drop, Jitter, Duplicate, Delay, CrashRestart } action;
    i64 value = 0;  // jitter/duplicate max, delay amount, crash restart delay
    InitParms restart_parms{};
    PyRandom rng;

    // Does every msg-scoped predicate hold on some single message in the
    // envelope (manglers.py Conditional.matches)?
    bool msg_candidates_match(const MsgS &m,
                              const vector<const MPredD *> &mp) const {
        bool all_ok = true;
        for (const MPredD *p : mp)
            if (!p->msg_match(m)) {
                all_ok = false;
                break;
            }
        if (all_ok) return true;
        if (m.t == MT::MsgBatch)
            for (const auto &inner : m.inner)
                if (msg_candidates_match(*inner, mp)) return true;
        return false;
    }

    bool base_match(u64 r, const SimEv &e) const {
        vector<const MPredD *> msg_preds;
        for (const auto &p : preds) {
            if (p.msg_scoped()) msg_preds.push_back(&p);
            else if (!p.event_match(r, e)) return false;
        }
        if (msg_preds.empty()) return true;
        if (e.kind != SK::MsgReceived) return false;
        return msg_candidates_match(*e.msg, msg_preds);
    }

    bool applies(u64 r, const SimEv &e) {
        if (wrap == WFor) return base_match(r, e);
        if (wrap == WUntil) {
            if (latch || base_match(r, e)) {
                latch = true;
                return false;
            }
            return true;
        }
        // WAfter
        if (latch || base_match(r, e)) {
            latch = true;
            return true;
        }
        return false;
    }
};

struct EventQueue {
    vector<SimEv> heap;
    i64 counter = 0;
    i64 fake_time = 0;
    std::unique_ptr<ManglerG> mangler;  // null = no consume-time mangler
    // Birth-key stamping mode (see SimEv::bt): SEQ is the classic global
    // counter (bt pinned to 0 — today's order, zero change); PDES stamps
    // (bt = insertion fake_time, ctr = *prov++) with a partition-local
    // provisional rank finalized at the window barrier; TAIL stamps
    // (bt = fake_time, ctr = counter++) for the exact-stop sequential
    // tail, whose births never share a bt with window-born events.
    enum Stamp : u8 { SEQ = 0, PDES = 1, TAIL = 2 };
    u8 stamp_mode = SEQ;
    i64 *prov = nullptr;  // PDES provisional rank source (partition-owned)

    size_t size() const { return heap.size(); }

    void insert(SimEv ev) {
        if (ev.time < fake_time) throw EngineError("attempted to modify the past");
        if (stamp_mode == SEQ) {
            ev.bt = 0;
            ev.ctr = counter++;
        } else if (stamp_mode == PDES) {
            ev.bt = fake_time;
            ev.ctr = (*prov)++;
        } else {
            ev.bt = fake_time;
            ev.ctr = counter++;
        }
        heap.push_back(std::move(ev));
        std::push_heap(heap.begin(), heap.end(), SimEvCmp());
    }

    // Insert an event whose (bt, ctr) birth key is already final (barrier
    // delivery of cross-partition messages; heap-merge for the tail).
    void insert_stamped(SimEv ev) {
        heap.push_back(std::move(ev));
        std::push_heap(heap.begin(), heap.end(), SimEvCmp());
    }

    SimEv pop() {
        std::pop_heap(heap.begin(), heap.end(), SimEvCmp());
        SimEv ev = std::move(heap.back());
        heap.pop_back();
        return ev;
    }

    SimEv consume() {
        // First-touch mangling (testengine/queue.py consume): draw one
        // random per unmangled pop, apply the mangler, reinsert its results
        // (each with a fresh FIFO counter — even a pass-through moves to
        // the back of its timestamp group, exactly like the Python engine),
        // and loop.  Mangled events are delivered as-is.
        while (true) {
            if (heap.empty())
                throw EngineError("event queue drained to empty");
            SimEv ev = pop();
            if (!mangler || ev.mangled) {
                fake_time = ev.time;
                return ev;
            }
            u64 r = mangler->rng.getrandbits62();
            if (!mangler->applies(r, ev)) {
                ev.mangled = true;
                insert(std::move(ev));
                continue;
            }
            switch (mangler->action) {
                case ManglerG::Drop:
                    continue;
                case ManglerG::Jitter:
                    ev.time += (i64)(r % (u64)mangler->value);
                    ev.mangled = true;
                    insert(std::move(ev));
                    continue;
                case ManglerG::Duplicate: {
                    SimEv clone = ev;  // shallow: payload pointers shared
                    clone.time += (i64)(r % (u64)mangler->value);
                    ev.mangled = true;
                    clone.mangled = true;
                    insert(std::move(ev));
                    insert(std::move(clone));
                    continue;
                }
                case ManglerG::Delay:
                    ev.time += mangler->value;
                    // remangle: stays unmangled, may be delayed again
                    insert(std::move(ev));
                    continue;
                case ManglerG::CrashRestart: {
                    i64 when = ev.time + mangler->value;
                    ev.mangled = true;
                    insert(std::move(ev));
                    SimEv restart;
                    restart.time = when;
                    restart.kind = SK::Initialize;
                    restart.target = mangler->restart_parms.id;
                    restart.init = std::make_shared<const InitParms>(
                        mangler->restart_parms);
                    restart.mangled = true;
                    insert(std::move(restart));
                    continue;
                }
            }
        }
    }

    void remove_events_for(i32 target) {
        heap.erase(std::remove_if(heap.begin(), heap.end(),
                                  [target](const SimEv &e) {
                                      return e.target == target;
                                  }),
                   heap.end());
        std::make_heap(heap.begin(), heap.end(), SimEvCmp());
    }
};

// ---------------------------------------------------------------------------
// Quorums / bucket math (statemachine/stateless.py).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// PDES partition (docs/PERFORMANCE.md §4/§7.1): conservative parallel
// discrete-event simulation over the link-latency lookahead.  Replicas are
// partitioned across workers; each window [T, T+L) is processed partition-
// locally (cross-partition messages cannot arrive inside it, because every
// inter-node delivery pays link_latency >= L), and the barrier replays the
// window's processing order to (a) finalize birth-key ranks, (b) deliver
// cross-partition sends, (c) fold stats and drain-predicate flips in exact
// global order.  Bit-identity contract: identical steps, fake-time, and
// per-node state to the sequential engine (tests/test_fastengine.py).
// ---------------------------------------------------------------------------

struct AckShard;  // per-partition ack-ledger overlay (defined with AckLedger)

struct Partition {
    i32 id = 0;
    EventQueue q;
    // Ledger-on runs: provisional ack-wave registrations made this window
    // (folded into the global ledger in replay order at the barrier).
    std::unique_ptr<AckShard> shard;
    i64 prov_counter = 0;  // provisional birth ranks (monotone, never reset)
    i64 window_start = 0;  // sim-time start of the current window
    i64 prov_base = 0;     // prov_counter at window start (resolve-map base)
    vector<SimEv> outbox;  // cross-partition sends made this window

    // One entry per event processed this window, in partition-local order
    // (which equals global order restricted to this partition).
    struct PLogE {
        i64 time;        // processing time
        i64 bt;          // processed event's birth time
        i64 rank;        // its rank (provisional iff prov)
        i64 prov_start;  // prov counter before processing: the event's
                         // births are prov ids [prov_start, prov_start+births)
        u32 births;
        u8 prov;
    };
    vector<PLogE> plog;

    // Drain-predicate transition candidates (kind 0 = client satisfied,
    // kind 1 = node became drain-ready), resolved/deduped at the barrier.
    struct Flip {
        u32 at;  // plog index of the causing event
        u8 kind;
        i64 id;
    };
    vector<Flip> flips;

    // Queue purges caused by an Initialize processed this window
    // (remove_events_for drops in-flight messages to the booting node).
    // The partition-local removal handles this partition's queue; the
    // barrier uses these markers to drop same-window cross-partition
    // sends to the node whose birth precedes the Initialize globally.
    struct Purge {
        u32 at;   // plog index of the Initialize event
        i32 node;
    };
    vector<Purge> purges;

    // Window stats, folded into the engine at each barrier.
    i64 steps = 0;
    i64 committed_ops = 0;
    u64 crypto_ns = 0;
    u64 work_cycles = 0;
    // Per-node work attribution for traffic-aware repartitioning (indexed
    // by node id; folded into Engine::node_load at each barrier).
    vector<u64> node_cycles;
    // Partition-local hash memos (content-keyed; results content-equal
    // across partitions, so locality only costs duplicate hashing).
    std::unordered_map<string, i32> host_memo;
    std::unordered_map<string, i32> wave_memo;
    string error;  // threaded-mode exception capture
};

struct PdesResult {
    i64 steps = 0;      // exact global step count (flip step or stop_steps)
    i64 fake_time = 0;  // exact simulated time at that step
    i64 flip_step = -1;
    i64 flip_time = -1;
    bool done = false;
    bool timed_out = false;
    i64 windows = 0;
    u64 barrier_cycles = 0;
    u64 barrier_ns = 0;  // steady-clock barrier time (pdes_barrier_seconds)
    u64 sum_part_cycles = 0;
    u64 max_part_cycles = 0;
    i64 tail_steps = 0;
    i64 repartitions = 0;  // traffic-aware rebalances taken at barriers
    i64 lookahead = 0;     // conservative window width W (sim units)
    bool ledger_on = false;  // ack ledger was live (sharded) during the run
};

struct Quorums {
    i64 n, f;
    i64 iq() const { return (n + f + 2) / 2; }
    i64 wq() const { return f + 1; }
};

// is_committed (stateless.py:100): MSB-first committed mask, exact-width window.
bool is_committed(i64 req_no, const ClientStateS &cs) {
    i64 offset = req_no - cs.lw;
    if (offset < 0) return true;
    if (offset >= cs.width) return false;
    size_t byte_index = (size_t)(offset >> 3);
    if (byte_index >= cs.mask.size()) return false;
    return (u8(cs.mask[byte_index]) & (0x80u >> (offset & 7))) != 0;
}

string u64be(u64 v) {
    string s(8, '\0');
    for (int i = 0; i < 8; i++) s[i] = (char)(v >> (56 - 8 * i));
    return s;
}

// Flatten an EpochChange into its canonical hash parts
// (stateless.py epoch_change_hash_data).
vector<string> ec_hash_data(const Interner &in, const EpochChangeS &ec) {
    vector<string> out;
    out.push_back(u64be((u64)ec.new_epoch));
    for (const auto &cp : ec.checkpoints) {
        out.push_back(u64be((u64)cp.first));
        out.push_back(in.get(cp.second));
    }
    for (const auto &e : ec.p_set) {
        out.push_back(u64be((u64)e.epoch));
        out.push_back(u64be((u64)e.seq));
        out.push_back(in.get(e.dig));
    }
    for (const auto &e : ec.q_set) {
        out.push_back(u64be((u64)e.epoch));
        out.push_back(u64be((u64)e.seq));
        out.push_back(in.get(e.dig));
    }
    return out;
}

string join_with_lengths(const vector<string> &parts) {
    string key;
    for (const auto &p : parts) {
        enc_uv(key, p.size());
        key.append(p);
    }
    return key;
}

// ---------------------------------------------------------------------------
// Shared engine context.
// ---------------------------------------------------------------------------

struct AckLedger;  // defined below (cluster-shared ack-wave canon)

struct Ctx {
    Interner intern;
    Wire wire{nullptr};
    NetConfigS cfg;   // the INITIAL network config
    NetCfgP cfg_p;    // shared pointer to the same (for NetState linkage)
    vector<ClientStateS> init_clients;
    i64 iq, wq;
    // Shared broadcast target set: most sends address every node, and the
    // per-send 64-int vector alloc+copy was a measurable share of the run.
    Targets bcast;
    AckLedger *ack_ledger = nullptr;  // null = ledger disabled

    void finish_init() {
        wire.in = &intern;
        cfg_p = std::make_shared<const NetConfigS>(cfg);
        Quorums q{(i64)cfg.nodes.size(), cfg.f};
        iq = q.iq();
        wq = q.wq();
        bcast = std::make_shared<vector<i32>>(cfg.nodes);
    }
};

// Action builder helpers (statemachine/actions.py fluent constructors).
ActionS act_send(Targets targets, MsgP msg) {
    ActionS a; a.t = AT::Send; a.targets = std::move(targets);
    a.payload = std::move(msg); return a;
}
ActionS act_send(vector<i32> targets, MsgP msg) {
    return act_send(std::make_shared<const vector<i32>>(std::move(targets)),
                    std::move(msg));
}
ActionS act_hash(vector<string> parts, HashOriginS origin) {
    ActionS a; a.t = AT::Hash;
    auto hr = std::make_shared<HashReqS>();
    hr->parts = std::move(parts);
    hr->origin = std::move(origin);
    a.payload = std::move(hr); return a;
}
ActionS act_persist(i64 index, PersistEntP entry) {
    ActionS a; a.t = AT::Persist; a.a = index; a.payload = std::move(entry); return a;
}
ActionS act_truncate(i64 index) {
    ActionS a; a.t = AT::Truncate; a.a = index; return a;
}
ActionS act_commit(QEntryP q) {
    ActionS a; a.t = AT::Commit; a.payload = std::move(q); return a;
}
ActionS act_checkpoint(i64 seq, NetCfgP cfg,
                       shared_ptr<const vector<ClientStateS>> cs) {
    ActionS a;
    a.t = AT::Checkpoint;
    a.a = seq;
    a.cfg = std::move(cfg);
    a.payload = std::move(cs);
    return a;
}
ActionS act_allocate(i64 client, i64 reqno) {
    ActionS a; a.t = AT::AllocatedRequest; a.a = client; a.b = reqno; return a;
}
ActionS act_correct(AckS ack) {
    ActionS a; a.t = AT::CorrectRequest; a.ack = ack; return a;
}
ActionS act_forward(vector<i32> targets, AckS ack) {
    ActionS a; a.t = AT::ForwardRequest;
    a.targets = std::make_shared<const vector<i32>>(std::move(targets));
    a.ack = ack; return a;
}
ActionS act_state_transfer(i64 seq, i32 value) {
    ActionS a;
    a.t = AT::StateTransfer;
    a.a = seq;
    a.b = value;
    return a;
}
ActionS act_state_applied(i64 seq, NetStateP ns) {
    ActionS a; a.t = AT::StateApplied; a.a = seq; a.payload = std::move(ns); return a;
}

void concat(Actions &into, Actions &&from) {
    for (auto &a : from) into.push_back(std::move(a));
}

// Replica bitmask over up to 256 nodes (4 u64 words; BASELINE config 5 is
// a 256-replica network).  Bit index == dense node id.
struct Mask {
    u64 w[4] = {0, 0, 0, 0};
    bool test(i64 i) const {
        return (w[(size_t)(i >> 6)] >> (i & 63)) & 1;
    }
    void set(i64 i) { w[(size_t)(i >> 6)] |= 1ull << (i & 63); }
    void clearbit(i64 i) { w[(size_t)(i >> 6)] &= ~(1ull << (i & 63)); }
    // Per-bit atomic variants for masks shared across PDES partition
    // threads (each node only ever flips its own bit, but bits of the
    // same word belong to different threads).
    void set_atomic(i64 i) {
        __atomic_fetch_or(&w[(size_t)(i >> 6)], 1ull << (i & 63),
                          __ATOMIC_RELAXED);
    }
    void clear_atomic(i64 i) {
        __atomic_fetch_and(&w[(size_t)(i >> 6)], ~(1ull << (i & 63)),
                           __ATOMIC_RELAXED);
    }
    i64 count() const {
        return __builtin_popcountll(w[0]) + __builtin_popcountll(w[1]) +
               __builtin_popcountll(w[2]) + __builtin_popcountll(w[3]);
    }
    bool any() const { return (w[0] | w[1] | w[2] | w[3]) != 0; }
    bool operator==(const Mask &o) const {
        return w[0] == o.w[0] && w[1] == o.w[1] && w[2] == o.w[2] &&
               w[3] == o.w[3];
    }
    bool operator!=(const Mask &o) const { return !(*this == o); }
};

// Fill both EC hash caches in one pass (see EpochChangeS).
void ec_fill_hash_cache(const Interner &in, const EpochChangeS &ec) {
    if (ec.hash_cache_done) return;
    vector<string> parts = ec_hash_data(in, ec);
    size_t total = 0;
    for (const auto &p : parts) total += p.size();
    ec.hash_joined_cache.reserve(total);
    ec.hash_key_cache.reserve(total + parts.size() * 9);
    for (const auto &p : parts) {
        ec.hash_joined_cache.append(p);
        enc_uv(ec.hash_key_cache, (u64)p.size());
        ec.hash_key_cache.append(p);
    }
    ec.hash_cache_done = true;
}

vector<i32> mask_to_nodes(const Mask &mask) {
    vector<i32> out;
    for (i32 i = 0; i < 256; i++)
        if (mask.test(i)) out.push_back(i);
    return out;
}

// Message constructors.
MsgP mk_prepare(i64 seq, i64 epoch, i32 dig) {
    auto m = std::make_shared<MsgS>(); m->t = MT::Prepare; m->seq = seq;
    m->epoch = epoch; m->dig = dig; return m;
}
MsgP mk_commit(i64 seq, i64 epoch, i32 dig) {
    auto m = std::make_shared<MsgS>(); m->t = MT::Commit; m->seq = seq;
    m->epoch = epoch; m->dig = dig; return m;
}
MsgP mk_preprepare(i64 seq, i64 epoch, vector<AckS> batch) {
    auto m = std::make_shared<MsgS>(); m->t = MT::Preprepare; m->seq = seq;
    m->epoch = epoch; m->acks = std::move(batch); return m;
}
MsgP mk_ack_msg(AckS a) {
    auto m = std::make_shared<MsgS>(); m->t = MT::AckMsg; m->acks.push_back(a);
    return m;
}
MsgP mk_ack_batch(vector<AckS> acks) {
    auto m = std::make_shared<MsgS>(); m->t = MT::AckBatch;
    m->acks = std::move(acks); return m;
}
MsgP mk_checkpoint_msg(i64 seq, i32 value) {
    auto m = std::make_shared<MsgS>(); m->t = MT::Checkpoint; m->seq = seq;
    m->dig = value; return m;
}
MsgP mk_suspect(i64 epoch) {
    auto m = std::make_shared<MsgS>(); m->t = MT::Suspect; m->epoch = epoch;
    return m;
}
MsgP mk_fetch_request(AckS a) {
    auto m = std::make_shared<MsgS>(); m->t = MT::FetchRequest;
    m->acks.push_back(a); return m;
}
MsgP mk_fetch_batch(i64 seq, i32 dig) {
    auto m = std::make_shared<MsgS>(); m->t = MT::FetchBatch; m->seq = seq;
    m->dig = dig; return m;
}
MsgP mk_forward_batch(i64 seq, vector<AckS> acks, i32 dig) {
    auto m = std::make_shared<MsgS>(); m->t = MT::ForwardBatch; m->seq = seq;
    m->acks = std::move(acks); m->dig = dig; return m;
}

// ---------------------------------------------------------------------------
// Persisted log (statemachine/persisted.py).
// ---------------------------------------------------------------------------

struct PersistedLog {
    i64 next_index = 0;
    vector<std::pair<i64, PersistEntP>> entries;

    void append_initial_load(i64 index, PersistEntP entry) {
        if (!entries.empty()) {
            if (next_index != index)
                throw EngineError("WAL indexes out of order");
        } else {
            next_index = index;
        }
        entries.emplace_back(index, std::move(entry));
        next_index = index + 1;
    }

    Actions append(PersistEntP entry) {
        if (entries.empty())
            throw EngineError("appending to an unseeded log");
        i64 index = next_index;
        entries.emplace_back(index, entry);
        next_index += 1;
        Actions a;
        a.push_back(act_persist(index, std::move(entry)));
        return a;
    }

    Actions truncate(i64 low_watermark) {
        for (size_t pos = 0; pos < entries.size(); pos++) {
            const auto &e = *entries[pos].second;
            if (e.t == PET::C) {
                if (e.seq < low_watermark) continue;
            } else if (e.t == PET::N) {
                if (e.seq <= low_watermark) continue;
            } else {
                continue;
            }
            if (pos == 0) break;
            i64 index = entries[pos].first;
            entries.erase(entries.begin(), entries.begin() + (std::ptrdiff_t)pos);
            Actions a;
            a.push_back(act_truncate(index));
            return a;
        }
        return Actions();
    }

    EpochChangeP construct_epoch_change(i64 new_epoch) const {
        // Pass 1: count PEntries per sequence so only the last one is kept.
        std::unordered_map<i64, i64> p_counts;
        bool have_epoch = false;
        i64 log_epoch = 0;
        for (const auto &pr : entries) {
            if (have_epoch && log_epoch >= new_epoch) break;
            const auto &e = *pr.second;
            if (e.t == PET::P) {
                p_counts[e.seq] += 1;
            } else if (e.t == PET::N) {
                log_epoch = e.epoch_config.number;
                have_epoch = true;
            } else if (e.t == PET::F) {
                log_epoch = e.epoch_config.number;
                have_epoch = true;
            }
        }
        auto ec = std::make_shared<EpochChangeS>();
        ec->new_epoch = new_epoch;
        have_epoch = false;
        log_epoch = 0;
        for (const auto &pr : entries) {
            if (have_epoch && log_epoch >= new_epoch) break;
            const auto &e = *pr.second;
            if (e.t == PET::P) {
                i64 &remaining = p_counts[e.seq];
                if (remaining != 1) {
                    remaining -= 1;
                    continue;
                }
                ec->p_set.push_back(ECSetEntryS{log_epoch, e.seq, e.dig});
            } else if (e.t == PET::Q) {
                ec->q_set.push_back(
                    ECSetEntryS{log_epoch, e.q->seq, e.q->dig});
            } else if (e.t == PET::N || e.t == PET::F) {
                log_epoch = e.epoch_config.number;
                have_epoch = true;
            } else if (e.t == PET::C) {
                ec->checkpoints.emplace_back(e.seq, e.dig);
            }
        }
        return ec;
    }
};

PersistEntP pe_q(QEntryP q) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::Q; e->q = std::move(q); return e;
}
PersistEntP pe_p(i64 seq, i32 dig) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::P; e->seq = seq; e->dig = dig; return e;
}
PersistEntP pe_c(i64 seq, i32 value, NetStateP ns) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::C; e->seq = seq;
    e->dig = value; e->netstate = std::move(ns); return e;
}
PersistEntP pe_n(i64 seq, EpochCfgS cfg) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::N; e->seq = seq;
    e->epoch_config = std::move(cfg); return e;
}
PersistEntP pe_f(EpochCfgS cfg) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::F;
    e->epoch_config = std::move(cfg); return e;
}
PersistEntP pe_ec(i64 num) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::EC; e->num = num; return e;
}
PersistEntP pe_t(i64 seq, i32 value) {
    auto e = std::make_shared<PersistEntS>();
    e->t = PET::T;
    e->seq = seq;
    e->dig = value;
    return e;
}
PersistEntP pe_suspect(i64 epoch) {
    auto e = std::make_shared<PersistEntS>(); e->t = PET::Suspect; e->num = epoch; return e;
}

// ---------------------------------------------------------------------------
// Message buffers (statemachine/msgbuffers.py).
// ---------------------------------------------------------------------------

enum class Applyable : u8 { PAST = 0, CURRENT = 1, FUTURE = 2, INVALID = 3 };

struct NodeBuffer {
    i64 total_size = 0;
    i64 buffer_size;  // my_config.buffer_size
    bool over_capacity() const { return total_size > buffer_size; }
};

struct MsgBuffer {
    deque<std::pair<MsgP, i64>> buffer;
    NodeBuffer *nb = nullptr;
    i64 *group = nullptr;
    const Wire *wire = nullptr;

    void store(MsgP msg) {
        while (nb->over_capacity() && !buffer.empty()) {
            auto old = buffer.front();
            buffer.pop_front();
            if (group) (*group)--;
            nb->total_size -= old.second;
        }
        i64 size = wire->msg_size(*msg);
        buffer.emplace_back(std::move(msg), size);
        if (group) (*group)++;
        nb->total_size += size;
    }

    // next/iterate compact the deque in ONE pass instead of erasing from
    // the middle per removed entry: erase-at-i on a deque is O(n), which
    // turned big-buffer drains (cascading view changes buffer enormous
    // message piles) into O(n^2) wall time.  Kept entries preserve their
    // relative order and apply_fn-appended entries are still visited, so
    // behavior is identical to the erase-based loop.
    template <typename F>
    MsgP next(F &&filter_fn) {
        size_t kept = 0;
        MsgP found;
        size_t i = 0;
        for (; i < buffer.size(); i++) {
            MsgP msg = buffer[i].first;
            i64 size = buffer[i].second;
            Applyable verdict = filter_fn(*msg);
            if (verdict == Applyable::FUTURE) {
                if (kept != i) buffer[kept] = std::move(buffer[i]);
                kept++;
                continue;
            }
            if (group) (*group)--;
            nb->total_size -= size;
            if (verdict == Applyable::CURRENT) {
                found = std::move(msg);
                i++;
                break;
            }
        }
        for (; i < buffer.size(); i++, kept++)
            if (kept != i) buffer[kept] = std::move(buffer[i]);
        buffer.resize(kept);
        return found;
    }

    template <typename F, typename A>
    void iterate(F &&filter_fn, A &&apply_fn) {
        size_t kept = 0;
        for (size_t i = 0; i < buffer.size(); i++) {
            MsgP msg = buffer[i].first;
            i64 size = buffer[i].second;
            Applyable verdict = filter_fn(*msg);
            if (verdict == Applyable::FUTURE) {
                if (kept != i) buffer[kept] = std::move(buffer[i]);
                kept++;
                continue;
            }
            if (group) (*group)--;
            nb->total_size -= size;
            if (verdict == Applyable::CURRENT) apply_fn(std::move(msg));
        }
        buffer.resize(kept);
    }

    bool empty() const { return buffer.empty(); }
    size_t size() const { return buffer.size(); }
};

// Per-node registry of per-peer buffers (NodeBuffers).
struct NodeBuffers {
    std::map<i32, NodeBuffer> node_map;
    i64 buffer_size;

    NodeBuffer *node_buffer(i32 source) {
        auto it = node_map.find(source);
        if (it == node_map.end()) {
            it = node_map.emplace(source, NodeBuffer{0, buffer_size}).first;
        }
        return &it->second;
    }
};

// ---------------------------------------------------------------------------
// Checkpoint agreement tracking (statemachine/checkpoints.py).
// ---------------------------------------------------------------------------

struct Checkpoint {
    i64 seq_no;
    i32 my_id;
    const Ctx *ctx;
    // (value, supporters) insertion-ordered.
    vector<std::pair<i32, vector<i32>>> values;
    i32 committed_value = -1;  // -1 = None
    i32 my_value = -1;
    bool stable = false;

    void apply_checkpoint_msg(i32 source, i32 value) {
        vector<i32> *supporters = nullptr;
        for (auto &pr : values)
            if (pr.first == value) { supporters = &pr.second; break; }
        if (!supporters) {
            values.emplace_back(value, vector<i32>());
            supporters = &values.back().second;
        }
        for (i32 s : *supporters)
            if (s == source) return;  // dedup double-votes (hardening)
        supporters->push_back(source);
        i64 agreements = (i64)supporters->size();

        if (agreements == ctx->wq) committed_value = value;
        if (source == my_id) my_value = value;

        if (my_value >= 0 && committed_value >= 0 && !stable) {
            if (value != committed_value)
                throw EngineError("my checkpoint disagrees with the committed network view");
            if (agreements >= ctx->iq) stable = true;
        }
    }
};

struct CheckpointState_ { enum V { IDLE = 0, GARBAGE_COLLECTABLE = 1 }; };

struct CheckpointTracker {
    int state = CheckpointState_::IDLE;
    PersistedLog *persisted;
    NodeBuffers *node_buffers;
    InitParms my_config;
    const Ctx *ctx;
    std::map<i32, i64> highest_checkpoints;
    std::map<i64, shared_ptr<Checkpoint>> checkpoint_map;
    vector<shared_ptr<Checkpoint>> active_checkpoints;
    std::map<i32, MsgBuffer> msg_buffers;
    bool have_config = false;
    NetCfgP net_cfg;  // from the first CEntry's network state (Python twin)
    // Mid-epoch catch-up trigger (checkpoints.py catch_up_target,
    // docs/Divergences.md #13): seq < 0 = unset.
    i64 catch_up_seq = -1;
    i32 catch_up_value = -1;

    shared_ptr<Checkpoint> checkpoint(i64 seq_no) {
        auto it = checkpoint_map.find(seq_no);
        if (it != checkpoint_map.end()) return it->second;
        auto cp = std::make_shared<Checkpoint>();
        cp->seq_no = seq_no;
        cp->my_id = my_config.id;
        cp->ctx = ctx;
        checkpoint_map.emplace(seq_no, cp);
        return cp;
    }

    i64 high_watermark() const { return active_checkpoints.back()->seq_no; }
    i64 low_watermark() const { return active_checkpoints.front()->seq_no; }

    Applyable filter(const MsgS &msg) const {
        if (msg.seq < active_checkpoints.front()->seq_no) return Applyable::PAST;
        if (msg.seq > high_watermark()) return Applyable::FUTURE;
        return Applyable::CURRENT;
    }

    void reinitialize() {
        auto old_checkpoint_map = std::move(checkpoint_map);
        auto old_msg_buffers = std::move(msg_buffers);

        highest_checkpoints.clear();
        checkpoint_map.clear();
        active_checkpoints.clear();
        msg_buffers.clear();
        have_config = false;
        catch_up_seq = -1;
        catch_up_value = -1;

        for (const auto &pr : persisted->entries) {
            if (pr.second->t != PET::C) continue;
            if (!have_config) {
                have_config = true;
                net_cfg = pr.second->netstate->config;
            }
            auto cp = checkpoint(pr.second->seq);
            cp->apply_checkpoint_msg(my_config.id, pr.second->dig);
            active_checkpoints.push_back(cp);
        }
        if (active_checkpoints.empty())
            throw EngineError("log must contain a CEntry");
        active_checkpoints[0]->stable = true;

        for (i32 node : ctx->cfg.nodes) {
            auto it = old_msg_buffers.find(node);
            if (it != old_msg_buffers.end()) {
                msg_buffers.emplace(node, std::move(it->second));
            } else {
                MsgBuffer mb;
                mb.nb = node_buffers->node_buffer(node);
                mb.wire = &ctx->wire;
                msg_buffers.emplace(node, std::move(mb));
            }
        }

        // Re-apply remembered agreements (commutative).
        for (const auto &pr : old_checkpoint_map) {
            if (pr.first < low_watermark()) continue;
            for (const auto &val : pr.second->values)
                for (i32 node : val.second)
                    apply_checkpoint_msg(node, pr.first, val.first);
        }
        garbage_collect();
    }

    void step(i32 source, MsgP msg) {
        Applyable verdict = filter(*msg);
        if (verdict == Applyable::PAST) return;
        if (verdict == Applyable::FUTURE) msg_buffers.at(source).store(msg);
        apply_checkpoint_msg(source, msg->seq, msg->dig);
    }

    i64 garbage_collect() {
        size_t highest_stable_idx = 0;
        for (size_t i = 0; i < active_checkpoints.size(); i++) {
            if (!active_checkpoints[i]->stable) break;
            highest_stable_idx = i;
        }
        for (size_t i = 0; i < highest_stable_idx; i++)
            checkpoint_map.erase(active_checkpoints[i]->seq_no);
        active_checkpoints.erase(active_checkpoints.begin(),
                                 active_checkpoints.begin() +
                                     (std::ptrdiff_t)highest_stable_idx);

        while (active_checkpoints.size() < 3) {
            i64 next_seq = high_watermark() + net_cfg->ci;
            active_checkpoints.push_back(checkpoint(next_seq));
        }

        for (i32 node : ctx->cfg.nodes) {
            auto &mb = msg_buffers.at(node);
            mb.iterate([this](const MsgS &m) { return filter(m); },
                       [this, node](MsgP m) {
                           apply_checkpoint_msg(node, m->seq, m->dig);
                       });
        }
        state = CheckpointState_::IDLE;
        return active_checkpoints[0]->seq_no;
    }

    void apply_checkpoint_msg(i32 source, i64 seq_no, i32 value) {
        bool above_high = seq_no > high_watermark();
        if (above_high) {
            auto it = highest_checkpoints.find(source);
            if (it == highest_checkpoints.end() || seq_no > it->second)
                highest_checkpoints[source] = seq_no;
            // No early return: above-window agreements keep accumulating
            // so the catch-up trigger can reach f+1 on a value even when
            // sources' first reports straddle different seq_nos
            // (checkpoints.py twin; Divergences.md #13).
        }
        auto cp = checkpoint(seq_no);
        cp->apply_checkpoint_msg(source, value);

        if (above_high && cp->committed_value >= 0) {
            // Weak quorum attests a checkpoint beyond every tracked
            // window: arm the mid-epoch catch-up transfer
            // (docs/Divergences.md #13; checkpoints.py twin).
            if (catch_up_seq < 0 || seq_no > catch_up_seq) {
                catch_up_seq = seq_no;
                catch_up_value = cp->committed_value;
            }
        }

        if (cp->stable && seq_no > low_watermark() && !above_high) {
            state = CheckpointState_::GARBAGE_COLLECTABLE;
            return;
        }
        if (!above_high) return;

        std::set<i64> referenced;
        for (const auto &acp : active_checkpoints) referenced.insert(acp->seq_no);
        for (const auto &pr : highest_checkpoints) referenced.insert(pr.second);
        for (auto it = checkpoint_map.begin(); it != checkpoint_map.end();) {
            if (!referenced.count(it->first)) it = checkpoint_map.erase(it);
            else ++it;
        }
    }
};

// ---------------------------------------------------------------------------
// Ready / available lists (statemachine/client_tracker.py).
// ---------------------------------------------------------------------------

struct ClientReqNoD;  // disseminator's per-(client, req_no) record
using CRNP = shared_ptr<ClientReqNoD>;

template <typename T>
struct AppendList {
    deque<T> consumed;
    deque<T> pending;

    void reset_iterator() {
        for (auto &v : pending) consumed.push_back(std::move(v));
        pending = std::move(consumed);
        consumed.clear();
    }
    bool has_next() const { return !pending.empty(); }
    T next() {
        T v = std::move(pending.front());
        pending.pop_front();
        consumed.push_back(v);
        return v;
    }
    void push_back(T v) { pending.push_back(std::move(v)); }

    template <typename F>
    void garbage_collect(F &&should_remove) {
        deque<T> nc, np;
        for (auto &v : consumed)
            if (!should_remove(v)) nc.push_back(std::move(v));
        for (auto &v : pending)
            if (!should_remove(v)) np.push_back(std::move(v));
        consumed = std::move(nc);
        pending = std::move(np);
    }
};

struct ClientTracker {
    InitParms my_config;
    shared_ptr<AppendList<CRNP>> ready_list;
    shared_ptr<AppendList<AckS>> available_list;
    vector<ClientStateS> client_states;

    void reinitialize(const NetStateS &ns) {
        client_states = ns.clients;
        available_list = std::make_shared<AppendList<AckS>>();
        ready_list = std::make_shared<AppendList<CRNP>>();
    }

    void add_ready(CRNP crn) { ready_list->push_back(std::move(crn)); }
    void add_available(AckS ack) { available_list->push_back(ack); }

    // allocate(): GC both lists against post-checkpoint client states.
    void allocate(const NetStateS &state);
};

// ---------------------------------------------------------------------------
// Batch tracker (statemachine/batch_tracker.py).
// ---------------------------------------------------------------------------

struct BatchRec {
    std::set<i64> observed_for;
    vector<AckS> request_acks;
};

struct BatchTracker {
    std::map<i32, BatchRec> batches_by_digest;
    std::map<i32, vector<i64>> fetch_in_flight;
    PersistedLog *persisted;

    void reinitialize() {
        batches_by_digest.clear();
        fetch_in_flight.clear();
        for (const auto &pr : persisted->entries)
            if (pr.second->t == PET::Q)
                add_batch(pr.second->q->seq, pr.second->q->dig,
                          pr.second->q->reqs);
    }

    void truncate(i64 seq_no) {
        for (auto it = batches_by_digest.begin();
             it != batches_by_digest.end();) {
            auto &b = it->second;
            std::set<i64> keep;
            for (i64 s : b.observed_for)
                if (s >= seq_no) keep.insert(s);
            b.observed_for = std::move(keep);
            if (b.observed_for.empty()) it = batches_by_digest.erase(it);
            else ++it;
        }
    }

    void add_batch(i64 seq_no, i32 digest, const vector<AckS> &request_acks) {
        auto it = batches_by_digest.find(digest);
        if (it == batches_by_digest.end()) {
            it = batches_by_digest.emplace(digest, BatchRec{{}, request_acks})
                     .first;
        }
        it->second.observed_for.insert(seq_no);
        auto fit = fetch_in_flight.find(digest);
        if (fit != fetch_in_flight.end()) {
            for (i64 s : fit->second) it->second.observed_for.insert(s);
            fetch_in_flight.erase(fit);
        }
    }

    Actions fetch_batch(i64 seq_no, i32 digest, vector<i32> sources) {
        auto it = fetch_in_flight.find(digest);
        if (it != fetch_in_flight.end())
            for (i64 s : it->second)
                if (s == seq_no) return Actions();
        fetch_in_flight[digest].push_back(seq_no);
        Actions a;
        a.push_back(act_send(std::move(sources), mk_fetch_batch(seq_no, digest)));
        return a;
    }

    Actions reply_fetch_batch(i32 source, i64 seq_no, i32 digest) {
        auto it = batches_by_digest.find(digest);
        if (it == batches_by_digest.end()) return Actions();
        Actions a;
        a.push_back(act_send({source},
                             mk_forward_batch(seq_no, it->second.request_acks,
                                              digest)));
        return a;
    }

    Actions apply_forward_batch_msg(i32 source, i64 seq_no, i32 digest,
                                    const vector<AckS> &request_acks,
                                    const Interner &in) {
        if (!fetch_in_flight.count(digest)) return Actions();
        vector<string> parts;
        for (const auto &a : request_acks) parts.push_back(in.get(a.dig));
        HashOriginS origin;
        origin.t = OT::VerifyBatch;
        origin.source = source;
        origin.seq = seq_no;
        origin.request_acks = request_acks;
        origin.expected_digest = digest;
        Actions acts;
        acts.push_back(act_hash(std::move(parts), std::move(origin)));
        return acts;
    }

    void apply_verify_batch_hash_result(i32 digest, const HashOriginS &origin) {
        if (origin.expected_digest != digest)
            throw EngineError("forwarded batch hash mismatch (byzantine forwarder)");
        auto it = fetch_in_flight.find(digest);
        if (it == fetch_in_flight.end()) return;
        vector<i64> in_flight = std::move(it->second);
        fetch_in_flight.erase(it);
        auto bit = batches_by_digest.find(digest);
        if (bit == batches_by_digest.end())
            bit = batches_by_digest
                      .emplace(digest, BatchRec{{}, origin.request_acks})
                      .first;
        for (i64 s : in_flight) bit->second.observed_for.insert(s);
    }

    bool has_fetch_in_flight() const { return !fetch_in_flight.empty(); }
    const BatchRec *get_batch(i32 digest) const {
        auto it = batches_by_digest.find(digest);
        return it == batches_by_digest.end() ? nullptr : &it->second;
    }
    BatchRec *get_batch_mut(i32 digest) {
        auto it = batches_by_digest.find(digest);
        return it == batches_by_digest.end() ? nullptr : &it->second;
    }
};

// ---------------------------------------------------------------------------
// Cluster-shared ack-wave ledger.
//
// The O(N²) collapse (round-3 headline work): every AckBatch broadcast is
// applied by all N receivers to near-identical per-(client, req_no) vote
// state.  Instead of replaying the per-ack mask arithmetic N times, the
// engine applies each broadcast ONCE to a canonical per-client record set
// at SEND time (send order == arrival order under the engine envelope's
// uniform link latency — the queue breaks time ties by insertion sequence,
// so every receiver consumes broadcasts in registration order).  Receivers
// then consume each wave segment as a cursor bump plus a replay of the
// precomputed quorum-crossing candidates; all non-crossing acks cost the
// receiver nothing.
//
// Receiver-side asymmetries are handled exactly:
//   * own-ack early application (a node applies its own acks via the
//     self-send short-circuit before the wave's canonical position):
//     per-(client, receiver) `own_early` position sets shift crossing
//     counts by +1 for pending own bits (the `adj` term);
//   * window skew (PAST acks skip, FUTURE acks buffer classically and the
//     record goes copy-on-divergence for that receiver until it retires
//     from the window — divergence is per-record and self-healing);
//   * every non-green entry point (buffered replays, force-acks during
//     epoch fetch, attention/fetch ticks, fetch-request replies)
//     materializes the receiver's private record from the canonical logs
//     first and proceeds on the classic path.
// Per-receiver maps that downstream components read (weak/strong/my
// request maps, committed flags, attention, resend state) are maintained
// classically at the receiver's own instants, so the Proposer/ClientTracker
// interfaces are unchanged and exact.
//
// Reference semantics preserved: client_hash_disseminator.go:806-876 (the
// ack accumulation rules this plane replays canonically).
// ---------------------------------------------------------------------------

// The host-fast floor shared by hash_parts and check_ready (mirrors
// crypto.py::_host_fast's complement): single parts under 512 B stay on
// the host; everything else is wave-eligible device content.
inline bool hash_is_host_floor(const vector<string> &parts) {
    return parts.size() == 1 && parts[0].size() < 512;
}

struct WaveTouch {
    i64 req_no;
    i32 dig;      // digest interner id
    u32 post;     // canonical agreement count after this touch (NEW/DUP)
    u8 kind;      // 0=NEW bit, 1=DUP (same-digest revote), 2=REJECT/no-op
    bool candidate;  // post (or post+1 for adj receivers) can cross a quorum
};

struct WaveSeg {
    i64 client;
    void *canon = nullptr;  // CanonClient* (set at registration; map nodes
                            // have stable addresses)
    u8 src;
    i64 min_reqno, max_reqno;
    u32 ack_start, ack_end;  // slice of the registered msg's acks vector
    vector<WaveTouch> touches;      // in batch order
    vector<u32> candidates;         // indexes into touches
};

struct WaveReg {
    MsgP msg;                 // keeps the acks alive for classic fallback
    u32 pos;                  // global stream position (the wave id)
    i64 min_any, max_any;     // req_no bounds across all segments
    vector<WaveSeg> segs;     // in batch (client-ascending) order
    vector<u32> candidate_segs;  // seg indexes with a non-empty candidate set
    // Lazily-built per-ack singleton msgs shared by every receiver that
    // buffers the ack as FUTURE (saves an alloc + wire-size computation
    // per receiver per ack).
    mutable vector<MsgP> single_msgs;

    const MsgP &single(size_t k) const {
        if (single_msgs.empty()) single_msgs.resize(msg->acks.size());
        if (!single_msgs[k]) single_msgs[k] = mk_ack_msg(msg->acks[k]);
        return single_msgs[k];
    }
};

// Per-receiver cursor over the global ack-wave stream.  Every broadcast
// wave is consumed by every live receiver in registration order; own waves
// (self-send short-circuit) are consumed early and absorbed when the
// cursor reaches their position.
struct LedView {
    u32 version = 0;
    vector<u32> own_early;

    bool consumed(u32 pos) const {
        if (pos < version) return true;
        for (u32 p : own_early)
            if (p == pos) return true;
        return false;
    }
    void absorb() {
        bool moved = true;
        while (moved && !own_early.empty()) {
            moved = false;
            for (size_t i = 0; i < own_early.size(); i++)
                if (own_early[i] == version) {
                    own_early.erase(own_early.begin() + (std::ptrdiff_t)i);
                    version += 1;
                    moved = true;
                    break;
                }
        }
    }
};

struct CanonDig {
    i32 dig;
    Mask mask;
    // (stream position, source) per added bit, in canonical order.
    vector<std::pair<u32, u8>> add_log;

    i32 pos_of(u8 src) const {  // -1 if src never added its bit
        for (const auto &pr : add_log)
            if (pr.second == src) return (i32)pr.first;
        return -1;
    }
};

struct CanonRec {
    i64 req_no;
    Mask non_null;
    vector<std::pair<u32, u8>> nn_log;  // (position, source) per non-null bit
    vector<CanonDig> digs;              // canonical first-sight order
    Mask diverged;                      // receivers on private record state

    CanonDig *find(i32 dig) {
        for (auto &d : digs)
            if (d.dig == dig) return &d;
        return nullptr;
    }
    CanonDig &find_or_create(i32 dig) {
        CanonDig *d = find(dig);
        if (d) return *d;
        digs.push_back(CanonDig{dig});
        return digs.back();
    }
};

struct CanonClient {
    i64 base = -1;            // lowest req_no with a record (set on first touch)
    deque<CanonRec> recs;

    CanonRec *rec(i64 req_no) {
        if (base < 0 || req_no < base) return nullptr;
        i64 off = req_no - base;
        if (off >= (i64)recs.size()) return nullptr;
        return &recs[(size_t)off];
    }
    CanonRec &rec_or_create(i64 req_no) {
        if (base < 0) {
            base = req_no;
            recs.emplace_back();
            recs.back().req_no = req_no;
            return recs.back();
        }
        while (req_no < base) {  // extend downward (defensive; base is the
            recs.emplace_front();  // first-touched req_no, usually 0)
            base -= 1;
            recs.front().req_no = base;
        }
        while ((i64)recs.size() <= req_no - base) {
            recs.emplace_back();
            recs.back().req_no = base + (i64)recs.size() - 1;
        }
        return recs[(size_t)(req_no - base)];
    }
};

struct AckLedger {
    i64 wq, sq;
    deque<WaveReg> waves;  // window [wave_base, wave_base + size)
    u32 wave_base = 0;
    std::map<i64, CanonClient> clients;

    // find-first: under PDES every client is pre-registered at setup, so
    // the concurrent-window path is a pure lookup (operator[]'s insert
    // machinery would be a structural race across partition threads).
    CanonClient &client(i64 id) {
        auto it = clients.find(id);
        if (it != clients.end()) return it->second;
        return clients[id];
    }

    const WaveReg &wave(i64 wave_id) const {
        return waves[(size_t)((u32)wave_id - wave_base)];
    }

    // Bound ledger memory: waves every live receiver's cursor has passed
    // will never be consumed again (buffered replays use fresh singleton
    // msgs), and canonical records below every receiver's low watermark
    // have retired.  Called periodically by the engine.
    void prune(u32 min_version, const std::map<i64, i64> &min_lw) {
        while (wave_base < min_version && !waves.empty()) {
            waves.pop_front();
            wave_base += 1;
        }
        for (auto &pr : clients) {
            auto it = min_lw.find(pr.first);
            if (it == min_lw.end()) continue;
            CanonClient &cc = pr.second;
            while (cc.base >= 0 && cc.base < it->second && !cc.recs.empty() &&
                   !cc.recs.front().diverged.any()) {
                cc.recs.pop_front();
                cc.base += 1;
            }
        }
    }

    bool is_candidate_count(i64 post) const {
        return post == wq - 1 || post == wq || post == sq - 1 || post == sq;
    }

    // Register one broadcast ack msg: apply it to the canonical state
    // (mirroring ClientD::ack_run's accept/dup/reject rules exactly) and
    // record per-touch outcomes for receiver-side replay.
    void register_msg(const MsgP &m, i32 source) {
        if (m->wave_id >= 0) return;
        WaveReg reg;
        reg.msg = m;
        reg.pos = wave_base + (u32)waves.size();
        reg.min_any = INT64_MAX;
        reg.max_any = INT64_MIN;
        const vector<AckS> &acks = m->acks;
        size_t i = 0;
        while (i < acks.size()) {
            i64 client_id = acks[i].client;
            CanonClient &cc = client(client_id);
            WaveSeg seg;
            seg.client = client_id;
            seg.canon = &cc;
            seg.src = (u8)source;
            seg.ack_start = (u32)i;
            seg.min_reqno = acks[i].reqno;
            seg.max_reqno = acks[i].reqno;
            while (i < acks.size() && acks[i].client == client_id) {
                const AckS &a = acks[i];
                if (a.reqno < seg.min_reqno) seg.min_reqno = a.reqno;
                if (a.reqno > seg.max_reqno) seg.max_reqno = a.reqno;
                CanonRec &R = cc.rec_or_create(a.reqno);
                WaveTouch t;
                t.req_no = a.reqno;
                t.dig = a.dig;
                t.post = 0;
                t.candidate = false;
                if (a.dig != 0 && R.non_null.test(source)) {
                    // Source already voted non-null: only a same-digest
                    // revote proceeds (as a DUP); otherwise the vote is
                    // rejected (at most creating an empty candidate entry).
                    CanonDig *ex = R.find(a.dig);
                    if (!ex || !ex->mask.test(source)) {
                        if (!ex) R.digs.push_back(CanonDig{a.dig});
                        t.kind = 2;  // REJECT: no receiver-visible effect
                    } else {
                        t.kind = 1;  // DUP
                        t.post = (u32)ex->mask.count();
                        t.candidate = is_candidate_count((i64)t.post);
                    }
                } else {
                    if (a.dig != 0) {
                        if (!R.non_null.test(source)) {
                            R.non_null.set(source);
                            R.nn_log.emplace_back(reg.pos, (u8)source);
                        }
                    }
                    CanonDig &D = R.find_or_create(a.dig);
                    if (D.mask.test(source)) {
                        t.kind = 1;  // DUP (null revote or same-digest)
                        t.post = (u32)D.mask.count();
                        t.candidate = is_candidate_count((i64)t.post);
                    } else {
                        D.mask.set(source);
                        D.add_log.emplace_back(reg.pos, (u8)source);
                        t.kind = 0;  // NEW
                        t.post = (u32)D.mask.count();
                        t.candidate = is_candidate_count((i64)t.post);
                    }
                }
                if (t.candidate)
                    seg.candidates.push_back((u32)seg.touches.size());
                seg.touches.push_back(t);
                i++;
            }
            seg.ack_end = (u32)i;
            if (seg.min_reqno < reg.min_any) reg.min_any = seg.min_reqno;
            if (seg.max_reqno > reg.max_any) reg.max_any = seg.max_reqno;
            if (!seg.candidates.empty())
                reg.candidate_segs.push_back((u32)reg.segs.size());
            reg.segs.push_back(std::move(seg));
        }
        m->wave_id = (i64)reg.pos;
        waves.push_back(std::move(reg));
    }
};

// ---------------------------------------------------------------------------
// PDES ack-ledger sharding.  Under PDES the global registration order of a
// window's broadcasts is only known at the barrier, so each partition
// registers its own sends into a private overlay with PROVISIONAL wave
// positions (high bit set — never `< version`, so LedView::consumed treats
// them as own-early membership checks).  Only the SENDER consumes a
// provisional wave (the self-send short-circuit, same step): with the
// ledger live the window width is min over ALL directed links, so every
// arrival of a window-sent wave lands in a later window — after the
// barrier has folded the shard into the global ledger in exact replay
// order and remapped the sender's early-consumed position to the final
// one.  The overlay therefore only has to compose with the sender's own
// consumed set; other partitions' same-window registrations are invisible
// by construction, exactly as they are unconsumed in the sequential run.
// ---------------------------------------------------------------------------

constexpr u32 LED_PROV_BIT = 0x80000000u;

struct ShardDig {
    i32 dig;
    Mask mask;                           // this window's new bits only
    vector<std::pair<u32, u8>> add_log;  // provisional positions
};

struct ShardRec {
    Mask non_null;                       // this window's new non-null bits
    vector<std::pair<u32, u8>> nn_log;
    vector<ShardDig> digs;

    ShardDig *find(i32 dig) {
        for (auto &d : digs)
            if (d.dig == dig) return &d;
        return nullptr;
    }
    const ShardDig *find(i32 dig) const {
        for (const auto &d : digs)
            if (d.dig == dig) return &d;
        return nullptr;
    }
};

struct AckShard {
    AckLedger *global = nullptr;
    std::map<std::pair<i64, i64>, ShardRec> recs;  // (client, req_no)
    struct ShardWave {
        WaveReg reg;   // reg.pos is provisional (LED_PROV_BIT | index)
        u32 plog_at;   // partition plog index of the sending step
        i32 src;       // sender node id (fold re-registers + remaps)
    };
    deque<ShardWave> waves;  // deque: reg references stay stable
    size_t foldi = 0;        // barrier fold cursor

    ShardRec *rec(i64 client, i64 req_no) {
        auto it = recs.find({client, req_no});
        return it == recs.end() ? nullptr : &it->second;
    }
    const ShardRec *rec(i64 client, i64 req_no) const {
        auto it = recs.find({client, req_no});
        return it == recs.end() ? nullptr : &it->second;
    }

    void clear() {
        recs.clear();
        waves.clear();
        foldi = 0;
    }

    // Mirror of AckLedger::register_msg against the COMPOSED state
    // (frozen global ledger + this partition's overlay).  kind is exact
    // (it depends only on the source's own bits, which live globally or
    // in this overlay); post/candidate are best-effort and unused — the
    // sender's own-path consumption recounts from the composed add logs,
    // and arrivals only ever consume the fold-time global registration.
    void register_msg_lite(const MsgP &m, i32 source, u32 plog_at) {
        if (m->wave_id >= 0) return;
        ShardWave sw;
        sw.plog_at = plog_at;
        sw.src = source;
        WaveReg &reg = sw.reg;
        reg.msg = m;
        reg.pos = LED_PROV_BIT | (u32)waves.size();
        reg.min_any = INT64_MAX;
        reg.max_any = INT64_MIN;
        const vector<AckS> &acks = m->acks;
        size_t i = 0;
        while (i < acks.size()) {
            i64 client_id = acks[i].client;
            auto cit = global->clients.find(client_id);
            if (cit == global->clients.end())
                throw EngineError("pdes ledger: client not pre-registered");
            CanonClient &cc = cit->second;
            WaveSeg seg;
            seg.client = client_id;
            seg.canon = &cc;
            seg.src = (u8)source;
            seg.ack_start = (u32)i;
            seg.min_reqno = acks[i].reqno;
            seg.max_reqno = acks[i].reqno;
            while (i < acks.size() && acks[i].client == client_id) {
                const AckS &a = acks[i];
                if (a.reqno < seg.min_reqno) seg.min_reqno = a.reqno;
                if (a.reqno > seg.max_reqno) seg.max_reqno = a.reqno;
                CanonRec *RG = cc.rec(a.reqno);  // read-only (frozen)
                ShardRec &S = recs[{client_id, a.reqno}];
                WaveTouch t;
                t.req_no = a.reqno;
                t.dig = a.dig;
                t.post = 0;
                t.candidate = false;
                bool nn_src = (RG && RG->non_null.test(source)) ||
                              S.non_null.test(source);
                CanonDig *DG = RG ? RG->find(a.dig) : nullptr;
                ShardDig *DS = S.find(a.dig);
                bool have_bit = (DG && DG->mask.test(source)) ||
                                (DS && DS->mask.test(source));
                if (a.dig != 0 && nn_src) {
                    if (!have_bit) {
                        if (!DG && !DS) S.digs.push_back(ShardDig{a.dig});
                        t.kind = 2;  // REJECT
                    } else {
                        t.kind = 1;  // DUP
                        t.post = (u32)((DG ? DG->mask.count() : 0) +
                                       (DS ? DS->mask.count() : 0));
                        t.candidate = global->is_candidate_count((i64)t.post);
                    }
                } else {
                    if (a.dig != 0 && !nn_src) {
                        S.non_null.set(source);
                        S.nn_log.emplace_back(reg.pos, (u8)source);
                    }
                    if (have_bit) {
                        t.kind = 1;  // DUP (null revote or same-digest)
                    } else {
                        if (!DS) {
                            S.digs.push_back(ShardDig{a.dig});
                            DS = &S.digs.back();
                        }
                        DS->mask.set(source);
                        DS->add_log.emplace_back(reg.pos, (u8)source);
                        t.kind = 0;  // NEW
                    }
                    t.post = (u32)((DG ? DG->mask.count() : 0) +
                                   (DS ? DS->mask.count() : 0));
                    t.candidate = global->is_candidate_count((i64)t.post);
                }
                if (t.candidate)
                    seg.candidates.push_back((u32)seg.touches.size());
                seg.touches.push_back(t);
                i++;
            }
            seg.ack_end = (u32)i;
            if (seg.min_reqno < reg.min_any) reg.min_any = seg.min_reqno;
            if (seg.max_reqno > reg.max_any) reg.max_any = seg.max_reqno;
            if (!seg.candidates.empty())
                reg.candidate_segs.push_back((u32)reg.segs.size());
            reg.segs.push_back(std::move(seg));
        }
        m->wave_id = (i64)reg.pos;
        waves.push_back(std::move(sw));
    }
};

// ---------------------------------------------------------------------------
// Client request dissemination (statemachine/disseminator.py).
// Vote masks are 4-word Masks (engine envelope: <= 256 nodes).
// ---------------------------------------------------------------------------

constexpr i64 CORRECT_FETCH_TICKS = 4;
constexpr i64 FETCH_TIMEOUT_TICKS = 4;
constexpr i64 ACK_RESEND_TICKS = 20;

struct ClientRequestD {
    AckS ack;
    Mask agreements;
    bool stored = false;
    bool fetching = false;
    i64 ticks_fetching = 0;
    i64 ticks_correct = 0;

    Actions fetch() {
        if (fetching) return Actions();
        fetching = true;
        ticks_fetching = 0;
        Actions a;
        a.push_back(act_send(mask_to_nodes(agreements), mk_fetch_request(ack)));
        return a;
    }
};
using CRP = shared_ptr<ClientRequestD>;

// Small insertion-ordered map digest-id -> value (1-2 entries typical).
template <typename V>
struct SmallDigMap {
    vector<std::pair<i32, V>> items;
    V *get(i32 k) {
        for (auto &pr : items)
            if (pr.first == k) return &pr.second;
        return nullptr;
    }
    const V *get(i32 k) const {
        for (const auto &pr : items)
            if (pr.first == k) return &pr.second;
        return nullptr;
    }
    V &put(i32 k, V v) {
        for (auto &pr : items)
            if (pr.first == k) { pr.second = std::move(v); return pr.second; }
        items.emplace_back(k, std::move(v));
        return items.back().second;
    }
    bool contains(i32 k) const { return get(k) != nullptr; }
    size_t size() const { return items.size(); }
    bool empty() const { return items.empty(); }
};

struct ClientReqNoD {
    i64 client_id, req_no;
    i64 valid_after_seq_no;
    Mask non_null_voters;
    SmallDigMap<CRP> requests;         // all observed candidates
    SmallDigMap<CRP> weak_requests;    // correct
    SmallDigMap<CRP> strong_requests;  // proposable
    SmallDigMap<CRP> my_requests;      // locally persisted
    bool committed = false;
    i64 acks_sent = 0;
    i32 acked_digest = -1;  // -1 = None
    i64 resend_nonce = 0;
    // Digests this receiver has self-applied its own ack for (ledger `adj`
    // bookkeeping; 1 entry normally, 2 after a null promotion).
    vector<i32> self_acked;

    CRP client_req(const AckS &ack) {
        CRP *existing = requests.get(ack.dig);
        if (existing) return *existing;
        auto cr = std::make_shared<ClientRequestD>();
        cr->ack = ack;
        requests.put(ack.dig, cr);
        return cr;
    }

    void apply_new_request(const AckS &ack) {
        if (my_requests.contains(ack.dig)) return;
        CRP req = client_req(ack);
        req->stored = true;
        my_requests.put(ack.dig, req);
    }

    // generate_ack() -> (has_ack, ack) (disseminator.py:215-232).
    bool generate_ack(AckS *out) {
        if (my_requests.empty()) return false;
        if (my_requests.size() == 1) {
            acks_sent = 1;
            CRP req = my_requests.items[0].second;
            acked_digest = req->ack.dig;
            *out = req->ack;
            return true;
        }
        AckS null_ack{client_id, req_no, 0};
        CRP null_req = client_req(null_ack);
        null_req->stored = true;
        my_requests.put(0, null_req);
        acks_sent = 1;
        acked_digest = 0;
        *out = null_ack;
        return true;
    }

    bool needs_attention() const {
        const auto &wr = weak_requests;
        if (wr.empty()) return false;
        if (wr.size() == 1) {
            const CRP &req = wr.items[0].second;
            if (req->fetching) return true;
            return !req->stored;
        }
        if (!my_requests.contains(0)) return true;  // null promotion pending
        for (const auto &pr : wr.items)
            if (pr.second->fetching) return true;
        return false;
    }

    // attention_tick (disseminator.py:270-318); returns promoted.
    bool attention_tick(Actions &actions, const Targets &nodes,
                        const Interner &intern) {
        bool promoted = false;
        if (!my_requests.contains(0) && weak_requests.size() > 1) {
            AckS null_ack{client_id, req_no, 0};
            CRP null_req = client_req(null_ack);
            null_req->stored = true;
            my_requests.put(0, null_req);
            acks_sent = 1;
            acked_digest = 0;
            promoted = true;
            actions.push_back(act_send(nodes, mk_ack_msg(null_ack)));
            actions.push_back(act_correct(null_ack));
        }
        if (weak_requests.size() == 1) {
            CRP req = weak_requests.items[0].second;
            if (!req->stored && !req->fetching) {
                if (req->ticks_correct <= CORRECT_FETCH_TICKS)
                    req->ticks_correct += 1;
                else
                    concat(actions, req->fetch());
            }
        }
        vector<CRP> to_fetch;
        for (auto &pr : weak_requests.items) {
            CRP &req = pr.second;
            if (!req->fetching) continue;
            if (req->ticks_fetching <= FETCH_TIMEOUT_TICKS) {
                req->ticks_fetching += 1;
                continue;
            }
            req->fetching = false;
            to_fetch.push_back(req);
        }
        if (!to_fetch.empty()) {
            // Python: to_fetch.sort(key=digest bytes, reverse=True).
            std::stable_sort(to_fetch.begin(), to_fetch.end(),
                             [&intern](const CRP &a, const CRP &b) {
                                 return intern.get(a->ack.dig) >
                                        intern.get(b->ack.dig);
                             });
            for (auto &req : to_fetch) concat(actions, req->fetch());
        }
        return promoted;
    }
};

struct ClientD {
    const Ctx *ctx = nullptr;
    InitParms my_config;
    ClientTracker *client_tracker = nullptr;
    ClientStateS client_state;
    bool has_state = false;
    i64 high_watermark = 0;
    i64 next_ready_mark = 0;
    i64 next_ack_mark = 0;
    // Dense window [win_base, win_base+win.size()-1] — Python's insertion-
    // ordered dict over an ascending contiguous window.
    i64 win_base = 0;
    deque<CRNP> win;
    i64 tick_count = 0;
    std::set<i64> attention;
    std::map<i64, vector<std::pair<i64, i64>>> resend_schedule;
    i64 resend_seq = 0;
    i64 weak_quorum = 0, strong_quorum = 0;
    // Ack-ledger consumption state (see AckLedger): the receiver's global
    // stream cursor lives on the Disseminator (LedView); this client holds
    // only its classic flag and shared-counter hooks.
    const LedView *led_view = nullptr;
    i64 *led_diverged_total = nullptr;
    i64 *led_classic_count = nullptr;
    // PDES: the owning partition's ledger overlay (slot on the
    // Disseminator, re-pointed every step; null outside PDES windows).
    AckShard *const *led_shard_slot = nullptr;
    bool led_classic = false;
    i64 led_diverged = 0;

    const AckShard *led_shard() const {
        return led_shard_slot ? *led_shard_slot : nullptr;
    }

    // Quorum bookkeeping used during a changed-config rebuild
    // (disseminator.py:234-246 _apply_request_ack).
    void apply_request_ack(ClientReqNoD &crn, i32 source, const AckS &a) {
        if (a.dig != 0) crn.non_null_voters.set(source);
        CRP req = crn.client_req(a);
        req->agreements.set(source);
        i64 count = req->agreements.count();
        if (count < weak_quorum) return;
        crn.weak_requests.put(a.dig, req);
        if (count < strong_quorum) return;
        crn.strong_requests.put(a.dig, req);
    }

    // disseminator.py:162-198 (ClientReqNo.reinitialize, config changed):
    // re-derive quorum sets from remembered agreements, iterating old
    // candidates in sorted-digest-bytes order (the rebuild both reorders
    // the candidate maps and constructs fresh ClientRequests, dropping
    // fetch state; `stored` carries over into fresh my_requests).
    void crn_rebuild(ClientReqNoD &crn) {
        auto old_items = std::move(crn.requests.items);
        crn.requests.items.clear();
        crn.non_null_voters = Mask();
        crn.weak_requests.items.clear();
        crn.strong_requests.items.clear();
        crn.my_requests.items.clear();
        std::stable_sort(old_items.begin(), old_items.end(),
                         [this](const std::pair<i32, CRP> &a,
                                const std::pair<i32, CRP> &b) {
                             return ctx->intern.get(a.first) <
                                    ctx->intern.get(b.first);
                         });
        for (const auto &pr : old_items) {
            const CRP &old_req = pr.second;
            for (i32 node : ctx->cfg.nodes)
                if (old_req->agreements.test(node))
                    apply_request_ack(crn, node, old_req->ack);
            if (old_req->stored) {
                CRP new_req = crn.client_req(old_req->ack);
                new_req->stored = true;
                crn.my_requests.put(pr.first, new_req);
            }
        }
    }

    CRNP win_get(i64 req_no) const {
        i64 off = req_no - win_base;
        if (off < 0 || off >= (i64)win.size()) return nullptr;
        return win[(size_t)off];
    }

    CRNP req_no_of(i64 req_no) {
        CRNP crn = win_get(req_no);
        if (!crn) throw EngineError("client should have req_no");
        return crn;
    }

    bool in_watermarks(i64 req_no) const {
        return client_state.lw <= req_no && req_no <= high_watermark;
    }

    Actions reinitialize(i64 seq_no, i64 client_id,
                         const ClientStateS &state, bool reconfiguring,
                         bool same_config, i64 ci) {
        Actions actions;
        weak_quorum = ctx->wq;
        strong_quorum = ctx->iq;
        if (!same_config)
            // A changed config invalidates the ledger's canonical view of
            // this client (quorum-set rebuild reorders candidate maps):
            // materialize private state and consume classically from here.
            led_fallback_all_classic();
        led_classic = led_classic || my_config.led_classic;
        deque<CRNP> old_win = std::move(win);
        i64 old_base = win_base;
        win.clear();
        // Records dropped below the new low watermark retire their
        // divergence marks (self-healing: fresh records start fast).
        if (!old_win.empty())
            for (i64 rn = old_base; rn < state.lw &&
                                    rn < old_base + (i64)old_win.size();
                 rn++)
                led_release(rn);

        i64 intermediate_high = state.lw + state.width - state.wclc - 1;
        client_state = state;
        has_state = true;
        high_watermark =
            !reconfiguring ? state.lw + state.width - 1 : intermediate_high;
        next_ready_mark = state.lw;
        if (next_ack_mark < state.lw) next_ack_mark = state.lw;

        win_base = state.lw;
        // Config never changes within the engine envelope (same_config=True
        // after the first call; the first call has no prior req_nos at all).
        for (i64 rn = state.lw; rn <= high_watermark; rn++) {
            CRNP crn;
            i64 old_off = rn - old_base;
            if (old_off >= 0 && old_off < (i64)old_win.size() &&
                !old_win.empty()) {
                crn = old_win[(size_t)old_off];
                if (same_config) {
                    // Graceful rotation under an unchanged config: identity
                    // on vote state; only per-candidate fetch state resets.
                    for (auto &pr : crn->requests.items) {
                        pr.second->fetching = false;
                        pr.second->ticks_fetching = 0;
                        pr.second->ticks_correct = 0;
                    }
                } else {
                    crn_rebuild(*crn);
                }
            } else {
                i64 valid_after =
                    rn > intermediate_high ? seq_no + ci : seq_no;
                crn = std::make_shared<ClientReqNoD>();
                crn->client_id = client_id;
                crn->req_no = rn;
                crn->valid_after_seq_no = valid_after;
                actions.push_back(act_allocate(client_id, rn));
            }
            crn->committed = is_committed(rn, state);
            win.push_back(std::move(crn));
        }
        attention.clear();
        for (const auto &crn : win)
            if (!crn->committed && crn->needs_attention())
                attention.insert(crn->req_no);
        advance_ready();
        return actions;
    }

    Actions allocate(i64 seq_no, const ClientStateS &state, bool reconfiguring,
                     i64 ci) {
        Actions actions;
        i64 intermediate_high = state.lw + state.width - state.wclc - 1;
        if (intermediate_high != high_watermark)
            throw EngineError("new intermediate high watermark mismatch");
        i64 new_high =
            !reconfiguring ? state.lw + state.width - 1 : intermediate_high;

        if (state.lw > next_ready_mark) next_ready_mark = state.lw;
        if (state.lw > next_ack_mark) next_ack_mark = state.lw;

        // Drop window prefix below the new low watermark.
        while (!win.empty() && win_base != state.lw) {
            led_release(win_base);
            win.pop_front();
            win_base += 1;
        }
        if (win.empty()) win_base = state.lw;
        for (i64 rn = state.lw; rn <= high_watermark; rn++)
            if (is_committed(rn, state)) req_no_of(rn)->committed = true;

        client_state = state;

        i64 valid_after = seq_no + ci;
        for (i64 rn = intermediate_high + 1; rn <= new_high; rn++) {
            actions.push_back(act_allocate(state.id, rn));
            auto crn = std::make_shared<ClientReqNoD>();
            crn->client_id = state.id;
            crn->req_no = rn;
            crn->valid_after_seq_no = valid_after;
            win.push_back(std::move(crn));
        }
        high_watermark = new_high;
        advance_ready();
        return actions;
    }

    // --- ack-ledger consumption (see AckLedger above) -------------------

    bool led_enabled() const {
        return ctx->ack_ledger != nullptr && !led_classic;
    }

    // Reconstruct this receiver's private per-record vote state from the
    // canonical logs (consumed prefix + own-early positions), then mark
    // the record diverged so every later touch goes the classic path.
    void led_ensure_private(ClientReqNoD &crn) {
        if (!led_enabled()) return;
        CanonClient &cc = ctx->ack_ledger->client(client_state.id);
        CanonRec &R = cc.rec_or_create(crn.req_no);
        if (R.diverged.test(my_config.id)) return;
        const AckShard *sh = led_shard();
        const ShardRec *S = sh ? sh->rec(client_state.id, crn.req_no) : nullptr;
        Mask nn;
        for (const auto &pr : R.nn_log)
            if (led_view->consumed(pr.first)) nn.set(pr.second);
        if (S)
            for (const auto &pr : S->nn_log)
                if (led_view->consumed(pr.first)) nn.set(pr.second);
        crn.non_null_voters = nn;
        for (const auto &D : R.digs) {
            CRP cr = crn.client_req(AckS{crn.client_id, crn.req_no, D.dig});
            Mask m;
            for (const auto &pr : D.add_log)
                if (led_view->consumed(pr.first)) m.set(pr.second);
            if (S)
                if (const ShardDig *DS = S->find(D.dig))
                    for (const auto &pr : DS->add_log)
                        if (led_view->consumed(pr.first)) m.set(pr.second);
            cr->agreements = m;
        }
        if (S)
            for (const auto &DS : S->digs) {
                // Digests first seen this window (canonically AFTER every
                // frozen global dig, so appending preserves sight order).
                bool in_global = false;
                for (const auto &D : R.digs)
                    if (D.dig == DS.dig) in_global = true;
                if (in_global) continue;
                CRP cr =
                    crn.client_req(AckS{crn.client_id, crn.req_no, DS.dig});
                Mask m;
                for (const auto &pr : DS.add_log)
                    if (led_view->consumed(pr.first)) m.set(pr.second);
                cr->agreements = m;
            }
        R.diverged.set_atomic(my_config.id);
        led_diverged += 1;
        if (led_diverged_total) *led_diverged_total += 1;
    }

    void led_release(i64 req_no) {
        if (!led_enabled()) return;
        CanonClient &cc = ctx->ack_ledger->client(client_state.id);
        CanonRec *R = cc.rec(req_no);
        if (R && R->diverged.test(my_config.id)) {
            R->diverged.clear_atomic(my_config.id);
            led_diverged -= 1;
            if (led_diverged_total) *led_diverged_total -= 1;
        }
    }

    // After a window roll replayed this receiver's buffered FUTURE acks,
    // a diverged record whose masks exactly match the canonical view is
    // aligned again — clear the mark so it rides the fast path.  Records
    // diverged for other reasons (force-acks, missing buffered acks) fail
    // the comparison and stay private.  Private fetch/tick state on the
    // CRPs is orthogonal to alignment (the fast path never touches it).
    void led_try_realign() {
        if (!led_enabled() || led_diverged == 0) return;
        CanonClient &cc = ctx->ack_ledger->client(client_state.id);
        const AckShard *sh = led_shard();
        for (const auto &crnp : win) {
            ClientReqNoD &crn = *crnp;
            CanonRec *R = cc.rec(crn.req_no);
            if (!R || !R->diverged.test(my_config.id)) continue;
            const ShardRec *S =
                sh ? sh->rec(client_state.id, crn.req_no) : nullptr;
            Mask nn;
            for (const auto &pr : R->nn_log)
                if (led_view->consumed(pr.first)) nn.set(pr.second);
            if (S)
                for (const auto &pr : S->nn_log)
                    if (led_view->consumed(pr.first)) nn.set(pr.second);
            if (crn.non_null_voters != nn) continue;
            bool equal = true;
            for (const auto &D : R->digs) {
                Mask m;
                for (const auto &pr : D.add_log)
                    if (led_view->consumed(pr.first)) m.set(pr.second);
                if (S)
                    if (const ShardDig *DS = S->find(D.dig))
                        for (const auto &pr : DS->add_log)
                            if (led_view->consumed(pr.first))
                                m.set(pr.second);
                CRP *cr = crn.requests.get(D.dig);
                Mask actual = cr ? (*cr)->agreements : Mask();
                if (actual != m) { equal = false; break; }
            }
            if (equal && S)
                for (const auto &DS : S->digs) {
                    if (R->find(DS.dig)) continue;
                    Mask m;
                    for (const auto &pr : DS.add_log)
                        if (led_view->consumed(pr.first)) m.set(pr.second);
                    CRP *cr = crn.requests.get(DS.dig);
                    Mask actual = cr ? (*cr)->agreements : Mask();
                    if (actual != m) { equal = false; break; }
                }
            if (!equal) continue;
            R->diverged.clear_atomic(my_config.id);
            led_diverged -= 1;
            if (led_diverged_total) *led_diverged_total -= 1;
            if (led_diverged == 0) break;
        }
    }

    // Materialize every in-window record and consume classically forever
    // (safety valve for conditions the fast path does not model).
    void led_fallback_all_classic() {
        if (led_enabled())
            for (const auto &crnp : win) led_ensure_private(*crnp);
        if (!led_classic && led_classic_count) *led_classic_count += 1;
        led_classic = true;
    }

    // Quorum-crossing replay for one candidate touch consumed as an
    // arrival (seg.src != me).  Mirrors ack_run's per-ack body for counts
    // at the quorum edges; all other counts have no receiver-visible
    // effect.  `adj` shifts the canonical count when our own bit for this
    // digest was self-applied early and its canonical position is still
    // ahead of this touch.
    void led_candidate(CanonRec &R, const WaveTouch &t, u32 seg_pos,
                       const AckS &a, Actions &actions) {
        if (t.kind == 2) return;  // canonically rejected: no effect
        CRNP crnp = win_get(t.req_no);
        if (!crnp) throw EngineError("ledger candidate outside window");
        ClientReqNoD &crn = *crnp;
        i64 adj = 0;
        if (!crn.self_acked.empty()) {
            for (i32 d : crn.self_acked)
                if (d == t.dig) {
                    CanonDig *D = R.find(t.dig);
                    i32 p = D ? D->pos_of((u8)my_config.id) : -1;
                    if (p < 0 || (u32)p > seg_pos) adj = 1;
                    break;
                }
        }
        i64 c_r = (i64)t.post + adj;
        if (c_r == weak_quorum) {
            CRP cr = crn.client_req(a);
            crn.weak_requests.put(t.dig, cr);
            if (!cr->stored) actions.push_back(act_correct(a));
            update_attention(crn);
            if (cr->stored) client_tracker->add_available(a);
        }
        if (c_r == strong_quorum) {
            CRP cr = crn.client_req(a);
            crn.strong_requests.put(t.dig, cr);
            advance_ready();
        }
    }

    // Own-segment touch (self-send short-circuit): applied early, before
    // the touch's canonical position is reached by arrivals.  The count on
    // our view derives from the add log restricted to our consumed set
    // plus this touch itself.
    void led_own_touch(CanonClient &cc, u32 wave_pos, const WaveTouch &t,
                       const AckS &a, Actions &actions) {
        if (client_state.lw > t.req_no) return;  // PAST
        if (high_watermark < t.req_no)
            throw EngineError("own ack beyond own high watermark");
        CanonRec &R = cc.rec_or_create(t.req_no);
        if (R.diverged.test(my_config.id)) {
            ack_into(actions, my_config.id, a, false);
            return;
        }
        CRNP crnp = win_get(t.req_no);
        if (!crnp) throw EngineError("own ack outside window");
        ClientReqNoD &crn = *crnp;
        if (t.kind == 2) {
            // Conflicting own revote, canonically rejected — classic would
            // reject identically (our non-null bit was self-applied).
            crn.client_req(a);
            return;
        }
        if (t.kind == 0) {
            bool known = false;
            for (i32 d : crn.self_acked)
                if (d == t.dig) known = true;
            if (!known) crn.self_acked.push_back(t.dig);
        }
        CanonDig *D = R.find(t.dig);
        i64 cnt = 0;
        if (D) {
            for (const auto &pr : D->add_log) {
                bool cons = led_view->consumed(pr.first);
                if (!cons && pr.first == wave_pos &&
                    pr.second == (u8)my_config.id)
                    cons = true;  // the bit this touch applies
                if (cons) cnt += 1;
            }
        }
        // PDES: this window's own bits (including the one this touch
        // applies, at its provisional position) live only in the overlay.
        if (const AckShard *sh = led_shard())
            if (const ShardRec *S = sh->rec(client_state.id, t.req_no))
                if (const ShardDig *DS = S->find(t.dig))
                    for (const auto &pr : DS->add_log) {
                        bool cons = led_view->consumed(pr.first);
                        if (!cons && pr.first == wave_pos &&
                            pr.second == (u8)my_config.id)
                            cons = true;
                        if (cons) cnt += 1;
                    }
        i64 c_r = cnt;
        if (c_r < weak_quorum) return;
        bool newly = c_r == weak_quorum;
        CRP cr = crn.client_req(a);
        if (newly) {
            crn.weak_requests.put(t.dig, cr);
            if (!cr->stored) actions.push_back(act_correct(a));
            update_attention(crn);
        }
        if (cr->stored) client_tracker->add_available(a);  // source == me
        if (c_r == strong_quorum) {
            crn.strong_requests.put(t.dig, cr);
            advance_ready();
        }
    }

    // Exact per-touch walk of one segment (used when the wave-level fast
    // preconditions fail: window straddling or diverged records).
    template <typename BufferStore>
    void led_seg_slow(const WaveSeg &seg, u32 wave_pos,
                      const vector<AckS> &acks, Actions &actions,
                      BufferStore &&buffer_store) {
        CanonClient &cc = *(CanonClient *)seg.canon;
        if (led_diverged == 0) {
            // No private records: only candidates and the FUTURE suffix
            // matter (touches are reqno-ascending within a segment —
            // coalesce_sends sorts batches by (client, reqno)).
            for (u32 ci : seg.candidates) {
                const WaveTouch &t = seg.touches[ci];
                if (t.req_no < client_state.lw || t.req_no > high_watermark)
                    continue;
                CanonRec *R = cc.rec(t.req_no);
                led_candidate(*R, t, wave_pos, acks[seg.ack_start + ci],
                              actions);
            }
            if (seg.max_reqno > high_watermark) {
                size_t k = seg.touches.size();
                while (k > 0 && seg.touches[k - 1].req_no > high_watermark)
                    k--;
                for (; k < seg.touches.size(); k++) {
                    const WaveTouch &t = seg.touches[k];
                    if (t.req_no <= high_watermark) continue;  // unsorted guard
                    buffer_store(seg.ack_start + k);
                    CanonRec &R = cc.rec_or_create(t.req_no);
                    if (!R.diverged.test(my_config.id)) {
                        R.diverged.set(my_config.id);
                        led_diverged += 1;
                        if (led_diverged_total) *led_diverged_total += 1;
                    }
                }
            }
            return;
        }
        for (size_t k = 0; k < seg.touches.size(); k++) {
            const WaveTouch &t = seg.touches[k];
            const AckS &a = acks[seg.ack_start + k];
            if (client_state.lw > t.req_no) continue;  // PAST: no effect
            if (high_watermark < t.req_no) {
                // FUTURE: buffer classically; the record rides private
                // state for us from here (it has never been in our
                // window, so fresh classic state is exact).
                buffer_store(seg.ack_start + k);
                CanonRec &R = cc.rec_or_create(t.req_no);
                if (!R.diverged.test(my_config.id)) {
                    R.diverged.set_atomic(my_config.id);
                    led_diverged += 1;
                    if (led_diverged_total) *led_diverged_total += 1;
                }
                continue;
            }
            CanonRec *R = cc.rec(t.req_no);
            if (R && R->diverged.test(my_config.id)) {
                ack_into(actions, (i32)seg.src, a, false);
                continue;
            }
            if (t.candidate && R)
                led_candidate(*R, t, wave_pos, a, actions);
        }
    }

    // ack_into (disseminator.py:488-539) — the per-ack hot path.
    CRP ack_into(Actions &actions, i32 source, const AckS &ack,
                 bool force = false) {
        CRNP crnp = win_get(ack.reqno);
        if (!crnp) throw EngineError("ack outside watermarks");
        led_ensure_private(*crnp);
        ClientReqNoD &crn = *crnp;

        if (ack.dig != 0 && !force) {
            CRP *existing = crn.requests.get(ack.dig);
            bool already_voted_this =
                existing && (*existing)->agreements.test(source);
            if (crn.non_null_voters.test(source) && !already_voted_this)
                return crn.client_req(ack);
        }
        if (ack.dig != 0) crn.non_null_voters.set(source);

        CRP cr = crn.client_req(ack);
        if (source == my_config.id && !cr->agreements.test(source)) {
            bool known = false;
            for (i32 d : crn.self_acked)
                if (d == ack.dig) known = true;
            if (!known) crn.self_acked.push_back(ack.dig);
        }
        cr->agreements.set(source);
        i64 agreement_count = cr->agreements.count();

        bool newly_correct = agreement_count == weak_quorum;
        if (newly_correct) {
            crn.weak_requests.put(ack.dig, cr);
            if (!cr->stored) actions.push_back(act_correct(ack));
            update_attention(crn);
        }
        if (cr->stored &&
            (newly_correct ||
             (agreement_count >= weak_quorum && source == my_config.id)))
            client_tracker->add_available(ack);
        if (agreement_count == strong_quorum) {
            crn.strong_requests.put(ack.dig, cr);
            advance_ready();
        }
        return cr;
    }

    // ack_run (disseminator.py:541-604): a run of in-window acks from one
    // source for this client starting at acks[start]; returns index after.
    size_t ack_run(Actions &actions, i32 source, const vector<AckS> &acks,
                   size_t start) {
        u64 bit = 1ull << source;
        i64 weak_q = weak_quorum, strong_q = strong_quorum;
        i64 low = client_state.lw, high = high_watermark;
        i64 client_id = acks[start].client;
        size_t n = acks.size();
        size_t i = start;
        while (i < n) {
            const AckS &ack = acks[i];
            if (ack.client != client_id) break;
            i64 req_no = ack.reqno;
            if (req_no < low || req_no > high) break;
            i++;
            i32 digest = ack.dig;
            ClientReqNoD &crn = *win[(size_t)(req_no - win_base)];
            CRP cr;
            if (digest != 0 && crn.non_null_voters.test(source)) {
                CRP *existing = crn.requests.get(digest);
                if (!existing) {
                    auto fresh = std::make_shared<ClientRequestD>();
                    fresh->ack = ack;
                    crn.requests.put(digest, fresh);
                    continue;
                }
                if (!(*existing)->agreements.test(source)) continue;
                cr = *existing;
            } else {
                if (digest != 0) crn.non_null_voters.set(source);
                CRP *existing = crn.requests.get(digest);
                if (existing) {
                    cr = *existing;
                } else {
                    cr = std::make_shared<ClientRequestD>();
                    cr->ack = ack;
                    crn.requests.put(digest, cr);
                }
            }
            cr->agreements.set(source);
            i64 count = cr->agreements.count();
            if (count < weak_q) continue;
            bool newly_correct = count == weak_q;
            if (newly_correct) {
                crn.weak_requests.put(digest, cr);
                if (!cr->stored) actions.push_back(act_correct(ack));
                update_attention(crn);
            }
            if (cr->stored && (newly_correct || source == my_config.id))
                client_tracker->add_available(ack);
            if (count == strong_q) {
                crn.strong_requests.put(digest, cr);
                advance_ready();
            }
        }
        return i;
    }

    void advance_ready() {
        for (i64 i = next_ready_mark; i <= high_watermark; i++) {
            if (i != next_ready_mark) return;
            CRNP crn = req_no_of(i);
            if (crn->committed) {
                next_ready_mark = i + 1;
                continue;
            }
            for (const auto &pr : crn->strong_requests.items) {
                if (!crn->my_requests.contains(pr.first)) continue;
                client_tracker->add_ready(crn);
                next_ready_mark = i + 1;
                break;
            }
        }
    }

    // Appends freshly generated acks to `acks` instead of broadcasting:
    // the disseminator's flush_acks coalesces acks across all dirty
    // clients into one AckBatch per event batch (mirrors the Python
    // Client.advance_acks / flush_acks split).
    void advance_acks(vector<AckS> &acks) {
        for (i64 i = next_ack_mark; i <= high_watermark; i++) {
            CRNP crn = req_no_of(i);
            AckS ack{0, 0, 0};
            if (!crn->generate_ack(&ack)) break;
            acks.push_back(ack);
            schedule_resend(*crn, tick_count + ACK_RESEND_TICKS + 1);
            update_attention(*crn);
            next_ack_mark = i + 1;
        }
    }

    void update_attention(ClientReqNoD &crn) {
        if (!crn.committed && crn.needs_attention())
            attention.insert(crn.req_no);
        else
            attention.erase(crn.req_no);
    }

    void schedule_resend(ClientReqNoD &crn, i64 due_tick) {
        resend_seq += 1;
        crn.resend_nonce = resend_seq;
        resend_schedule[due_tick].emplace_back(crn.req_no, crn.resend_nonce);
    }

    void apply_new_request(const AckS &ack) {
        CRNP crn = req_no_of(ack.reqno);
        crn->apply_new_request(ack);
        update_attention(*crn);
    }

    void note_fetching(const AckS &ack) {
        CRNP crn = win_get(ack.reqno);
        if (crn) update_attention(*crn);
    }

    void tick(Actions &actions, const Targets &nodes) {
        tick_count += 1;
        if (!attention.empty()) {
            // Python iterates sorted(attention) over a snapshot.
            vector<i64> snapshot(attention.begin(), attention.end());
            for (i64 rn : snapshot) {
                CRNP crn = win_get(rn);
                if (!crn || crn->committed) {
                    attention.erase(rn);
                    continue;
                }
                // attention_tick mutates per-candidate fetch state and
                // reads agreements (fetch targets): private-state ground.
                led_ensure_private(*crn);
                if (crn->attention_tick(actions, nodes, ctx->intern))
                    schedule_resend(*crn, tick_count + ACK_RESEND_TICKS);
                update_attention(*crn);
            }
        }
        vector<AckS> resend;
        auto due_it = resend_schedule.find(tick_count);
        if (due_it != resend_schedule.end()) {
            vector<std::pair<i64, i64>> due = std::move(due_it->second);
            resend_schedule.erase(due_it);
            for (const auto &pr : due) {
                CRNP crnp = win_get(pr.first);
                if (!crnp || crnp->committed || crnp->resend_nonce != pr.second)
                    continue;
                ClientReqNoD &crn = *crnp;
                CRP *req = crn.my_requests.get(crn.acked_digest);
                if (!req)
                    throw EngineError("sent an ack for a request we do not have");
                crn.acks_sent += 1;
                resend.push_back((*req)->ack);
                schedule_resend(crn,
                                tick_count + crn.acks_sent * ACK_RESEND_TICKS + 1);
            }
        }
        if (resend.size() == 1)
            actions.push_back(act_send(nodes, mk_ack_msg(resend[0])));
        else if (!resend.empty())
            actions.push_back(act_send(nodes, mk_ack_batch(std::move(resend))));
    }
};

struct Disseminator {
    const Ctx *ctx = nullptr;
    InitParms my_config;
    NodeBuffers *node_buffers = nullptr;
    ClientTracker *client_tracker = nullptr;
    NetCfgP network_config;  // the active consensused config
    i64 allocated_through = 0;
    bool initialized = false;
    vector<ClientStateS> client_states;
    std::map<i32, MsgBuffer> msg_buffers;
    std::map<i64, shared_ptr<ClientD>> clients;
    vector<ClientD *> client_dense;  // direct index for small dense ids
    std::set<i64> ack_dirty;
    // Ack-ledger receiver state: the global stream cursor plus the
    // aggregates that gate the wave-level fast path.
    LedView led_view;
    // PDES: the owning partition's ledger overlay, re-pointed by the
    // engine every step (null in sequential runs and barrier tails).
    AckShard *led_shard = nullptr;
    i64 led_diverged_total = 0;
    i64 led_classic_count = 0;
    i64 led_max_lw = 0;          // max client low watermark (PAST gate)
    i64 led_min_high = INT64_MAX;  // min client high watermark (FUTURE gate)

    void led_refresh_bounds() {
        led_max_lw = 0;
        led_min_high = INT64_MAX;
        led_classic_count = 0;
        for (const auto &pr : clients) {
            const ClientD &c = *pr.second;
            if (c.client_state.lw > led_max_lw) led_max_lw = c.client_state.lw;
            if (c.high_watermark < led_min_high) led_min_high = c.high_watermark;
            if (c.led_classic) led_classic_count += 1;
        }
    }

    ClientD *client(i64 client_id) {
        if ((u64)client_id < client_dense.size())
            return client_dense[(size_t)client_id];
        auto it = clients.find(client_id);
        return it == clients.end() ? nullptr : it->second.get();
    }

    void rebuild_dense() {
        client_dense.clear();
        i64 max_id = -1;
        for (const auto &pr : clients) max_id = std::max(max_id, pr.first);
        if (max_id < 0 || max_id >= 4096) return;
        client_dense.assign((size_t)max_id + 1, nullptr);
        for (const auto &pr : clients)
            client_dense[(size_t)pr.first] = pr.second.get();
    }

    Actions reinitialize(i64 seq_no, const NetStateS &network_state) {
        Actions actions;
        bool reconfiguring = !network_state.pending.empty();
        bool same_config =
            network_config && *network_config == *network_state.config;
        network_config = network_state.config;
        allocated_through = seq_no;

        auto old_clients = std::move(clients);
        clients.clear();
        client_states = network_state.clients;
        for (const auto &cs : client_states) {
            shared_ptr<ClientD> c;
            auto it = old_clients.find(cs.id);
            if (it != old_clients.end()) {
                c = it->second;
            } else {
                c = std::make_shared<ClientD>();
                c->ctx = ctx;
                c->my_config = my_config;
                c->client_tracker = client_tracker;
                c->led_view = &led_view;
                c->led_shard_slot = &led_shard;
                c->led_diverged_total = &led_diverged_total;
                c->led_classic_count = &led_classic_count;
            }
            clients.emplace(cs.id, c);
            concat(actions,
                   c->reinitialize(seq_no, cs.id, cs, reconfiguring,
                                   same_config, network_config->ci));
        }
        led_refresh_bounds();
        auto old_msg_buffers = std::move(msg_buffers);
        msg_buffers.clear();
        for (i32 node : ctx->cfg.nodes) {
            auto it = old_msg_buffers.find(node);
            if (it != old_msg_buffers.end()) {
                msg_buffers.emplace(node, std::move(it->second));
            } else {
                MsgBuffer mb;
                mb.nb = node_buffers->node_buffer(node);
                mb.wire = &ctx->wire;
                msg_buffers.emplace(node, std::move(mb));
            }
        }
        rebuild_dense();
        initialized = true;
        return actions;
    }

    Actions tick() {
        Actions actions;
        for (const auto &cs : client_states)
            clients.at(cs.id)->tick(actions, ctx->bcast);
        return actions;
    }

    Applyable filter(const MsgS &msg) {
        if (msg.t == MT::AckMsg) {
            const AckS &ack = msg.acks[0];
            ClientD *c = client(ack.client);
            if (!c) return Applyable::FUTURE;
            if (c->client_state.lw > ack.reqno) return Applyable::PAST;
            if (c->high_watermark < ack.reqno) return Applyable::FUTURE;
            return Applyable::CURRENT;
        }
        if (msg.t == MT::FetchRequest) return Applyable::CURRENT;
        throw EngineError("unexpected client message type");
    }

    // The classic per-ack classification loop over acks[i..end) — the
    // AckBatch arm of disseminator.py:1056-1085; also the fallback for
    // ledger segments outside the fast path's envelope.
    void classic_slice(Actions &actions, i32 source, const vector<AckS> &acks,
                       size_t i, size_t end) {
        while (i < end) {
            const AckS &ack = acks[i];
            ClientD *c = client(ack.client);
            if (!c) {
                msg_buffers.at(source).store(mk_ack_msg(ack));  // FUTURE
                i++;
                continue;
            }
            i64 req_no = ack.reqno;
            if (c->client_state.lw > req_no) {
                i++;
                continue;  // PAST
            }
            if (c->high_watermark < req_no) {
                msg_buffers.at(source).store(mk_ack_msg(ack));  // FUTURE
                i++;
                continue;
            }
            i = c->ack_run(actions, source, acks, i);
        }
    }

    Actions step(i32 source, const MsgP &msg) {
        if ((msg->t == MT::AckBatch || msg->t == MT::AckMsg) &&
            msg->wave_id >= 0 && ctx->ack_ledger != nullptr) {
            // Ledger wave consumption: ONE cursor bump per wave plus the
            // precomputed quorum-crossing candidates.  See AckLedger.
            u64 t0 = __rdtsc();
            Actions actions;
            const WaveReg *regp;
            if ((u64)msg->wave_id & (u64)LED_PROV_BIT) {
                // PDES provisional wave: only the sender's self-send
                // short-circuit may consume it (arrivals land post-fold
                // with the final id — the window is narrower than every
                // link by construction).
                if (source != my_config.id || !led_shard)
                    throw EngineError(
                        "pdes ledger: provisional wave outside sender");
                regp = &led_shard
                            ->waves[(size_t)((u32)msg->wave_id &
                                             ~LED_PROV_BIT)]
                            .reg;
            } else {
                regp = &ctx->ack_ledger->wave(msg->wave_id);
            }
            const WaveReg &reg = *regp;
            const vector<AckS> &acks = reg.msg->acks;
            auto buffer_store = [&](size_t ack_index) {
                msg_buffers.at(source).store(reg.single(ack_index));
            };
            if (source == my_config.id) {
                // Own wave, consumed early via the self-send short-circuit.
                for (const WaveSeg &seg : reg.segs) {
                    ClientD *c = client(seg.client);
                    if (!c) {
                        for (u32 k = seg.ack_start; k < seg.ack_end; k++)
                            buffer_store(k);
                        continue;
                    }
                    if (c->led_classic) {
                        classic_slice(actions, source, acks, seg.ack_start,
                                      seg.ack_end);
                        continue;
                    }
                    CanonClient &cc = *(CanonClient *)seg.canon;
                    for (size_t k = 0; k < seg.touches.size(); k++)
                        c->led_own_touch(cc, reg.pos, seg.touches[k],
                                         acks[seg.ack_start + k], actions);
                }
                if (led_view.version == reg.pos) {
                    led_view.version += 1;
                    led_view.absorb();
                } else {
                    led_view.own_early.push_back(reg.pos);
                }
                g_parts[0].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
                return actions;
            }
            // Arrival: the cursor must be exactly at this wave's position
            // (gaps can only be our own early-consumed waves).
            led_view.absorb();
            if (led_view.version != reg.pos) {
                // Outside the modeled envelope: switch every client to the
                // classic path, permanently (safe, exact).  The cursor
                // still advances so ledger pruning is not blocked.
                for (const auto &pr : clients)
                    pr.second->led_fallback_all_classic();
                led_refresh_bounds();
                if (reg.pos + 1 > led_view.version) {
                    led_view.version = reg.pos + 1;
                    led_view.own_early.clear();
                }
                classic_slice(actions, source, acks, 0, acks.size());
                g_parts[0].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
                return actions;
            }
            if (led_classic_count == 0 && led_diverged_total == 0 &&
                reg.max_any < led_min_high && reg.min_any >= led_max_lw) {
                // Steady-state: only quorum-crossing candidates cost work.
                for (u32 si : reg.candidate_segs) {
                    const WaveSeg &seg = reg.segs[si];
                    ClientD *c = client(seg.client);
                    CanonClient &cc = *(CanonClient *)seg.canon;
                    for (u32 ci : seg.candidates) {
                        const WaveTouch &t = seg.touches[ci];
                        CanonRec *R = cc.rec(t.req_no);
                        c->led_candidate(*R, t, reg.pos,
                                         acks[seg.ack_start + ci], actions);
                    }
                }
            } else {
                for (const WaveSeg &seg : reg.segs) {
                    ClientD *c = client(seg.client);
                    if (!c) {
                        for (u32 k = seg.ack_start; k < seg.ack_end; k++)
                            buffer_store(k);
                        continue;
                    }
                    if (c->led_classic) {
                        classic_slice(actions, source, acks, seg.ack_start,
                                      seg.ack_end);
                        continue;
                    }
                    // Per-segment gate: an in-window segment with no
                    // diverged records costs only its candidates.
                    if (c->led_diverged == 0 &&
                        c->client_state.lw <= seg.min_reqno &&
                        seg.max_reqno <= c->high_watermark) {
                        CanonClient &cc = *(CanonClient *)seg.canon;
                        for (u32 ci : seg.candidates) {
                            const WaveTouch &t = seg.touches[ci];
                            CanonRec *R = cc.rec(t.req_no);
                            c->led_candidate(*R, t, reg.pos,
                                             acks[seg.ack_start + ci],
                                             actions);
                        }
                        continue;
                    }
                    c->led_seg_slow(seg, reg.pos, acks, actions, buffer_store);
                }
            }
            led_view.version = reg.pos + 1;
            led_view.absorb();
            g_parts[0].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
            return actions;
        }
        if (msg->t == MT::AckBatch) {
            u64 t0 = __rdtsc();
            // Per-ack classification; in-window same-client runs go through
            // ack_run (the AckBatch arm of disseminator.py:1056-1085 — the
            // pure semantics the native plane replays).
            Actions actions;
            classic_slice(actions, source, msg->acks, 0, msg->acks.size());
            g_parts[0].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
            return actions;
        }
        Applyable verdict = filter(*msg);
        if (verdict == Applyable::PAST) return Actions();
        if (verdict == Applyable::FUTURE) {
            msg_buffers.at(source).store(msg);
            return Actions();
        }
        return apply_msg(source, msg);
    }

    Actions apply_msg(i32 source, const MsgP &msg) {
        if (msg->t == MT::AckMsg) {
            Actions actions;
            ack(actions, source, msg->acks[0], false);
            return actions;
        }
        if (msg->t == MT::FetchRequest) {
            const AckS &a = msg->acks[0];
            return reply_fetch_request(source, a);
        }
        throw EngineError("unexpected client message type");
    }

    Actions apply_new_request(const AckS &ack) {
        ClientD *c = client(ack.client);
        if (!c) return Actions();
        if (!c->in_watermarks(ack.reqno)) return Actions();
        c->apply_new_request(ack);
        ack_dirty.insert(ack.client);
        return Actions();
    }

    Actions flush_acks() {
        // All dirty clients' acks coalesce into ONE AckBatch per flush
        // (mirrors the Python flush_acks: one broadcast per event batch,
        // not one per client; receive arms classify per ack).
        if (ack_dirty.empty()) return Actions();
        Actions actions;
        vector<AckS> merged;
        for (i64 client_id : ack_dirty) {  // std::set: sorted like Python
            ClientD *c = client(client_id);
            if (c) c->advance_acks(merged);
        }
        ack_dirty.clear();
        if (merged.size() == 1)
            actions.push_back(act_send(ctx->bcast, mk_ack_msg(merged[0])));
        else if (!merged.empty())
            actions.push_back(
                act_send(ctx->bcast, mk_ack_batch(std::move(merged))));
        return actions;
    }

    Actions allocate(i64 seq_no, const NetStateS &network_state) {
        if (seq_no != network_state.config->ci + allocated_through)
            throw EngineError("unexpected skip in allocate");
        Actions actions;
        allocated_through = seq_no;
        bool reconfiguring = !network_state.pending.empty();
        for (const auto &cs : network_state.clients) {
            ClientD *c = client(cs.id);
            concat(actions,
                   c->allocate(seq_no, cs, reconfiguring, network_config->ci));
        }
        led_refresh_bounds();
        for (i32 node : ctx->cfg.nodes) {
            msg_buffers.at(node).iterate(
                [this](const MsgS &m) { return filter(m); },
                [this, node, &actions](MsgP m) {
                    concat(actions, apply_msg(node, m));
                });
        }
        if (ctx->ack_ledger != nullptr) {
            for (const auto &cs : network_state.clients)
                client(cs.id)->led_try_realign();
            led_refresh_bounds();
        }
        return actions;
    }

    Actions reply_fetch_request(i32 source, const AckS &a) {
        ClientD *c = client(a.client);
        if (!c || !c->in_watermarks(a.reqno)) return Actions();
        CRNP crn = c->req_no_of(a.reqno);
        c->led_ensure_private(*crn);  // reads agreements (our own bit)
        CRP *data = crn->requests.get(a.dig);
        if (!data || !(*data)->agreements.test(my_config.id))
            return Actions();
        Actions actions;
        actions.push_back(act_forward({source}, a));
        return actions;
    }

    CRP ack(Actions &actions, i32 source, const AckS &a, bool force) {
        ClientD *c = client(a.client);
        if (!c)
            throw EngineError("step filtering should delay reqs for non-existent clients");
        return c->ack_into(actions, source, a, force);
    }

    void note_fetching(const AckS &a) {
        ClientD *c = client(a.client);
        if (c) c->note_fetching(a);
    }
};

// ---------------------------------------------------------------------------
// Proposer (statemachine/proposer.py).
// ---------------------------------------------------------------------------

struct ProposalBucket {
    i64 bucket_id;
    i64 current_checkpoint;
    i64 checkpoint_interval;
    i64 request_count;
    vector<CRP> pending;
    deque<CRP> ready_list;
    deque<CRP> next_ready_list;

    void queue_request(i64 valid_after_seq_no, CRP cr) {
        if (current_checkpoint >= valid_after_seq_no) {
            ready_list.push_back(std::move(cr));
        } else {
            if (valid_after_seq_no != current_checkpoint + checkpoint_interval)
                throw EngineError(
                    "requests should never become ready beyond the next "
                    "checkpoint interval");
            next_ready_list.push_back(std::move(cr));
        }
    }

    void advance(i64 to_seq_no) {
        if (to_seq_no >= current_checkpoint + checkpoint_interval) {
            current_checkpoint += checkpoint_interval;
            for (auto &cr : next_ready_list) ready_list.push_back(std::move(cr));
            next_ready_list.clear();
        }
        while ((i64)pending.size() < request_count && !ready_list.empty()) {
            pending.push_back(std::move(ready_list.front()));
            ready_list.pop_front();
        }
    }

    bool has_outstanding(i64 for_seq_no) {
        advance(for_seq_no);
        return !pending.empty();
    }

    bool has_pending(i64 for_seq_no) {
        advance(for_seq_no);
        return !pending.empty() && (i64)pending.size() == request_count;
    }

    vector<CRP> next() {
        vector<CRP> result = std::move(pending);
        pending.clear();
        return result;
    }
};

struct Proposer {
    const Ctx *ctx;
    InitParms my_config;
    i64 nb;  // TOTAL bucket count under the active config
    std::map<i64, ProposalBucket> proposal_buckets;
    shared_ptr<AppendList<CRNP>> ready_iterator;

    Proposer(const Ctx *c, i64 base_checkpoint, InitParms mc,
             shared_ptr<AppendList<CRNP>> ready_list,
             const std::map<i64, i32> &buckets)
        : ctx(c), my_config(mc), nb((i64)buckets.size()) {
        for (const auto &pr : buckets) {
            if (pr.second != mc.id) continue;
            ProposalBucket b;
            b.bucket_id = pr.first;
            b.current_checkpoint = base_checkpoint;
            b.checkpoint_interval = c->cfg.ci;
            b.request_count = mc.batch_size;
            proposal_buckets.emplace(pr.first, std::move(b));
        }
        ready_list->reset_iterator();
        ready_iterator = std::move(ready_list);
    }

    void advance(i64 to_seq_no) {
        while (ready_iterator->has_next()) {
            CRNP crn = ready_iterator->next();
            if (crn->committed) continue;
            i64 bucket_id = (crn->client_id + crn->req_no) % nb;
            auto it = proposal_buckets.find(bucket_id);
            if (it == proposal_buckets.end()) continue;
            ProposalBucket &bucket = it->second;
            bucket.advance(to_seq_no);
            if (crn->strong_requests.size() > 1) {
                // Conflicting strong certs: prefer the null request.
                CRP *null_req = crn->strong_requests.get(0);
                if (!null_req)
                    throw EngineError(
                        "if multiple requests have quorum, one must be null");
                bucket.queue_request(crn->valid_after_seq_no, *null_req);
            } else {
                if (crn->strong_requests.size() != 1)
                    throw EngineError("exactly one strong request must exist");
                bucket.queue_request(crn->valid_after_seq_no,
                                     crn->strong_requests.items[0].second);
            }
        }
    }

    ProposalBucket *proposal_bucket(i64 bucket_id) {
        auto it = proposal_buckets.find(bucket_id);
        return it == proposal_buckets.end() ? nullptr : &it->second;
    }
};

// ---------------------------------------------------------------------------
// Commit state (statemachine/commitstate.py).
// ---------------------------------------------------------------------------

struct CommittingClient {
    ClientStateS last_state;
    vector<i64> committed;  // -1 = None, seq_no otherwise

    CommittingClient() = default;
    CommittingClient(i64 seq_no, const ClientStateS &cs) {
        committed.assign((size_t)cs.width, -1);
        i64 bits = 8 * (i64)cs.mask.size();
        for (i64 i = 0; i < bits; i++) {
            bool set = (u8(cs.mask[(size_t)(i >> 3)]) & (0x80u >> (i & 7))) != 0;
            if (set && i < (i64)committed.size()) committed[(size_t)i] = seq_no;
        }
        last_state = cs;
    }

    void mark_committed(i64 seq_no, i64 req_no) {
        if (req_no < last_state.lw) return;
        i64 offset = req_no - last_state.lw;
        if (offset >= (i64)committed.size()) {
            if (offset >= last_state.width)
                throw EngineError("commit beyond client window");
            committed.resize((size_t)(offset + 1), -1);
        }
        committed[(size_t)offset] = seq_no;
    }

    ClientStateS create_checkpoint_state() {
        ClientStateS old = last_state;
        i64 first_uncommitted = -1, last_committed = -1;
        bool have_fu = false, have_lc = false;
        for (i64 i = 0; i < old.width; i++) {
            i64 seq = i < (i64)committed.size() ? committed[(size_t)i] : -1;
            i64 req_no = old.lw + i;
            if (seq != -1) {
                last_committed = req_no;
                have_lc = true;
            } else if (!have_fu) {
                first_uncommitted = req_no;
                have_fu = true;
            }
        }
        if (!have_lc) {
            ClientStateS ns{old.id, old.width, 0, old.lw, string()};
            last_state = ns;
            return ns;
        }
        if (!have_fu) first_uncommitted = last_committed + 1;

        i64 width_consumed = first_uncommitted - old.lw;
        {
            vector<i64> next;
            for (i64 i = width_consumed; i < (i64)committed.size(); i++)
                next.push_back(committed[(size_t)i]);
            next.resize((size_t)(next.size() + old.width), -1);
            next.resize((size_t)old.width);
            committed = std::move(next);
        }

        string mask_bytes;
        if (last_committed != first_uncommitted) {
            i64 nbits = 8 * ((last_committed - first_uncommitted) / 8 + 1);
            mask_bytes.assign((size_t)(nbits / 8), '\0');
            for (i64 i = 0; i <= last_committed - first_uncommitted; i++) {
                if (committed[(size_t)i] == -1) continue;
                if (i == 0)
                    throw EngineError(
                        "the first uncommitted request cannot be committed");
                mask_bytes[(size_t)(i >> 3)] =
                    (char)(u8(mask_bytes[(size_t)(i >> 3)]) | (0x80u >> (i & 7)));
            }
        }
        ClientStateS ns{old.id, old.width, width_consumed, first_uncommitted,
                        mask_bytes};
        last_state = ns;
        return ns;
    }
};

struct CommitState {
    const Ctx *ctx = nullptr;
    PersistedLog *persisted = nullptr;
    std::map<i64, CommittingClient> committing_clients;
    i64 low_watermark = 0;
    i64 last_applied_commit = 0;
    i64 highest_commit = 0;
    i64 stop_at_seq_no = 0;
    NetStateP active_state;
    vector<QEntryP> lower_half_commits, upper_half_commits;
    bool checkpoint_pending = false;
    bool transferring = false;
    // Failed-transfer retry machinery (commitstate.py:221-229; completes
    // the reference's open edge, state_machine.go:210-212).
    i64 transfer_retry_in = 0;
    i64 transfer_retry_backoff = 0;
    bool have_retry_target = false;
    i64 retry_seq = 0;
    i32 retry_value = 0;

    Actions reinitialize() {
        const PersistEntS *last_c = nullptr, *last_t = nullptr;
        for (const auto &pr : persisted->entries) {
            if (pr.second->t == PET::C) last_c = pr.second.get();
            else if (pr.second->t == PET::T) last_t = pr.second.get();
        }
        if (!last_c) throw EngineError("log must contain a CEntry");

        active_state = last_c->netstate;
        low_watermark = last_c->seq;

        Actions actions;
        actions.push_back(act_state_applied(low_watermark, active_state));

        i64 ci = active_state->config->ci;
        if (active_state->pending.empty())
            stop_at_seq_no = last_c->seq + 2 * ci;
        else
            // Mid-reconfiguration: ordering halts at the next checkpoint,
            // which is where the pending reconfiguration will apply.
            stop_at_seq_no = low_watermark + ci;
        last_applied_commit = last_c->seq;
        highest_commit = last_c->seq;
        lower_half_commits.assign((size_t)ci, nullptr);
        upper_half_commits.assign((size_t)ci, nullptr);
        checkpoint_pending = false;

        committing_clients.clear();
        for (const auto &cs : active_state->clients)
            committing_clients.emplace(cs.id,
                                       CommittingClient(low_watermark, cs));

        transfer_retry_in = 0;
        transfer_retry_backoff = 0;
        have_retry_target = false;

        if (!last_t || last_c->seq >= last_t->seq) {
            transferring = false;
            return actions;
        }
        // Crashed mid-state-transfer: re-issue the transfer request.
        transferring = true;
        actions.push_back(act_state_transfer(last_t->seq, last_t->dig));
        return actions;
    }

    Actions transfer_to(i64 seq_no, i32 value) {
        if (transferring)
            throw EngineError("concurrent state transfers are not supported");
        transferring = true;
        Actions actions = persisted->append(pe_t(seq_no, value));
        actions.push_back(act_state_transfer(seq_no, value));
        return actions;
    }

    Actions apply_transfer_failed(i64 seq_no, i32 value) {
        // Stale failure from before a reinitialization — ignore.
        if (!transferring) return Actions();
        transfer_retry_backoff =
            transfer_retry_backoff == 0
                ? 1
                : std::min<i64>(transfer_retry_backoff * 2, 8);
        transfer_retry_in = transfer_retry_backoff;
        have_retry_target = true;
        retry_seq = seq_no;
        retry_value = value;
        return Actions();
    }

    Actions tick() {
        if (!have_retry_target) return Actions();
        transfer_retry_in -= 1;
        if (transfer_retry_in > 0) return Actions();
        have_retry_target = false;
        Actions actions;
        actions.push_back(act_state_transfer(retry_seq, retry_value));
        return actions;
    }

    Actions apply_checkpoint_result(i64 seq_no, i32 value, NetStateP ns) {
        i64 ci = active_state->config->ci;
        if (transferring) return Actions();
        if (seq_no != low_watermark + ci)
            throw EngineError("stale checkpoint result");
        bool completing_reconfiguration = !active_state->pending.empty();
        if (ns->pending.empty() && !completing_reconfiguration)
            stop_at_seq_no = seq_no + 2 * ci;
        // else: a reconfiguration is pending (don't order past the next
        // checkpoint) or this checkpoint just applied one (the epoch ends
        // here; the machine reinitializes under the new config).
        active_state = ns;
        lower_half_commits = std::move(upper_half_commits);
        upper_half_commits.assign((size_t)ci, nullptr);
        low_watermark = seq_no;
        checkpoint_pending = false;

        Actions actions = persisted->append(pe_c(seq_no, value, ns));
        actions.push_back(
            act_send(ctx->bcast, mk_checkpoint_msg(seq_no, value)));
        actions.push_back(act_state_applied(seq_no, ns));
        return actions;
    }

    std::pair<vector<QEntryP> *, size_t> slot(i64 seq_no, i64 ci) {
        bool upper = seq_no - low_watermark > ci;
        size_t offset = (size_t)((seq_no - (low_watermark + 1)) % ci);
        return {upper ? &upper_half_commits : &lower_half_commits, offset};
    }

    void commit(const QEntryP &q_entry) {
        if (transferring)
            throw EngineError("must never commit during state transfer");
        if (q_entry->seq > stop_at_seq_no)
            throw EngineError("commit seq exceeds stop");
        if (q_entry->seq <= low_watermark) return;
        if (highest_commit < q_entry->seq) {
            if (highest_commit + 1 != q_entry->seq)
                throw EngineError("out-of-order commit");
            highest_commit = q_entry->seq;
        }
        i64 ci = active_state->config->ci;
        auto [commits, offset] = slot(q_entry->seq, ci);
        QEntryP &existing = (*commits)[offset];
        if (existing) {
            if (existing->dig != q_entry->dig)
                throw EngineError("conflicting commit digests");
        } else {
            existing = q_entry;
        }
    }

    // drain() needs next_network_config; implemented after the helper below.
    Actions drain();
};

// next_network_config (commitstate.py:141-182): roll every client window
// forward, then apply any pending reconfigurations.
std::pair<NetCfgP, shared_ptr<const vector<ClientStateS>>>
next_network_config(const NetStateS &starting_state,
                    std::map<i64, CommittingClient> &committing_clients) {
    NetCfgP next_config = starting_state.config;
    auto out = std::make_shared<vector<ClientStateS>>();
    for (const auto &old_client : starting_state.clients) {
        auto it = committing_clients.find(old_client.id);
        if (it == committing_clients.end())
            throw EngineError("no committing client instance");
        out->push_back(it->second.create_checkpoint_state());
    }
    for (const auto &reconfig : starting_state.pending) {
        if (reconfig.t == ReconfigS::NewClient) {
            out->push_back(
                ClientStateS{reconfig.id, reconfig.width, 0, 0, string()});
        } else if (reconfig.t == ReconfigS::RemoveClient) {
            bool found = false;
            for (size_t i = 0; i < out->size(); i++)
                if ((*out)[i].id == reconfig.id) {
                    out->erase(out->begin() + (std::ptrdiff_t)i);
                    found = true;
                    break;
                }
            if (!found)
                throw EngineError("asked to remove a client which doesn't exist");
        } else {
            next_config = reconfig.config;
        }
    }
    return {std::move(next_config), std::move(out)};
}

Actions CommitState::drain() {
    i64 ci = active_state->config->ci;
    // Fast path (commitstate.py:370-384).
    i64 lac = last_applied_commit;
    if (lac < low_watermark + 2 * ci &&
        !(lac == low_watermark + ci && !checkpoint_pending)) {
        auto [commits, offset] = slot(lac + 1, ci);
        if (!(*commits)[offset]) return Actions();
    }

    Actions actions;
    while (last_applied_commit < low_watermark + 2 * ci) {
        if (last_applied_commit == low_watermark + ci && !checkpoint_pending) {
            auto [network_config, client_configs] =
                next_network_config(*active_state, committing_clients);
            actions.push_back(act_checkpoint(
                last_applied_commit, std::move(network_config),
                std::move(client_configs)));
            checkpoint_pending = true;
        }
        i64 next_commit = last_applied_commit + 1;
        auto [commits, offset] = slot(next_commit, ci);
        QEntryP commit = (*commits)[offset];
        if (!commit) break;
        if (commit->seq != next_commit)
            throw EngineError("attempted out-of-order commit");
        actions.push_back(act_commit(commit));
        for (const auto &req : commit->reqs)
            committing_clients.at(req.client).mark_committed(commit->seq,
                                                             req.reqno);
        last_applied_commit = next_commit;
    }
    return actions;
}

// ---------------------------------------------------------------------------
// Per-sequence three-phase commit (statemachine/sequence.py, dict path; the
// Python engine's native-plane path is observably identical to it).
// ---------------------------------------------------------------------------

enum class SeqState : u8 {
    UNINITIALIZED = 0, ALLOCATED = 1, PENDING_REQUESTS = 2, READY = 3,
    PREPREPARED = 4, PREPARED = 5, COMMITTED = 6,
};

struct Sequence {
    const Ctx *ctx;
    i32 owner;
    i64 seq_no, epoch;
    i32 my_id;
    PersistedLog *persisted;
    SeqState state = SeqState::UNINITIALIZED;
    QEntryP q_entry;
    vector<CRP> client_requests;
    vector<AckS> batch;
    std::unordered_set<AckS, AckHash> outstanding_reqs;
    bool has_outstanding_set = false;
    i32 digest = -1;  // -1 = None
    Mask prep_mask, commit_mask;
    SmallDigMap<i64> prepares, commits;
    i32 my_prepare_digest = -1;

    Sequence(const Ctx *c, i32 own, i64 ep, i64 sn, PersistedLog *p, i32 my)
        : ctx(c), owner(own), seq_no(sn), epoch(ep), my_id(my), persisted(p) {}

    i32 key_of(i32 d) const { return d < 0 ? 0 : d; }

    Actions advance_state() {
        Actions actions;
        while (true) {
            SeqState old_state = state;
            if (state == SeqState::PENDING_REQUESTS) {
                if (!(has_outstanding_set && !outstanding_reqs.empty()))
                    state = SeqState::READY;
            } else if (state == SeqState::READY) {
                if (digest != -1 || batch.empty()) concat(actions, prepare_());
            } else if (state == SeqState::PREPREPARED) {
                concat(actions, check_prepare_quorum());
            } else if (state == SeqState::PREPARED) {
                check_commit_quorum();
            }
            if (state == old_state) return actions;
        }
    }

    Actions allocate_as_owner(vector<CRP> crs) {
        client_requests = std::move(crs);
        vector<AckS> acks;
        for (const auto &cr : client_requests) acks.push_back(cr->ack);
        return allocate(std::move(acks), nullptr);
    }

    Actions allocate(vector<AckS> request_acks,
                     std::unordered_set<AckS, AckHash> *outstanding) {
        if (state != SeqState::UNINITIALIZED)
            throw EngineError("sequence must be uninitialized to allocate");
        state = SeqState::ALLOCATED;
        batch = std::move(request_acks);
        if (outstanding) {
            outstanding_reqs = std::move(*outstanding);
            has_outstanding_set = true;
        } else {
            has_outstanding_set = false;
        }
        if (batch.empty()) {
            state = SeqState::READY;
            return apply_batch_hash_result(-1);
        }
        vector<string> parts;
        for (const auto &a : batch) parts.push_back(ctx->intern.get(a.dig));
        HashOriginS origin;
        origin.t = OT::Batch;
        origin.source = owner;
        origin.epoch = epoch;
        origin.seq = seq_no;
        origin.request_acks = batch;
        Actions actions;
        actions.push_back(act_hash(std::move(parts), std::move(origin)));
        state = SeqState::PENDING_REQUESTS;
        concat(actions, advance_state());
        return actions;
    }

    Actions satisfy_outstanding(const AckS &ack) {
        auto it = outstanding_reqs.find(ack);
        if (!has_outstanding_set || it == outstanding_reqs.end())
            throw EngineError("told request was ready but we weren't waiting");
        outstanding_reqs.erase(it);
        return advance_state();
    }

    Actions apply_batch_hash_result(i32 dig) {
        digest = dig;
        return apply_prepare_msg(owner, dig);
    }

    Actions prepare_() {
        auto q = std::make_shared<QEntryS>();
        q->seq = seq_no;
        q->dig = key_of(digest);
        q->reqs = batch;
        q_entry = q;
        state = SeqState::PREPREPARED;

        Actions actions = persisted->append(pe_q(q_entry));

        if (owner == my_id) {
            for (const auto &cr : client_requests) {
                const Mask &agreements = cr->agreements;
                vector<i32> missing;
                for (i32 node : ctx->cfg.nodes)
                    if (!agreements.test(node)) missing.push_back(node);
                if (!missing.empty())
                    actions.push_back(act_forward(std::move(missing), cr->ack));
            }
            actions.push_back(
                act_send(ctx->bcast, mk_preprepare(seq_no, epoch, batch)));
        } else {
            actions.push_back(act_send(
                ctx->bcast, mk_prepare(seq_no, epoch, key_of(digest))));
        }
        return actions;
    }

    // apply_prepare_msg (sequence.py:255-291); dig -1 = None.
    Actions apply_prepare_msg(i32 source, i32 dig) {
        if (prep_mask.test(source) || commit_mask.test(source))
            return Actions();  // duplicate
        prep_mask.set(source);
        if (source == my_id) my_prepare_digest = dig;
        i32 key = key_of(dig);
        i64 *cnt = prepares.get(key);
        i64 count = cnt ? *cnt + 1 : 1;
        prepares.put(key, count);
        SeqState s = state;
        if (s == SeqState::PREPREPARED) {
            if (count >= ctx->iq) return advance_state();
            return Actions();
        }
        if (s == SeqState::READY || s == SeqState::PENDING_REQUESTS)
            return advance_state();
        return Actions();
    }

    Actions check_prepare_quorum() {
        i32 my_key = key_of(digest);
        const i64 *cntp = prepares.get(my_key);
        i64 agreements = cntp ? *cntp : 0;
        if (!prep_mask.test(my_id) && !commit_mask.test(my_id))
            return Actions();
        i32 my_digest = key_of(my_prepare_digest);
        if (my_digest != my_key) return Actions();
        if (agreements < ctx->iq) return Actions();

        state = SeqState::PREPARED;
        Actions actions = persisted->append(pe_p(seq_no, my_key));
        actions.push_back(
            act_send(ctx->bcast, mk_commit(seq_no, epoch, my_key)));
        return actions;
    }

    void apply_commit_msg(i32 source, i32 dig) {
        if (commit_mask.test(source)) return;  // duplicate
        commit_mask.set(source);
        i32 key = key_of(dig);
        i64 *cnt = commits.get(key);
        i64 count = cnt ? *cnt + 1 : 1;
        commits.put(key, count);
        if (state == SeqState::PREPARED && count >= ctx->iq)
            check_commit_quorum();
    }

    void check_commit_quorum() {
        i32 my_key = key_of(digest);
        const i64 *cntp = commits.get(my_key);
        i64 agreements = cntp ? *cntp : 0;
        if (!commit_mask.test(my_id)) return;
        if (agreements < ctx->iq) return;
        state = SeqState::COMMITTED;
    }
};
using SeqP = shared_ptr<Sequence>;

// ---------------------------------------------------------------------------
// Outstanding-request bookkeeping (statemachine/outstanding.py).
// ---------------------------------------------------------------------------

struct ClientOutstandingReqs {
    i64 next_req_no;
    i64 num_buckets;
    ClientStateS client;

    void skip_previously_committed() {
        while (is_committed(next_req_no, client)) next_req_no += num_buckets;
    }
};

struct AllOutstandingReqs {
    shared_ptr<AppendList<AckS>> available_iterator;
    std::unordered_set<AckS, AckHash> correct_requests;
    std::unordered_map<AckS, SeqP, AckHash> outstanding_requests;
    std::map<i64, std::map<i64, ClientOutstandingReqs>> buckets;

    AllOutstandingReqs(shared_ptr<AppendList<AckS>> available_list,
                       const NetStateS &network_state) {
        available_list->reset_iterator();
        available_iterator = std::move(available_list);
        i64 num_buckets = network_state.config->nb;
        for (i64 bucket = 0; bucket < num_buckets; bucket++) {
            auto &clients = buckets[bucket];
            for (const auto &client : network_state.clients) {
                i64 lw = client.lw;
                i64 first_uncommitted =
                    lw + ((((bucket - client.id - lw) % num_buckets) +
                           num_buckets) %
                          num_buckets);
                ClientOutstandingReqs cors{first_uncommitted, num_buckets,
                                           client};
                cors.skip_previously_committed();
                clients.emplace(client.id, cors);
            }
        }
        advance_requests();  // no sequences allocated yet -> no actions
    }

    Actions advance_requests() {
        Actions actions;
        while (available_iterator->has_next()) {
            AckS ack = available_iterator->next();
            auto it = outstanding_requests.find(ack);
            if (it != outstanding_requests.end()) {
                SeqP seq = it->second;
                outstanding_requests.erase(it);
                concat(actions, seq->satisfy_outstanding(ack));
                continue;
            }
            correct_requests.insert(ack);
        }
        return actions;
    }

    Actions apply_acks(i64 bucket, const SeqP &seq, vector<AckS> batch) {
        auto bit = buckets.find(bucket);
        if (bit == buckets.end()) throw EngineError("no such bucket");
        auto &clients = bit->second;

        std::unordered_set<AckS, AckHash> outstanding;
        for (const auto &req : batch) {
            auto cit = clients.find(req.client);
            if (cit == clients.end())
                throw EngineError("fastengine: batch references unknown client");
            ClientOutstandingReqs &co = cit->second;
            if (co.next_req_no != req.reqno)
                throw EngineError("fastengine: out-of-order batch req_no");
            auto crit = correct_requests.find(req);
            if (crit != correct_requests.end()) {
                correct_requests.erase(crit);
            } else {
                outstanding_requests.emplace(req, seq);
                outstanding.insert(req);
            }
            co.next_req_no += co.num_buckets;
            co.skip_previously_committed();
        }
        return seq->allocate(std::move(batch), &outstanding);
    }
};

// ---------------------------------------------------------------------------
// Active epoch (statemachine/epoch_active.py).
// ---------------------------------------------------------------------------

std::map<i64, i32> assign_buckets(const EpochCfgS &epoch_config,
                                  const NetConfigS &cfg) {
    std::set<i32> leaders(epoch_config.leaders.begin(),
                          epoch_config.leaders.end());
    std::map<i64, i32> buckets;
    i64 overflow_index = 0;
    const auto &nodes = cfg.nodes;
    for (i64 i = 0; i < cfg.nb; i++) {
        i32 natural = nodes[(size_t)((i + epoch_config.number) % (i64)nodes.size())];
        if (leaders.count(natural)) {
            buckets[i] = natural;
        } else {
            buckets[i] = epoch_config.leaders[(size_t)(
                overflow_index % (i64)epoch_config.leaders.size())];
            overflow_index += 1;
        }
    }
    return buckets;
}

struct PreprepareBuffer {
    i64 next_seq_no;
    MsgBuffer buffer;
};

struct ActiveEpoch {
    const Ctx *ctx;
    EpochCfgS epoch_config;
    InitParms my_config;
    shared_ptr<AllOutstandingReqs> outstanding_reqs;
    shared_ptr<Proposer> proposer;
    PersistedLog *persisted;
    CommitState *commit_state;
    std::map<i64, i32> buckets;
    deque<vector<SeqP>> sequences;
    vector<PreprepareBuffer> preprepare_buffers;
    std::map<i32, MsgBuffer> other_buffers;
    vector<i64> lowest_unallocated;
    i64 lowest_uncommitted;
    i64 last_committed_at_tick = 0;
    i64 ticks_since_progress = 0;
    i64 buffered = 0;  // shared live count across this epoch's buffers
    i64 nb, ci;
    vector<i64> owned_buckets;

    ActiveEpoch(const Ctx *c, const EpochCfgS &ecfg, PersistedLog *p,
                NodeBuffers *node_buffers, CommitState *cs,
                ClientTracker *client_tracker, InitParms mc)
        : ctx(c), epoch_config(ecfg), my_config(mc), persisted(p),
          commit_state(cs) {
        i64 starting_seq_no = cs->highest_commit;
        const NetConfigS &net_cfg = *cs->active_state->config;
        outstanding_reqs = std::make_shared<AllOutstandingReqs>(
            client_tracker->available_list, *cs->active_state);
        buckets = assign_buckets(ecfg, net_cfg);
        nb = (i64)buckets.size();
        ci = net_cfg.ci;
        for (i64 b = 0; b < nb; b++)
            if (buckets[b] == mc.id) owned_buckets.push_back(b);
        lowest_unallocated.assign((size_t)nb, 0);
        for (i64 i = 0; i < nb; i++) {
            i64 first_seq_no = starting_seq_no + i + 1;
            lowest_unallocated[(size_t)(first_seq_no % nb)] = first_seq_no;
        }
        lowest_uncommitted = cs->highest_commit + 1;
        proposer = std::make_shared<Proposer>(
            c, starting_seq_no, mc, client_tracker->ready_list, buckets);
        for (i64 i = 0; i < nb; i++) {
            PreprepareBuffer pb;
            pb.next_seq_no = lowest_unallocated[(size_t)i];
            pb.buffer.nb = node_buffers->node_buffer(buckets[i]);
            pb.buffer.wire = &c->wire;
            pb.buffer.group = &buffered;
            preprepare_buffers.push_back(std::move(pb));
        }
        for (i32 node : c->cfg.nodes) {
            MsgBuffer mb;
            mb.nb = node_buffers->node_buffer(node);
            mb.wire = &c->wire;
            mb.group = &buffered;
            other_buffers.emplace(node, std::move(mb));
        }
    }

    i64 seq_to_bucket(i64 seq_no) const { return seq_no % nb; }
    i64 low_watermark() const { return sequences.front()[0]->seq_no; }
    i64 high_watermark() const {
        if (sequences.empty()) return commit_state->low_watermark;
        return sequences.back().back()->seq_no;
    }
    bool in_watermarks(i64 seq_no) const {
        return !sequences.empty() && low_watermark() <= seq_no &&
               seq_no <= high_watermark();
    }

    SeqP sequence(i64 seq_no) {
        i64 index = (seq_no - low_watermark()) / ci;
        i64 offset = (seq_no - low_watermark()) % ci;
        SeqP seq = sequences[(size_t)index][(size_t)offset];
        if (seq->seq_no != seq_no)
            throw EngineError("sequence retrieved had unexpected seq_no");
        return seq;
    }

    Applyable filter(i32 source, const MsgS &msg) {
        if (msg.t == MT::Preprepare) {
            i64 seq_no = msg.seq;
            i64 bucket = seq_to_bucket(seq_no);
            if (buckets[bucket] != source) return Applyable::INVALID;
            if (seq_no > epoch_config.planned_expiration)
                return Applyable::INVALID;
            if (seq_no > high_watermark()) return Applyable::FUTURE;
            if (seq_no < low_watermark()) return Applyable::PAST;
            i64 next_preprepare = preprepare_buffers[(size_t)bucket].next_seq_no;
            if (seq_no < next_preprepare) return Applyable::PAST;
            if (seq_no > next_preprepare) return Applyable::FUTURE;
            return Applyable::CURRENT;
        }
        if (msg.t == MT::Prepare) {
            i64 seq_no = msg.seq;
            i64 bucket = seq_to_bucket(seq_no);
            if (buckets[bucket] == source) return Applyable::INVALID;
            if (seq_no > epoch_config.planned_expiration)
                return Applyable::INVALID;
            if (seq_no < low_watermark()) return Applyable::PAST;
            if (seq_no > high_watermark()) return Applyable::FUTURE;
            return Applyable::CURRENT;
        }
        if (msg.t == MT::Commit) {
            i64 seq_no = msg.seq;
            if (seq_no > epoch_config.planned_expiration)
                return Applyable::INVALID;
            if (seq_no < low_watermark()) return Applyable::PAST;
            if (seq_no > high_watermark()) return Applyable::FUTURE;
            return Applyable::CURRENT;
        }
        throw EngineError("unexpected msg type in active epoch filter");
    }

    Actions apply(i32 source, const MsgP &msg) {
        Actions actions;
        if (msg->t == MT::Preprepare) {
            i64 bucket = seq_to_bucket(msg->seq);
            PreprepareBuffer &buffer = preprepare_buffers[(size_t)bucket];
            MsgP next_msg = msg;
            while (next_msg) {
                concat(actions, apply_preprepare_msg(source, next_msg->seq,
                                                     next_msg->acks));
                buffer.next_seq_no += nb;
                next_msg = buffer.buffer.next([this, source](const MsgS &m) {
                    return filter(source, m);
                });
            }
        } else if (msg->t == MT::Prepare) {
            concat(actions,
                   sequence(msg->seq)->apply_prepare_msg(source, msg->dig));
        } else if (msg->t == MT::Commit) {
            concat(actions, apply_commit_msg(source, msg->seq, msg->dig));
        } else {
            throw EngineError("unexpected msg type in active epoch apply");
        }
        return actions;
    }

    Actions step(i32 source, const MsgP &msg) {
        if (msg->t == MT::Prepare) return step_prepare(source, msg);
        if (msg->t == MT::Commit) return step_commit(source, msg);
        Applyable verdict = filter(source, *msg);
        if (verdict == Applyable::CURRENT) return apply(source, msg);
        if (verdict == Applyable::FUTURE) {
            if (msg->t == MT::Preprepare) {
                i64 bucket = seq_to_bucket(msg->seq);
                preprepare_buffers[(size_t)bucket].buffer.store(msg);
            } else {
                other_buffers.at(source).store(msg);
            }
        }
        return Actions();
    }

    Actions step_prepare(i32 source, const MsgP &msg) {
        i64 seq_no = msg->seq;
        if (buckets[seq_no % nb] == source) return Actions();  // INVALID
        if (seq_no > epoch_config.planned_expiration) return Actions();
        i64 low = sequences.front()[0]->seq_no;
        if (seq_no < low) return Actions();  // PAST
        if (seq_no > sequences.back().back()->seq_no) {
            other_buffers.at(source).store(msg);  // FUTURE
            return Actions();
        }
        i64 offset = seq_no - low;
        SeqP seq = sequences[(size_t)(offset / ci)][(size_t)(offset % ci)];
        return seq->apply_prepare_msg(source, msg->dig);
    }

    Actions step_commit(i32 source, const MsgP &msg) {
        i64 seq_no = msg->seq;
        if (seq_no > epoch_config.planned_expiration) return Actions();
        i64 low = sequences.front()[0]->seq_no;
        if (seq_no < low) return Actions();  // PAST
        i64 high = sequences.back().back()->seq_no;
        if (seq_no > high) {
            other_buffers.at(source).store(msg);  // FUTURE
            return Actions();
        }
        i64 offset = seq_no - low;
        SeqP seq = sequences[(size_t)(offset / ci)][(size_t)(offset % ci)];
        seq->apply_commit_msg(source, msg->dig);
        if (seq->state != SeqState::COMMITTED || seq_no != lowest_uncommitted)
            return Actions();
        commit_cascade();
        return Actions();
    }

    // Envelope vote application — replicates the Python native-plane path
    // (voteplane.py + ackplane.cpp seq_apply_core + machine.py MsgBatch arm):
    // Phase A applies every vote's mask/count update in envelope order,
    // recording fallbacks (wrong epoch / future) and transition hints;
    // Phase B runs the records in order, re-validating each quorum.
    template <typename StepFn>
    Actions apply_envelope_votes(const vector<MsgP> &votes, i32 source,
                                 StepFn &&generic_step) {
        struct Rec {
            bool fallback;
            size_t idx;
            int kind;
            i64 seq;
        };
        vector<Rec> records;
        for (size_t k = 0; k < votes.size(); k++) {
            const MsgS &m = *votes[k];
            if (m.t != MT::Prepare && m.t != MT::Commit) continue;  // rest
            int kind = m.t == MT::Prepare ? 0 : 1;
            if (m.epoch != epoch_config.number) {
                records.push_back({true, k, 0, 0});
                continue;
            }
            i64 seq_no = m.seq;
            i64 low = sequences.front()[0]->seq_no;
            if (seq_no < low) continue;  // PAST
            if (kind == 0 && nb > 0 && buckets[seq_no % nb] == source)
                continue;  // INVALID: owners never send Prepare
            if (seq_no > epoch_config.planned_expiration) continue;  // INVALID
            if (seq_no > sequences.back().back()->seq_no) {
                records.push_back({true, k, 0, 0});  // FUTURE
                continue;
            }
            i64 offset = seq_no - low;
            Sequence &s =
                *sequences[(size_t)(offset / ci)][(size_t)(offset % ci)];
            i32 key = s.key_of(m.dig);
            i32 expected = s.key_of(s.digest);
            bool matches = key == expected;
            bool hint = false;
            if (kind == 0) {
                if (s.prep_mask.test(source) || s.commit_mask.test(source))
                    continue;  // dup
                s.prep_mask.set(source);
                if (source == s.my_id) s.my_prepare_digest = m.dig;
                i64 *cnt = s.prepares.get(key);
                i64 n = cnt ? *cnt + 1 : 1;
                s.prepares.put(key, n);
                if (s.state == SeqState::PREPREPARED) {
                    if (matches && n >= ctx->iq) hint = true;
                } else if (s.state == SeqState::READY ||
                           s.state == SeqState::PENDING_REQUESTS) {
                    hint = true;
                }
            } else {
                if (s.commit_mask.test(source)) continue;  // dup
                s.commit_mask.set(source);
                i64 *cnt = s.commits.get(key);
                i64 n = cnt ? *cnt + 1 : 1;
                s.commits.put(key, n);
                if (s.state == SeqState::PREPARED && matches && n >= ctx->iq)
                    hint = true;
            }
            if (hint) records.push_back({false, k, kind, seq_no});
        }
        Actions actions;
        for (const Rec &rec : records) {
            if (rec.fallback) {
                concat(actions, generic_step(source, votes[rec.idx]));
                continue;
            }
            SeqP seq = sequence(rec.seq);
            if (rec.kind == 0) {
                SeqState s = seq->state;
                if (s == SeqState::PREPREPARED || s == SeqState::READY ||
                    s == SeqState::PENDING_REQUESTS)
                    concat(actions, seq->advance_state());
            } else {
                seq->check_commit_quorum();
            }
            if (seq->state == SeqState::COMMITTED &&
                seq->seq_no == lowest_uncommitted)
                commit_cascade();
        }
        return actions;
    }

    void commit_cascade() {
        i64 low = sequences.front()[0]->seq_no;
        i64 high = sequences.back().back()->seq_no;
        i64 lowest = lowest_uncommitted;
        while (lowest <= high) {
            i64 offset = lowest - low;
            SeqP seq = sequences[(size_t)(offset / ci)][(size_t)(offset % ci)];
            if (seq->state != SeqState::COMMITTED) break;
            commit_state->commit(seq->q_entry);
            lowest += 1;
        }
        lowest_uncommitted = lowest;
    }

    Actions apply_preprepare_msg(i32 source, i64 seq_no, vector<AckS> batch) {
        SeqP seq = sequence(seq_no);
        if (seq->owner == my_config.id)
            return seq->apply_prepare_msg(source, seq->digest);
        i64 bucket = seq_to_bucket(seq_no);
        if (seq_no != lowest_unallocated[(size_t)bucket])
            throw EngineError("step should defer all but the next expected preprepare");
        lowest_unallocated[(size_t)bucket] += nb;
        return outstanding_reqs->apply_acks(bucket, seq, std::move(batch));
    }

    Actions apply_commit_msg(i32 source, i64 seq_no, i32 dig) {
        SeqP seq = sequence(seq_no);
        seq->apply_commit_msg(source, dig);
        if (seq->state != SeqState::COMMITTED || seq_no != lowest_uncommitted)
            return Actions();
        commit_cascade();
        return Actions();
    }

    Actions apply_batch_hash_result(i64 seq_no, i32 digest) {
        if (!in_watermarks(seq_no)) return Actions();
        return sequence(seq_no)->apply_batch_hash_result(digest);
    }

    // move_low_watermark -> (actions, epoch_done)
    std::pair<Actions, bool> move_low_watermark(i64 seq_no) {
        if (seq_no == epoch_config.planned_expiration)
            return {Actions(), true};
        if (seq_no == commit_state->stop_at_seq_no) return {Actions(), true};
        Actions actions = advance();
        while (seq_no > low_watermark()) sequences.pop_front();
        return {std::move(actions), false};
    }

    Actions drain_buffers() {
        Actions actions;
        if (!buffered) return actions;
        for (i64 bucket = 0; bucket < nb; bucket++) {
            PreprepareBuffer &buffer = preprepare_buffers[(size_t)bucket];
            if (buffer.buffer.empty()) continue;
            i32 source = buckets[bucket];
            MsgP next_msg = buffer.buffer.next(
                [this, source](const MsgS &m) { return filter(source, m); });
            if (!next_msg) continue;
            concat(actions, apply(source, next_msg));
        }
        for (i32 node : ctx->cfg.nodes) {
            MsgBuffer &other = other_buffers.at(node);
            if (other.empty()) continue;
            other.iterate(
                [this, node](const MsgS &m) { return filter(node, m); },
                [this, node, &actions](MsgP m) {
                    concat(actions, apply(node, m));
                });
        }
        return actions;
    }

    bool needs_advance() {
        i64 hw = high_watermark();
        if (hw < epoch_config.planned_expiration &&
            hw < commit_state->stop_at_seq_no)
            return true;
        if (buffered) return true;
        if (proposer->ready_iterator->has_next()) return true;
        for (i64 bucket : owned_buckets) {
            i64 seq_no = lowest_unallocated[(size_t)bucket];
            if (seq_no <= hw &&
                proposer->proposal_bucket(bucket)->has_pending(seq_no))
                return true;
        }
        return false;
    }

    Actions advance() {
        Actions actions;
        if (high_watermark() > epoch_config.planned_expiration)
            throw EngineError("window extends beyond planned expiration");
        if (high_watermark() > commit_state->stop_at_seq_no)
            throw EngineError("window extends beyond the stop sequence");

        while (high_watermark() < epoch_config.planned_expiration &&
               high_watermark() < commit_state->stop_at_seq_no) {
            i64 base = high_watermark() + 1;
            concat(actions, persisted->append(pe_n(base, epoch_config)));
            vector<SeqP> chunk;
            for (i64 i = 0; i < ci; i++) {
                chunk.push_back(std::make_shared<Sequence>(
                    ctx, buckets[seq_to_bucket(base + i)],
                    epoch_config.number, base + i, persisted, my_config.id));
            }
            sequences.push_back(std::move(chunk));
        }

        concat(actions, drain_buffers());
        proposer->advance(lowest_uncommitted);

        for (i64 bucket : owned_buckets) {
            ProposalBucket *prb = proposer->proposal_bucket(bucket);
            while (true) {
                i64 seq_no = lowest_unallocated[(size_t)bucket];
                if (seq_no > high_watermark()) break;
                if (!prb->has_pending(seq_no)) break;
                SeqP seq = sequence(seq_no);
                concat(actions, seq->allocate_as_owner(prb->next()));
                lowest_unallocated[(size_t)bucket] += nb;
            }
        }
        return actions;
    }

    Actions tick() {
        if (last_committed_at_tick < commit_state->highest_commit) {
            last_committed_at_tick = commit_state->highest_commit;
            ticks_since_progress = 0;
            return Actions();
        }
        ticks_since_progress += 1;
        Actions actions;

        if (ticks_since_progress > my_config.suspect_ticks) {
            actions.push_back(act_send(ctx->bcast,
                                       mk_suspect(epoch_config.number)));
            concat(actions, persisted->append(pe_suspect(epoch_config.number)));
        }
        if (my_config.heartbeat_ticks == 0 ||
            ticks_since_progress % my_config.heartbeat_ticks != 0)
            return actions;

        for (i64 bucket : owned_buckets) {
            i64 unallocated_seq_no = lowest_unallocated[(size_t)bucket];
            if (unallocated_seq_no > high_watermark()) continue;
            SeqP seq = sequence(unallocated_seq_no);
            ProposalBucket *prb = proposer->proposal_bucket(bucket);
            vector<CRP> client_reqs;
            if (prb->has_outstanding(unallocated_seq_no))
                client_reqs = prb->next();
            concat(actions, seq->allocate_as_owner(std::move(client_reqs)));
            lowest_unallocated[(size_t)bucket] += nb;
        }
        return actions;
    }
};

// ---------------------------------------------------------------------------
// Epoch-change parsing and ack accumulation (statemachine/epoch_change.py).
// ---------------------------------------------------------------------------

struct ParsedEC {
    EpochChangeP underlying;
    i64 low_watermark = 0;
    std::map<i64, ECSetEntryS> p_set;              // seq -> entry
    std::map<i64, std::map<i64, i32>> q_set;       // seq -> epoch -> digest
    std::set<i32> acks;
};
using ParsedECP = shared_ptr<ParsedEC>;

// try_parse (raising variant returns nullptr on malformed content).
ParsedECP try_parse_epoch_change(const EpochChangeP &underlying) {
    if (underlying->checkpoints.empty()) return nullptr;
    auto out = std::make_shared<ParsedEC>();
    out->underlying = underlying;
    out->low_watermark = underlying->checkpoints[0].first;
    std::set<i64> seen_cp;
    for (const auto &cp : underlying->checkpoints) {
        out->low_watermark = std::min(out->low_watermark, cp.first);
        if (seen_cp.count(cp.first)) return nullptr;
        seen_cp.insert(cp.first);
    }
    for (const auto &e : underlying->p_set) {
        if (out->p_set.count(e.seq)) return nullptr;
        out->p_set.emplace(e.seq, e);
    }
    for (const auto &e : underlying->q_set) {
        auto &views = out->q_set[e.seq];
        if (views.count(e.epoch)) return nullptr;
        views.emplace(e.epoch, e.dig);
    }
    return out;
}

struct EpochChangeVotes {
    // (digest, parsed) insertion-ordered.
    vector<std::pair<i32, ParsedECP>> parsed_by_digest;
    i32 strong_cert = -1;

    ParsedECP get(i32 digest) const {
        for (const auto &pr : parsed_by_digest)
            if (pr.first == digest) return pr.second;
        return nullptr;
    }

    void add_ack(i32 source, const EpochChangeP &msg, i32 digest, i64 iq) {
        ParsedECP parsed = get(digest);
        if (!parsed) {
            parsed = try_parse_epoch_change(msg);
            if (!parsed) return;  // malformed; drop
            parsed_by_digest.emplace_back(digest, parsed);
        }
        parsed->acks.insert(source);
        if (strong_cert == -1 && (i64)parsed->acks.size() >= iq)
            strong_cert = digest;
    }
};

// construct_new_epoch_config (statemachine/stateless.py:164-315).
NewEpochCfgP construct_new_epoch_config(
    const Ctx *ctx, const NetConfigS &config, const vector<i32> &new_leaders,
    const std::map<i32, ParsedECP> &epoch_changes) {
    // (seq, value) -> supporters, insertion-ordered.
    vector<std::pair<std::pair<i64, i32>, vector<i32>>> checkpoint_supporters;
    i64 new_epoch_number = 0;
    for (i32 node : config.nodes) {
        auto it = epoch_changes.find(node);
        if (it == epoch_changes.end()) continue;
        const ParsedEC &ec = *it->second;
        new_epoch_number = ec.underlying->new_epoch;
        std::set<std::pair<i64, i32>> seen;
        for (const auto &cp : ec.underlying->checkpoints) {
            std::pair<i64, i32> key(cp.first, cp.second);
            if (seen.count(key)) continue;
            seen.insert(key);
            bool found = false;
            for (auto &pr : checkpoint_supporters)
                if (pr.first == key) {
                    pr.second.push_back(node);
                    found = true;
                    break;
                }
            if (!found)
                checkpoint_supporters.emplace_back(key, vector<i32>{node});
        }
    }

    bool have_max = false;
    std::pair<i64, i32> max_checkpoint{0, 0};
    for (const auto &pr : checkpoint_supporters) {
        if ((i64)pr.second.size() < ctx->wq) continue;
        i64 lower_watermarks = 0;
        for (const auto &ec : epoch_changes)
            if (ec.second->low_watermark <= pr.first.first) lower_watermarks++;
        if (lower_watermarks < ctx->iq) continue;
        if (!have_max) {
            max_checkpoint = pr.first;
            have_max = true;
            continue;
        }
        if (max_checkpoint.first > pr.first.first) continue;
        if (max_checkpoint.first == pr.first.first)
            throw EngineError("two correct quorums disagree on checkpoint value");
        max_checkpoint = pr.first;
    }
    if (!have_max) return nullptr;

    i64 cp_seq = max_checkpoint.first;
    i32 cp_value = max_checkpoint.second;
    i64 window = 2 * config.ci;
    vector<i32> final_preprepares((size_t)window, 0);
    bool any_selected = false;

    vector<vector<const ECSetEntryS *>> candidates((size_t)window);
    vector<i64> entry_counts((size_t)window, 0);
    for (i32 node : config.nodes) {
        auto it = epoch_changes.find(node);
        if (it == epoch_changes.end()) continue;
        const ParsedEC &node_ec = *it->second;
        i64 lw = node_ec.low_watermark;
        for (const auto &pr : node_ec.p_set) {
            i64 p_off = pr.first - cp_seq - 1;
            if (0 <= p_off && p_off < window) {
                candidates[(size_t)p_off].push_back(&pr.second);
                if (lw < pr.first) entry_counts[(size_t)p_off]++;
            }
        }
    }
    vector<i64> sorted_lws;
    for (const auto &ec : epoch_changes)
        sorted_lws.push_back(ec.second->low_watermark);
    std::sort(sorted_lws.begin(), sorted_lws.end());

    for (i64 offset = 0; offset < window; offset++) {
        i64 seq_no = cp_seq + 1 + offset;
        const ECSetEntryS *selected = nullptr;
        for (const ECSetEntryS *entry : candidates[(size_t)offset]) {
            i64 a1 = 0;
            for (const auto &opr : epoch_changes) {
                const ParsedEC &other = *opr.second;
                if (other.low_watermark >= seq_no) continue;
                auto oit = other.p_set.find(seq_no);
                if (oit == other.p_set.end() ||
                    oit->second.epoch < entry->epoch) {
                    a1++;
                    continue;
                }
                if (oit->second.epoch > entry->epoch) continue;
                if (oit->second.dig == entry->dig) a1++;
            }
            if (a1 < ctx->iq) continue;
            i64 a2 = 0;
            for (const auto &opr : epoch_changes) {
                const ParsedEC &other = *opr.second;
                auto qit = other.q_set.find(seq_no);
                if (qit == other.q_set.end() || qit->second.empty()) continue;
                for (const auto &ed : qit->second) {
                    if (ed.first >= entry->epoch && ed.second == entry->dig) {
                        a2++;
                        break;
                    }
                }
            }
            if (a2 < ctx->wq) continue;
            selected = entry;
            break;
        }
        if (selected) {
            final_preprepares[(size_t)offset] = selected->dig;
            any_selected = true;
            continue;
        }
        i64 b_count =
            (i64)(std::lower_bound(sorted_lws.begin(), sorted_lws.end(),
                                   seq_no) -
                  sorted_lws.begin()) -
            entry_counts[(size_t)offset];
        if (b_count < ctx->iq) return nullptr;
    }

    auto out = std::make_shared<NewEpochCfgS>();
    out->config.number = new_epoch_number;
    out->config.leaders = new_leaders;
    out->config.planned_expiration = cp_seq + config.mel;
    out->cp_seq = cp_seq;
    out->cp_value = cp_value;
    if (any_selected) out->final_preprepares = std::move(final_preprepares);
    return out;
}

// ---------------------------------------------------------------------------
// Epoch target: the 11-state lifecycle machine (statemachine/epoch_target.py).
// ---------------------------------------------------------------------------

struct ETS {
    enum V {
        PREPENDING = 0, PENDING = 1, VERIFYING = 2, FETCHING = 3,
        ECHOING = 4, READYING = 5, RESUMING = 6, READY = 7,
        IN_PROGRESS = 8, ENDING = 9, DONE = 10,
    };
};

struct EpochTarget {
    const Ctx *ctx;
    int state = ETS::PREPENDING;
    CommitState *commit_state;
    i64 state_ticks = 0;
    i64 number;
    i64 starting_seq_no = 0;
    std::map<i32, EpochChangeVotes> changes;
    std::map<i32, ParsedECP> strong_changes;
    vector<std::pair<NewEpochCfgP, std::set<i32>>> echos, readies;
    shared_ptr<ActiveEpoch> active_epoch;
    std::set<i32> suspicions;
    MsgP my_new_epoch;              // NewEpoch message (nullptr = None)
    ParsedECP my_epoch_change;
    vector<i32> my_leader_choice;
    bool have_leader_choice = false;
    MsgP leader_new_epoch;          // NewEpoch message
    NewEpochCfgP network_new_epoch;
    // Crash-recovery resume (no Bracha broadcast ran): the epoch config
    // from the last NEntry, used to rebuild the active epoch at READY
    // (epoch_target.py resume_epoch_config).
    EpochCfgS resume_epoch_config{};
    bool have_resume_config = false;
    bool is_primary;
    std::map<i32, MsgBuffer> prestart_buffers;
    PersistedLog *persisted;
    NodeBuffers *node_buffers;
    ClientTracker *client_tracker;
    Disseminator *client_hash_disseminator;
    BatchTracker *batch_tracker;
    NetCfgP network_config;  // the active consensused config at creation
    InitParms my_config;
    // digest state per EC content: (digest | -1 pending | -2 fresh,
    // waiting (source, origin) pairs).  The content-keyed map is the
    // source of truth; the pointer cache avoids hashing the multi-KB
    // content key per ack (EC objects are shared across every receiver of
    // a broadcast; unordered_map values are node-stable under rehash).
    std::unordered_map<string, std::pair<i32, vector<std::pair<i32, i32>>>>
        ec_digests;
    std::unordered_map<const void *,
                       std::pair<i32, vector<std::pair<i32, i32>>> *>
        ec_entry_by_ptr;

    std::pair<i32, vector<std::pair<i32, i32>>> &ec_entry(
        const EpochChangeP &ec) {
        auto pit = ec_entry_by_ptr.find((const void *)ec.get());
        if (pit != ec_entry_by_ptr.end()) return *pit->second;
        ec_fill_hash_cache(ctx->intern, *ec);
        auto [it, inserted] = ec_digests.try_emplace(
            ec->hash_key_cache,
            std::make_pair((i32)-2, vector<std::pair<i32, i32>>()));
        (void)inserted;
        ec_entry_by_ptr.emplace((const void *)ec.get(), &it->second);
        return it->second;
    }

    EpochTarget(const Ctx *c, i64 num, PersistedLog *p, NodeBuffers *nbufs,
                CommitState *cs, ClientTracker *ct, Disseminator *dis,
                BatchTracker *bt, NetCfgP ncfg, InitParms mc)
        : ctx(c), commit_state(cs), number(num), persisted(p),
          node_buffers(nbufs), client_tracker(ct),
          client_hash_disseminator(dis), batch_tracker(bt),
          network_config(std::move(ncfg)), my_config(mc) {
        is_primary = num % (i64)c->cfg.nodes.size() == mc.id;
        for (i32 node : c->cfg.nodes) {
            MsgBuffer mb;
            mb.nb = nbufs->node_buffer(node);
            mb.wire = &c->wire;
            prestart_buffers.emplace(node, std::move(mb));
        }
    }

    Actions step(i32 source, const MsgP &msg) {
        if (state < ETS::IN_PROGRESS) {
            prestart_buffers.at(source).store(msg);
            return Actions();
        }
        if (state == ETS::DONE) return Actions();
        return active_epoch->step(source, msg);
    }

    MsgP construct_new_epoch(const vector<i32> &new_leaders) {
        if ((i64)strong_changes.size() < ctx->iq)
            throw EngineError("need more acked epoch changes");
        NewEpochCfgP new_config = construct_new_epoch_config(
            ctx, *network_config, new_leaders, strong_changes);
        if (!new_config) return nullptr;
        auto m = std::make_shared<MsgS>();
        m->t = MT::NewEpoch;
        m->necfg = new_config;
        for (i32 node : ctx->cfg.nodes) {
            if (!strong_changes.count(node)) continue;
            m->remote_changes.emplace_back(node,
                                           changes.at(node).strong_cert);
        }
        return m;
    }

    void verify_new_epoch_state() {
        std::map<i32, ParsedECP> epoch_changes;
        for (const auto &remote : leader_new_epoch->remote_changes) {
            if (epoch_changes.count(remote.first)) return;  // malformed
            auto vit = changes.find(remote.first);
            if (vit == changes.end()) return;
            ParsedECP parsed = vit->second.get(remote.second);
            if (!parsed || (i64)parsed->acks.size() < ctx->wq) return;
            epoch_changes.emplace(remote.first, parsed);
        }
        NewEpochCfgP reconstructed = construct_new_epoch_config(
            ctx, *network_config, leader_new_epoch->necfg->config.leaders,
            epoch_changes);
        if (!reconstructed || !(*reconstructed == *leader_new_epoch->necfg))
            return;  // byzantine primary
        state = ETS::FETCHING;
    }

    Actions fetch_new_epoch_state() {
        const NewEpochCfgS &nec = *leader_new_epoch->necfg;
        if (commit_state->transferring)
            return Actions();  // wait for state transfer first
        if (nec.cp_seq > commit_state->highest_commit)
            return commit_state->transfer_to(nec.cp_seq, nec.cp_value);

        Actions actions;
        bool fetch_pending = false;
        for (size_t i = 0; i < nec.final_preprepares.size(); i++) {
            i32 digest = nec.final_preprepares[i];
            if (digest == 0) continue;  // null request
            i64 seq_no = (i64)i + nec.cp_seq + 1;
            if (seq_no <= commit_state->highest_commit) continue;

            vector<i32> sources;
            for (const auto &remote : leader_new_epoch->remote_changes) {
                ParsedECP parsed = changes.at(remote.first).get(remote.second);
                auto qit = parsed->q_set.find(seq_no);
                if (qit == parsed->q_set.end()) continue;
                for (const auto &ed : qit->second)
                    if (ed.second == digest) {
                        sources.push_back(remote.first);
                        break;
                    }
            }
            if ((i64)sources.size() < ctx->wq)
                throw EngineError("too few sources for new-epoch batch");

            BatchRec *batch = batch_tracker->get_batch_mut(digest);
            if (!batch) {
                concat(actions,
                       batch_tracker->fetch_batch(seq_no, digest, sources));
                fetch_pending = true;
                continue;
            }
            batch->observed_for.insert(seq_no);
            for (const auto &request_ack : batch->request_acks) {
                CRP cr;
                for (i32 node : sources)
                    cr = client_hash_disseminator->ack(actions, node,
                                                       request_ack, true);
                if (cr->stored) continue;
                fetch_pending = true;
                concat(actions, cr->fetch());
                client_hash_disseminator->note_fetching(request_ack);
            }
        }
        if (fetch_pending) return actions;
        if (nec.cp_seq > commit_state->low_watermark) return actions;

        state = ETS::ECHOING;
        if (nec.cp_seq == commit_state->stop_at_seq_no &&
            !nec.final_preprepares.empty())
            // Provably unreachable among correct nodes (see the proof in
            // epoch_target.py fetch_new_epoch_state / docs/Divergences.md
            // #9): window extension never passes stop_at, so A2 support
            // for a batch past a halted boundary needs f+1 byzantine
            // attestations, and verify_new_epoch_state's reconstruction
            // rejects a fabricated carryover before FETCHING.
            throw EngineError(
                "verified NewEpoch carries batches past a reconfiguration "
                "boundary (impossible for <= f byzantine nodes)");

        concat(actions,
               persisted->append(pe_n(nec.cp_seq + 1, nec.config)));
        for (size_t i = 0; i < nec.final_preprepares.size(); i++) {
            i32 digest = nec.final_preprepares[i];
            i64 seq_no = (i64)i + nec.cp_seq + 1;
            if (digest == 0) {
                auto q = std::make_shared<QEntryS>();
                q->seq = seq_no;
                q->dig = 0;
                concat(actions, persisted->append(pe_q(q)));
                continue;
            }
            const BatchRec *batch = batch_tracker->get_batch(digest);
            if (!batch) {
                if (seq_no <= commit_state->highest_commit)
                    // Already committed (fetch loop skipped it) and
                    // possibly checkpoint-truncated from the tracker;
                    // its QEntry is in the log from the original commit
                    // (mirrors epoch_target.py fetch_new_epoch_state).
                    continue;
                throw EngineError("batch verified above is now missing");
            }
            auto q = std::make_shared<QEntryS>();
            q->seq = seq_no;
            q->dig = digest;
            q->reqs = batch->request_acks;
            concat(actions, persisted->append(pe_q(q)));
            if (seq_no % network_config->ci == 0 &&
                seq_no < commit_state->stop_at_seq_no)
                concat(actions,
                       persisted->append(pe_n(seq_no + 1, nec.config)));
        }
        starting_seq_no = nec.cp_seq + (i64)nec.final_preprepares.size() + 1;

        auto echo = std::make_shared<MsgS>();
        echo->t = MT::NewEpochEcho;
        echo->necfg = leader_new_epoch->necfg;
        actions.push_back(act_send(ctx->bcast, echo));
        return actions;
    }

    Actions repeat_epoch_change_broadcast() {
        auto m = std::make_shared<MsgS>();
        m->t = MT::EpochChange;
        m->ec = my_epoch_change->underlying;
        Actions a;
        a.push_back(act_send(ctx->bcast, m));
        return a;
    }

    Actions tick_prepending() {
        if (!my_new_epoch) {
            i64 half = my_config.new_epoch_timeout_ticks / 2;
            if (half && state_ticks % half == 0 && my_epoch_change)
                return repeat_epoch_change_broadcast();
            return Actions();
        }
        if (is_primary) {
            Actions a;
            a.push_back(act_send(ctx->bcast, my_new_epoch));
            return a;
        }
        return Actions();
    }

    Actions tick_pending() {
        if (!my_new_epoch || !my_epoch_change) return Actions();
        i64 pending_ticks = state_ticks % my_config.new_epoch_timeout_ticks;
        if (is_primary) {
            if (pending_ticks % 2 == 0) {
                Actions a;
                a.push_back(act_send(ctx->bcast, my_new_epoch));
                return a;
            }
        } else {
            if (pending_ticks == 0) {
                Actions a;
                a.push_back(act_send(
                    ctx->bcast,
                    mk_suspect(my_new_epoch->necfg->config.number)));
                concat(a, persisted->append(
                              pe_suspect(my_new_epoch->necfg->config.number)));
                return a;
            }
            if (pending_ticks % 2 == 0) return repeat_epoch_change_broadcast();
        }
        return Actions();
    }

    Actions tick() {
        state_ticks += 1;
        if (state == ETS::PREPENDING) return tick_prepending();
        if (state <= ETS::RESUMING) return tick_pending();
        if (state <= ETS::IN_PROGRESS) return active_epoch->tick();
        return Actions();
    }

    Actions apply_epoch_change_msg(i32 source, const MsgP &msg) {
        Actions actions;
        if (source != my_config.id) {
            auto ack = std::make_shared<MsgS>();
            ack->t = MT::EpochChangeAck;
            ack->originator = source;
            ack->ec = msg->ec;
            actions.push_back(act_send(ctx->bcast, ack));
        }
        concat(actions, apply_epoch_change_ack_msg(source, source, msg->ec));
        return actions;
    }

    Actions apply_epoch_change_ack_msg(i32 source, i32 origin,
                                       const EpochChangeP &ec) {
        auto &entry = ec_entry(ec);
        if (entry.first >= 0)
            return apply_ec_digest(source, origin, ec, entry.first);
        if (entry.first == -1) {  // hash already in flight
            entry.second.emplace_back(source, origin);
            return Actions();
        }
        entry.first = -1;
        HashOriginS ho;
        ho.t = OT::EpochChange;
        ho.source = source;
        ho.origin = origin;
        ho.ec = ec;
        Actions actions;
        // Small ECs stay multi-part so the host-floor classification (and
        // with it the device-plane routing) is unchanged from the
        // pre-cache behavior; only large certs use the single-part cache.
        if (ec->hash_joined_cache.size() < 512)
            actions.push_back(act_hash(ec_hash_data(ctx->intern, *ec),
                                       std::move(ho)));
        else
            actions.push_back(act_hash(vector<string>{ec->hash_joined_cache},
                                       std::move(ho)));
        return actions;
    }

    Actions apply_epoch_change_digest(const HashOriginS &origin, i32 digest) {
        const EpochChangeP &msg = origin.ec;
        auto &entry = ec_entry(msg);
        vector<std::pair<i32, i32>> waiters;
        if (entry.first == -1) waiters = std::move(entry.second);
        entry.first = digest;
        entry.second.clear();
        Actions actions =
            apply_ec_digest(origin.source, origin.origin, msg, digest);
        for (const auto &w : waiters)
            concat(actions, apply_ec_digest(w.first, w.second, msg, digest));
        return actions;
    }

    Actions apply_ec_digest(i32 source_node, i32 origin_node,
                            const EpochChangeP &msg, i32 digest) {
        EpochChangeVotes &votes = changes[origin_node];
        votes.add_ack(source_node, msg, digest, ctx->iq);
        if (votes.strong_cert != -1 && !strong_changes.count(origin_node)) {
            strong_changes.emplace(origin_node, votes.get(votes.strong_cert));
            return advance_state();
        }
        return Actions();
    }

    Actions check_epoch_quorum() {
        if ((i64)strong_changes.size() < ctx->iq || !my_epoch_change)
            return Actions();
        my_new_epoch = construct_new_epoch(my_leader_choice);
        if (!my_new_epoch) return Actions();
        state_ticks = 0;
        state = ETS::PENDING;
        if (is_primary) {
            Actions a;
            a.push_back(act_send(ctx->bcast, my_new_epoch));
            return a;
        }
        return Actions();
    }

    Actions apply_new_epoch_msg(const MsgP &msg) {
        leader_new_epoch = msg;
        return advance_state();
    }

    std::set<i32> *cfg_set(vector<std::pair<NewEpochCfgP, std::set<i32>>> &m,
                           const NewEpochCfgP &config) {
        for (auto &pr : m)
            if (*pr.first == *config) return &pr.second;
        m.emplace_back(config, std::set<i32>());
        return &m.back().second;
    }

    Actions apply_new_epoch_echo_msg(i32 source, const NewEpochCfgP &config) {
        cfg_set(echos, config)->insert(source);
        return advance_state();
    }

    Actions check_new_epoch_echo_quorum() {
        Actions actions;
        for (auto &pr : echos) {
            if ((i64)pr.second.size() < ctx->iq) continue;
            state = ETS::READYING;
            const NewEpochCfgS &config = *pr.first;
            for (size_t i = 0; i < config.final_preprepares.size(); i++) {
                i64 seq_no = (i64)i + config.cp_seq + 1;
                concat(actions,
                       persisted->append(
                           pe_p(seq_no, config.final_preprepares[i])));
            }
            auto ready = std::make_shared<MsgS>();
            ready->t = MT::NewEpochReady;
            ready->necfg = pr.first;
            actions.push_back(act_send(ctx->bcast, ready));
            return actions;
        }
        return actions;
    }

    Actions apply_new_epoch_ready_msg(i32 source, const NewEpochCfgP &config) {
        if (state > ETS::READYING) return Actions();
        std::set<i32> *rs = cfg_set(readies, config);
        rs->insert(source);
        if ((i64)rs->size() < ctx->wq) return Actions();
        if (state < ETS::ECHOING) return advance_state();
        if (state < ETS::READYING) {
            state = ETS::READYING;
            auto ready = std::make_shared<MsgS>();
            ready->t = MT::NewEpochReady;
            ready->necfg = config;
            Actions a;
            a.push_back(act_send(ctx->bcast, ready));
            return a;
        }
        return advance_state();
    }

    void check_new_epoch_ready_quorum() {
        for (auto &pr : readies) {
            if ((i64)pr.second.size() < ctx->iq) continue;
            state = ETS::RESUMING;
            network_new_epoch = pr.first;

            bool current_epoch = false;
            for (const auto &e : persisted->entries) {
                if (e.second->t == PET::Q) {
                    if (current_epoch) commit_state->commit(e.second->q);
                } else if (e.second->t == PET::EC) {
                    if (e.second->num < pr.first->config.number) continue;
                    if (pr.first->config.number < e.second->num)
                        throw EngineError(
                            "epoch change entries cannot exceed the target epoch");
                    current_epoch = true;
                }
            }
        }
    }

    void check_epoch_resumed() {
        if (commit_state->stop_at_seq_no < starting_seq_no) return;
        if (commit_state->low_watermark + 1 != starting_seq_no) return;
        state = ETS::READY;
    }

    template <typename StepFn>
    Actions advance_state_with(StepFn &&generic_step_unused) {
        return advance_state();
    }

    Actions advance_state() {
        if (state == ETS::IN_PROGRESS) {
            ActiveEpoch *ae = active_epoch.get();
            if (!ae->outstanding_reqs->available_iterator->has_next() &&
                !ae->needs_advance())
                return Actions();
        }
        Actions actions;
        while (true) {
            int old_state = state;
            if (state == ETS::PREPENDING) {
                concat(actions, check_epoch_quorum());
            } else if (state == ETS::PENDING) {
                if (!leader_new_epoch) return actions;
                state = ETS::VERIFYING;
            } else if (state == ETS::VERIFYING) {
                verify_new_epoch_state();
            } else if (state == ETS::FETCHING) {
                concat(actions, fetch_new_epoch_state());
            } else if (state == ETS::ECHOING) {
                concat(actions, check_new_epoch_echo_quorum());
            } else if (state == ETS::READYING) {
                check_new_epoch_ready_quorum();
            } else if (state == ETS::RESUMING) {
                check_epoch_resumed();
            } else if (state == ETS::READY) {
                if (!network_new_epoch && !have_resume_config)
                    throw EngineError(
                        "READY with neither a network config nor a resume config");
                const EpochCfgS &epoch_config = network_new_epoch
                                                    ? network_new_epoch->config
                                                    : resume_epoch_config;
                if (commit_state->low_watermark >=
                    epoch_config.planned_expiration) {
                    // The epoch expired while we were down or state
                    // transferring past it: no window left to resume
                    // (activating would assert in advance()).  End it so
                    // the tracker rolls to an epoch change targeting
                    // max_correct_epoch (epoch_target.py READY arm).
                    state = ETS::DONE;
                    continue;
                }
                active_epoch = std::make_shared<ActiveEpoch>(
                    ctx, epoch_config, persisted, node_buffers, commit_state,
                    client_tracker, my_config);
                concat(actions, active_epoch->advance());
                state = ETS::IN_PROGRESS;
                for (i32 node : ctx->cfg.nodes) {
                    prestart_buffers.at(node).iterate(
                        [](const MsgS &) { return Applyable::CURRENT; },
                        [this, node, &actions](MsgP m) {
                            concat(actions, active_epoch->step(node, m));
                        });
                }
                concat(actions, active_epoch->drain_buffers());
            } else if (state == ETS::IN_PROGRESS) {
                ActiveEpoch *ae = active_epoch.get();
                if (ae->outstanding_reqs->available_iterator->has_next())
                    concat(actions, ae->outstanding_reqs->advance_requests());
                if (ae->needs_advance()) concat(actions, ae->advance());
            }
            if (state == old_state) return actions;
        }
    }

    Actions move_low_watermark(i64 seq_no) {
        if (state != ETS::IN_PROGRESS) return Actions();
        auto [actions, done] = active_epoch->move_low_watermark(seq_no);
        if (done) state = ETS::DONE;
        return actions;
    }

    void apply_suspect_msg(i32 source) {
        suspicions.insert(source);
        if ((i64)suspicions.size() >= ctx->iq) state = ETS::DONE;
    }
};

// ---------------------------------------------------------------------------
// Epoch tracker (statemachine/epoch_tracker.py).
// ---------------------------------------------------------------------------

constexpr i64 TICKS_OUT_OF_CORRECT_EPOCH_LIMIT = 10;

i64 epoch_for_msg(const MsgS &msg) {
    switch (msg.t) {
        case MT::Preprepare:
        case MT::Prepare:
        case MT::Commit:
        case MT::Suspect:
            return msg.epoch;
        case MT::EpochChange:
            return msg.ec->new_epoch;
        case MT::EpochChangeAck:
            return msg.ec->new_epoch;
        case MT::NewEpoch:
        case MT::NewEpochEcho:
        case MT::NewEpochReady:
            return msg.necfg->config.number;
        default:
            throw EngineError("unexpected epoch message type");
    }
}

struct EpochTracker {
    const Ctx *ctx;
    shared_ptr<EpochTarget> current_epoch;
    PersistedLog *persisted;
    NodeBuffers *node_buffers;
    CommitState *commit_state;
    InitParms my_config;
    BatchTracker *batch_tracker;
    ClientTracker *client_tracker;
    Disseminator *client_hash_disseminator;
    std::map<i32, MsgBuffer> future_msgs;
    vector<std::pair<i32, i64>> max_epochs;  // insertion-ordered (source, max)
    i64 max_correct_epoch = 0;
    i64 ticks_out_of_correct_epoch = 0;
    bool needs_state_transfer = false;  // mirror of epoch_tracker.py's flag

    NetCfgP network_config;  // refreshed from the commit state's active state

    shared_ptr<EpochTarget> new_target(i64 number) {
        return std::make_shared<EpochTarget>(
            ctx, number, persisted, node_buffers, commit_state, client_tracker,
            client_hash_disseminator, batch_tracker, network_config,
            my_config);
    }

    Actions reinitialize() {
        network_config = commit_state->active_state->config;
        for (i32 node : ctx->cfg.nodes) {
            if (!future_msgs.count(node)) {
                MsgBuffer mb;
                mb.nb = node_buffers->node_buffer(node);
                mb.wire = &ctx->wire;
                future_msgs.emplace(node, std::move(mb));
            }
        }

        Actions actions;
        const PersistEntS *last_n = nullptr, *last_f = nullptr;
        bool have_ec = false;
        i64 last_ec_num = 0;
        i64 highest_preprepared = 0;
        for (const auto &pr : persisted->entries) {
            const PersistEntS &e = *pr.second;
            if (e.t == PET::N) last_n = &e;
            else if (e.t == PET::F) last_f = &e;
            else if (e.t == PET::EC) { have_ec = true; last_ec_num = e.num; }
            else if (e.t == PET::Q) {
                if (e.q->seq > highest_preprepared)
                    highest_preprepared = e.q->seq;
            } else if (e.t == PET::C) {
                // After state transfer we may have a CEntry with no QEntry.
                if (e.seq > highest_preprepared) highest_preprepared = e.seq;
            }
        }
        if (!last_n && !last_f)
            throw EngineError("no active epoch and no last epoch in log");
        if (last_n && last_f &&
            last_n->epoch_config.number <= last_f->epoch_config.number)
            throw EngineError("new epoch number must exceed last terminated epoch");

        if (last_n && (!have_ec || last_ec_num <= last_n->epoch_config.number)) {
            // Reinitializing mid-epoch: resume it (and suspect it, since we
            // may have missed traffic while down) —
            // epoch_tracker.py:163-181.
            current_epoch = new_target(last_n->epoch_config.number);
            i64 starting_seq_no = highest_preprepared + 1;
            i64 ci = network_config->ci;
            while (starting_seq_no % ci != 1) {
                // Advance to the first sequence after some checkpoint, so
                // we never re-consent on sequences we already consented on.
                starting_seq_no += 1;
                needs_state_transfer = true;
            }
            current_epoch->starting_seq_no = starting_seq_no;
            current_epoch->state = ETS::RESUMING;
            current_epoch->resume_epoch_config = last_n->epoch_config;
            current_epoch->have_resume_config = true;
            concat(actions,
                   persisted->append(pe_suspect(last_n->epoch_config.number)));
            actions.push_back(act_send(
                ctx->bcast, mk_suspect(last_n->epoch_config.number)));
            for (i32 node : ctx->cfg.nodes) {
                future_msgs.at(node).iterate(
                    [this](const MsgS &m) { return filter(m); },
                    [this, node, &actions](MsgP m) {
                        concat(actions, apply_msg(node, m));
                    });
            }
            return actions;
        }
        if (last_f && (!have_ec || last_ec_num <= last_f->epoch_config.number)) {
            last_ec_num = last_f->epoch_config.number + 1;
            have_ec = true;
            concat(actions, persisted->append(pe_ec(last_ec_num)));
        }
        if (!have_ec) throw EngineError("no epoch-change entry after recovery");
        if (current_epoch && current_epoch->number == last_ec_num) {
            concat(actions, current_epoch->advance_state());
            return actions;
        }
        EpochChangeP epoch_change = persisted->construct_epoch_change(last_ec_num);
        ParsedECP parsed = try_parse_epoch_change(epoch_change);
        if (!parsed) throw EngineError("own epoch change failed to parse");
        current_epoch = new_target(last_ec_num);
        current_epoch->my_epoch_change = parsed;
        current_epoch->my_leader_choice = network_config->nodes;  // all lead
        current_epoch->have_leader_choice = true;

        for (i32 node : ctx->cfg.nodes) {
            future_msgs.at(node).iterate(
                [this](const MsgS &m) { return filter(m); },
                [this, node, &actions](MsgP m) {
                    concat(actions, apply_msg(node, m));
                });
        }
        return actions;
    }

    Actions advance_state() {
        if (current_epoch->state < ETS::DONE)
            return current_epoch->advance_state();
        if (commit_state->checkpoint_pending) return Actions();

        i64 new_epoch_number = current_epoch->number + 1;
        if (max_correct_epoch > new_epoch_number)
            new_epoch_number = max_correct_epoch;
        EpochChangeP epoch_change =
            persisted->construct_epoch_change(new_epoch_number);
        ParsedECP my_epoch_change = try_parse_epoch_change(epoch_change);
        if (!my_epoch_change)
            throw EngineError("own epoch change failed to parse");

        current_epoch = new_target(new_epoch_number);
        current_epoch->my_epoch_change = my_epoch_change;
        current_epoch->my_leader_choice = {my_config.id};
        current_epoch->have_leader_choice = true;

        Actions actions = persisted->append(pe_ec(new_epoch_number));
        auto ecm = std::make_shared<MsgS>();
        ecm->t = MT::EpochChange;
        ecm->ec = epoch_change;
        actions.push_back(act_send(ctx->bcast, ecm));

        for (i32 node : ctx->cfg.nodes) {
            future_msgs.at(node).iterate(
                [this](const MsgS &m) { return filter(m); },
                [this, node, &actions](MsgP m) {
                    concat(actions, apply_msg(node, m));
                });
        }
        return actions;
    }

    Applyable filter(const MsgS &msg) {
        i64 epoch_number = epoch_for_msg(msg);
        if (epoch_number < current_epoch->number) return Applyable::PAST;
        if (epoch_number > current_epoch->number) return Applyable::FUTURE;
        return Applyable::CURRENT;
    }

    Actions step(i32 source, const MsgP &msg) {
        i64 epoch_number = epoch_for_msg(*msg);
        if (epoch_number < current_epoch->number) return Actions();
        if (epoch_number > current_epoch->number) {
            bool found = false;
            for (auto &pr : max_epochs)
                if (pr.first == source) {
                    if (pr.second < epoch_number) pr.second = epoch_number;
                    found = true;
                    break;
                }
            if (!found) max_epochs.emplace_back(source, epoch_number);
            future_msgs.at(source).store(msg);
            return Actions();
        }
        return apply_msg(source, msg);
    }

    Actions apply_msg(i32 source, const MsgP &msg) {
        EpochTarget *target = current_epoch.get();
        switch (msg->t) {
            case MT::Preprepare:
            case MT::Prepare:
            case MT::Commit:
                return target->step(source, msg);
            case MT::Suspect:
                target->apply_suspect_msg(source);
                return Actions();
            case MT::EpochChange: {
                u64 _t0 = __rdtsc();
                Actions _a = target->apply_epoch_change_msg(source, msg);
                g_parts[4].fetch_add(__rdtsc() - _t0, std::memory_order_relaxed);
                return _a;
            }
            case MT::EpochChangeAck: {
                u64 _t0 = __rdtsc();
                Actions _a = target->apply_epoch_change_ack_msg(
                    source, msg->originator, msg->ec);
                g_parts[5].fetch_add(__rdtsc() - _t0, std::memory_order_relaxed);
                return _a;
            }
            case MT::NewEpoch:
                if (msg->necfg->config.number % (i64)ctx->cfg.nodes.size() !=
                    source)
                    return Actions();  // not from the epoch primary
                return target->apply_new_epoch_msg(msg);
            case MT::NewEpochEcho:
                return target->apply_new_epoch_echo_msg(source, msg->necfg);
            case MT::NewEpochReady:
                return target->apply_new_epoch_ready_msg(source, msg->necfg);
            default:
                throw EngineError("unexpected epoch message type");
        }
    }

    Actions apply_batch_hash_result(i64 epoch, i64 seq_no, i32 digest) {
        if (epoch != current_epoch->number ||
            current_epoch->state != ETS::IN_PROGRESS)
            return Actions();
        return current_epoch->active_epoch->apply_batch_hash_result(seq_no,
                                                                    digest);
    }

    Actions apply_epoch_change_digest(const HashOriginS &origin, i32 digest) {
        i64 target_number = origin.ec->new_epoch;
        if (target_number < current_epoch->number) return Actions();
        if (target_number > current_epoch->number)
            throw EngineError("epoch change digest for future epoch");
        return current_epoch->apply_epoch_change_digest(origin, digest);
    }

    Actions tick() {
        for (const auto &pr : max_epochs) {
            i64 max_epoch = pr.second;
            if (max_epoch <= max_correct_epoch) continue;
            i64 matches = 0;
            for (const auto &pr2 : max_epochs)
                if (pr2.second >= max_epoch) matches++;
            if (matches < ctx->wq) continue;
            max_correct_epoch = max_epoch;
        }
        if (max_correct_epoch > current_epoch->number) {
            ticks_out_of_correct_epoch += 1;
            if (ticks_out_of_correct_epoch > TICKS_OUT_OF_CORRECT_EPOCH_LIMIT)
                current_epoch->state = ETS::DONE;
        }
        return current_epoch->tick();
    }

    Actions move_low_watermark(i64 seq_no) {
        return current_epoch->move_low_watermark(seq_no);
    }
};

// ---------------------------------------------------------------------------
// Root state machine (statemachine/machine.py).
// ---------------------------------------------------------------------------

struct MachineState_ {
    enum V { UNINITIALIZED = 0, LOADING_PERSISTED = 1, INITIALIZED = 2 };
};

struct Machine {
    const Ctx *ctx;
    int state = MachineState_::UNINITIALIZED;
    InitParms my_config{};
    bool have_config = false;
    std::unique_ptr<PersistedLog> persisted;
    std::unique_ptr<NodeBuffers> node_buffers;
    std::unique_ptr<CheckpointTracker> checkpoint_tracker;
    std::unique_ptr<ClientTracker> client_tracker;
    std::unique_ptr<CommitState> commit_state;
    std::unique_ptr<Disseminator> client_hash_disseminator;
    std::unique_ptr<BatchTracker> batch_tracker;
    std::unique_ptr<EpochTracker> epoch_tracker;

    void initialize(const InitParms &parameters) {
        if (state != MachineState_::UNINITIALIZED)
            throw EngineError("state machine has already been initialized");
        my_config = parameters;
        have_config = true;
        state = MachineState_::LOADING_PERSISTED;
        persisted = std::make_unique<PersistedLog>();
        node_buffers = std::make_unique<NodeBuffers>();
        node_buffers->buffer_size = parameters.buffer_size;
        checkpoint_tracker = std::make_unique<CheckpointTracker>();
        checkpoint_tracker->persisted = persisted.get();
        checkpoint_tracker->node_buffers = node_buffers.get();
        checkpoint_tracker->my_config = parameters;
        checkpoint_tracker->ctx = ctx;
        client_tracker = std::make_unique<ClientTracker>();
        client_tracker->my_config = parameters;
        commit_state = std::make_unique<CommitState>();
        commit_state->ctx = ctx;
        commit_state->persisted = persisted.get();
        client_hash_disseminator = std::make_unique<Disseminator>();
        client_hash_disseminator->ctx = ctx;
        client_hash_disseminator->my_config = parameters;
        client_hash_disseminator->node_buffers = node_buffers.get();
        client_hash_disseminator->client_tracker = client_tracker.get();
        batch_tracker = std::make_unique<BatchTracker>();
        batch_tracker->persisted = persisted.get();
        epoch_tracker = std::make_unique<EpochTracker>();
        epoch_tracker->ctx = ctx;
        epoch_tracker->persisted = persisted.get();
        epoch_tracker->node_buffers = node_buffers.get();
        epoch_tracker->commit_state = commit_state.get();
        epoch_tracker->my_config = parameters;
        epoch_tracker->batch_tracker = batch_tracker.get();
        epoch_tracker->client_tracker = client_tracker.get();
        epoch_tracker->client_hash_disseminator = client_hash_disseminator.get();
    }

    void apply_persisted(i64 index, PersistEntP entry) {
        if (state != MachineState_::LOADING_PERSISTED)
            throw EngineError("not in the loading-persisted phase");
        persisted->append_initial_load(index, std::move(entry));
    }

    Actions complete_initialization() {
        if (state != MachineState_::LOADING_PERSISTED)
            throw EngineError("not in the loading-persisted phase");
        state = MachineState_::INITIALIZED;
        return reinitialize();
    }

    Actions reinitialize() {
        Actions actions = complete_pending_reconfiguration();
        concat(actions, recover_log());
        concat(actions, commit_state->reinitialize());
        client_tracker->reinitialize(*commit_state->active_state);
        concat(actions,
               client_hash_disseminator->reinitialize(
                   commit_state->low_watermark, *commit_state->active_state));
        checkpoint_tracker->reinitialize();
        batch_tracker->reinitialize();
        concat(actions, epoch_tracker->reinitialize());
        return actions;
    }

    Actions complete_pending_reconfiguration() {
        // Close the epoch at a reconfiguration boundary (machine.py:151-194):
        // when the checkpoint APPLYING a pending reconfiguration is
        // persisted (its predecessor CEntry still carries the pending list)
        // but no FEntry follows it yet, append the FEntry ending the
        // current epoch config.
        const PersistEntS *prev_c = nullptr, *last_c = nullptr;
        const EpochCfgS *last_epoch_config = nullptr;
        bool f_after_last_c = false;
        for (const auto &pr : persisted->entries) {
            const PersistEntS &e = *pr.second;
            if (e.t == PET::C) {
                prev_c = last_c;
                last_c = &e;
                f_after_last_c = false;
            } else if (e.t == PET::F) {
                f_after_last_c = true;
                last_epoch_config = &e.epoch_config;
            } else if (e.t == PET::N) {
                last_epoch_config = &e.epoch_config;
            }
        }
        if (!last_c || !prev_c || f_after_last_c ||
            prev_c->netstate->pending.empty())
            return Actions();
        if (!last_epoch_config)
            throw EngineError(
                "reconfiguration completed with no epoch config in the log");
        return persisted->append(pe_f(*last_epoch_config));
    }

    Actions recover_log() {
        Actions actions;
        const PersistEntS *last_c = nullptr;
        // Collect truncation points first (Python iterates a snapshot).
        vector<i64> truncate_seqs;
        for (const auto &pr : persisted->entries) {
            const PersistEntS &e = *pr.second;
            if (e.t == PET::C) last_c = &e;
            else if (e.t == PET::F) {
                if (!last_c)
                    throw EngineError("FEntry without corresponding CEntry");
                truncate_seqs.push_back(last_c->seq);
            }
        }
        if (!last_c) throw EngineError("found no checkpoints in the log");
        for (i64 seq : truncate_seqs)
            concat(actions, persisted->truncate(seq));
        return actions;
    }

    Actions step(i32 source, const MsgP &msg);

    Actions process_hash_result(i32 digest, const HashOriginS &origin) {
        if (origin.t == OT::Batch) {
            batch_tracker->add_batch(origin.seq, digest, origin.request_acks);
            return epoch_tracker->apply_batch_hash_result(origin.epoch,
                                                          origin.seq, digest);
        }
        if (origin.t == OT::EpochChange)
            return epoch_tracker->apply_epoch_change_digest(origin, digest);
        if (origin.t == OT::VerifyBatch) {
            Actions actions;
            batch_tracker->apply_verify_batch_hash_result(digest, origin);
            if (!batch_tracker->has_fetch_in_flight() &&
                epoch_tracker->current_epoch->state == ETS::FETCHING)
                concat(actions,
                       epoch_tracker->current_epoch->fetch_new_epoch_state());
            return actions;
        }
        throw EngineError("no hash origin type set");
    }

    Actions process_checkpoint_result(const EventS &result) {
        Actions actions;
        NetStateP ns = result.netstate();
        if (result.a < commit_state->low_watermark) return actions;
        i64 expected = commit_state->low_watermark +
                       commit_state->active_state->config->ci;
        if (expected != result.a)
            throw EngineError("checkpoint results must be one interval after the last");
        bool completing_reconfiguration =
            !commit_state->active_state->pending.empty();
        i64 prev_stop = commit_state->stop_at_seq_no;
        concat(actions, commit_state->apply_checkpoint_result(
                            result.a, result.digest, ns));
        if (completing_reconfiguration && !commit_state->transferring) {
            // This checkpoint applied a reconfiguration: the epoch ends
            // here; reinitialize under the new network state (the FEntry
            // flow of reference docs/LogMovement.md).
            concat(actions, reinitialize());
            return actions;
        }
        if (prev_stop < commit_state->stop_at_seq_no) {
            client_tracker->allocate(*ns);
            concat(actions, client_hash_disseminator->allocate(result.a, *ns));
        }
        return actions;
    }

    Actions apply_event(const EventS &event) {
        if (event.t == ET::InitialParameters)
            throw EngineError("init params handled by caller");
        if (event.t == ET::LoadPersistedEntry) {
            apply_persisted(event.a, event.entry());
            return Actions();
        }
        Actions actions;
        if (event.t == ET::LoadCompleted) {
            actions = complete_initialization();
        } else if (event.t == ET::ActionsReceived) {
            if (state == MachineState_::INITIALIZED)
                return client_hash_disseminator->flush_acks();
            return actions;
        } else {
            if (state != MachineState_::INITIALIZED)
                throw EngineError("cannot apply events to an uninitialized machine");
            if (event.t == ET::Step) {
                concat(actions, step(event.digest, event.msg()));
            } else if (event.t == ET::RequestPersisted) {
                concat(actions,
                       client_hash_disseminator->apply_new_request(event.ack));
            } else if (event.t == ET::HashResult) {
                concat(actions,
                       process_hash_result(event.digest, *event.origin()));
            } else if (event.t == ET::CheckpointResult) {
                concat(actions, process_checkpoint_result(event));
            } else if (event.t == ET::TickElapsed) {
                concat(actions, client_hash_disseminator->tick());
                concat(actions, epoch_tracker->tick());
                concat(actions, commit_state->tick());
            } else if (event.t == ET::StateTransferFailed) {
                concat(actions, commit_state->apply_transfer_failed(
                                    event.a, event.digest));
            } else if (event.t == ET::StateTransferComplete) {
                if (!commit_state->transferring)
                    throw EngineError(
                        "state transfer completed but none was requested");
                concat(actions, persisted->append(
                                    pe_c(event.a, event.digest,
                                         event.netstate())));
                concat(actions, reinitialize());
            } else {
                throw EngineError("unknown event type");
            }
        }

        if (checkpoint_tracker->state == CheckpointState_::GARBAGE_COLLECTABLE) {
            i64 new_low = checkpoint_tracker->garbage_collect();
            concat(actions, persisted->truncate(new_low));
            i64 ci = checkpoint_tracker->net_cfg->ci;
            if (new_low > ci) batch_tracker->truncate(new_low - ci);
            concat(actions, epoch_tracker->move_low_watermark(new_low));
        }

        // Mid-epoch catch-up (docs/Divergences.md #13; machine.py twin).
        // The target stays armed while a transfer is in flight: checkpoint
        // messages are sent once, so dropping it could strand the replica.
        if (checkpoint_tracker->catch_up_seq >= 0) {
            i64 seq_no = checkpoint_tracker->catch_up_seq;
            i32 value = checkpoint_tracker->catch_up_value;
            if (seq_no <= commit_state->highest_commit) {
                checkpoint_tracker->catch_up_seq = -1;  // stale
                checkpoint_tracker->catch_up_value = -1;
            } else if (!commit_state->transferring) {
                checkpoint_tracker->catch_up_seq = -1;
                checkpoint_tracker->catch_up_value = -1;
                concat(actions, commit_state->transfer_to(seq_no, value));
            }
        }

        u64 t0 = __rdtsc();
        while (true) {
            concat(actions, commit_state->drain());
            Actions loop_actions = epoch_tracker->advance_state();
            if (loop_actions.empty()) break;
            concat(actions, std::move(loop_actions));
        }
        g_parts[2].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
        return actions;
    }
};

Actions Machine::step(i32 source, const MsgP &msg) {
    MT t = msg->t;
    if (t == MT::Prepare || t == MT::Commit) {
        EpochTarget *target = epoch_tracker->current_epoch.get();
        if (msg->epoch == target->number && target->state == ETS::IN_PROGRESS)
            return target->active_epoch->step(source, msg);
        return epoch_tracker->step(source, msg);
    }
    if (t == MT::AckBatch || t == MT::AckMsg || t == MT::FetchRequest)
        return client_hash_disseminator->step(source, msg);
    if (t == MT::MsgBatch) {
        EpochTarget *target = epoch_tracker->current_epoch.get();
        if (target->state == ETS::IN_PROGRESS) {
            // Native-plane envelope path (voteplane.py split_votes): votes
            // first (in order), then the rest (in order) — classified
            // inline; apply_envelope_votes skips the non-votes.
            bool any_vote = false;
            for (const auto &im : msg->inner)
                if (im->t == MT::Prepare || im->t == MT::Commit) {
                    any_vote = true;
                    break;
                }
            if (any_vote) {
                u64 t0 = __rdtsc();
                Actions actions = target->active_epoch->apply_envelope_votes(
                    msg->inner, source, [this](i32 src, const MsgP &m) {
                        return step(src, m);
                    });
                g_parts[1].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
                for (const auto &im : msg->inner)
                    if (im->t != MT::Prepare && im->t != MT::Commit)
                        concat(actions, step(source, im));
                return actions;
            }
        }
        Actions actions;
        for (const auto &im : msg->inner) concat(actions, step(source, im));
        return actions;
    }
    if (t == MT::Checkpoint) {
        checkpoint_tracker->step(source, msg);
        return Actions();
    }
    if (t == MT::FetchBatch)
        return batch_tracker->reply_fetch_batch(source, msg->seq, msg->dig);
    if (t == MT::ForwardBatch)
        return batch_tracker->apply_forward_batch_msg(source, msg->seq,
                                                      msg->dig, msg->acks,
                                                      ctx->intern);
    if (t == MT::Suspect || t == MT::EpochChange || t == MT::EpochChangeAck ||
        t == MT::NewEpoch || t == MT::NewEpochEcho || t == MT::NewEpochReady ||
        t == MT::Preprepare)
        return epoch_tracker->step(source, msg);
    throw EngineError("unexpected message type in machine step");
}

// ClientTracker::allocate (deferred: needs is_committed over CRNP/AckS).
void ClientTracker::allocate(const NetStateS &state) {
    std::map<i64, const ClientStateS *> state_map;
    for (const auto &cs : state.clients) state_map.emplace(cs.id, &cs);
    available_list->garbage_collect([&](const AckS &ack) {
        auto it = state_map.find(ack.client);
        if (it == state_map.end())
            throw EngineError("available client req must have its client in config");
        return is_committed(ack.reqno, *it->second);
    });
    ready_list->garbage_collect([&](const CRNP &crn) {
        auto it = state_map.find(crn->client_id);
        if (it == state_map.end())
            throw EngineError("client removal not yet supported");
        return is_committed(crn->req_no, *it->second);
    });
}

// ---------------------------------------------------------------------------
// Processor layer (processor/{serial,work,clients}.py) and simulated node
// fakes (testengine/recorder.py).
// ---------------------------------------------------------------------------

struct WorkItems {
    Actions wal_actions, net_actions, hash_actions, client_actions,
        app_actions;
    Events req_store_events, result_events;

    void add_state_machine_results(Actions &&actions) {
        for (auto &action : actions) {
            switch (action.t) {
                case AT::Send: {
                    MT t = action.msg_raw()->t;
                    if (t == MT::AckMsg || t == MT::AckBatch ||
                        t == MT::Checkpoint || t == MT::FetchBatch ||
                        t == MT::ForwardBatch)
                        net_actions.push_back(std::move(action));
                    else
                        wal_actions.push_back(std::move(action));
                    break;
                }
                case AT::Hash:
                    hash_actions.push_back(std::move(action));
                    break;
                case AT::Persist:
                case AT::Truncate:
                    wal_actions.push_back(std::move(action));
                    break;
                case AT::Commit:
                case AT::Checkpoint:
                case AT::StateTransfer:
                    app_actions.push_back(std::move(action));
                    break;
                case AT::AllocatedRequest:
                case AT::CorrectRequest:
                case AT::StateApplied:
                    client_actions.push_back(std::move(action));
                    break;
                case AT::ForwardRequest:
                    break;  // dropped (reference work.go:176)
            }
        }
    }
};

// In-memory request store (testengine SimReqStore).
struct SimReqStore {
    std::unordered_set<AckS, AckHash> requests;
    std::unordered_map<u64, i32> allocations;  // (client<<32|reqno) packed

    static u64 key(i64 client, i64 reqno) {
        return ((u64)client << 40) | (u64)reqno;
    }
    void put_request(const AckS &ack) { requests.insert(ack); }
    bool has_request(const AckS &ack) const { return requests.count(ack) != 0; }
    void put_allocation(i64 client, i64 reqno, i32 dig) {
        allocations[key(client, reqno)] = dig;
    }
    i32 get_allocation(i64 client, i64 reqno) const {  // -1 = None
        auto it = allocations.find(key(client, reqno));
        return it == allocations.end() ? -1 : it->second;
    }
};

// In-memory WAL (testengine SimWAL) — index bookkeeping only; entries are
// retained for parity of the strict accounting, trimmed on truncate.
struct SimWAL {
    i64 low_index = 1;
    deque<PersistEntP> entries;

    void write(i64 index, PersistEntP entry) {
        i64 expected = low_index + (i64)entries.size();
        if (index != expected) throw EngineError("WAL out of order");
        entries.push_back(std::move(entry));
    }
    void truncate(i64 index) {
        if (index < low_index) throw EngineError("truncate below low index");
        i64 to_remove = index - low_index;
        if (to_remove >= (i64)entries.size())
            throw EngineError("truncate beyond highest index");
        entries.erase(entries.begin(), entries.begin() + to_remove);
        low_index = index;
    }
};

// The simulated replicated app (testengine NodeState).
//
// Cluster-shared hash-chain memoization: all N replicas apply the SAME
// ordered QEntry stream to the same app semantics, so the expensive parts
// of the evolution — the SHA-256 chain state and the per-client
// committed-reqs map — are functions of the chain position, not of the
// replica.  The engine keeps one content-addressed chain DAG (AppChain);
// each replica holds only a cursor (chain_id).  The first replica to reach
// a position pays for it; the other N-1 follow pointers.  Divergent
// streams (impossible in the green envelope, but the memo does not assume
// it) simply grow separate branches keyed by (seq, batch digest).
// Per-replica semantic assertions (commit ordering, reqstore presence)
// still run per replica — only the symmetric computation is shared.
struct AppChainNode {
    Sha256 hash_state;
    std::unordered_map<u64, i32> next;       // (seq<<32|digest) -> node
    std::unordered_map<i32, i32> snap_next;  // checkpoint value id -> node
    string digest;  // memoized hash_state.digest()
    bool digest_done = false;
    // Committed-floor delta memo: absolute (client, floor) assignments a
    // replica with CANONICAL floors applies at this position, one entry
    // per client the batch raised.  Consumers apply it with MAX, so a
    // delta created by a floor-lagging (state-transferred) replica — a
    // superset with never-higher values — stays correct for everyone.
    vector<std::pair<i64, i64>> delta;
};

struct AppChain {
    vector<AppChainNode> nodes;
    AppChain() { nodes.emplace_back(); }
};

struct AppState {
    const Ctx *ctx;
    SimReqStore *req_store;
    AppChain *chain = nullptr;
    i32 chain_id = 0;
    i64 last_seq_no = 0;
    i64 checkpoint_seq_no = 0;
    string checkpoint_hash;
    NetStateP checkpoint_state;
    std::map<i64, i64> committed_reqs;
    // State-transfer bookkeeping + app-level failure injection
    // (testengine/recorder.py NodeState).
    i64 fail_transfers = 0;
    // False once this node state-transfers: its committed_reqs floors lag
    // the chain's canonical floors (skipped batches are never applied), so
    // it leaves the shared-delta fast path for the per-request one.
    bool floors_canonical = true;
    vector<i64> state_transfers;
    vector<i64> transfer_failures;
    vector<i64> transfer_attempt_times;
    // Reconfiguration points (engine-global) + this replica's accumulated
    // pending reconfigurations since its last snap.
    const vector<std::tuple<i64, i64, ReconfigS>> *reconfig_points = nullptr;
    vector<ReconfigS> pending;

    const string &active_hash_digest() {
        AppChainNode &cur = chain->nodes[(size_t)chain_id];
        if (!cur.digest_done) {
            cur.digest = cur.hash_state.digest();
            cur.digest_done = true;
        }
        return cur.digest;
    }

    // snap() -> value interner id.  Consumes pending reconfigurations into
    // the checkpointed network state (testengine NodeState.snap).
    i32 snap(Interner &intern, NetCfgP config,
             const vector<ClientStateS> &client_states) {
        checkpoint_seq_no = last_seq_no;
        auto ns = std::make_shared<NetStateS>();
        ns->config = std::move(config);
        ns->clients = client_states;
        ns->pending = std::move(pending);
        pending.clear();
        checkpoint_state = ns;
        checkpoint_hash = active_hash_digest();
        // The value embeds the (per-replica-encoded) network state, so the
        // snap transition is keyed by the value id: replicas snapping the
        // same state at the same position converge on one chain node.
        string value = checkpoint_hash;
        ctx->wire.net_state(value, *ns);
        i32 vid = intern.put(value);
        AppChainNode &cur = chain->nodes[(size_t)chain_id];
        auto it = cur.snap_next.find(vid);
        if (it != cur.snap_next.end()) {
            chain_id = it->second;
            return vid;
        }
        AppChainNode nxt;
        nxt.hash_state.update(checkpoint_hash);
        i32 nid = (i32)chain->nodes.size();
        chain->nodes.push_back(std::move(nxt));
        chain->nodes[(size_t)chain_id].snap_next.emplace(vid, nid);
        chain_id = nid;
        return vid;
    }

    void apply(const QEntryS &batch, const Interner &intern) {
        last_seq_no += 1;
        if (batch.seq != last_seq_no) throw EngineError("out-of-order commit");
        for (const auto &request : batch.reqs)
            if (!req_store->has_request(request))
                throw EngineError("reqstore must have a request we are committing");
        u64 key = ((u64)(u32)batch.seq << 32) | (u32)batch.dig;
        i32 nid;
        {
            AppChainNode &cur = chain->nodes[(size_t)chain_id];
            auto it = cur.next.find(key);
            nid = it != cur.next.end() ? it->second : -1;
        }
        if (nid < 0) {
            // First replica at this position: compute the hash transition
            // and the committed-floor delta (from OUR floors; a lagging
            // creator emits a superset with never-higher values — see the
            // delta comment on AppChainNode).
            AppChainNode nxt;
            nxt.hash_state = chain->nodes[(size_t)chain_id].hash_state;
            for (const auto &request : batch.reqs) {
                nxt.hash_state.update(intern.get(request.dig));
                auto cit = committed_reqs.find(request.client);
                i64 prev = cit == committed_reqs.end() ? 0 : cit->second;
                if (request.reqno + 1 > prev) {
                    bool found = false;
                    for (auto &pr : nxt.delta)
                        if (pr.first == request.client) {
                            if (request.reqno + 1 > pr.second)
                                pr.second = request.reqno + 1;
                            found = true;
                            break;
                        }
                    if (!found)
                        nxt.delta.emplace_back(request.client,
                                               request.reqno + 1);
                }
            }
            nid = (i32)chain->nodes.size();
            chain->nodes.push_back(std::move(nxt));
            chain->nodes[(size_t)chain_id].next.emplace(key, nid);
        }
        if (floors_canonical && (!reconfig_points || reconfig_points->empty())) {
            // Fast path (the common one: never-transferred replica, no
            // reconfiguration points): the memoized delta applied with
            // MAX is exactly the per-request floor update.
            for (const auto &pr : chain->nodes[(size_t)nid].delta) {
                i64 &slot = committed_reqs[pr.first];
                if (pr.second > slot) slot = pr.second;
            }
        } else {
            // Per-request path: a transferred replica's floors lag the
            // chain (Python computes per replica too, NodeState.apply),
            // and reconfiguration points must see every request.
            for (const auto &request : batch.reqs) {
                i64 &slot = committed_reqs[request.client];
                if (request.reqno + 1 > slot) slot = request.reqno + 1;
                if (reconfig_points)
                    for (const auto &point : *reconfig_points)
                        if (std::get<0>(point) == request.client &&
                            std::get<1>(point) == request.reqno)
                            pending.push_back(std::get<2>(point));
            }
        }
        chain_id = nid;
    }
};

// Client-side request-store logic (processor/clients.py).
struct ProcClientRequest {
    bool present = false;
    i32 local_allocation_digest = -1;  // -1 = None
    vector<i32> remote_correct_digests;
};

struct ProcClient {
    i64 client_id;
    SimReqStore *request_store;
    i64 next_req_no = 0;
    // Dense window over [base, base + win.size()): client request slots are
    // created/consumed in ascending runs, so the Python dict (insertion-
    // ordered, pruned from the bottom at state_applied) maps onto a deque.
    // Slots may be holes (present == false) until allocated/proposed.
    i64 base = 0;
    bool base_set = false;
    deque<ProcClientRequest> win;
    i64 live = 0;  // count of present slots

    ProcClientRequest *slot(i64 req_no) {
        if (!base_set) return nullptr;
        i64 off = req_no - base;
        if (off < 0 || off >= (i64)win.size()) return nullptr;
        ProcClientRequest &cr = win[(size_t)off];
        return cr.present ? &cr : nullptr;
    }

    ProcClientRequest *ensure_slot(i64 req_no) {
        if (!base_set) {
            base = req_no;
            base_set = true;
        }
        while (req_no < base) {
            // The Python dict re-creates entries below a pruned low
            // watermark (clients.py Client.allocate); extend downward.
            win.emplace_front();
            base -= 1;
        }
        while ((i64)win.size() <= req_no - base) win.emplace_back();
        ProcClientRequest &cr = win[(size_t)(req_no - base)];
        if (!cr.present) {
            cr.present = true;
            live += 1;
        }
        return &cr;
    }

    void state_applied(const ClientStateS &state) {
        while (base_set && !win.empty() && base < state.lw) {
            if (win.front().present) live -= 1;
            win.pop_front();
            base += 1;
        }
        // A fully drained window must rebase, or the next ensure_slot would
        // materialize every hole between the stale base and the new slot.
        if (base_set && win.empty() && base < state.lw) base = state.lw;
        if (next_req_no < state.lw) next_req_no = state.lw;
    }

    // allocate() -> local digest or -1.
    i32 allocate(i64 req_no) {
        ProcClientRequest *existing = slot(req_no);
        if (existing) return existing->local_allocation_digest;
        ProcClientRequest *cr = ensure_slot(req_no);
        cr->local_allocation_digest =
            request_store->get_allocation(client_id, req_no);
        return cr->local_allocation_digest;
    }

    bool empty() const { return live == 0; }

    i64 first_req_no() const {
        for (size_t i = 0; i < win.size(); i++)
            if (win[i].present) return base + (i64)i;
        throw EngineError("empty proc client window");
    }

    void add_correct_digest(i64 req_no, i32 digest) {
        if (empty())
            throw EngineError("client-not-exist in add_correct_digest");
        ProcClientRequest *cr = slot(req_no);
        if (!cr) {
            if (req_no < first_req_no()) return;  // already GC'd
            throw EngineError("unallocated client request marked correct");
        }
        auto &rcd = cr->remote_correct_digests;
        for (i32 d : rcd)
            if (d == digest) return;
        rcd.push_back(digest);
    }

    i64 next_req_no_value() const {
        if (empty()) throw EngineError("ClientNotExist");
        return next_req_no;
    }

    // propose() (clients.py:98-144); digest precomputed by the engine.
    // Returns (has_event, ack) — the RequestPersisted event if emitted.
    bool propose(i64 req_no, i32 digest, AckS *out) {
        if (empty()) throw EngineError("ClientNotExist");
        if (req_no < next_req_no) return false;

        if (req_no == next_req_no) {
            while (true) {
                next_req_no += 1;
                ProcClientRequest *nxt = slot(next_req_no);
                if (!nxt || nxt->local_allocation_digest == -1) break;
            }
        }
        ProcClientRequest *existing = slot(req_no);
        bool previously_allocated = existing != nullptr;
        ProcClientRequest &cr = *(existing ? existing : ensure_slot(req_no));
        if (cr.local_allocation_digest != -1) {
            if (cr.local_allocation_digest == digest) return false;
            throw EngineError("conflicting digest for req_no");
        }
        if (!cr.remote_correct_digests.empty()) {
            bool ok = false;
            for (i32 d : cr.remote_correct_digests)
                if (d == digest) ok = true;
            if (!ok)
                throw EngineError("other known-correct digests exist for req_no");
        }
        AckS ack{client_id, req_no, digest};
        request_store->put_request(ack);
        request_store->put_allocation(client_id, req_no, digest);
        cr.local_allocation_digest = digest;
        if (previously_allocated) {
            *out = ack;
            return true;
        }
        return false;
    }
};

struct ProcClients {
    SimReqStore *request_store;
    std::map<i64, ProcClient> clients;

    ProcClient *client(i64 client_id) {
        auto it = clients.find(client_id);
        if (it == clients.end()) {
            ProcClient c;
            c.client_id = client_id;
            c.request_store = request_store;
            it = clients.emplace(client_id, std::move(c)).first;
        }
        return &it->second;
    }

    Events process_client_actions(const Actions &actions) {
        Events events;
        i64 last_id = -1;
        ProcClient *cached = nullptr;
        for (const auto &action : actions) {
            if (action.t == AT::AllocatedRequest) {
                if (action.a != last_id) {
                    last_id = action.a;
                    cached = client(last_id);
                }
                i32 digest = cached->allocate(action.b);
                if (digest == -1) continue;
                EventS ev;
                ev.t = ET::RequestPersisted;
                ev.ack = AckS{action.a, action.b, digest};
                events.push_back(std::move(ev));
            } else if (action.t == AT::CorrectRequest) {
                client(action.ack.client)
                    ->add_correct_digest(action.ack.reqno, action.ack.dig);
            } else if (action.t == AT::StateApplied) {
                for (const auto &cs : action.netstate()->clients)
                    client(cs.id)->state_applied(cs);
            } else {
                throw EngineError("unexpected client action type");
            }
        }
        return events;
    }
};

// _coalesce_sends (processor/serial.py:96-145).
vector<ActionS> coalesce_sends(Actions &&actions) {
    struct Group {
        size_t index;
        vector<MsgP> msgs;
        vector<AckS> acks;
    };
    vector<std::pair<Targets, Group>> groups;  // insertion-ordered by key
    vector<std::optional<ActionS>> out;
    for (auto &action : actions) {
        if (action.t != AT::Send)
            throw EngineError("unexpected Net action type");
        Group *slot = nullptr;
        for (auto &pr : groups)
            if (pr.first == action.targets ||
                *pr.first == *action.targets) {
                slot = &pr.second;
                break;
            }
        if (!slot) {
            groups.emplace_back(action.targets,
                                Group{out.size(), {}, {}});
            slot = &groups.back().second;
            out.emplace_back(std::nullopt);
        }
        const MsgS *msg = action.msg_raw();
        if (msg->t == MT::AckMsg) slot->acks.push_back(msg->acks[0]);
        else if (msg->t == MT::AckBatch)
            for (const auto &a : msg->acks) slot->acks.push_back(a);
        else slot->msgs.push_back(action.msg());
    }
    for (auto &pr : groups) {
        Group &g = pr.second;
        if (!g.acks.empty()) {
            std::stable_sort(g.acks.begin(), g.acks.end(),
                             [](const AckS &a, const AckS &b) {
                                 if (a.client != b.client)
                                     return a.client < b.client;
                                 return a.reqno < b.reqno;
                             });
            if (g.acks.size() == 1) g.msgs.push_back(mk_ack_msg(g.acks[0]));
            else g.msgs.push_back(mk_ack_batch(std::move(g.acks)));
        }
        MsgP final_msg;
        if (g.msgs.size() == 1) {
            final_msg = g.msgs[0];
        } else {
            auto mb = std::make_shared<MsgS>();
            mb->t = MT::MsgBatch;
            mb->inner = std::move(g.msgs);
            final_msg = mb;
        }
        out[g.index] = act_send(pr.first, final_msg);
    }
    vector<ActionS> result;
    for (auto &o : out)
        if (o) result.push_back(std::move(*o));
    return result;
}

// ---------------------------------------------------------------------------
// The engine: nodes + scheduler (testengine/recorder.py Recording).
// ---------------------------------------------------------------------------

constexpr int PROPOSAL_CHUNK = 32;

struct RuntimeParms {
    i64 tick_interval = 500, link_latency = 100, wal_latency = 100,
        net_latency = 15, hash_latency = 25, client_latency = 15,
        app_latency = 30, req_store_latency = 150, events_latency = 10;
    // Per-destination link latency (docs/PERFORMANCE.md §7.1, per-link
    // lookahead): empty means the scalar link_latency applies to every
    // destination.  The self entry is ignored (self-sends short-circuit).
    vector<i64> lat_to;
    i64 link_lat(i64 dest) const {
        return lat_to.empty() ? link_latency : lat_to[(size_t)dest];
    }
};

struct ClientSpec {
    i64 id;
    i64 total;
    bool signed_mode = false;
    bool corrupt = false;
    std::set<i32> ignore_nodes;
    vector<i32> payloads;        // interner id per req_no
    vector<i32> payload_digests; // sha256 id per req_no
    vector<u8> verdicts;         // auth verdict per req_no (signed mode)
};

struct EngineNode {
    i32 id;
    InitParms init_parms;
    RuntimeParms runtime;
    i64 start_delay = 0;
    SimWAL wal;
    SimReqStore req_store;
    AppState state;
    std::unique_ptr<WorkItems> work_items;
    std::unique_ptr<ProcClients> clients;
    std::unique_ptr<Machine> machine;
    bool pending[7] = {false, false, false, false, false, false, false};
    // category order: wal, net, client, hash, app, req_store, result
    bool drain_ready = false;
};

struct Engine {
    Ctx ctx;
    EventQueue queue;
    // PDES state (empty for sequential runs; see struct Partition).
    vector<std::unique_ptr<Partition>> parts;
    vector<i32> part_of;  // node id -> partition id
    bool pdes_threaded = false;
    i64 pdes_W = 0;  // conservative window width for the current part_of
    // Traffic model for rebalancing: per-node EWMA of window work cycles,
    // plus the raw per-window vectors of the last few windows — the
    // repartition objective (sum of per-window partition maxima) lives in
    // the window-to-window burst structure that the EWMA smooths away.
    vector<double> node_load;
    std::deque<vector<u64>> node_hist;
    // Pooled barrier-merge buffers (reused every window).
    vector<vector<i64>> pdes_fin;
    vector<size_t> pdes_logi, pdes_flipi, pdes_purgei;
    std::shared_mutex intern_mu;  // installed on ctx.intern when threaded
    std::mutex chain_mu, snap_mu;  // shared chain / snap registry guards
    vector<std::unique_ptr<EngineNode>> nodes;
    vector<ClientSpec> client_specs;  // in config order
    i64 steps = 0;
    i64 committed_ops = 0;
    // Incremental drain bookkeeping: the drain predicate is a pure function
    // of state that changes only in checkpoint snaps (client low watermarks)
    // and commits (committed counts), so it is maintained there instead of
    // rescanning nodes x clients every step.  drained() stays exactly the
    // predicate of recorder.py:761-803, evaluated after every step.
    std::unordered_map<i64, i64> drain_targets;  // client -> target (0 corrupt)
    i64 nodes_not_ready = 0;   // nodes whose checkpoint lws miss targets
    i64 clients_unsatisfied = 0;  // targets>0 not yet committed anywhere
    std::unordered_map<i64, bool> client_satisfied;
    u64 kind_cycles[11] = {0};
    u64 kind_counts[11] = {0};
    u64 ev_cycles[12] = {0};
    u64 ev_counts[12] = {0};
    // Per-message-kind attribution of Step-event application (the c4
    // profile's dominant bucket): indexed by MT.
    u64 msg_cycles[16] = {0};
    u64 msg_counts[16] = {0};
    u64 fix_cycles = 0;  // post-event GC+fixpoint share (inside apply_event)
    u64 crypto_ns = 0;  // host CPU spent hashing (SHA-256) in-engine
    // Wave mirror log: (joined message id, digest id) for wave-eligible
    // content; first sight of a content logs it for the device plane.
    vector<std::pair<i32, i32>> wave_log;
    // Cluster-symmetric hash memos: all N replicas hash identical protocol
    // content (batch digests, epoch-change data), so each unique content is
    // hashed once and the other N-1 requests are lookups.  Two maps keep
    // the domains separate (a host-fast hit must never shadow the same
    // bytes arriving as wave-eligible content, which must reach wave_log);
    // wave_memo doubles as the device-mirror dedup set.  Metering stays
    // honest: crypto_ns accrues only when SHA-256 actually runs.
    std::unordered_map<string, i32> host_memo;
    std::unordered_map<string, i32> wave_memo;
    // Cluster-shared app hash-chain DAG (see AppChain above).
    AppChain app_chain;
    // Reconfiguration points: (client_id, req_no, reconfiguration) applied
    // by every replica's app when that request commits.
    vector<std::tuple<i64, i64, ReconfigS>> reconfig_points;
    // Cluster-shared ack-wave ledger (see AckLedger above); enabled when
    // link latency is uniform (so send order == arrival order).
    AckLedger ack_ledger;
    // Device-authoritative crypto (docs/FastEngine.md "Device crypto"):
    // in device_hash_mode, wave-eligible digests are CONSUMED from device
    // collects — the engine pauses (wall-clock only; the simulated
    // schedule is untouched, so step counts stay bit-identical to mirror
    // mode) whenever the next event needs a digest not yet supplied.  In
    // streaming_auth_mode, signed-request verdicts arrive in lookahead
    // waves during the run instead of one pre-run bitmap.
    bool device_hash_mode = false;
    bool streaming_auth_mode = false;
    // Structured drop mangler (testengine/manglers.py DropMessages): drop
    // MsgReceived deliveries matching (from, to); empty set = match any.
    // The only mangler inside the fast envelope.
    bool drop_mangler = false;
    Mask drop_from, drop_to;
    bool drop_from_any = false, drop_to_any = false;

    bool drop_matches(i32 source, i32 target) const {
        if (source == target) return false;  // self-links stay reliable
        if (!drop_from_any && !drop_from.test(source)) return false;
        if (!drop_to_any && !drop_to.test(target)) return false;
        return true;
    }
    std::unordered_map<string, i32> device_digests;  // content -> digest id
    vector<string> need_hash_content;
    vector<std::pair<i64, i64>> need_verdicts;  // (client, verdicts needed up to)

    ClientSpec *spec_of(i64 client_id) {
        for (auto &cs : client_specs)
            if (cs.id == client_id) return &cs;
        return nullptr;
    }

    // Engine-wide hashing service (the hash plane): identical digests to
    // hashlib; wave-eligible content (multi-part or >= 512 B single part —
    // the complement of crypto.py::_host_fast) is mirrored for the device.
    // PDES runs (part != null) use partition-local memos/meters and skip
    // the device mirror (device modes are outside the PDES envelope).
    i32 hash_parts(const vector<string> &parts, Partition *part = nullptr) {
        auto &h_memo = part ? part->host_memo : host_memo;
        auto &w_memo = part ? part->wave_memo : wave_memo;
        u64 &c_ns = part ? part->crypto_ns : crypto_ns;
        if (hash_is_host_floor(parts)) {
            // Below the wave floor (host-only content).  Memo lookup keys
            // on the part itself — no copy on the hit path.
            auto hit = h_memo.find(parts[0]);
            if (hit != h_memo.end()) return hit->second;
            auto t0 = std::chrono::steady_clock::now();
            i32 r = ctx.intern.put(sha256(parts[0]));
            c_ns += (u64)std::chrono::duration_cast<std::chrono::nanoseconds>(
                             std::chrono::steady_clock::now() - t0)
                             .count();
            if (h_memo.size() > (1u << 17)) h_memo.clear();  // bounded
            h_memo.emplace(parts[0], r);
            return r;
        }
        string joined;
        for (const auto &p : parts) joined.append(p);
        if (device_hash_mode) {
            // The device is authoritative for wave-eligible content: no
            // host hash, no mirror log.  check_ready() guarantees the
            // digest was supplied before this event ran.
            auto dit = device_digests.find(joined);
            if (dit == device_digests.end())
                throw EngineError("device digest missing at hash time");
            return dit->second;
        }
        auto hit = w_memo.find(joined);
        if (hit != w_memo.end()) return hit->second;
        auto t0 = std::chrono::steady_clock::now();
        string digest = sha256(joined);
        i32 did = ctx.intern.put(digest);
        c_ns += (u64)std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
        // First sight of this wave content: mirror it for the device.  A
        // bounded-clear re-sight re-logs, which the Python side verifies
        // again harmlessly.  (PDES: no device plane, no mirror.)
        if (!part) wave_log.emplace_back(ctx.intern.put(joined), did);
        if (w_memo.size() > (1u << 17)) w_memo.clear();  // bounded
        w_memo.emplace(std::move(joined), did);
        return did;
    }

    void init_node_world(i32 node_id, const vector<ClientStateS> &init_clients) {
        EngineNode &node = *nodes[(size_t)node_id];
        node.state.ctx = &ctx;
        node.state.req_store = &node.req_store;
        node.state.chain = &app_chain;
        node.state.reconfig_points = &reconfig_points;
        i32 checkpoint_value =
            node.state.snap(ctx.intern, ctx.cfg_p, init_clients);
        register_snap(checkpoint_value, node.state);
        auto ns = node.state.checkpoint_state;
        node.wal.entries.clear();
        node.wal.low_index = 1;
        node.wal.entries.push_back(pe_c(0, checkpoint_value, ns));
        EpochCfgS cfg0;
        cfg0.number = 0;
        cfg0.leaders = ctx.cfg.nodes;
        cfg0.planned_expiration = 0;
        node.wal.entries.push_back(pe_f(cfg0));
    }

    void initialize_node(EngineNode &node) {
        node.work_items = std::make_unique<WorkItems>();
        node.clients = std::make_unique<ProcClients>();
        node.clients->request_store = &node.req_store;
        node.machine = std::make_unique<Machine>();
        node.machine->ctx = &ctx;
        for (auto &p : node.pending) p = false;
        // recover_wal_for_existing_node: init + load entries + complete.
        Events &ev = node.work_items->result_events;
        {
            EventS e;
            e.t = ET::InitialParameters;
            ev.push_back(std::move(e));
        }
        for (size_t i = 0; i < node.wal.entries.size(); i++) {
            EventS e;
            e.t = ET::LoadPersistedEntry;
            e.a = node.wal.low_index + (i64)i;
            e.payload = node.wal.entries[i];
            ev.push_back(std::move(e));
        }
        {
            EventS e;
            e.t = ET::LoadCompleted;
            ev.push_back(std::move(e));
        }
    }

    void schedule_proposal(i32 node_id, i64 client_id, i64 req_no,
                           i64 delay, Partition *part = nullptr) {
        EventQueue &q = part ? part->q : queue;
        SimEv ev;
        ev.time = q.fake_time + delay;
        ev.kind = SK::ClientProposal;
        ev.target = node_id;
        ev.client = client_id;
        ev.reqno = req_no;
        q.insert(std::move(ev));
    }

    Actions process_wal_actions(EngineNode &node, Actions &&actions) {
        Actions net_actions;
        for (auto &action : actions) {
            if (action.t == AT::Send) net_actions.push_back(std::move(action));
            else if (action.t == AT::Persist)
                node.wal.write(action.a, action.entry());
            else if (action.t == AT::Truncate)
                node.wal.truncate(action.a);
            else
                throw EngineError("unexpected WAL action type");
        }
        return net_actions;
    }

    // Bound ledger memory: drop waves every live receiver's cursor has
    // passed and canonical records below every receiver's low watermark.
    void prune_ledger() {
        u32 minv = UINT32_MAX;
        std::map<i64, i64> min_lw;
        for (const auto &np : nodes) {
            if (!np->machine || !np->machine->client_hash_disseminator)
                continue;
            Disseminator &d = *np->machine->client_hash_disseminator;
            if (!d.initialized) continue;
            if (d.led_view.version < minv) minv = d.led_view.version;
            for (const auto &pr : d.clients) {
                i64 lw = pr.second->client_state.lw;
                auto it = min_lw.find(pr.first);
                if (it == min_lw.end() || lw < it->second)
                    min_lw[pr.first] = lw;
            }
        }
        if (minv == UINT32_MAX) return;
        // Clear stale divergence marks on fully-retired records (below
        // every receiver's low watermark no window will ever cover them
        // again); fixes the owning receivers' counters so the fast gates
        // and prune() are not blocked by a missed release.
        for (auto &cp : ctx.ack_ledger->clients) {
            auto it = min_lw.find(cp.first);
            if (it == min_lw.end()) continue;
            CanonClient &cc = cp.second;
            for (i64 rn = cc.base; rn >= 0 && rn < it->second &&
                                   rn - cc.base < (i64)cc.recs.size();
                 rn++) {
                CanonRec &R = cc.recs[(size_t)(rn - cc.base)];
                if (!R.diverged.any()) continue;
                for (size_t r = 0; r < nodes.size(); r++) {
                    if (!R.diverged.test((i64)r)) continue;
                    R.diverged.clearbit((i64)r);
                    EngineNode &dn = *nodes[r];
                    if (!dn.machine || !dn.machine->client_hash_disseminator)
                        continue;
                    ClientD *dc =
                        dn.machine->client_hash_disseminator->client(cp.first);
                    if (dc && !dc->led_classic) {
                        dc->led_diverged -= 1;
                        dn.machine->client_hash_disseminator
                            ->led_diverged_total -= 1;
                    }
                }
            }
        }
        ctx.ack_ledger->prune(minv, min_lw);
    }

    Events process_net_actions(EngineNode &node, Actions &&actions,
                               Partition *part = nullptr) {
        EventQueue &q = part ? part->q : queue;
        Events events;
        u64 t0 = __rdtsc();
        auto coalesced = coalesce_sends(std::move(actions));
        g_parts[3].fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
        for (auto &action : coalesced) {
            MsgP m = action.msg();
            // Register broadcast ack waves in the cluster ledger at send
            // time (send order == arrival order under uniform latency), so
            // receivers consume them as cursor bumps + crossing replays.
            // (PDES runs require the ledger disabled.)
            if (ctx.ack_ledger != nullptr &&
                (action.targets == ctx.bcast || *action.targets == *ctx.bcast)) {
                if (part) {
                    // PDES window: provisional registration in this
                    // partition's shard, tagged with the sending step's
                    // plog index so the barrier folds it into the global
                    // ledger at the exact replay position.  Pruning is
                    // deferred to the (serial) barrier.
                    if (part->plog.empty())
                        throw EngineError("pdes ledger: send outside step");
                    u32 at = (u32)(part->plog.size() - 1);
                    if (m->t == MT::AckBatch || m->t == MT::AckMsg) {
                        part->shard->register_msg_lite(m, node.id, at);
                    } else if (m->t == MT::MsgBatch) {
                        for (const auto &im : m->inner)
                            if (im->t == MT::AckBatch || im->t == MT::AckMsg)
                                part->shard->register_msg_lite(im, node.id,
                                                               at);
                    }
                } else {
                    if (m->t == MT::AckBatch || m->t == MT::AckMsg) {
                        ctx.ack_ledger->register_msg(m, node.id);
                    } else if (m->t == MT::MsgBatch) {
                        for (const auto &im : m->inner)
                            if (im->t == MT::AckBatch || im->t == MT::AckMsg)
                                ctx.ack_ledger->register_msg(im, node.id);
                    }
                    if (ctx.ack_ledger->waves.size() >= 256) prune_ledger();
                }
            }
            for (i32 replica : *action.targets) {
                if (replica == node.id) {
                    EventS e;
                    e.t = ET::Step;
                    e.digest = replica;
                    e.payload = m;
                    events.push_back(std::move(e));
                } else {
                    if (drop_mangler && drop_matches(node.id, replica))
                        continue;  // mangled away (DropMessages)
                    SimEv ev;
                    ev.time = q.fake_time + node.runtime.link_lat(replica);
                    ev.kind = SK::MsgReceived;
                    ev.target = replica;
                    ev.src = node.id;
                    ev.msg = m;
                    if (part && part_of[(size_t)replica] != part->id) {
                        // Cross-partition send: stamp the provisional
                        // birth key from the same monotone source as heap
                        // inserts (the interleaved insertion order is the
                        // global one) and hold it for barrier delivery.
                        ev.bt = q.fake_time;
                        ev.ctr = part->prov_counter++;
                        part->outbox.push_back(std::move(ev));
                    } else {
                        q.insert(std::move(ev));
                    }
                }
            }
        }
        return events;
    }

    Events process_hash_actions(Actions &&actions, Partition *part = nullptr) {
        Events events;
        for (auto &action : actions) {
            if (action.t != AT::Hash)
                throw EngineError("unexpected Hash action type");
            HashReqP hr = action.hash();
            i32 digest = hash_parts(hr->parts, part);
            EventS e;
            e.t = ET::HashResult;
            e.digest = digest;
            e.payload = shared_ptr<const HashOriginS>(hr, &hr->origin);
            events.push_back(std::move(e));
        }
        return events;
    }

    Events process_app_actions(EngineNode &node, Actions &&actions,
                               Partition *part = nullptr) {
        Events events;
        for (auto &action : actions) {
            if (action.t == AT::Commit) {
                QEntryP q = action.qentry();
                if (pdes_threaded) {
                    std::lock_guard<std::mutex> lk(chain_mu);
                    node.state.apply(*q, ctx.intern);
                } else {
                    node.state.apply(*q, ctx.intern);
                }
                (part ? part->committed_ops : committed_ops) +=
                    (i64)q->reqs.size();
                note_commits(node, *q, part);
            } else if (action.t == AT::Checkpoint) {
                i32 value;
                if (pdes_threaded) {
                    std::lock_guard<std::mutex> lk(chain_mu);
                    value = node.state.snap(ctx.intern, action.cfg,
                                            *action.cstates());
                } else {
                    value = node.state.snap(ctx.intern, action.cfg,
                                            *action.cstates());
                }
                register_snap(value, node.state);
                refresh_node_ready(node, part);
                EventS e;
                e.t = ET::CheckpointResult;
                e.a = action.a;
                e.digest = value;
                e.payload = node.state.checkpoint_state;
                events.push_back(std::move(e));
            } else if (action.t == AT::StateTransfer) {
                // NodeState.transfer_to (testengine/recorder.py:189-206)
                // with the engine's app-level failure injection.  (Reachable
                // in PDES runs too: a lagging replica may transfer even on
                // the green path, hence the snap-registry lock below.)
                node.state.transfer_attempt_times.push_back(
                    (part ? part->q : queue).fake_time);
                i64 seq = action.a;
                i32 value = (i32)action.b;
                if (node.state.fail_transfers > 0) {
                    node.state.fail_transfers -= 1;
                    node.state.transfer_failures.push_back(seq);
                    EventS e;
                    e.t = ET::StateTransferFailed;
                    e.a = seq;
                    e.digest = value;
                    events.push_back(std::move(e));
                    continue;
                }
                std::unique_lock<std::mutex> snap_lk(snap_mu,
                                                     std::defer_lock);
                if (pdes_threaded) snap_lk.lock();
                auto sit = snap_registry.find(value);
                if (sit == snap_registry.end())
                    throw EngineError(
                        "transfer target value never snapped in this engine");
                node.state.state_transfers.push_back(seq);
                node.state.last_seq_no = seq;
                node.state.checkpoint_seq_no = seq;
                node.state.checkpoint_state = sit->second.second;
                node.state.checkpoint_hash =
                    ctx.intern.get(value).substr(0, 32);
                node.state.chain_id = sit->second.first;
                // Skipped batches are never applied: this node's floors
                // now lag the chain's canonical ones for good.
                node.state.floors_canonical = false;
                refresh_node_ready(node, part);
                EventS e;
                e.t = ET::StateTransferComplete;
                e.a = seq;
                e.digest = value;
                e.payload = node.state.checkpoint_state;
                events.push_back(std::move(e));
            } else {
                throw EngineError("unexpected App action type");
            }
        }
        return events;
    }

    // Checkpoint value id -> (chain node, network state): every value a
    // state transfer can target was produced by some replica's snap in this
    // engine, so the app-side decode is a content-addressed lookup.
    std::unordered_map<i32, std::pair<i32, NetStateP>> snap_registry;

    void register_snap(i32 value, const AppState &state) {
        if (pdes_threaded) {
            std::lock_guard<std::mutex> lk(snap_mu);
            snap_registry.emplace(
                value, std::make_pair(state.chain_id, state.checkpoint_state));
            return;
        }
        snap_registry.emplace(value,
                              std::make_pair(state.chain_id,
                                             state.checkpoint_state));
    }

    Actions process_state_machine_events(EngineNode &node, Events &&events,
                                         Partition *part = nullptr) {
        Actions actions;
        for (const auto &event : events) {
            if (event.t == ET::InitialParameters) {
                node.machine->initialize(node.init_parms);
                continue;
            }
            if (part) {
                concat(actions, node.machine->apply_event(event));
                continue;
            }
            u64 t0 = __rdtsc();
            concat(actions, node.machine->apply_event(event));
            u64 dt = __rdtsc() - t0;
            ev_cycles[(int)event.t] += dt;
            ev_counts[(int)event.t] += 1;
            if (event.t == ET::Step && event.payload) {
                const MsgS *m = (const MsgS *)event.payload.get();
                msg_cycles[(int)m->t] += dt;
                msg_counts[(int)m->t] += 1;
            }
        }
        EventS marker;
        marker.t = ET::ActionsReceived;
        concat(actions, node.machine->apply_event(marker));
        return actions;
    }

    void step(Partition *part = nullptr);
    i64 run(i64 max_steps, i64 timeout, bool *done, bool *timed_out,
            bool *need_device);
    PdesResult run_pdes(i64 partitions, bool threaded, i64 timeout,
                        i64 stop_time, i64 stop_steps);
    // Envelope probe: empty string = this engine can run under PDES with
    // the given partition count; otherwise a structured reason of the form
    // "pdes_envelope[<code>]: <detail>" (the Python layer parses the code
    // into PdesEnvelopeUnsupported.reason).
    string pdes_check(i64 partitions) const;
    void pdes_setup(i64 partitions, bool threaded);
    // Conservative lookahead for a partition assignment: the smallest
    // latency on any link that can carry a cross-partition message (with
    // the ledger live, the smallest inter-node latency outright — wave
    // registration order must fold once per window).
    i64 pdes_lookahead_for(const vector<i32> &assign) const;
    // Traffic-aware rebalancing at a barrier (all keys final, outboxes
    // empty): recompute part_of from the node-load EWMA, migrate queued
    // events, refresh pdes_W.  Returns true if the assignment changed.
    bool pdes_repartition(double imbalance);
    void pdes_window(Partition &part, i64 window_start, i64 window_end,
                     i64 step_cap);
    // Barrier replay: finalize birth-key ranks, deliver cross-partition
    // sends, fold stats and drain flips in exact global order.  Returns
    // the global step index (1-based) at which the drain predicate first
    // held, or -1.
    i64 pdes_barrier(i64 window_start, i64 *flip_time);

    // Inspect the queue head: does the next event need device results the
    // wrapper has not supplied yet?  Fills need_hash_content /
    // need_verdicts when so.  Consumes nothing; the simulated schedule is
    // independent of the pause.
    i64 ready_head_ctr = -1;  // head already vetted (pause/resume path)

    // Deep device-work scan (device-authoritative stall collapse,
    // docs/PERFORMANCE.md §9): every unsupplied wave-eligible content in
    // ANY queued ProcessHash event — not just the head's — so one pause
    // serves a whole generation of future waves in one dispatch+collect.
    // Batch contents carry no dependency on earlier device digests, so
    // everything visible is dispatchable immediately.
    void collect_pending_hash_deep(deque<string> &out) {
        // string_views over stable storage (need_hash_content is untouched
        // here; out is a deque, so grown elements keep their addresses).
        std::set<std::string_view> seen;
        for (const auto &c : need_hash_content) seen.insert(c);
        for (const auto &ev : queue.heap) {
            if (ev.kind != SK::ProcessHash || !ev.actions) continue;
            for (const auto &action : *ev.actions) {
                if (action.t != AT::Hash) continue;
                HashReqP hr = action.hash();
                if (hr->scan_state == 2) continue;
                if (hr->scan_state == 0) {
                    if (hash_is_host_floor(hr->parts)) {
                        hr->scan_state = 2;
                        continue;
                    }
                    for (const auto &p : hr->parts)
                        hr->scan_join.append(p);
                    hr->scan_state = 1;
                }
                if (device_digests.find(hr->scan_join) !=
                    device_digests.end()) {
                    hr->scan_state = 2;
                    hr->scan_join.clear();
                    hr->scan_join.shrink_to_fit();
                    continue;
                }
                if (seen.count(hr->scan_join)) continue;
                out.push_back(hr->scan_join);
                seen.insert(out.back());
            }
        }
    }

    bool check_ready() {
        if (!device_hash_mode && !streaming_auth_mode) return true;
        if (queue.heap.empty()) return true;
        const SimEv &head = queue.heap.front();
        if (head.ctr == ready_head_ctr) return true;
        need_hash_content.clear();
        need_verdicts.clear();
        if (device_hash_mode && head.kind == SK::ProcessHash) {
            for (const auto &action : *head.actions) {
                if (action.t != AT::Hash) continue;
                HashReqP hr = action.hash();
                const vector<string> &parts = hr->parts;
                if (hash_is_host_floor(parts)) continue;
                string joined;
                for (const auto &p : parts) joined.append(p);
                if (device_digests.find(joined) != device_digests.end())
                    continue;
                bool dup = false;  // same content twice in one event batch
                for (const auto &c : need_hash_content)
                    if (c == joined) { dup = true; break; }
                if (!dup) need_hash_content.push_back(std::move(joined));
            }
        }
        if (streaming_auth_mode && head.kind == SK::ClientProposal) {
            ClientSpec *cs = spec_of(head.client);
            if (cs && cs->signed_mode) {
                i64 need_to = std::min(head.reqno + (i64)PROPOSAL_CHUNK,
                                       cs->total);
                if ((i64)cs->verdicts.size() < need_to)
                    need_verdicts.emplace_back(head.client, need_to);
            }
        }
        bool ready = need_hash_content.empty() && need_verdicts.empty();
        if (ready) ready_head_ctr = head.ctr;
        return ready;
    }
    bool drained() const {
        return nodes_not_ready == 0 && clients_unsatisfied == 0;
    }
    bool node_lws_ready(const EngineNode &node) const {
        if (!node.state.checkpoint_state) return false;
        for (const auto &cs : node.state.checkpoint_state->clients) {
            auto it = drain_targets.find(cs.id);
            if (it != drain_targets.end() && it->second != cs.lw)
                return false;
        }
        return true;
    }
    void refresh_node_ready(EngineNode &node, Partition *part = nullptr) {
        bool ready = node_lws_ready(node);
        if (ready != node.drain_ready) {
            node.drain_ready = ready;
            if (part) {
                // PDES: the global counter is folded at the barrier, in
                // exact merged order (a node lives in one partition, so
                // its flag itself is safe to flip here).  Kind 1 = became
                // ready, kind 2 = regressed (e.g. a state transfer
                // installing a snapshot short of the targets).
                part->flips.push_back({(u32)part->plog.size() - 1,
                                       (u8)(ready ? 1 : 2), (i64)node.id});
            } else {
                nodes_not_ready += ready ? -1 : 1;
            }
        }
    }
    void note_commits(const EngineNode &node, const QEntryS &batch,
                      Partition *part = nullptr) {
        for (const auto &req : batch.reqs) {
            auto sit = client_satisfied.find(req.client);
            if (sit == client_satisfied.end() || sit->second) continue;
            auto tit = drain_targets.find(req.client);
            auto cit = node.state.committed_reqs.find(req.client);
            if (cit != node.state.committed_reqs.end() &&
                cit->second >= tit->second) {
                if (part) {
                    // Candidate only: client_satisfied stays untouched
                    // until the barrier (two partitions may both cross a
                    // client's threshold in one window; the replay keeps
                    // the globally-first and drops the rest).
                    part->flips.push_back(
                        {(u32)part->plog.size() - 1, 0, req.client});
                } else {
                    sit->second = true;
                    clients_unsatisfied -= 1;
                }
            }
        }
    }
};

void Engine::step(Partition *part) {
    u64 t_start = __rdtsc();
    EventQueue &queue = part ? part->q : this->queue;
    i64 plog_prov_start = part ? part->prov_counter : 0;
    SimEv event = queue.consume();
    if (part) {
        // Log the processed event's identity for the barrier replay.  The
        // key is provisional iff the event was born inside the current
        // window; births are the prov-id range consumed while processing.
        Partition::PLogE e;
        e.time = event.time;
        e.bt = event.bt;
        e.rank = event.ctr;
        e.prov_start = plog_prov_start;
        e.births = 0;  // patched below
        e.prov = event.bt >= part->window_start ? 1 : 0;
        part->plog.push_back(e);
    }
    EngineNode &node = *nodes[(size_t)event.target];
    const RuntimeParms &parms = node.runtime;
    // Ledger-on PDES: point the node's overlay slot at its partition's
    // shard for the duration of this step (null for sequential/tail
    // steps — led paths then read the global ledger alone).
    if (node.machine && node.machine->client_hash_disseminator)
        node.machine->client_hash_disseminator->led_shard =
            part && part->shard ? part->shard.get() : nullptr;

    switch (event.kind) {
        case SK::Initialize: {
            queue.remove_events_for(node.id);
            if (part)
                part->purges.push_back(
                    {(u32)(part->plog.size() - 1), node.id});
            if (event.init) {
                // Crash-and-restart: reboot under the event's parameters.
                // The restarted node missed ack-ledger wave prefixes while
                // down, so it consumes classically from here on.
                bool classic =
                    node.init_parms.led_classic || ctx.ack_ledger != nullptr;
                node.init_parms = *event.init;
                node.init_parms.led_classic = classic;
            }
            initialize_node(node);
            if (node.machine && node.machine->client_hash_disseminator)
                node.machine->client_hash_disseminator->led_shard =
                    part && part->shard ? part->shard.get() : nullptr;
            {
                SimEv tick;
                tick.time = queue.fake_time + parms.tick_interval;
                tick.kind = SK::Tick;
                tick.target = node.id;
                queue.insert(std::move(tick));
            }
            std::map<i64, const ClientStateS *> state_clients;
            for (const auto &cs : node.state.checkpoint_state->clients)
                state_clients.emplace(cs.id, &cs);
            for (const auto &client : client_specs) {
                if (client.ignore_nodes.count(node.id)) continue;
                auto it = state_clients.find(client.id);
                i64 start_req = it != state_clients.end() ? it->second->lw : 0;
                if (start_req < client.total)
                    schedule_proposal(node.id, client.id, start_req,
                                      parms.client_latency, part);
            }
            break;
        }
        case SK::MsgReceived: {
            if (node.machine) {
                EventS e;
                e.t = ET::Step;
                e.digest = event.src;
                e.payload = std::move(event.msg);
                node.work_items->result_events.push_back(std::move(e));
            }
            break;
        }
        case SK::ClientProposal: {
            ProcClient *client = node.clients->client(event.client);
            ClientSpec *sim_client = spec_of(event.client);
            if (!sim_client || sim_client->ignore_nodes.count(node.id))
                throw EngineError("node should be skipped by client");
            i64 req_no = event.reqno;
            bool broke = false;
            for (int k = 0; k < PROPOSAL_CHUNK; k++) {
                if (client->empty()) {
                    // ClientNotExistError: retry later.
                    schedule_proposal(node.id, event.client, req_no,
                                      parms.client_latency * 100, part);
                    broke = true;
                    break;
                }
                i64 next_req_no = client->next_req_no_value();
                if (next_req_no != req_no) {
                    if (next_req_no < sim_client->total)
                        schedule_proposal(node.id, event.client, next_req_no,
                                          parms.client_latency, part);
                    broke = true;
                    break;
                }
                if (sim_client->signed_mode &&
                    !(req_no < (i64)sim_client->verdicts.size() &&
                      sim_client->verdicts[(size_t)req_no])) {
                    // Forged/corrupt proposal: reject (skips the
                    // work-scheduling scan, like the Python `return`).
                    return;
                }
                AckS persisted_ack{0, 0, 0};
                if (client->propose(req_no,
                                    sim_client->payload_digests[(size_t)req_no],
                                    &persisted_ack)) {
                    EventS e;
                    e.t = ET::RequestPersisted;
                    e.ack = persisted_ack;
                    node.work_items->req_store_events.push_back(std::move(e));
                }
                req_no += 1;
                if (req_no >= sim_client->total) {
                    broke = true;
                    break;  // no more requests from this client
                }
            }
            if (!broke)
                schedule_proposal(node.id, event.client, req_no,
                                  parms.client_latency, part);
            break;
        }
        case SK::Tick: {
            EventS e;
            e.t = ET::TickElapsed;
            node.work_items->result_events.push_back(std::move(e));
            SimEv tick;
            tick.time = queue.fake_time + parms.tick_interval;
            tick.kind = SK::Tick;
            tick.target = node.id;
            queue.insert(std::move(tick));
            break;
        }
        case SK::ProcessReqStore: {
            // req_store.sync() is a no-op; events pass through.
            for (auto &e : *event.events)
                node.work_items->result_events.push_back(std::move(e));
            node.pending[5] = false;
            break;
        }
        case SK::ProcessResult: {
            Actions actions =
                process_state_machine_events(node, std::move(*event.events), part);
            node.work_items->add_state_machine_results(std::move(actions));
            node.pending[6] = false;
            break;
        }
        case SK::ProcessWal: {
            Actions net =
                process_wal_actions(node, std::move(*event.actions));
            for (auto &a : net)
                node.work_items->net_actions.push_back(std::move(a));
            node.pending[0] = false;
            break;
        }
        case SK::ProcessNet: {
            Events events =
                process_net_actions(node, std::move(*event.actions), part);
            for (auto &e : events)
                node.work_items->result_events.push_back(std::move(e));
            node.pending[1] = false;
            break;
        }
        case SK::ProcessHash: {
            Events events = process_hash_actions(std::move(*event.actions), part);
            for (auto &e : events)
                node.work_items->result_events.push_back(std::move(e));
            node.pending[3] = false;
            break;
        }
        case SK::ProcessClient: {
            Events events =
                node.clients->process_client_actions(*event.actions);
            for (auto &e : events)
                node.work_items->req_store_events.push_back(std::move(e));
            node.pending[2] = false;
            break;
        }
        case SK::ProcessApp: {
            Events events =
                process_app_actions(node, std::move(*event.actions), part);
            for (auto &e : events)
                node.work_items->result_events.push_back(std::move(e));
            node.pending[4] = false;
            break;
        }
    }

    if (part) {
        u64 dt = __rdtsc() - t_start;
        part->work_cycles += dt;
        part->node_cycles[(size_t)event.target] += dt;
    } else {
        kind_cycles[(int)event.kind] += __rdtsc() - t_start;
        kind_counts[(int)event.kind] += 1;
    }

    if (!node.work_items) {
        if (part)
            part->plog.back().births =
                (u32)(part->prov_counter - plog_prov_start);
        return;
    }

    // Schedule processing for non-empty categories with no batch in flight
    // (same order as recorder.py:742-749).
    WorkItems &work = *node.work_items;
    struct Cat {
        int idx;
        bool is_events;
        SK kind;
        i64 latency;
    };
    const Cat cats[7] = {
        {0, false, SK::ProcessWal, parms.wal_latency},
        {1, false, SK::ProcessNet, parms.net_latency},
        {2, false, SK::ProcessClient, parms.client_latency},
        {3, false, SK::ProcessHash, parms.hash_latency},
        {4, false, SK::ProcessApp, parms.app_latency},
        {5, true, SK::ProcessReqStore, parms.req_store_latency},
        {6, true, SK::ProcessResult, parms.events_latency},
    };
    Actions *action_batches[5] = {&work.wal_actions, &work.net_actions,
                                  &work.client_actions, &work.hash_actions,
                                  &work.app_actions};
    Events *event_batches[2] = {&work.req_store_events, &work.result_events};
    for (const Cat &cat : cats) {
        if (node.pending[cat.idx]) continue;
        if (!cat.is_events) {
            Actions *batch = action_batches[cat.idx];
            if (batch->empty()) continue;
            node.pending[cat.idx] = true;
            SimEv ev;
            ev.time = queue.fake_time + cat.latency;
            ev.kind = cat.kind;
            ev.target = node.id;
            ev.actions = std::make_shared<Actions>(std::move(*batch));
            batch->clear();
            queue.insert(std::move(ev));
        } else {
            Events *batch = event_batches[cat.idx - 5];
            if (batch->empty()) continue;
            node.pending[cat.idx] = true;
            SimEv ev;
            ev.time = queue.fake_time + cat.latency;
            ev.kind = cat.kind;
            ev.target = node.id;
            ev.events = std::make_shared<Events>(std::move(*batch));
            batch->clear();
            queue.insert(std::move(ev));
        }
    }
    if (part)
        part->plog.back().births =
            (u32)(part->prov_counter - plog_prov_start);
}

i64 Engine::run(i64 max_steps, i64 timeout, bool *done, bool *timed_out,
                bool *need_device) {
    *done = false;
    *timed_out = false;
    *need_device = false;
    i64 executed = 0;
    while (executed < max_steps) {
        if (!check_ready()) {
            *need_device = true;
            return executed;
        }
        steps += 1;
        executed += 1;
        step();
        if (drained()) {
            *done = true;
            return executed;
        }
        if (steps > timeout) {
            *timed_out = true;
            return executed;
        }
    }
    return executed;
}

// ---------------------------------------------------------------------------
// PDES run modes (docs/PERFORMANCE.md §7.1).  The simulation is bit-
// identical to the sequential engine: each window is processed partition-
// locally under provisional birth keys, and the barrier replay reconstructs
// the exact global order (see struct Partition above).  Two modes:
//
// * measurement (stop_steps < 0): run until the drain predicate first
//   holds, detected at the following barrier.  The returned step count and
//   fake-time are EXACT (computed from the replay); the engine state
//   overshoots by at most one window, so node summaries are not the
//   drain-step state.  This is the bench mode.
// * exact (stop_time/stop_steps from a prior run): process full windows
//   strictly before stop_time, then merge every partition queue into the
//   sequential queue and finish single-threaded to exactly stop_steps.
//   Node summaries then match the sequential engine bit-for-bit.
// ---------------------------------------------------------------------------

string Engine::pdes_check(i64 partitions) const {
    // Structured envelope probe (empty = eligible).  Codes are stable API:
    // the Python layer parses "pdes_envelope[<code>]" into
    // PdesEnvelopeUnsupported.reason, and bench.py keys c3_pdes_envelope
    // off them.  The structured DropMessages mangler IS in the envelope:
    // it applies at the SEND site (process_net_actions), which is
    // partition-local and deterministic — no RNG, no queue surgery.
    // Start delays and ignored nodes are in the envelope too: boot-time
    // queue purges replay exactly (see Partition::Purge), ignore sets are
    // partition-local, and a late-boot node consumes acks classically
    // when the ledger is live (led_classic at construction).
    if (!parts.empty())
        return "pdes_envelope[state]: pdes already initialized";
    if (steps != 0 || queue.fake_time != 0)
        return "pdes_envelope[state]: pdes requires a fresh engine";
    if (queue.mangler)
        return "pdes_envelope[mangler]: no consume-time manglers";
    if (device_hash_mode || streaming_auth_mode)
        return "pdes_envelope[device]: no device-paced modes";
    if (!reconfig_points.empty())
        return "pdes_envelope[reconfig]: no reconfiguration";
    for (const auto &np : nodes) {
        if (np->state.fail_transfers > 0)
            return "pdes_envelope[transfer_fail]: "
                   "no transfer-failure injection";
        if (np->runtime.link_latency < 1)
            return "pdes_envelope[latency]: link latency must be positive";
        for (size_t d = 0; d < np->runtime.lat_to.size(); d++)
            if ((i64)d != (i64)np->id && np->runtime.lat_to[d] < 1)
                return "pdes_envelope[latency]: "
                       "link latency must be positive";
    }
    if (partitions < 1 || partitions > (i64)nodes.size())
        return "pdes_envelope[partitions]: "
               "partitions must be in [1, node count]";
    return "";
}

i64 Engine::pdes_lookahead_for(const vector<i32> &assign) const {
    const i64 N = (i64)nodes.size();
    i64 w = INT64_MAX;
    for (i64 j = 0; j < N; j++) {
        const RuntimeParms &rt = nodes[(size_t)j]->runtime;
        for (i64 k = 0; k < N; k++) {
            if (j == k) continue;
            if (ctx.ack_ledger == nullptr &&
                assign[(size_t)j] == assign[(size_t)k])
                continue;
            w = std::min(w, rt.link_lat(k));
        }
    }
    if (w == INT64_MAX) {
        // Single partition, ledger off: no link constrains the window;
        // fall back to the smallest inter-node latency so window/barrier
        // cadence (and stats) stay comparable across partition counts.
        for (i64 j = 0; j < N; j++)
            for (i64 k = 0; k < N; k++)
                if (j != k)
                    w = std::min(w, nodes[(size_t)j]->runtime.link_lat(k));
        if (w == INT64_MAX) w = nodes[0]->runtime.link_latency;
    }
    return w;
}

void Engine::pdes_setup(i64 partitions, bool threaded) {
    string reason = pdes_check(partitions);
    if (!reason.empty()) throw EngineError(reason);
    pdes_threaded = threaded;
    if (threaded) ctx.intern.mu = &intern_mu;
    i64 N = (i64)nodes.size();
    part_of.assign((size_t)N, 0);
    node_load.assign((size_t)N, 0.0);
    for (i64 p = 0; p < partitions; p++) {
        auto part = std::make_unique<Partition>();
        part->id = (i32)p;
        part->q.stamp_mode = EventQueue::PDES;
        part->q.prov = &part->prov_counter;
        part->node_cycles.assign((size_t)N, 0);
        if (ctx.ack_ledger != nullptr) {
            part->shard = std::make_unique<AckShard>();
            part->shard->global = ctx.ack_ledger;
        }
        parts.push_back(std::move(part));
    }
    if (ctx.ack_ledger != nullptr) {
        // Pre-populate every client and its full reachable record range:
        // during windows partition threads may only READ the global
        // ledger's structure (operator[] inserts and rec_or_create
        // extensions would race); req_no never exceeds a sender's high
        // watermark <= total + width.
        for (const auto &ic : ctx.init_clients) {
            CanonClient &cc = ctx.ack_ledger->client(ic.id);
            i64 total = 0;
            const ClientSpec *cs = spec_of(ic.id);
            if (cs) total = cs->total;
            cc.rec_or_create(0);
            cc.rec_or_create(total + 2 * ic.width + 16);
        }
    }
    for (i64 i = 0; i < N; i++)
        part_of[(size_t)i] = (i32)(i * partitions / N);
    pdes_W = pdes_lookahead_for(part_of);
    // Distribute genesis events, restamped to birth time -1 (before any
    // in-run birth, so window-0 births cannot collide with their keys).
    for (auto &ev : queue.heap) {
        ev.bt = -1;
        Partition &pp = *parts[(size_t)part_of[(size_t)ev.target]];
        pp.q.heap.push_back(std::move(ev));
    }
    queue.heap.clear();
    for (auto &pp : parts)
        std::make_heap(pp->q.heap.begin(), pp->q.heap.end(), SimEvCmp());
}

bool Engine::pdes_repartition(double imbalance) {
    const size_t P = parts.size();
    const i64 N = (i64)nodes.size();
    double total = 0;
    for (i64 i = 0; i < N; i++) total += node_load[(size_t)i];
    if (total <= 0) return false;
    // Weights: the node-load EWMA, floored so currently-idle nodes still
    // count (they own future traffic once their clients rotate in).
    vector<double> w((size_t)N);
    double floor_w = total / (double)(N * 64);
    for (i64 i = 0; i < N; i++)
        w[(size_t)i] = std::max(node_load[(size_t)i], floor_w);
    bool nonuniform = false;
    for (const auto &np : nodes)
        if (!np->runtime.lat_to.empty()) nonuniform = true;
    vector<vector<i32>> cands;
    {
        // Contiguous weighted split: preserves index locality (regional
        // latency matrices are index-contiguous), which is what keeps the
        // cross-partition lookahead wide on WAN topologies.
        vector<i32> c((size_t)N, 0);
        double tw = 0;
        for (double x : w) tw += x;
        double per = tw / (double)P;
        double acc = 0;
        i32 cur = 0;
        i64 in_cur = 0;
        for (i64 i = 0; i < N; i++) {
            i64 remaining = N - i;
            if (cur < (i32)P - 1 && in_cur > 0 &&
                (acc >= per * (double)(cur + 1) ||
                 remaining == (i64)P - 1 - (i64)cur)) {
                cur += 1;
                in_cur = 0;
            }
            c[(size_t)i] = cur;
            in_cur += 1;
            acc += w[(size_t)i];
        }
        cands.push_back(std::move(c));
    }
    if (!nonuniform) {
        // LPT greedy onto the least-loaded partition (uniform latency:
        // any assignment keeps the same lookahead).
        vector<i64> order((size_t)N);
        for (i64 i = 0; i < N; i++) order[(size_t)i] = i;
        std::sort(order.begin(), order.end(), [&](i64 a, i64 b) {
            if (w[(size_t)a] != w[(size_t)b])
                return w[(size_t)a] > w[(size_t)b];
            return a < b;
        });
        vector<i32> c((size_t)N, 0);
        vector<double> bin(P, 0.0);
        for (i64 i : order) {
            size_t best = 0;
            for (size_t b = 1; b < P; b++)
                if (bin[b] < bin[best]) best = b;
            c[(size_t)i] = (i32)best;
            bin[best] += w[(size_t)i];
        }
        cands.push_back(std::move(c));
        // Round-robin interleave: bucket ownership rotates through
        // consecutive node ids, so a commit sweep's hot neighbors land in
        // different partitions — this balances each window's burst, which
        // total-weight balancing cannot see.
        vector<i32> rr((size_t)N);
        for (i64 i = 0; i < N; i++) rr[(size_t)i] = (i32)(i % (i64)P);
        cands.push_back(std::move(rr));
    }
    // Score = the objective itself on recent history: sum over kept
    // windows of that window's critical path (max partition member-cycle
    // sum) under the assignment.  The incumbent competes on the same
    // history, and migration isn't free, so switching needs a real win.
    auto score = [&](const vector<i32> &asn) {
        double s = 0;
        vector<double> bin(P, 0.0);
        for (const auto &hv : node_hist) {
            std::fill(bin.begin(), bin.end(), 0.0);
            for (i64 i = 0; i < N; i++)
                bin[(size_t)asn[(size_t)i]] += (double)hv[(size_t)i];
            s += *std::max_element(bin.begin(), bin.end());
        }
        return s;
    };
    const double cur_score = score(part_of);
    const vector<i32> *chosen = nullptr;
    double chosen_score = cur_score;
    for (const auto &c : cands) {
        if (c == part_of) continue;
        // Never trade lookahead for balance unless the imbalance is
        // severe: a narrower window multiplies barrier count for every
        // partition.
        if (pdes_lookahead_for(c) < pdes_W && imbalance <= 2.0) continue;
        double s = score(c);
        if (s < chosen_score) {
            chosen_score = s;
            chosen = &c;
        }
    }
    if (chosen == nullptr || chosen_score > 0.97 * cur_score) return false;
    const vector<i32> cand = *chosen;
    // Migrate queued events.  Safe at a barrier: every pending key is
    // final, outboxes are empty, plogs are cleared.
    vector<vector<SimEv>> moved(P);
    for (size_t p = 0; p < P; p++) {
        auto &hp = parts[p]->q.heap;
        size_t keep = 0;
        for (size_t k = 0; k < hp.size(); k++) {
            size_t np2 = (size_t)cand[(size_t)hp[k].target];
            if (np2 == p) {
                if (keep != k) hp[keep] = std::move(hp[k]);
                keep += 1;
            } else {
                moved[np2].push_back(std::move(hp[k]));
            }
        }
        hp.resize(keep);
    }
    for (size_t p = 0; p < P; p++) {
        auto &hp = parts[p]->q.heap;
        for (auto &ev : moved[p]) hp.push_back(std::move(ev));
        std::make_heap(hp.begin(), hp.end(), SimEvCmp());
    }
    part_of = cand;
    pdes_W = pdes_lookahead_for(part_of);
    return true;
}

void Engine::pdes_window(Partition &part, i64 window_start, i64 window_end,
                         i64 step_cap) {
    part.window_start = window_start;
    part.prov_base = part.prov_counter;
    EventQueue &q = part.q;
    while (!q.heap.empty() && q.heap.front().time < window_end) {
        step(&part);
        part.steps += 1;
        if (part.steps > step_cap)
            throw EngineError("pdes: window step runaway (timeout)");
    }
}

i64 Engine::pdes_barrier(i64 window_start, i64 *flip_time) {
    const size_t P = parts.size();
    // prov id -> final rank, per partition (dense, window-scoped).  The
    // buffers are engine members: capacity persists across windows, so
    // the per-barrier cost is an assign(), not an allocation.
    auto &fin = pdes_fin;
    auto &logi = pdes_logi;
    auto &flipi = pdes_flipi;
    auto &purgei = pdes_purgei;
    if (fin.size() < P) fin.resize(P);
    logi.assign(P, 0);
    flipi.assign(P, 0);
    purgei.assign(P, 0);
    for (size_t p = 0; p < P; p++)
        fin[p].assign(
            (size_t)(parts[p]->prov_counter - parts[p]->prov_base), -1);
    auto resolved = [&](size_t p, const Partition::PLogE &e) -> i64 {
        if (!e.prov) return e.rank;
        i64 r = fin[p][(size_t)(e.rank - parts[p]->prov_base)];
        if (r < 0) throw EngineError("pdes: unresolved rank in merge");
        return r;
    };
    // Incremental k-way merge: a binary min-heap of partition heads keyed
    // (time, bt, resolved rank) replaces the O(P) scan per pop.  A head's
    // rank is always resolvable when (re)pushed: a window-born event's
    // birth precedes it in the SAME partition's plog (its parent was
    // processed there first), so the birth was merged — and ranked —
    // before the event can become that partition's head.
    struct Head {
        i64 time, bt, rk;
        size_t p;
    };
    auto later = [](const Head &a, const Head &b) {
        if (a.time != b.time) return a.time > b.time;
        if (a.bt != b.bt) return a.bt > b.bt;
        return a.rk > b.rk;
    };
    vector<Head> heads;
    heads.reserve(P);
    for (size_t p = 0; p < P; p++) {
        if (parts[p]->plog.empty()) continue;
        const auto &e = parts[p]->plog[0];
        heads.push_back({e.time, e.bt, resolved(p, e), p});
    }
    std::make_heap(heads.begin(), heads.end(), later);
    i64 cur_bt = INT64_MIN, bt_rank = 0, flip_step = -1;
    while (!heads.empty()) {
        std::pop_heap(heads.begin(), heads.end(), later);
        const size_t best = heads.back().p;
        heads.pop_back();
        Partition &pp = *parts[best];
        const auto &e = pp.plog[logi[best]];
        // Initialize-driven queue purges act first: in the sequential
        // engine remove_events_for ran before the boot event's own births,
        // so exactly the already-ranked (= born-earlier) same-window cross
        // sends to the booting node are dropped.
        while (purgei[best] < pp.purges.size() &&
               pp.purges[purgei[best]].at == logi[best]) {
            const i32 purged = pp.purges[purgei[best]++].node;
            for (size_t p2 = 0; p2 < P; p2++) {
                auto &ob = parts[p2]->outbox;
                const i64 base2 = parts[p2]->prov_base;
                ob.erase(
                    std::remove_if(
                        ob.begin(), ob.end(),
                        [&](const SimEv &ev) {
                            return ev.target == purged &&
                                   fin[p2][(size_t)(ev.ctr - base2)] >= 0;
                        }),
                    ob.end());
            }
        }
        // Fold this step's provisional ack waves into the global ledger:
        // the merged order IS the sequential send order, so re-registering
        // here reproduces the canonical positions and logs bit-for-bit.
        // The sender's early-consumed provisional position is remapped to
        // the final one (then absorbed, matching the sequential cursor);
        // the shard overlay itself is discarded wholesale below.
        if (ctx.ack_ledger != nullptr) {
            AckShard &shard = *pp.shard;
            while (shard.foldi < shard.waves.size() &&
                   shard.waves[shard.foldi].plog_at == logi[best]) {
                AckShard::ShardWave &sw = shard.waves[shard.foldi++];
                const u32 prov = sw.reg.pos;
                const MsgP &m = sw.reg.msg;
                m->wave_id = -1;
                ctx.ack_ledger->register_msg(m, sw.src);
                EngineNode &sn = *nodes[(size_t)sw.src];
                if (sn.machine && sn.machine->client_hash_disseminator) {
                    LedView &lv =
                        sn.machine->client_hash_disseminator->led_view;
                    for (auto &pos : lv.own_early)
                        if (pos == prov) pos = (u32)m->wave_id;
                    lv.absorb();
                }
            }
        }
        // Its births get the next ranks of the insertion sequence at this
        // timestamp (the merged order IS the sequential processing order).
        if (e.time != cur_bt) {
            cur_bt = e.time;
            bt_rank = 0;
        }
        for (u32 k = 0; k < e.births; k++)
            fin[best][(size_t)(e.prov_start - pp.prov_base) + k] = bt_rank++;
        steps += 1;
        // Drain-predicate flips caused by this event, in global order.
        while (flipi[best] < pp.flips.size() &&
               pp.flips[flipi[best]].at == logi[best]) {
            const auto &f = pp.flips[flipi[best]++];
            if (f.kind == 0) {
                auto sit = client_satisfied.find(f.id);
                if (sit != client_satisfied.end() && !sit->second) {
                    sit->second = true;
                    clients_unsatisfied -= 1;
                }
            } else if (f.kind == 1) {
                nodes_not_ready -= 1;
            } else {
                nodes_not_ready += 1;
            }
            if (flip_step < 0 && drained()) {
                flip_step = steps;
                *flip_time = e.time;
            }
        }
        logi[best] += 1;
        if (logi[best] < pp.plog.size()) {
            const auto &ne = pp.plog[logi[best]];
            heads.push_back({ne.time, ne.bt, resolved(best, ne), best});
            std::push_heap(heads.begin(), heads.end(), later);
        }
    }
    // Re-stamp window-born events still pending, and the cross sends.
    for (size_t p = 0; p < P; p++) {
        Partition &pp = *parts[p];
        for (auto &ev : pp.q.heap) {
            if (ev.bt < window_start) continue;
            i64 r = fin[p][(size_t)(ev.ctr - pp.prov_base)];
            if (r < 0) throw EngineError("pdes: pending event unresolved");
            ev.ctr = r;
            // Relative order within every same-(time, bt) group is
            // preserved by construction, so the heap stays a heap.
        }
        for (auto &ev : pp.outbox) {
            i64 r = fin[p][(size_t)(ev.ctr - pp.prov_base)];
            if (r < 0) throw EngineError("pdes: outbox event unresolved");
            ev.ctr = r;
        }
    }
    // Deliver cross-partition sends (keys final; plain heap insert).
    for (size_t p = 0; p < P; p++) {
        for (auto &ev : parts[p]->outbox) {
            Partition &tgt = *parts[(size_t)part_of[(size_t)ev.target]];
            tgt.q.insert_stamped(std::move(ev));
        }
        parts[p]->outbox.clear();
    }
    // Fold window stats.
    for (size_t p = 0; p < P; p++) {
        Partition &pp = *parts[p];
        committed_ops += pp.committed_ops;
        pp.committed_ops = 0;
        crypto_ns += pp.crypto_ns;
        pp.crypto_ns = 0;
        pp.steps = 0;
        pp.plog.clear();
        pp.flips.clear();
        pp.purges.clear();
        if (pp.shard) {
            if (pp.shard->foldi != pp.shard->waves.size())
                throw EngineError("pdes ledger: unfolded shard waves");
            pp.shard->clear();
        }
    }
    // Deferred ledger pruning (serial here; structural mutation is unsafe
    // inside windows).
    if (ctx.ack_ledger != nullptr && ctx.ack_ledger->waves.size() >= 256)
        prune_ledger();
    // Fold the per-node work attribution into the traffic EWMA (each node
    // accrues only in its own partition), and keep the raw window vector:
    // candidate assignments are scored against the recent burst history.
    const i64 N = (i64)nodes.size();
    vector<u64> winv((size_t)N);
    for (i64 i = 0; i < N; i++) {
        Partition &pp = *parts[(size_t)part_of[(size_t)i]];
        u64 c = pp.node_cycles[(size_t)i];
        pp.node_cycles[(size_t)i] = 0;
        winv[(size_t)i] = c;
        node_load[(size_t)i] =
            0.7 * node_load[(size_t)i] + 0.3 * (double)c;
    }
    node_hist.push_back(std::move(winv));
    if (node_hist.size() > 8) node_hist.pop_front();
    return flip_step;
}

PdesResult Engine::run_pdes(i64 partitions, bool threaded, i64 timeout,
                            i64 stop_time, i64 stop_steps) {
    if (parts.empty()) pdes_setup(partitions, threaded);
    const size_t P = parts.size();
    const bool exact = stop_steps >= 0;
    const i64 step_cap = timeout + 1000;
    PdesResult res;
    res.lookahead = pdes_W;
    res.ledger_on = ctx.ack_ledger != nullptr;
    // Traffic-aware rebalancing cadence: the first windows are the
    // profiling prefix (seed assignment is naive-contiguous), then
    // rebalance on sustained imbalance with a cooldown so the event
    // migration cost amortizes.
    // The candidate scorer competes the incumbent on the same history
    // with hysteresis, so the trigger can run often and cheaply; the
    // cooldown only bounds migration churn.
    const i64 profile_windows = 3;
    const i64 repart_cooldown = 4;
    i64 last_repart = 0;

    // Persistent worker pool (threaded mode): generation-counter barrier.
    std::vector<std::thread> workers;
    std::mutex mu;
    std::condition_variable cv_go, cv_done;
    i64 gen = 0;
    size_t done_count = 0;
    bool shutdown = false;
    i64 cur_T = 0, cur_end = 0;
    const bool pool = threaded && P > 1;
    if (pool) {
        for (size_t p = 0; p < P; p++) {
            workers.emplace_back([&, p] {
                i64 seen = 0;
                while (true) {
                    i64 a, b;
                    {
                        std::unique_lock<std::mutex> lk(mu);
                        cv_go.wait(lk,
                                   [&] { return shutdown || gen > seen; });
                        if (shutdown) return;
                        seen = gen;
                        a = cur_T;
                        b = cur_end;
                    }
                    try {
                        pdes_window(*parts[p], a, b, step_cap);
                    } catch (const std::exception &ex) {
                        parts[p]->error = ex.what();
                    }
                    {
                        std::lock_guard<std::mutex> lk(mu);
                        done_count += 1;
                    }
                    cv_done.notify_all();
                }
            });
        }
    }
    auto stop_pool = [&] {
        if (!pool) return;
        {
            std::lock_guard<std::mutex> lk(mu);
            shutdown = true;
        }
        cv_go.notify_all();
        for (auto &w : workers) w.join();
        workers.clear();
    };

    i64 T = 0;
    try {
        while (true) {
            // Jump over empty stretches (no events in [T, next_t)).
            i64 next_t = INT64_MAX;
            for (auto &pp : parts)
                if (!pp->q.heap.empty())
                    next_t = std::min(next_t, pp->q.heap.front().time);
            if (next_t == INT64_MAX) break;  // queues fully drained
            if (next_t > T) T = next_t;
            i64 window_end = T + pdes_W;
            if (exact && window_end > stop_time) break;  // tail takes over

            u64 t0 = __rdtsc();
            if (pool) {
                {
                    std::lock_guard<std::mutex> lk(mu);
                    cur_T = T;
                    cur_end = window_end;
                    done_count = 0;
                    gen += 1;
                }
                cv_go.notify_all();
                {
                    std::unique_lock<std::mutex> lk(mu);
                    cv_done.wait(lk, [&] { return done_count == P; });
                }
                for (auto &pp : parts)
                    if (!pp->error.empty()) throw EngineError(pp->error);
            } else {
                for (auto &pp : parts)
                    pdes_window(*pp, T, window_end, step_cap);
            }
            u64 t1 = __rdtsc();
            u64 win_max = 0, win_sum = 0;
            for (auto &pp : parts) {
                win_sum += pp->work_cycles;
                if (pp->work_cycles > win_max) win_max = pp->work_cycles;
                pp->work_cycles = 0;
            }
            res.sum_part_cycles += win_sum;
            res.max_part_cycles += win_max;

            i64 ft = -1;
            auto b0 = std::chrono::steady_clock::now();
            i64 flip = pdes_barrier(T, &ft);
            res.barrier_cycles += __rdtsc() - t1;
            res.barrier_ns += (u64)std::chrono::duration_cast<
                                  std::chrono::nanoseconds>(
                                  std::chrono::steady_clock::now() - b0)
                                  .count();
            (void)t0;
            res.windows += 1;
            if (flip >= 0 && res.flip_step < 0) {
                res.flip_step = flip;
                res.flip_time = ft;
            }
            if (!exact && res.flip_step >= 0) break;
            if (steps > timeout) {
                res.timed_out = true;
                break;
            }
            // Rebalance at the barrier: once after the profiling prefix
            // (seeding from observed per-node work), then only on
            // sustained imbalance past the cooldown.
            if (P > 1) {
                double imb = win_sum > 0
                                 ? (double)win_max * (double)P /
                                       (double)win_sum
                                 : 1.0;
                bool due = res.windows == profile_windows ||
                           (res.windows - last_repart >= repart_cooldown &&
                            imb > 1.05);
                if (due && pdes_repartition(imb)) {
                    res.repartitions += 1;
                    res.lookahead = pdes_W;
                    last_repart = res.windows;
                }
            }
            T = window_end;
        }
        stop_pool();
    } catch (...) {
        stop_pool();
        throw;
    }

    if (exact && !res.timed_out) {
        // Sequential tail: merge every partition queue into the main one
        // (all keys final after the last barrier) and finish exactly.
        queue.fake_time = T;
        queue.stamp_mode = EventQueue::TAIL;
        for (auto &pp : parts) {
            for (auto &ev : pp->q.heap)
                queue.heap.push_back(std::move(ev));
            pp->q.heap.clear();
        }
        std::make_heap(queue.heap.begin(), queue.heap.end(), SimEvCmp());
        while (steps < stop_steps) {
            if (queue.heap.empty())
                throw EngineError("pdes exact: queue drained before stop");
            step(nullptr);
            steps += 1;
            res.tail_steps += 1;
        }
        res.done = true;
        res.steps = steps;
        res.fake_time = queue.fake_time;
    } else if (!exact) {
        res.done = res.flip_step >= 0;
        res.steps = res.done ? res.flip_step : steps;
        res.fake_time = res.done ? res.flip_time : 0;
        // Surface the exact drain point through stats(): the engine state
        // has overshot by up to one window (measurement mode), but the
        // reported step count and fake-time are the sequential ones.
        steps = res.steps;
        queue.fake_time = res.fake_time;
    }
    return res;
}

// ---------------------------------------------------------------------------
// Python bindings.
// ---------------------------------------------------------------------------

struct PyEngine {
    PyObject_HEAD
    Engine *engine;
};

// Owned-reference guard for the config-parsing paths: releases on every
// exit, including EngineError throws from get_i64.
struct PyRef {
    PyObject *p;
    explicit PyRef(PyObject *obj) : p(obj) {}
    ~PyRef() { Py_XDECREF(p); }
    PyRef(const PyRef &) = delete;
    PyRef &operator=(const PyRef &) = delete;
    explicit operator bool() const { return p != nullptr; }
};

i64 get_i64(PyObject *seq, Py_ssize_t i) {
    PyObject *o = PySequence_GetItem(seq, i);
    if (!o) throw EngineError("bad config item");
    i64 v = PyLong_AsLongLong(o);
    Py_DECREF(o);
    if (v == -1 && PyErr_Occurred()) throw EngineError("bad config int");
    return v;
}

void engine_dealloc(PyObject *self) {
    delete ((PyEngine *)self)->engine;
    Py_TYPE(self)->tp_free(self);
}

PyObject *engine_new(PyTypeObject *type, PyObject *args, PyObject *) {
    PyObject *net_tuple, *client_states, *client_specs, *node_specs;
    PyObject *mangler = Py_None;
    long long random_seed = 0;
    PyObject *reconfig_points = Py_None;
    long long flags = 0;  // bit 0: disable the ack ledger (PDES runs)
    if (!PyArg_ParseTuple(args, "OOOO|OLOL", &net_tuple, &client_states,
                          &client_specs, &node_specs, &mangler, &random_seed,
                          &reconfig_points, &flags))
        return nullptr;
    auto *engine = new Engine();
    try {
        engine->ctx.cfg.ci = get_i64(net_tuple, 1);
        engine->ctx.cfg.mel = get_i64(net_tuple, 2);
        engine->ctx.cfg.nb = get_i64(net_tuple, 3);
        engine->ctx.cfg.f = get_i64(net_tuple, 4);
        i64 n_nodes = get_i64(net_tuple, 0);
        if (n_nodes < 1 || n_nodes > 256)
            throw EngineError("fastengine supports 1..256 nodes");
        for (i64 i = 0; i < n_nodes; i++)
            engine->ctx.cfg.nodes.push_back((i32)i);
        engine->ctx.finish_init();

        // Initial client states: (id, width).
        Py_ssize_t n_cs = PySequence_Size(client_states);
        for (Py_ssize_t i = 0; i < n_cs; i++) {
            PyRef cs(PySequence_GetItem(client_states, i));
            if (!cs) throw EngineError("bad client state");
            ClientStateS c;
            c.id = get_i64(cs.p, 0);
            c.width = get_i64(cs.p, 1);
            c.wclc = 0;
            c.lw = 0;
            engine->ctx.init_clients.push_back(std::move(c));
        }

        // Client specs.
        Py_ssize_t n_clients = PySequence_Size(client_specs);
        for (Py_ssize_t i = 0; i < n_clients; i++) {
            PyRef spec(PySequence_GetItem(client_specs, i));
            if (!spec) throw EngineError("bad client spec");
            ClientSpec c;
            c.id = get_i64(spec.p, 0);
            c.total = get_i64(spec.p, 1);
            c.signed_mode = get_i64(spec.p, 2) != 0;
            c.corrupt = get_i64(spec.p, 3) != 0;
            {
                PyRef ignores(PySequence_GetItem(spec.p, 4));
                if (!ignores) throw EngineError("bad ignore list");
                Py_ssize_t n_ign = PySequence_Size(ignores.p);
                for (Py_ssize_t k = 0; k < n_ign; k++)
                    c.ignore_nodes.insert((i32)get_i64(ignores.p, k));
            }
            {
                PyRef payloads(PySequence_GetItem(spec.p, 5));
                if (!payloads) throw EngineError("bad payload list");
                Py_ssize_t n_pl = PySequence_Size(payloads.p);
                for (Py_ssize_t k = 0; k < n_pl; k++) {
                    PyRef b(PySequence_GetItem(payloads.p, k));
                    char *buf;
                    Py_ssize_t blen;
                    if (!b || PyBytes_AsStringAndSize(b.p, &buf, &blen) < 0)
                        throw EngineError("payload must be bytes");
                    string payload(buf, (size_t)blen);
                    c.payloads.push_back(engine->ctx.intern.put(payload));
                    c.payload_digests.push_back(
                        engine->ctx.intern.put(sha256(payload)));
                }
            }
            {
                PyRef verdicts(PySequence_GetItem(spec.p, 6));
                if (!verdicts) throw EngineError("bad verdicts");
                if (verdicts.p != Py_None) {
                    char *buf;
                    Py_ssize_t blen;
                    if (PyBytes_AsStringAndSize(verdicts.p, &buf, &blen) < 0)
                        throw EngineError("verdicts must be bytes or None");
                    for (Py_ssize_t k = 0; k < blen; k++)
                        c.verdicts.push_back((u8)buf[k]);
                }
            }
            engine->client_specs.push_back(std::move(c));
        }

        // Node specs.
        Py_ssize_t n_ns = PySequence_Size(node_specs);
        if (n_ns != (Py_ssize_t)n_nodes)
            throw EngineError("node spec count mismatch");
        for (Py_ssize_t i = 0; i < n_ns; i++) {
            PyRef spec(PySequence_GetItem(node_specs, i));
            if (!spec) throw EngineError("bad node spec");
            auto node = std::make_unique<EngineNode>();
            node->id = (i32)i;
            node->start_delay = get_i64(spec.p, 0);
            node->runtime.tick_interval = get_i64(spec.p, 1);
            node->runtime.link_latency = get_i64(spec.p, 2);
            node->runtime.wal_latency = get_i64(spec.p, 3);
            node->runtime.net_latency = get_i64(spec.p, 4);
            node->runtime.hash_latency = get_i64(spec.p, 5);
            node->runtime.client_latency = get_i64(spec.p, 6);
            node->runtime.app_latency = get_i64(spec.p, 7);
            node->runtime.req_store_latency = get_i64(spec.p, 8);
            node->runtime.events_latency = get_i64(spec.p, 9);
            node->init_parms.id = (i32)i;
            node->init_parms.batch_size = get_i64(spec.p, 10);
            node->init_parms.heartbeat_ticks = get_i64(spec.p, 11);
            node->init_parms.suspect_ticks = get_i64(spec.p, 12);
            node->init_parms.new_epoch_timeout_ticks = get_i64(spec.p, 13);
            node->init_parms.buffer_size = get_i64(spec.p, 14);
            // Optional element 15: per-destination link-latency row (None
            // or an N-tuple) — see RuntimeParms::lat_to.
            if (PySequence_Size(spec.p) > 15) {
                PyRef lat(PySequence_GetItem(spec.p, 15));
                if (!lat) throw EngineError("bad node spec");
                if (lat.p != Py_None) {
                    Py_ssize_t nl = PySequence_Size(lat.p);
                    if (nl != (Py_ssize_t)n_nodes)
                        throw EngineError(
                            "link_latency_to row length must equal node count");
                    for (Py_ssize_t k = 0; k < nl; k++)
                        node->runtime.lat_to.push_back(get_i64(lat.p, k));
                }
            }
            engine->nodes.push_back(std::move(node));
        }

        // Mangler descriptor: ("drop", from_nodes, to_nodes) for the
        // send-side structured DropMessages, or
        // ("generic", wrap, preds, action, value, restart_parms) for a
        // compiled DSL mangler (see fastengine.py _compile_mangler).
        if (mangler != Py_None) {
            PyRef kind_obj(PySequence_GetItem(mangler, 0));
            if (!kind_obj) throw EngineError("bad mangler descriptor");
            const char *kind_s = PyUnicode_AsUTF8(kind_obj.p);
            if (!kind_s) throw EngineError("bad mangler kind");
            string kind(kind_s);
            if (kind == "drop") {
                engine->drop_mangler = true;
                PyRef froms(PySequence_GetItem(mangler, 1));
                PyRef tos(PySequence_GetItem(mangler, 2));
                if (!froms || !tos) throw EngineError("bad mangler descriptor");
                Py_ssize_t nf = PySequence_Size(froms.p);
                Py_ssize_t nt = PySequence_Size(tos.p);
                auto checked = [n_nodes](i64 id) {
                    if (id < 0 || id >= n_nodes)
                        throw EngineError("mangler node id out of range");
                    return id;
                };
                if (nf == 0) engine->drop_from_any = true;
                for (Py_ssize_t i = 0; i < nf; i++)
                    engine->drop_from.set(checked(get_i64(froms.p, i)));
                if (nt == 0) engine->drop_to_any = true;
                for (Py_ssize_t i = 0; i < nt; i++)
                    engine->drop_to.set(checked(get_i64(tos.p, i)));
            } else if (kind == "generic") {
                auto mg = std::make_unique<ManglerG>();
                PyRef wrap_obj(PySequence_GetItem(mangler, 1));
                const char *wrap_s =
                    wrap_obj ? PyUnicode_AsUTF8(wrap_obj.p) : nullptr;
                if (!wrap_s) throw EngineError("bad mangler wrap");
                string wrap(wrap_s);
                if (wrap == "for") mg->wrap = ManglerG::WFor;
                else if (wrap == "until") mg->wrap = ManglerG::WUntil;
                else if (wrap == "after") mg->wrap = ManglerG::WAfter;
                else throw EngineError("unknown mangler wrap");

                PyRef preds(PySequence_GetItem(mangler, 2));
                if (!preds) throw EngineError("bad mangler predicates");
                Py_ssize_t np = PySequence_Size(preds.p);
                for (Py_ssize_t i = 0; i < np; i++) {
                    PyRef pd(PySequence_GetItem(preds.p, i));
                    if (!pd) throw EngineError("bad mangler predicate");
                    PyRef pk_obj(PySequence_GetItem(pd.p, 0));
                    const char *pk_s =
                        pk_obj ? PyUnicode_AsUTF8(pk_obj.p) : nullptr;
                    if (!pk_s) throw EngineError("bad predicate kind");
                    string pk(pk_s);
                    MPredD p{};
                    if (pk == "msgs") p.k = MPredD::Msgs;
                    else if (pk == "node_startup") p.k = MPredD::NodeStartup;
                    else if (pk == "client_proposal")
                        p.k = MPredD::ClientProposalEv;
                    else if (pk == "from_self") p.k = MPredD::FromSelf;
                    else if (pk == "from_nodes" || pk == "to_nodes") {
                        p.k = pk == "from_nodes" ? MPredD::FromNodes
                                                 : MPredD::ToNodes;
                        PyRef ids(PySequence_GetItem(pd.p, 1));
                        if (!ids) throw EngineError("bad node id list");
                        Py_ssize_t ni = PySequence_Size(ids.p);
                        for (Py_ssize_t j = 0; j < ni; j++)
                            p.ids.push_back(get_i64(ids.p, j));
                    } else if (pk == "at_percent" || pk == "with_sequence" ||
                               pk == "with_epoch" || pk == "from_client") {
                        if (pk == "at_percent") p.k = MPredD::AtPercent;
                        else if (pk == "with_sequence")
                            p.k = MPredD::WithSequence;
                        else if (pk == "with_epoch") p.k = MPredD::WithEpoch;
                        else p.k = MPredD::FromClient;
                        p.value = get_i64(pd.p, 1);
                    } else if (pk == "of_type") {
                        p.k = MPredD::OfType;
                        PyRef codes(PySequence_GetItem(pd.p, 1));
                        if (!codes) throw EngineError("bad type code list");
                        Py_ssize_t nc2 = PySequence_Size(codes.p);
                        for (Py_ssize_t j = 0; j < nc2; j++) {
                            i64 code = get_i64(codes.p, j);
                            if (code < 0 || code > 15)
                                throw EngineError("bad msg type code");
                            p.type_mask |= 1u << (u32)code;
                        }
                    } else {
                        throw EngineError("unknown mangler predicate kind");
                    }
                    mg->preds.push_back(std::move(p));
                }

                PyRef act_obj(PySequence_GetItem(mangler, 3));
                const char *act_s =
                    act_obj ? PyUnicode_AsUTF8(act_obj.p) : nullptr;
                if (!act_s) throw EngineError("bad mangler action");
                string act(act_s);
                if (act == "drop") mg->action = ManglerG::Drop;
                else if (act == "jitter") mg->action = ManglerG::Jitter;
                else if (act == "duplicate") mg->action = ManglerG::Duplicate;
                else if (act == "delay") mg->action = ManglerG::Delay;
                else if (act == "crash_and_restart_after")
                    mg->action = ManglerG::CrashRestart;
                else throw EngineError("unknown mangler action");
                mg->value = get_i64(mangler, 4);
                if ((mg->action == ManglerG::Jitter ||
                     mg->action == ManglerG::Duplicate) &&
                    mg->value <= 0)
                    throw EngineError("jitter/duplicate needs max_delay > 0");
                if (mg->action == ManglerG::CrashRestart) {
                    PyRef rp(PySequence_GetItem(mangler, 5));
                    if (!rp || rp.p == Py_None)
                        throw EngineError("crash restart needs init parms");
                    mg->restart_parms.id = (i32)get_i64(rp.p, 0);
                    mg->restart_parms.batch_size = get_i64(rp.p, 1);
                    mg->restart_parms.heartbeat_ticks = get_i64(rp.p, 2);
                    mg->restart_parms.suspect_ticks = get_i64(rp.p, 3);
                    mg->restart_parms.new_epoch_timeout_ticks =
                        get_i64(rp.p, 4);
                    mg->restart_parms.buffer_size = get_i64(rp.p, 5);
                    if (mg->restart_parms.id < 0 ||
                        mg->restart_parms.id >= (i32)n_nodes)
                        throw EngineError("restart target out of range");
                }
                mg->rng.seed_from_u64((u64)random_seed);
                engine->queue.mangler = std::move(mg);
            } else {
                throw EngineError("unknown mangler descriptor kind");
            }
        }

        // Ack ledger: requires send order == arrival order, i.e. uniform
        // link latency across nodes.  Late-started nodes miss canonical
        // stream prefixes, so they consume classically — and a drop
        // mangler breaks every-receiver-sees-every-wave, so it disables
        // the ledger outright (classic paths handle drops exactly).
        {
            // A consume-time mangler breaks send-order == arrival-order
            // (jitter/duplicates) and every-receiver-sees-every-wave
            // (drops), so any generic mangler disables the ledger outright.
            bool uniform = !engine->drop_mangler && !engine->queue.mangler;
            i64 base_lat = engine->nodes[0]->runtime.link_latency;
            for (const auto &node : engine->nodes) {
                if (node->runtime.link_latency != base_lat) uniform = false;
                for (size_t d = 0; d < node->runtime.lat_to.size(); d++)
                    if ((i64)d != (i64)node->id &&
                        node->runtime.lat_to[d] != base_lat)
                        uniform = false;
            }
            const char *env = std::getenv("MIRBFT_FAST_LEDGER");
            bool enabled =
                uniform && !(env && env[0] == '0') && !(flags & 1);
            if (enabled) {
                engine->ack_ledger.wq = engine->ctx.wq;
                engine->ack_ledger.sq = engine->ctx.iq;
                engine->ctx.ack_ledger = &engine->ack_ledger;
                for (auto &node : engine->nodes)
                    if (node->start_delay > 0)
                        node->init_parms.led_classic = true;
            }
        }

        // Reconfiguration points: (client_id, req_no, desc) where desc is
        // ("new_client", id, width) | ("remove_client", id) |
        // ("new_config", (nodes...), ci, mel, nb, f).  Envelope: a new
        // config must keep the node set, f, and checkpoint interval.
        if (reconfig_points != Py_None) {
            Py_ssize_t nr = PySequence_Size(reconfig_points);
            if (nr < 0) throw EngineError("bad reconfig points");
            for (Py_ssize_t i = 0; i < nr; i++) {
                PyRef pt(PySequence_GetItem(reconfig_points, i));
                if (!pt) throw EngineError("bad reconfig point");
                i64 client_id = get_i64(pt.p, 0);
                i64 req_no = get_i64(pt.p, 1);
                PyRef desc(PySequence_GetItem(pt.p, 2));
                if (!desc) throw EngineError("bad reconfig descriptor");
                PyRef kind_obj(PySequence_GetItem(desc.p, 0));
                const char *kind_s =
                    kind_obj ? PyUnicode_AsUTF8(kind_obj.p) : nullptr;
                if (!kind_s) throw EngineError("bad reconfig kind");
                string rk(kind_s);
                ReconfigS r{};
                if (rk == "new_client") {
                    r.t = ReconfigS::NewClient;
                    r.id = get_i64(desc.p, 1);
                    r.width = get_i64(desc.p, 2);
                } else if (rk == "remove_client") {
                    r.t = ReconfigS::RemoveClient;
                    r.id = get_i64(desc.p, 1);
                } else if (rk == "new_config") {
                    r.t = ReconfigS::NewConfig;
                    auto cfg = std::make_shared<NetConfigS>();
                    PyRef nodes_obj(PySequence_GetItem(desc.p, 1));
                    if (!nodes_obj) throw EngineError("bad new-config nodes");
                    Py_ssize_t nn = PySequence_Size(nodes_obj.p);
                    for (Py_ssize_t j = 0; j < nn; j++)
                        cfg->nodes.push_back((i32)get_i64(nodes_obj.p, j));
                    cfg->ci = get_i64(desc.p, 2);
                    cfg->mel = get_i64(desc.p, 3);
                    cfg->nb = get_i64(desc.p, 4);
                    cfg->f = get_i64(desc.p, 5);
                    if (cfg->nodes != engine->ctx.cfg.nodes ||
                        cfg->f != engine->ctx.cfg.f ||
                        cfg->ci != engine->ctx.cfg.ci)
                        throw EngineError(
                            "reconfig changing nodes/f/ci outside envelope");
                    r.config = std::move(cfg);
                } else {
                    throw EngineError("unknown reconfiguration kind");
                }
                engine->reconfig_points.emplace_back(client_id, req_no,
                                                     std::move(r));
            }
        }

        // Seed node worlds + initialize events (Recorder.recording()).
        for (i64 i = 0; i < n_nodes; i++) {
            engine->init_node_world((i32)i, engine->ctx.init_clients);
            SimEv ev;
            ev.time = engine->queue.fake_time +
                      engine->nodes[(size_t)i]->start_delay;
            ev.kind = SK::Initialize;
            ev.target = (i32)i;
            engine->queue.insert(std::move(ev));
        }

        // Drain-predicate bookkeeping (recorder.py:761-803 invariants).
        for (const auto &c : engine->client_specs) {
            i64 target = c.corrupt ? 0 : c.total;
            engine->drain_targets.emplace(c.id, target);
            if (target > 0) {
                engine->client_satisfied.emplace(c.id, false);
                engine->clients_unsatisfied += 1;
            }
        }
        for (auto &node : engine->nodes) {
            node->drain_ready = engine->node_lws_ready(*node);
            if (!node->drain_ready) engine->nodes_not_ready += 1;
        }
    } catch (const std::exception &e) {
        delete engine;
        if (!PyErr_Occurred()) PyErr_SetString(PyExc_RuntimeError, e.what());
        return nullptr;
    }
    PyEngine *self = (PyEngine *)type->tp_alloc(type, 0);
    if (!self) {
        delete engine;
        return nullptr;
    }
    self->engine = engine;
    return (PyObject *)self;
}

// run(max_steps, timeout) -> (executed_steps, done, timed_out)
PyObject *engine_run(PyObject *self, PyObject *args) {
    long long max_steps, timeout;
    if (!PyArg_ParseTuple(args, "LL", &max_steps, &timeout)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    bool done = false, timed_out = false, need_device = false;
    i64 executed = 0;
    string error;
    {
        PyThreadState *save = PyEval_SaveThread();
        try {
            executed = e->run(max_steps, timeout, &done, &timed_out,
                              &need_device);
        } catch (const std::exception &ex) {
            error = ex.what();
            if (error.empty()) error = "fastengine error";
        }
        PyEval_RestoreThread(save);
    }
    if (!error.empty()) {
        PyErr_SetString(PyExc_RuntimeError, error.c_str());
        return nullptr;
    }
    return Py_BuildValue("Liii", (long long)executed, done ? 1 : 0,
                         timed_out ? 1 : 0, need_device ? 1 : 0);
}

PyObject *engine_stats(PyObject *self, PyObject *) {
    Engine *e = ((PyEngine *)self)->engine;
    return Py_BuildValue("LLLd", (long long)e->steps,
                         (long long)e->queue.fake_time,
                         (long long)e->committed_ops,
                         (double)e->crypto_ns / 1e9);
}

// drain_state() -> (nodes_not_ready, clients_unsatisfied): the two halves
// of the drain predicate, for condition-bounded runs (bench config 5).
PyObject *engine_drain_state(PyObject *self, PyObject *) {
    Engine *e = ((PyEngine *)self)->engine;
    return Py_BuildValue("LL", (long long)e->nodes_not_ready,
                         (long long)e->clients_unsatisfied);
}

// node_summary(i) -> (checkpoint_seq_no, checkpoint_hash, epoch,
//                     last_seq_no, active_hash, committed_reqs dict,
//                     {client_id: low_watermark})
PyObject *engine_node_summary(PyObject *self, PyObject *args) {
    int i;
    if (!PyArg_ParseTuple(args, "i", &i)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    if (i < 0 || (size_t)i >= e->nodes.size()) {
        PyErr_SetString(PyExc_IndexError, "node index out of range");
        return nullptr;
    }
    EngineNode &node = *e->nodes[(size_t)i];
    i64 epoch = -1;
    if (node.machine && node.machine->epoch_tracker &&
        node.machine->epoch_tracker->current_epoch)
        epoch = node.machine->epoch_tracker->current_epoch->number;
    PyObject *committed = PyDict_New();
    if (!committed) return nullptr;
    for (const auto &pr : node.state.committed_reqs) {
        PyObject *v = PyLong_FromLongLong(pr.second);
        PyObject *k = PyLong_FromLongLong(pr.first);
        if (!v || !k || PyDict_SetItem(committed, k, v) < 0) {
            Py_XDECREF(v);
            Py_XDECREF(k);
            Py_DECREF(committed);
            return nullptr;
        }
        Py_DECREF(v);
        Py_DECREF(k);
    }
    PyObject *lws = PyDict_New();
    if (!lws) {
        Py_DECREF(committed);
        return nullptr;
    }
    if (node.state.checkpoint_state) {
        for (const auto &cs : node.state.checkpoint_state->clients) {
            PyObject *v = PyLong_FromLongLong(cs.lw);
            PyObject *k = PyLong_FromLongLong(cs.id);
            if (!v || !k || PyDict_SetItem(lws, k, v) < 0) {
                Py_XDECREF(v);
                Py_XDECREF(k);
                Py_DECREF(committed);
                Py_DECREF(lws);
                return nullptr;
            }
            Py_DECREF(v);
            Py_DECREF(k);
        }
    }
    const string &active = node.state.active_hash_digest();
    return Py_BuildValue(
        "Ly#LLy#NN", (long long)node.state.checkpoint_seq_no,
        node.state.checkpoint_hash.data(),
        (Py_ssize_t)node.state.checkpoint_hash.size(), (long long)epoch,
        (long long)node.state.last_seq_no, active.data(),
        (Py_ssize_t)active.size(), committed, lws);
}

// node_ack_state(i) -> int: FNV-1a fingerprint of the node's per-client
// ack-dissemination state (watermarks, vote masks, quorum sets, ledger
// cursor).  Deterministic across runs with identical event streams — the
// PDES ledger-parity test compares it against the sequential engine's.
PyObject *engine_node_ack_state(PyObject *self, PyObject *args) {
    int i;
    if (!PyArg_ParseTuple(args, "i", &i)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    if (i < 0 || (size_t)i >= e->nodes.size()) {
        PyErr_SetString(PyExc_IndexError, "node index out of range");
        return nullptr;
    }
    EngineNode &node = *e->nodes[(size_t)i];
    u64 h = 1469598103934665603ull;
    auto mix = [&h](u64 v) {
        h ^= v;
        h *= 1099511628211ull;
    };
    if (node.machine && node.machine->client_hash_disseminator &&
        node.machine->client_hash_disseminator->initialized) {
        Disseminator &d = *node.machine->client_hash_disseminator;
        mix((u64)d.led_view.version);
        vector<u32> early = d.led_view.own_early;
        std::sort(early.begin(), early.end());
        for (u32 p : early) mix((u64)p);
        mix((u64)d.led_diverged_total);
        mix((u64)d.led_classic_count);
        for (const auto &pr : d.clients) {
            const ClientD &c = *pr.second;
            mix((u64)pr.first);
            mix((u64)c.client_state.lw);
            mix((u64)c.high_watermark);
            mix(c.led_classic ? 1u : 0u);
            mix((u64)c.led_diverged);
            for (const auto &crnp : c.win) {
                const ClientReqNoD &crn = *crnp;
                mix((u64)crn.req_no);
                for (int wi = 0; wi < 4; wi++)
                    mix(crn.non_null_voters.w[wi]);
                for (i32 dg : crn.self_acked) mix((u64)(u32)dg);
                for (const auto &rp : crn.requests.items) {
                    mix((u64)(u32)rp.first);
                    for (int wi = 0; wi < 4; wi++)
                        mix(rp.second->agreements.w[wi]);
                    mix(rp.second->stored ? 1u : 0u);
                }
                for (const auto &rp : crn.weak_requests.items)
                    mix((u64)(u32)rp.first);
                for (const auto &rp : crn.strong_requests.items)
                    mix((u64)(u32)rp.first);
            }
        }
    }
    return PyLong_FromUnsignedLongLong((unsigned long long)h);
}

// set_fail_transfers(node, count): the node's next `count` state-transfer
// attempts fail at the app boundary (testengine NodeState.fail_transfers).
PyObject *engine_set_fail_transfers(PyObject *self, PyObject *args) {
    int i;
    long long count;
    if (!PyArg_ParseTuple(args, "iL", &i, &count)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    if (i < 0 || (size_t)i >= e->nodes.size()) {
        PyErr_SetString(PyExc_IndexError, "node index out of range");
        return nullptr;
    }
    e->nodes[(size_t)i]->state.fail_transfers = count;
    Py_RETURN_NONE;
}

// node_transfers(i) -> (state_transfers, transfer_failures, attempt_times)
PyObject *engine_node_transfers(PyObject *self, PyObject *args) {
    int i;
    if (!PyArg_ParseTuple(args, "i", &i)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    if (i < 0 || (size_t)i >= e->nodes.size()) {
        PyErr_SetString(PyExc_IndexError, "node index out of range");
        return nullptr;
    }
    const AppState &st = e->nodes[(size_t)i]->state;
    auto build = [](const vector<i64> &v) -> PyObject * {
        PyObject *t = PyTuple_New((Py_ssize_t)v.size());
        if (!t) return nullptr;
        for (size_t j = 0; j < v.size(); j++) {
            PyObject *n = PyLong_FromLongLong(v[j]);
            if (!n) {
                Py_DECREF(t);
                return nullptr;
            }
            PyTuple_SET_ITEM(t, (Py_ssize_t)j, n);
        }
        return t;
    };
    PyObject *a = build(st.state_transfers);
    PyObject *b = a ? build(st.transfer_failures) : nullptr;
    PyObject *c = b ? build(st.transfer_attempt_times) : nullptr;
    if (!c) {
        Py_XDECREF(a);
        Py_XDECREF(b);
        return nullptr;
    }
    return Py_BuildValue("NNN", a, b, c);
}

// pop_hash_log() -> list[(message_bytes, digest_bytes)]
PyObject *engine_pop_hash_log(PyObject *self, PyObject *) {
    Engine *e = ((PyEngine *)self)->engine;
    PyObject *out = PyList_New(0);
    if (!out) return nullptr;
    for (const auto &pr : e->wave_log) {
        const string &m = e->ctx.intern.get(pr.first);
        const string &d = e->ctx.intern.get(pr.second);
        PyObject *item =
            Py_BuildValue("y#y#", m.data(), (Py_ssize_t)m.size(), d.data(),
                          (Py_ssize_t)d.size());
        if (!item || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            return nullptr;
        }
        Py_DECREF(item);
    }
    e->wave_log.clear();
    return out;
}

// Steals v; on failure (or null v) releases BOTH v and the dict so error
// paths in the profile builders cannot leak the partially built dict.
int PyDictSetItemStringSteal(PyObject *d, const char *k, PyObject *v) {
    if (!v) {
        Py_DECREF(d);
        return -1;
    }
    int r = PyDict_SetItemString(d, k, v);
    Py_DECREF(v);
    if (r < 0) Py_DECREF(d);
    return r;
}

PyObject *engine_profile(PyObject *self, PyObject *) {
    Engine *e = ((PyEngine *)self)->engine;
    static const char *names[11] = {
        "initialize", "msg_received", "client_proposal", "tick",
        "proc_wal", "proc_net", "proc_hash", "proc_client", "proc_app",
        "proc_req_store", "proc_result"};
    PyObject *out = PyDict_New();
    if (!out) return nullptr;
    for (int i = 0; i < 11; i++) {
        PyObject *v = Py_BuildValue("KK", (unsigned long long)e->kind_cycles[i],
                                    (unsigned long long)e->kind_counts[i]);
        if (PyDictSetItemStringSteal(out, names[i], v) < 0) return nullptr;
    }
    static const char *part_names[6] = {"p_ackbatch", "p_votes", "p_fixpoint",
                                        "p_coalesce", "p_ackrun", "p_other"};
    for (int i = 0; i < 6; i++) {
        PyObject *v = Py_BuildValue(
            "KK", (unsigned long long)g_parts[i].load(std::memory_order_relaxed),
            (unsigned long long)0);
        if (PyDictSetItemStringSteal(out, part_names[i], v) < 0)
            return nullptr;
    }
    static const char *ev_names[12] = {
        "ev_init", "ev_load", "ev_load_done", "ev_hash_result",
        "ev_checkpoint_result", "ev_request_persisted", "ev_step",
        "ev_tick", "ev_actions_received", "ev_transfer_complete",
        "ev_transfer_failed", "ev_pad"};
    for (int i = 0; i < 12; i++) {
        PyObject *v = Py_BuildValue("KK", (unsigned long long)e->ev_cycles[i],
                                    (unsigned long long)e->ev_counts[i]);
        if (PyDictSetItemStringSteal(out, ev_names[i], v) < 0) return nullptr;
    }
    static const char *mt_names[16] = {
        "mt_preprepare", "mt_prepare", "mt_commit", "mt_checkpoint",
        "mt_suspect", "mt_epoch_change", "mt_epoch_change_ack",
        "mt_new_epoch", "mt_new_epoch_echo", "mt_new_epoch_ready",
        "mt_fetch_batch", "mt_forward_batch", "mt_fetch_request",
        "mt_ack", "mt_ack_batch", "mt_msg_batch"};
    for (int i = 0; i < 16; i++) {
        PyObject *v = Py_BuildValue("KK", (unsigned long long)e->msg_cycles[i],
                                    (unsigned long long)e->msg_counts[i]);
        if (PyDictSetItemStringSteal(out, mt_names[i], v) < 0) return nullptr;
    }
    return out;
}

// pending_device_work() -> (list[bytes] hash_content,
//                            list[(client_id, need_verdicts_up_to)])
PyObject *engine_pending_device_work(PyObject *self, PyObject *) {
    Engine *e = ((PyEngine *)self)->engine;
    PyObject *contents = PyList_New(0);
    if (!contents) return nullptr;
    // Head needs first (these gate the pause), then every other
    // unsupplied content visible in the queue (served in the same
    // dispatch so later pauses usually find digests present).  Skip the
    // deep scan on verdict-only pauses — nothing hash-related changed.
    deque<string> deep;
    if (e->device_hash_mode && !e->need_hash_content.empty())
        e->collect_pending_hash_deep(deep);
    vector<const string *> all;
    for (const auto &c : e->need_hash_content) all.push_back(&c);
    for (const auto &c : deep) all.push_back(&c);
    for (const string *cp : all) {
        const string &c = *cp;
        PyObject *b = PyBytes_FromStringAndSize(c.data(), (Py_ssize_t)c.size());
        if (!b || PyList_Append(contents, b) < 0) {
            Py_XDECREF(b);
            Py_DECREF(contents);
            return nullptr;
        }
        Py_DECREF(b);
    }
    PyObject *verdicts = PyList_New(0);
    if (!verdicts) {
        Py_DECREF(contents);
        return nullptr;
    }
    for (const auto &pr : e->need_verdicts) {
        PyObject *t = Py_BuildValue("LL", (long long)pr.first,
                                    (long long)pr.second);
        if (!t || PyList_Append(verdicts, t) < 0) {
            Py_XDECREF(t);
            Py_DECREF(contents);
            Py_DECREF(verdicts);
            return nullptr;
        }
        Py_DECREF(t);
    }
    return Py_BuildValue("NN", contents, verdicts);
}

// supply_digests([(content_bytes, digest_bytes), ...])
PyObject *engine_supply_digests(PyObject *self, PyObject *args) {
    PyObject *items;
    if (!PyArg_ParseTuple(args, "O", &items)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    Py_ssize_t n = PySequence_Size(items);
    if (n < 0) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyRef it(PySequence_GetItem(items, i));
        if (!it) return nullptr;
        const char *content, *digest;
        Py_ssize_t clen, dlen;
        if (!PyArg_ParseTuple(it.p, "y#y#", &content, &clen, &digest, &dlen))
            return nullptr;
        e->device_digests[string(content, (size_t)clen)] =
            e->ctx.intern.put(string(digest, (size_t)dlen));
    }
    Py_RETURN_NONE;
}

// supply_verdicts(client_id, verdict_bytes) — appends to the client's
// verdict array (streaming-auth mode).
PyObject *engine_supply_verdicts(PyObject *self, PyObject *args) {
    long long client_id;
    const char *buf;
    Py_ssize_t blen;
    if (!PyArg_ParseTuple(args, "Ly#", &client_id, &buf, &blen))
        return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    ClientSpec *cs = e->spec_of(client_id);
    if (!cs) {
        PyErr_SetString(PyExc_KeyError, "unknown client");
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < blen; i++) cs->verdicts.push_back((u8)buf[i]);
    Py_RETURN_NONE;
}

// set_device_modes(device_hash, streaming_auth)
PyObject *engine_set_device_modes(PyObject *self, PyObject *args) {
    int dh, sa;
    if (!PyArg_ParseTuple(args, "ii", &dh, &sa)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    e->device_hash_mode = dh != 0;
    e->streaming_auth_mode = sa != 0;
    Py_RETURN_NONE;
}

// run_pdes(partitions, threaded, timeout, stop_time, stop_steps) -> dict.
// Measurement mode (stop_steps < 0) runs to the drain flip and returns the
// exact step count / fake-time; exact mode replays to the given stop and
// leaves the engine state bit-identical to the sequential run there.
PyObject *engine_run_pdes(PyObject *self, PyObject *args) {
    long long partitions, threaded, timeout, stop_time, stop_steps;
    if (!PyArg_ParseTuple(args, "LLLLL", &partitions, &threaded, &timeout,
                          &stop_time, &stop_steps))
        return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    PdesResult r;
    string error;
    {
        PyThreadState *save = PyEval_SaveThread();
        try {
            r = e->run_pdes(partitions, threaded != 0, timeout, stop_time,
                            stop_steps);
        } catch (const std::exception &ex) {
            error = ex.what();
            if (error.empty()) error = "fastengine error";
        }
        PyEval_RestoreThread(save);
    }
    if (!error.empty()) {
        PyErr_SetString(PyExc_RuntimeError, error.c_str());
        return nullptr;
    }
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:i,s:i,s:L,s:K,s:K,s:K,s:K,s:L,s:L,s:L,s:i}",
        "steps", (long long)r.steps, "fake_time", (long long)r.fake_time,
        "flip_step", (long long)r.flip_step, "flip_time",
        (long long)r.flip_time, "done", r.done ? 1 : 0, "timed_out",
        r.timed_out ? 1 : 0, "windows", (long long)r.windows,
        "barrier_cycles", (unsigned long long)r.barrier_cycles,
        "barrier_ns", (unsigned long long)r.barrier_ns, "sum_part_cycles",
        (unsigned long long)r.sum_part_cycles, "max_part_cycles",
        (unsigned long long)r.max_part_cycles, "tail_steps",
        (long long)r.tail_steps, "repartitions", (long long)r.repartitions,
        "lookahead", (long long)r.lookahead, "ledger_on",
        r.ledger_on ? 1 : 0);
}

// pdes_check(partitions) -> None (eligible) or the structured
// "pdes_envelope[<code>]: <detail>" reason string.  Probe only: no state
// is touched, so bench.py can classify configs without running them.
PyObject *engine_pdes_check(PyObject *self, PyObject *args) {
    long long partitions;
    if (!PyArg_ParseTuple(args, "L", &partitions)) return nullptr;
    Engine *e = ((PyEngine *)self)->engine;
    string reason;
    try {
        reason = e->pdes_check(partitions);
    } catch (const std::exception &ex) {
        PyErr_SetString(PyExc_RuntimeError, ex.what());
        return nullptr;
    }
    if (reason.empty()) Py_RETURN_NONE;
    return PyUnicode_FromStringAndSize(reason.data(),
                                       (Py_ssize_t)reason.size());
}

PyMethodDef engine_methods[] = {
    {"run", engine_run, METH_VARARGS, nullptr},
    {"run_pdes", engine_run_pdes, METH_VARARGS, nullptr},
    {"pdes_check", engine_pdes_check, METH_VARARGS, nullptr},
    {"pending_device_work", engine_pending_device_work, METH_NOARGS, nullptr},
    {"supply_digests", engine_supply_digests, METH_VARARGS, nullptr},
    {"supply_verdicts", engine_supply_verdicts, METH_VARARGS, nullptr},
    {"set_device_modes", engine_set_device_modes, METH_VARARGS, nullptr},
    {"stats", engine_stats, METH_NOARGS, nullptr},
    {"drain_state", engine_drain_state, METH_NOARGS, nullptr},
    {"node_summary", engine_node_summary, METH_VARARGS, nullptr},
    {"node_ack_state", engine_node_ack_state, METH_VARARGS, nullptr},
    {"set_fail_transfers", engine_set_fail_transfers, METH_VARARGS, nullptr},
    {"node_transfers", engine_node_transfers, METH_VARARGS, nullptr},
    {"pop_hash_log", engine_pop_hash_log, METH_NOARGS, nullptr},
    {"profile", engine_profile, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject EngineType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// profile_globals() -> dict of the process-wide profiling counters
// (cumulative across engines; callers diff snapshots to attribute a run).
PyObject *mod_profile_globals(PyObject *, PyObject *) {
    static const char *part_names[6] = {"p_ackbatch", "p_votes", "p_fixpoint",
                                        "p_coalesce", "p_ackrun", "p_other"};
    PyObject *out = PyDict_New();
    if (!out) return nullptr;
    for (int i = 0; i < 6; i++) {
        PyObject *v = PyLong_FromUnsignedLongLong(
            g_parts[i].load(std::memory_order_relaxed));
        if (PyDictSetItemStringSteal(out, part_names[i], v) < 0)
            return nullptr;
    }
    return out;
}

PyMethodDef fast_module_methods[] = {
    {"profile_globals", mod_profile_globals, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef fast_moduledef = {
    PyModuleDef_HEAD_INIT, "_fast",
    "Native fast-path cluster engine (C++ twin of the Python testengine).",
    -1, fast_module_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__fast(void) {
    EngineType.tp_name = "mirbft_tpu_torch._native._fast.FastEngine";
    EngineType.tp_basicsize = sizeof(PyEngine);
    EngineType.tp_flags = Py_TPFLAGS_DEFAULT;
    EngineType.tp_new = engine_new;
    EngineType.tp_dealloc = engine_dealloc;
    EngineType.tp_methods = engine_methods;
    if (PyType_Ready(&EngineType) < 0) return nullptr;
    PyObject *m = PyModule_Create(&fast_moduledef);
    if (!m) return nullptr;
    Py_INCREF(&EngineType);
    if (PyModule_AddObject(m, "FastEngine", (PyObject *)&EngineType) < 0) {
        Py_DECREF(&EngineType);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
