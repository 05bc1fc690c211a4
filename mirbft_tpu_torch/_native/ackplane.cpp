// Native ack-vote plane: the O(N^2)-per-request hot path of the client
// request dissemination protocol (reference pkg/statemachine/
// client_hash_disseminator.go:806-876), reduced to packed bitmask
// accumulation in C.
//
// Design contract with mirbft_tpu_torch/statemachine/disseminator.py:
//
//  * The plane owns vote accumulation ONLY for the green path of a
//    (client, req_no): every observed ack carries the same single non-null
//    digest ("canonical").  Anything else — a null digest, a second distinct
//    digest, a forced ack, a buffered-replay ack — is returned to Python
//    ("pyfall"), which EJECTS the slot (syncs the native mask into the
//    Python ClientRequest objects and marks the slot ejected) and runs the
//    exact reference semantics from then on.
//
//  * Quorum crossings are returned as records and REPLAYED by Python
//    through the same tail logic as the pure-Python path, preserving action
//    order and content exactly.  The crossing condition mirrors
//    Client.ack_into / Client.ack_run: emit when count == weak_q, when
//    count == strong_q, or when source == my_id and count >= weak_q —
//    including for duplicate votes (a duplicate arriving while the count
//    sits at a threshold re-runs the tail in the reference semantics, so it
//    must here too).
//
//  * Digests are interned process-wide: digest bytes <-> int32 id.  Ids
//    never leave the process and never enter hashes or the wire format.
//
// No external dependencies; CPython C API only (the environment provides no
// pybind11 — see repo docs/tpu_plane.md).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Digest interning (module-global).

struct BytesKey {
    std::string data;
    bool operator==(const BytesKey &o) const { return data == o.data; }
};

struct BytesKeyHash {
    size_t operator()(const BytesKey &k) const {
        return std::hash<std::string>()(k.data);
    }
};

struct InternTable {
    std::unordered_map<BytesKey, int32_t, BytesKeyHash> ids;
    std::vector<PyObject *> objects;  // id -> bytes object (owned ref)
    size_t cap = 1u << 20;  // bound on distinct digests held native

    // Returns the digest id, or -1 when the digest cannot be owned
    // natively: the null digest, or the table is at capacity.  -1 routes
    // the ack to the Python path, which works from the original bytes —
    // correctness is unaffected, the native fast path just stops covering
    // new digests (memory stays bounded against digest-flooding peers).
    // -2 signals a Python error.
    int32_t intern(PyObject *bytes_obj) {
        char *buf;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(bytes_obj, &buf, &len) < 0) return -2;
        if (len == 0) return -1;  // null digest sentinel
        BytesKey key{std::string(buf, (size_t)len)};
        auto it = ids.find(key);
        if (it != ids.end()) return it->second;
        if (objects.size() >= cap) return -1;  // full: Python path takes over
        int32_t id = (int32_t)objects.size();
        Py_INCREF(bytes_obj);
        objects.push_back(bytes_obj);
        ids.emplace(std::move(key), id);
        return id;
    }
};

InternTable *g_intern = nullptr;

// ---------------------------------------------------------------------------
// Plane object.

constexpr uint8_t SLOT_EJECTED = 1;

struct ClientWin {
    int64_t low = 0;
    int64_t high = -1;  // inclusive; high < low -> empty
    std::vector<int32_t> canonical;  // digest id, -1 = none yet
    std::vector<uint16_t> count;
    std::vector<uint8_t> flags;
    std::vector<uint64_t> votes;  // width * words

    int64_t width() const { return high - low + 1; }
};

struct Plane {
    PyObject_HEAD
    int n_nodes;
    int my_id;
    int weak_q;
    int strong_q;
    int words;
    std::unordered_map<int64_t, ClientWin> *clients;
};

PyObject *mask_to_bytes(const uint64_t *w, int words) {
    // Little-endian byte string, words*8 long; Python: int.from_bytes(b,'little')
    return PyBytes_FromStringAndSize((const char *)w, (Py_ssize_t)words * 8);
}

int bytes_to_mask(PyObject *b, uint64_t *out, int words) {
    char *buf;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(b, &buf, &len) < 0) return -1;
    std::memset(out, 0, (size_t)words * 8);
    if (len > (Py_ssize_t)words * 8) len = (Py_ssize_t)words * 8;
    std::memcpy(out, buf, (size_t)len);
    return 0;
}

void plane_dealloc(PyObject *self) {
    Plane *p = (Plane *)self;
    delete p->clients;
    Py_TYPE(self)->tp_free(self);
}

PyObject *plane_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    static const char *kwlist[] = {"n_nodes", "my_id", "weak_q", "strong_q",
                                   nullptr};
    int n_nodes, my_id, weak_q, strong_q;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "iiii", (char **)kwlist,
                                     &n_nodes, &my_id, &weak_q, &strong_q))
        return nullptr;
    if (n_nodes <= 0 || n_nodes > 4096) {
        PyErr_SetString(PyExc_ValueError, "n_nodes out of range");
        return nullptr;
    }
    Plane *p = (Plane *)type->tp_alloc(type, 0);
    if (!p) return nullptr;
    p->n_nodes = n_nodes;
    p->my_id = my_id;
    p->weak_q = weak_q;
    p->strong_q = strong_q;
    p->words = (n_nodes + 63) / 64;
    p->clients = new std::unordered_map<int64_t, ClientWin>();
    return (PyObject *)p;
}

// set_client(client_id, low, high): create or rebase a client window.
// Slots in the [low, high] overlap with the previous window are preserved;
// everything else starts empty.
PyObject *plane_set_client(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, low, high;
    if (!PyArg_ParseTuple(args, "LLL", &client_id, &low, &high)) return nullptr;
    if (high < low || high - low > 1 << 20) {
        PyErr_SetString(PyExc_ValueError, "bad window");
        return nullptr;
    }
    const int words = p->words;
    int64_t w = high - low + 1;
    ClientWin fresh;
    fresh.low = low;
    fresh.high = high;
    fresh.canonical.assign((size_t)w, -1);
    fresh.count.assign((size_t)w, 0);
    fresh.flags.assign((size_t)w, 0);
    fresh.votes.assign((size_t)w * words, 0);

    auto it = p->clients->find(client_id);
    if (it != p->clients->end()) {
        ClientWin &old = it->second;
        int64_t from = low > old.low ? low : old.low;
        int64_t to = high < old.high ? high : old.high;
        for (int64_t rn = from; rn <= to; rn++) {
            size_t oi = (size_t)(rn - old.low), ni = (size_t)(rn - low);
            fresh.canonical[ni] = old.canonical[oi];
            fresh.count[ni] = old.count[oi];
            fresh.flags[ni] = old.flags[oi];
            std::memcpy(&fresh.votes[ni * words], &old.votes[oi * words],
                        (size_t)words * 8);
        }
        it->second = std::move(fresh);
    } else {
        p->clients->emplace(client_id, std::move(fresh));
    }
    Py_RETURN_NONE;
}

PyObject *plane_drop_client(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id;
    if (!PyArg_ParseTuple(args, "L", &client_id)) return nullptr;
    p->clients->erase(client_id);
    Py_RETURN_NONE;
}

PyObject *plane_clear(PyObject *self, PyObject *) {
    Plane *p = (Plane *)self;
    p->clients->clear();
    Py_RETURN_NONE;
}

// import_slot(client_id, req_no, digest_bytes|None, mask_bytes, count)
// (Re-)take native ownership of a slot with known state; un-ejects.
PyObject *plane_import_slot(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, req_no;
    PyObject *digest_obj, *mask_obj;
    int count;
    if (!PyArg_ParseTuple(args, "LLOOi", &client_id, &req_no, &digest_obj,
                          &mask_obj, &count))
        return nullptr;
    auto it = p->clients->find(client_id);
    if (it == p->clients->end()) {
        PyErr_SetString(PyExc_KeyError, "unknown client");
        return nullptr;
    }
    ClientWin &win = it->second;
    if (req_no < win.low || req_no > win.high) {
        PyErr_SetString(PyExc_IndexError, "req_no outside window");
        return nullptr;
    }
    int32_t did = -1;
    if (digest_obj != Py_None) {
        did = g_intern->intern(digest_obj);
        if (did == -2) return nullptr;
        if (did == -1) {
            // Null digest (caller bug) or intern table at capacity: the
            // slot cannot be owned natively.
            Py_RETURN_FALSE;
        }
    }
    size_t i = (size_t)(req_no - win.low);
    win.canonical[i] = did;
    win.count[i] = (uint16_t)count;
    win.flags[i] = 0;
    if (bytes_to_mask(mask_obj, &win.votes[i * p->words], p->words) < 0)
        return nullptr;
    Py_RETURN_TRUE;
}

PyObject *plane_mark_ejected(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, req_no;
    if (!PyArg_ParseTuple(args, "LL", &client_id, &req_no)) return nullptr;
    auto it = p->clients->find(client_id);
    if (it != p->clients->end()) {
        ClientWin &win = it->second;
        if (req_no >= win.low && req_no <= win.high)
            win.flags[(size_t)(req_no - win.low)] |= SLOT_EJECTED;
    }
    Py_RETURN_NONE;
}

PyObject *slot_state_tuple(Plane *p, ClientWin &win, size_t i) {
    PyObject *mask = mask_to_bytes(&win.votes[i * p->words], p->words);
    if (!mask) return nullptr;
    PyObject *res = Py_BuildValue("iNi", (int)win.canonical[i], mask,
                                  (int)win.count[i]);
    return res;
}

// peek(client_id, req_no) -> (digest_id, mask_bytes, count) | None
// None when the plane has nothing live for the slot (unknown client,
// out of window, or ejected).
PyObject *plane_peek(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, req_no;
    if (!PyArg_ParseTuple(args, "LL", &client_id, &req_no)) return nullptr;
    auto it = p->clients->find(client_id);
    if (it == p->clients->end()) Py_RETURN_NONE;
    ClientWin &win = it->second;
    if (req_no < win.low || req_no > win.high) Py_RETURN_NONE;
    size_t i = (size_t)(req_no - win.low);
    if (win.flags[i] & SLOT_EJECTED) Py_RETURN_NONE;
    if (win.canonical[i] == -1 && win.count[i] == 0) Py_RETURN_NONE;
    return slot_state_tuple(p, win, i);
}

// eject(client_id, req_no) -> slot state (digest_id, mask_bytes, count) or
// None, and marks the slot ejected.  Unlike peek(), an already-ejected
// slot's state is STILL returned: apply_core may mark a slot mid-batch and
// Python must still be able to merge the accumulated votes (the merge is an
// idempotent bitmask OR, so repeated ejects are harmless).
PyObject *plane_eject(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, req_no;
    if (!PyArg_ParseTuple(args, "LL", &client_id, &req_no)) return nullptr;
    auto it = p->clients->find(client_id);
    if (it == p->clients->end()) Py_RETURN_NONE;
    ClientWin &win = it->second;
    if (req_no < win.low || req_no > win.high) Py_RETURN_NONE;
    size_t i = (size_t)(req_no - win.low);
    win.flags[i] |= SLOT_EJECTED;
    if (win.canonical[i] == -1 && win.count[i] == 0) Py_RETURN_NONE;
    return slot_state_tuple(p, win, i);
}

// Core per-ack application.  Returns:
//   0 applied, no crossing;  1 python-fallback;  2 past (drop);
//   3 crossing (out_* filled).
//
// A fallback on an existing in-window slot marks it EJECTED immediately, so
// every LATER ack for the same slot — including later acks in the same
// batch — also falls back, preserving the reference's strict per-ack
// ordering (e.g. the first-non-null-binding rule when one batch carries
// conflicting digests from one source).  Python retrieves the accumulated
// votes via eject(), which stays valid after the mark.
inline int apply_core(Plane *p, int64_t client_id, int64_t req_no,
                      int32_t digest_id, int source, ClientWin **out_win,
                      size_t *out_idx) {
    auto it = p->clients->find(client_id);
    if (it == p->clients->end()) return 1;  // unknown client -> buffer
    ClientWin &win = it->second;
    if (req_no < win.low) return 2;   // past
    if (req_no > win.high) return 1;  // future -> buffer
    size_t i = (size_t)(req_no - win.low);
    if (win.flags[i] & SLOT_EJECTED) return 1;
    if (digest_id < 0) {
        win.flags[i] |= SLOT_EJECTED;  // null digest -> python semantics
        return 1;
    }
    if (win.canonical[i] == -1)
        win.canonical[i] = digest_id;
    else if (win.canonical[i] != digest_id) {
        win.flags[i] |= SLOT_EJECTED;  // conflicting digest -> python
        return 1;
    }
    uint64_t *w = &win.votes[i * p->words + (source >> 6)];
    uint64_t bit = 1ULL << (source & 63);
    if (!(*w & bit)) {
        *w |= bit;
        win.count[i]++;
    }
    int c = win.count[i];
    if (c == p->weak_q || c == p->strong_q ||
        (source == p->my_id && c >= p->weak_q)) {
        *out_win = &win;
        *out_idx = i;
        return 3;
    }
    return 0;
}

// apply_batch(packed_bytes, source) -> list of records in ack order:
//   (idx,)                                   python-fallback
//   (idx, client_id, req_no, digest_id, count, mask_bytes)   crossing
// Packed record layout (little-endian, 16 bytes):
//   int32 client_id, int32 digest_id (-1 null), int64 req_no.
PyObject *plane_apply_batch(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    Py_buffer packed;
    int source;
    if (!PyArg_ParseTuple(args, "y*i", &packed, &source)) return nullptr;
    if (source < 0 || source >= p->n_nodes) {
        PyBuffer_Release(&packed);
        PyErr_SetString(PyExc_ValueError, "source out of range");
        return nullptr;
    }
    PyObject *out = PyList_New(0);
    if (!out) {
        PyBuffer_Release(&packed);
        return nullptr;
    }
    const char *base = (const char *)packed.buf;
    Py_ssize_t n = packed.len / 16;
    for (Py_ssize_t k = 0; k < n; k++) {
        const char *rec = base + k * 16;
        int32_t client_id, digest_id;
        int64_t req_no;
        std::memcpy(&client_id, rec, 4);
        std::memcpy(&digest_id, rec + 4, 4);
        std::memcpy(&req_no, rec + 8, 8);
        ClientWin *win;
        size_t idx;
        int r = apply_core(p, client_id, req_no, digest_id, source, &win, &idx);
        if (r == 0 || r == 2) continue;
        PyObject *item;
        if (r == 1) {
            item = Py_BuildValue("(n)", (Py_ssize_t)k);
        } else {
            PyObject *mask = mask_to_bytes(&win->votes[idx * p->words], p->words);
            if (!mask) {
                Py_DECREF(out);
                PyBuffer_Release(&packed);
                return nullptr;
            }
            item = Py_BuildValue("nLLiiN", (Py_ssize_t)k, (long long)client_id,
                                 (long long)req_no, (int)digest_id,
                                 (int)win->count[idx], mask);
        }
        if (!item || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            PyBuffer_Release(&packed);
            return nullptr;
        }
        Py_DECREF(item);
    }
    PyBuffer_Release(&packed);
    return out;
}

// apply_one(client_id, req_no, digest_bytes, source) ->
//   0 | 1 | 2 (as apply_core) | (count, digest_id, mask_bytes) on crossing.
PyObject *plane_apply_one(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id, req_no;
    PyObject *digest_obj;
    int source;
    if (!PyArg_ParseTuple(args, "LLOi", &client_id, &req_no, &digest_obj,
                          &source))
        return nullptr;
    if (source < 0 || source >= p->n_nodes) {
        PyErr_SetString(PyExc_ValueError, "source out of range");
        return nullptr;
    }
    int32_t did = g_intern->intern(digest_obj);
    if (did == -2) return nullptr;
    ClientWin *win;
    size_t idx;
    int r = apply_core(p, client_id, req_no, did, source, &win, &idx);
    if (r == 3) {
        PyObject *mask = mask_to_bytes(&win->votes[idx * p->words], p->words);
        if (!mask) return nullptr;
        return Py_BuildValue("iiN", (int)win->count[idx], (int)did, mask);
    }
    return PyLong_FromLong(r);
}

// export_client(client_id) -> list of (req_no, digest_id, mask_bytes, count)
// for live (non-ejected, touched) slots; used at reinitialize.
PyObject *plane_export_client(PyObject *self, PyObject *args) {
    Plane *p = (Plane *)self;
    long long client_id;
    if (!PyArg_ParseTuple(args, "L", &client_id)) return nullptr;
    PyObject *out = PyList_New(0);
    if (!out) return nullptr;
    auto it = p->clients->find(client_id);
    if (it == p->clients->end()) return out;
    ClientWin &win = it->second;
    for (int64_t rn = win.low; rn <= win.high; rn++) {
        size_t i = (size_t)(rn - win.low);
        if (win.flags[i] & SLOT_EJECTED) continue;
        if (win.canonical[i] == -1 && win.count[i] == 0) continue;
        PyObject *mask = mask_to_bytes(&win.votes[i * p->words], p->words);
        if (!mask) {
            Py_DECREF(out);
            return nullptr;
        }
        PyObject *item =
            Py_BuildValue("LiNi", (long long)rn, (int)win.canonical[i], mask,
                          (int)win.count[i]);
        if (!item || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            return nullptr;
        }
        Py_DECREF(item);
    }
    return out;
}

PyMethodDef plane_methods[] = {
    {"set_client", plane_set_client, METH_VARARGS, nullptr},
    {"drop_client", plane_drop_client, METH_VARARGS, nullptr},
    {"clear", plane_clear, METH_NOARGS, nullptr},
    {"import_slot", plane_import_slot, METH_VARARGS, nullptr},
    {"mark_ejected", plane_mark_ejected, METH_VARARGS, nullptr},
    {"peek", plane_peek, METH_VARARGS, nullptr},
    {"eject", plane_eject, METH_VARARGS, nullptr},
    {"apply_batch", plane_apply_batch, METH_VARARGS, nullptr},
    {"apply_one", plane_apply_one, METH_VARARGS, nullptr},
    {"export_client", plane_export_client, METH_VARARGS, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PlaneType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// Sequence-vote plane: the O(N^2)-per-sequence Prepare/Commit hot path of
// the three-phase commit (reference pkg/statemachine/sequence.go:257-355,
// epoch_active.go:142-213).  Vote accumulation (replica bitmasks + per-digest
// counts) runs here; Python keeps the sequence lifecycle and reads counts
// lazily at its quorum checks, so the records this plane returns are HINTS —
// liberal is fine, Python re-validates every transition condition.
//
// Contract with mirbft_tpu_torch/statemachine/sequence.py + machine.py:
//
//  * The plane mirrors the active epoch's watermark window exactly
//    (set_window after every extension/trim); Python phase changes are
//    pushed via set_phase, the batch digest via set_expected.
//  * apply_votes() applies one packed envelope of votes from one source,
//    mirroring the _step_prepare/_step_commit filters (owner-INVALID,
//    planned-expiration-INVALID, past-drop); FUTURE and wrong-epoch votes
//    come back as fallback records and Python routes the original message
//    objects through the slow path (buffering, epoch tracker).
//  * Per-slot digest tables are bounded (VOTE_DIGEST_CAP).  Votes for a
//    digest that does not fit are still mask-deduplicated but not counted —
//    harmless for every observable: quorum checks only ever read the
//    expected digest's count, and set_expected's entry always fits (the
//    cap applies to vote-created entries only).

constexpr int VOTE_DIGEST_CAP = 64;
constexpr uint8_t PH_PENDING_REQUESTS = 2;
constexpr uint8_t PH_READY = 3;
constexpr uint8_t PH_PREPREPARED = 4;
constexpr uint8_t PH_PREPARED = 5;

struct DigestCount {
    std::string digest;
    int32_t prep = 0;
    int32_t commit = 0;
};

struct SeqSlot {
    uint8_t phase = 0;          // SeqState numeric value
    bool expected_set = false;  // set_expected called
    std::string expected;       // batch digest ("" = null batch until set)
    bool my_prep_set = false;
    std::string my_prep;        // digest our own prepare carried
    std::vector<uint64_t> prep_mask, commit_mask;  // words each
    std::vector<DigestCount> counts;

    DigestCount *find_count(const char *d, size_t dlen, bool create,
                            bool force) {
        for (auto &c : counts)
            if (c.digest.size() == dlen &&
                std::memcmp(c.digest.data(), d, dlen) == 0)
                return &c;
        if (!create) return nullptr;
        if (!force && counts.size() >= VOTE_DIGEST_CAP) return nullptr;
        counts.push_back(DigestCount{std::string(d, dlen), 0, 0});
        return &counts.back();
    }
};

struct SeqPlaneObj {
    PyObject_HEAD
    int n_nodes, my_id, iq, words, nb;
    int64_t epoch, planned_expiration;
    int64_t low, high;  // inclusive window; high < low -> empty
    std::vector<int32_t> *buckets;
    std::vector<SeqSlot> *slots;  // index: seq_no - low
};

void seqplane_dealloc(PyObject *self) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    delete p->buckets;
    delete p->slots;
    Py_TYPE(self)->tp_free(self);
}

PyObject *seqplane_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    static const char *kwlist[] = {"n_nodes", "my_id", "iq", nullptr};
    int n_nodes, my_id, iq;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "iii", (char **)kwlist,
                                     &n_nodes, &my_id, &iq))
        return nullptr;
    if (n_nodes <= 0 || n_nodes > 4096) {
        PyErr_SetString(PyExc_ValueError, "n_nodes out of range");
        return nullptr;
    }
    SeqPlaneObj *p = (SeqPlaneObj *)type->tp_alloc(type, 0);
    if (!p) return nullptr;
    p->n_nodes = n_nodes;
    p->my_id = my_id;
    p->iq = iq;
    p->words = (n_nodes + 63) / 64;
    p->nb = 0;
    p->epoch = -1;
    p->planned_expiration = -1;
    p->low = 0;
    p->high = -1;
    p->buckets = new std::vector<int32_t>();
    p->slots = new std::vector<SeqSlot>();
    return (PyObject *)p;
}

// reset(epoch, planned_expiration, buckets_bytes): start an (empty) window
// for a new active epoch.  buckets_bytes: little-endian int32 per bucket
// (bucket index -> owning node id).
PyObject *seqplane_reset(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long epoch, planned_expiration;
    Py_buffer buckets;
    if (!PyArg_ParseTuple(args, "LLy*", &epoch, &planned_expiration, &buckets))
        return nullptr;
    p->epoch = epoch;
    p->planned_expiration = planned_expiration;
    p->nb = (int)(buckets.len / 4);
    p->buckets->assign((size_t)p->nb, 0);
    std::memcpy(p->buckets->data(), buckets.buf, (size_t)p->nb * 4);
    PyBuffer_Release(&buckets);
    p->low = 0;
    p->high = -1;
    p->slots->clear();
    Py_RETURN_NONE;
}

// set_window(low, high): rebase to [low, high] preserving overlapping slots.
PyObject *seqplane_set_window(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long low, high;
    if (!PyArg_ParseTuple(args, "LL", &low, &high)) return nullptr;
    if (high - low >= (1 << 22)) {
        PyErr_SetString(PyExc_ValueError, "window too large");
        return nullptr;
    }
    if (low == p->low && high == p->high) Py_RETURN_NONE;  // unchanged
    std::vector<SeqSlot> fresh((size_t)(high >= low ? high - low + 1 : 0));
    for (auto &s : fresh) {
        s.prep_mask.assign((size_t)p->words, 0);
        s.commit_mask.assign((size_t)p->words, 0);
    }
    int64_t from = low > p->low ? low : p->low;
    int64_t to = high < p->high ? high : p->high;
    for (int64_t sn = from; sn <= to; sn++)
        fresh[(size_t)(sn - low)] = std::move((*p->slots)[(size_t)(sn - p->low)]);
    *p->slots = std::move(fresh);
    p->low = low;
    p->high = high;
    Py_RETURN_NONE;
}

inline SeqSlot *seq_slot(SeqPlaneObj *p, int64_t seq_no) {
    if (seq_no < p->low || seq_no > p->high) return nullptr;
    return &(*p->slots)[(size_t)(seq_no - p->low)];
}

PyObject *seqplane_set_phase(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long seq_no;
    int phase;
    if (!PyArg_ParseTuple(args, "Li", &seq_no, &phase)) return nullptr;
    SeqSlot *s = seq_slot(p, seq_no);
    if (!s) {
        PyErr_SetString(PyExc_IndexError, "seq_no outside plane window");
        return nullptr;
    }
    s->phase = (uint8_t)phase;
    Py_RETURN_NONE;
}

PyObject *seqplane_set_expected(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long seq_no;
    const char *d;
    Py_ssize_t dlen;
    if (!PyArg_ParseTuple(args, "Ly#", &seq_no, &d, &dlen)) return nullptr;
    SeqSlot *s = seq_slot(p, seq_no);
    if (!s) {
        PyErr_SetString(PyExc_IndexError, "seq_no outside plane window");
        return nullptr;
    }
    s->expected.assign(d, (size_t)dlen);
    s->expected_set = true;
    s->find_count(d, (size_t)dlen, true, /*force=*/true);
    Py_RETURN_NONE;
}

// Core vote application.  Returns the post-increment count for the vote's
// digest (0 when deduplicated or uncounted), and sets *hint when Python
// should run the corresponding transition check.
inline int32_t seq_apply_core(SeqPlaneObj *p, SeqSlot *s, int kind,
                              const char *d, size_t dlen, int source,
                              bool *dup, bool *hint) {
    *dup = false;
    *hint = false;
    uint64_t *pw = &s->prep_mask[(size_t)(source >> 6)];
    uint64_t *cw = &s->commit_mask[(size_t)(source >> 6)];
    uint64_t bit = 1ULL << (source & 63);
    bool matches_expected =
        s->expected.size() == dlen &&
        std::memcmp(s->expected.data(), d, dlen) == 0;
    if (kind == 0) {  // prepare: dedup on (prep|commit) bit
        if ((*pw | *cw) & bit) {
            *dup = true;
            return 0;
        }
        *pw |= bit;
        if (source == p->my_id) {
            s->my_prep.assign(d, dlen);
            s->my_prep_set = true;
        }
        DigestCount *c = s->find_count(d, dlen, true, false);
        int32_t n = 0;
        if (c) n = ++c->prep;
        if (s->phase == PH_PREPREPARED) {
            if (matches_expected && n >= p->iq) *hint = true;
        } else if (s->phase == PH_READY || s->phase == PH_PENDING_REQUESTS) {
            *hint = true;  // digest-arrival path: Python advance_state
        }
        return n;
    }
    // commit: dedup on commit bit only
    if (*cw & bit) {
        *dup = true;
        return 0;
    }
    *cw |= bit;
    DigestCount *c = s->find_count(d, dlen, true, false);
    int32_t n = 0;
    if (c) n = ++c->commit;
    if (s->phase == PH_PREPARED && matches_expected && n >= p->iq)
        *hint = true;
    return n;
}

// apply_vote(kind, seq_no, digest_bytes, source) -> None (duplicate) | count.
// The slow-path entry used by Sequence.apply_prepare_msg/apply_commit_msg;
// the caller has already passed the epoch_active filters.
PyObject *seqplane_apply_vote(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    int kind, source;
    long long seq_no;
    const char *d;
    Py_ssize_t dlen;
    if (!PyArg_ParseTuple(args, "iLy#i", &kind, &seq_no, &d, &dlen, &source))
        return nullptr;
    if (source < 0 || source >= p->n_nodes) {
        PyErr_SetString(PyExc_ValueError, "source out of range");
        return nullptr;
    }
    SeqSlot *s = seq_slot(p, seq_no);
    if (!s) {
        PyErr_SetString(PyExc_IndexError, "seq_no outside plane window");
        return nullptr;
    }
    bool dup, hint;
    int32_t n = seq_apply_core(p, s, kind, d, (size_t)dlen, source, &dup, &hint);
    if (dup) Py_RETURN_NONE;
    return PyLong_FromLong((long)n);
}

// apply_votes(packed, source) -> list of records, in vote order:
//   (k,)             fallback: Python routes the original message (future
//                    buffering, wrong epoch, unpackable digest)
//   (kind, seq_no)   hint: Python runs the transition check
// Packed record layout (56 bytes, little-endian):
//   u8 kind (0 prepare, 1 commit, 255 unpackable), u8 dlen (<=32), pad[6],
//   i64 seq_no, i64 epoch, u8 digest[32].
PyObject *seqplane_apply_votes(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    Py_buffer packed;
    int source;
    if (!PyArg_ParseTuple(args, "y*i", &packed, &source)) return nullptr;
    if (source < 0 || source >= p->n_nodes) {
        PyBuffer_Release(&packed);
        PyErr_SetString(PyExc_ValueError, "source out of range");
        return nullptr;
    }
    PyObject *out = PyList_New(0);
    if (!out) {
        PyBuffer_Release(&packed);
        return nullptr;
    }
    const char *base = (const char *)packed.buf;
    Py_ssize_t n = packed.len / 56;
    for (Py_ssize_t k = 0; k < n; k++) {
        const char *rec = base + k * 56;
        uint8_t kind = (uint8_t)rec[0];
        uint8_t dlen = (uint8_t)rec[1];
        int64_t seq_no, epoch;
        std::memcpy(&seq_no, rec + 8, 8);
        std::memcpy(&epoch, rec + 16, 8);
        const char *d = rec + 24;

        PyObject *item = nullptr;
        if (kind > 1 || epoch != p->epoch) {
            item = Py_BuildValue("(n)", (Py_ssize_t)k);  // fallback
        } else {
            // Mirror _step_prepare/_step_commit filters (all pre-window
            // verdicts are silent drops, so their relative order is not
            // observable).  PAST first: it also rejects negative seq_no
            // before the bucket modulo, whose C++ sign would otherwise
            // index out of bounds.
            if (seq_no < p->low) continue;  // PAST
            if (kind == 0 && p->nb > 0 &&
                (*p->buckets)[(size_t)(seq_no % p->nb)] == source)
                continue;  // INVALID: owners never send Prepare
            if (seq_no > p->planned_expiration) continue;  // INVALID
            if (seq_no > p->high) {
                item = Py_BuildValue("(n)", (Py_ssize_t)k);  // FUTURE
            } else {
                SeqSlot *s = &(*p->slots)[(size_t)(seq_no - p->low)];
                bool dup, hint;
                seq_apply_core(p, s, kind, d, dlen, source, &dup, &hint);
                if (!hint) continue;
                item = Py_BuildValue("iL", (int)kind, (long long)seq_no);
            }
        }
        if (!item || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            PyBuffer_Release(&packed);
            return nullptr;
        }
        Py_DECREF(item);
    }
    PyBuffer_Release(&packed);
    return out;
}

// query(seq_no) -> (prep_count, commit_count, self_prep_or_commit,
//                   self_commit, my_prep_matches_expected)
// Everything Python's _check_prepare_quorum/_check_commit_quorum read.
// Counts are for the expected digest ("" until set_expected — matching the
// Python path's `digest or b""` keying).
PyObject *seqplane_query(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long seq_no;
    if (!PyArg_ParseTuple(args, "L", &seq_no)) return nullptr;
    SeqSlot *s = seq_slot(p, seq_no);
    if (!s) {
        PyErr_SetString(PyExc_IndexError, "seq_no outside plane window");
        return nullptr;
    }
    DigestCount *c =
        s->find_count(s->expected.data(), s->expected.size(), false, false);
    uint64_t self_p = s->prep_mask[(size_t)(p->my_id >> 6)] &
                      (1ULL << (p->my_id & 63));
    uint64_t self_c = s->commit_mask[(size_t)(p->my_id >> 6)] &
                      (1ULL << (p->my_id & 63));
    // Python dict path compares (my_prepare_digest or b"") != (digest or b"");
    // an unset my_prep is the empty string here, matching.
    bool my_matches = s->my_prep == s->expected;
    return Py_BuildValue("iiiii", c ? (int)c->prep : 0,
                         c ? (int)c->commit : 0,
                         (self_p | self_c) ? 1 : 0, self_c ? 1 : 0,
                         my_matches ? 1 : 0);
}

// export_slot(seq_no) -> (prep_mask, commit_mask, counts_list, my_prep|None)
// for the pure-Python rebuild in tests / debugging.
PyObject *seqplane_export_slot(PyObject *self, PyObject *args) {
    SeqPlaneObj *p = (SeqPlaneObj *)self;
    long long seq_no;
    if (!PyArg_ParseTuple(args, "L", &seq_no)) return nullptr;
    SeqSlot *s = seq_slot(p, seq_no);
    if (!s) Py_RETURN_NONE;
    PyObject *pm = mask_to_bytes(s->prep_mask.data(), p->words);
    PyObject *cm = mask_to_bytes(s->commit_mask.data(), p->words);
    PyObject *counts = PyList_New(0);
    if (!pm || !cm || !counts) {
        Py_XDECREF(pm);
        Py_XDECREF(cm);
        Py_XDECREF(counts);
        return nullptr;
    }
    for (auto &c : s->counts) {
        PyObject *item = Py_BuildValue(
            "y#ii", c.digest.data(), (Py_ssize_t)c.digest.size(),
            (int)c.prep, (int)c.commit);
        if (!item || PyList_Append(counts, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(pm);
            Py_DECREF(cm);
            Py_DECREF(counts);
            return nullptr;
        }
        Py_DECREF(item);
    }
    PyObject *my_prep;
    if (s->my_prep_set)
        my_prep = PyBytes_FromStringAndSize(s->my_prep.data(),
                                            (Py_ssize_t)s->my_prep.size());
    else {
        my_prep = Py_None;
        Py_INCREF(Py_None);
    }
    if (!my_prep) {
        Py_DECREF(pm);
        Py_DECREF(cm);
        Py_DECREF(counts);
        return nullptr;
    }
    return Py_BuildValue("NNNN", pm, cm, counts, my_prep);
}

PyMethodDef seqplane_methods[] = {
    {"reset", seqplane_reset, METH_VARARGS, nullptr},
    {"set_window", seqplane_set_window, METH_VARARGS, nullptr},
    {"set_phase", seqplane_set_phase, METH_VARARGS, nullptr},
    {"set_expected", seqplane_set_expected, METH_VARARGS, nullptr},
    {"apply_vote", seqplane_apply_vote, METH_VARARGS, nullptr},
    {"apply_votes", seqplane_apply_votes, METH_VARARGS, nullptr},
    {"query", seqplane_query, METH_VARARGS, nullptr},
    {"export_slot", seqplane_export_slot, METH_VARARGS, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject SeqPlaneType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// Module-level functions.

PyObject *interned_str_client_id;
PyObject *interned_str_req_no;
PyObject *interned_str_digest;
PyObject *interned_str_seq_no;
PyObject *interned_str_epoch;

// Message classes registered once by the Python glue so pack_votes can
// classify by exact type (borrowed refs held for the process lifetime).
PyObject *g_prepare_type = nullptr;
PyObject *g_commit_type = nullptr;

// register_vote_types(Prepare, Commit)
PyObject *mod_register_vote_types(PyObject *, PyObject *args) {
    PyObject *prep, *commit;
    if (!PyArg_ParseTuple(args, "OO", &prep, &commit)) return nullptr;
    Py_XDECREF(g_prepare_type);
    Py_XDECREF(g_commit_type);
    Py_INCREF(prep);
    Py_INCREF(commit);
    g_prepare_type = prep;
    g_commit_type = commit;
    Py_RETURN_NONE;
}

// pack_votes(msgs) -> (packed_bytes, vote_msgs, rest)
// Splits an envelope's messages into the Prepare/Commit vote stream (packed
// for SeqPlane.apply_votes, originals kept aligned by index for fallback
// routing) and the rest.  A vote whose digest exceeds 32 bytes is packed as
// kind 255 (unpackable -> fallback).  Record layout matches SeqPlane.apply_votes (56 bytes).
PyObject *mod_pack_votes(PyObject *, PyObject *arg) {
    if (!g_prepare_type) {
        PyErr_SetString(PyExc_RuntimeError, "vote types not registered");
        return nullptr;
    }
    PyObject *seq = PySequence_Fast(arg, "pack_votes expects a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *votes = PyList_New(0);
    PyObject *rest = PyList_New(0);
    PyObject *packed = nullptr;
    std::string buf;
    buf.reserve((size_t)n * 56);
    if (!votes || !rest) goto fail;
    for (Py_ssize_t k = 0; k < n; k++) {
        PyObject *msg = PySequence_Fast_GET_ITEM(seq, k);
        PyObject *t = (PyObject *)Py_TYPE(msg);
        int kind;
        if (t == g_prepare_type)
            kind = 0;
        else if (t == g_commit_type)
            kind = 1;
        else {
            if (PyList_Append(rest, msg) < 0) goto fail;
            continue;
        }
        PyObject *sn_o = PyObject_GetAttr(msg, interned_str_seq_no);
        PyObject *ep_o = sn_o ? PyObject_GetAttr(msg, interned_str_epoch) : nullptr;
        PyObject *dg_o = ep_o ? PyObject_GetAttr(msg, interned_str_digest) : nullptr;
        if (!dg_o) {
            Py_XDECREF(sn_o);
            Py_XDECREF(ep_o);
            goto fail;
        }
        {
            int64_t seq_no = PyLong_AsLongLong(sn_o);
            int64_t epoch = PyLong_AsLongLong(ep_o);
            char *d = nullptr;
            Py_ssize_t dlen = 0;
            int bad = PyBytes_AsStringAndSize(dg_o, &d, &dlen) < 0;
            if (bad) PyErr_Clear();
            char rec[56];
            std::memset(rec, 0, 56);
            if (bad || dlen > 32 || PyErr_Occurred()) {
                PyErr_Clear();
                rec[0] = (char)(uint8_t)255;  // unpackable -> fallback
            } else {
                rec[0] = (char)(uint8_t)kind;
                rec[1] = (char)(uint8_t)dlen;
                std::memcpy(rec + 24, d, (size_t)dlen);
            }
            std::memcpy(rec + 8, &seq_no, 8);
            std::memcpy(rec + 16, &epoch, 8);
            buf.append(rec, 56);
        }
        Py_DECREF(sn_o);
        Py_DECREF(ep_o);
        Py_DECREF(dg_o);
        if (PyList_Append(votes, msg) < 0) goto fail;
    }
    packed = PyBytes_FromStringAndSize(buf.data(), (Py_ssize_t)buf.size());
    if (!packed) goto fail;
    Py_DECREF(seq);
    return Py_BuildValue("NNN", packed, votes, rest);
fail:
    Py_XDECREF(votes);
    Py_XDECREF(rest);
    Py_XDECREF(packed);
    Py_DECREF(seq);
    return nullptr;
}

// pack_acks(acks: sequence of RequestAck) -> bytes (16 bytes per ack).
PyObject *mod_pack_acks(PyObject *, PyObject *arg) {
    PyObject *seq = PySequence_Fast(arg, "pack_acks expects a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyBytes_FromStringAndSize(nullptr, n * 16);
    if (!out) {
        Py_DECREF(seq);
        return nullptr;
    }
    char *buf = PyBytes_AS_STRING(out);
    for (Py_ssize_t k = 0; k < n; k++) {
        PyObject *ack = PySequence_Fast_GET_ITEM(seq, k);
        PyObject *cid_o = PyObject_GetAttr(ack, interned_str_client_id);
        if (!cid_o) goto fail;
        PyObject *rn_o = PyObject_GetAttr(ack, interned_str_req_no);
        if (!rn_o) {
            Py_DECREF(cid_o);
            goto fail;
        }
        PyObject *dg_o = PyObject_GetAttr(ack, interned_str_digest);
        if (!dg_o) {
            Py_DECREF(cid_o);
            Py_DECREF(rn_o);
            goto fail;
        }
        {
            int32_t client_id = (int32_t)PyLong_AsLongLong(cid_o);
            int64_t req_no = PyLong_AsLongLong(rn_o);
            int32_t digest_id = g_intern->intern(dg_o);
            Py_DECREF(cid_o);
            Py_DECREF(rn_o);
            Py_DECREF(dg_o);
            if (digest_id == -2 || PyErr_Occurred()) goto fail;
            char *rec = buf + k * 16;
            std::memcpy(rec, &client_id, 4);
            std::memcpy(rec + 4, &digest_id, 4);
            std::memcpy(rec + 8, &req_no, 8);
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

PyObject *mod_digest_bytes(PyObject *, PyObject *arg) {
    long id = PyLong_AsLong(arg);
    if (id == -1 && PyErr_Occurred()) return nullptr;
    if (id < 0 || (size_t)id >= g_intern->objects.size()) {
        PyErr_SetString(PyExc_IndexError, "unknown digest id");
        return nullptr;
    }
    PyObject *o = g_intern->objects[(size_t)id];
    Py_INCREF(o);
    return o;
}

PyMethodDef module_methods[] = {
    {"pack_acks", mod_pack_acks, METH_O, nullptr},
    {"digest_bytes", mod_digest_bytes, METH_O, nullptr},
    {"register_vote_types", mod_register_vote_types, METH_VARARGS, nullptr},
    {"pack_votes", mod_pack_votes, METH_O, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_core",
    "Native hot-path planes for mirbft_tpu_torch (ack-vote accumulation).",
    -1, module_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__core(void) {
    PlaneType.tp_name = "mirbft_tpu_torch._native._core.AckPlane";
    PlaneType.tp_basicsize = sizeof(Plane);
    PlaneType.tp_flags = Py_TPFLAGS_DEFAULT;
    PlaneType.tp_new = plane_new;
    PlaneType.tp_dealloc = plane_dealloc;
    PlaneType.tp_methods = plane_methods;
    if (PyType_Ready(&PlaneType) < 0) return nullptr;

    SeqPlaneType.tp_name = "mirbft_tpu_torch._native._core.SeqPlane";
    SeqPlaneType.tp_basicsize = sizeof(SeqPlaneObj);
    SeqPlaneType.tp_flags = Py_TPFLAGS_DEFAULT;
    SeqPlaneType.tp_new = seqplane_new;
    SeqPlaneType.tp_dealloc = seqplane_dealloc;
    SeqPlaneType.tp_methods = seqplane_methods;
    if (PyType_Ready(&SeqPlaneType) < 0) return nullptr;

    g_intern = new InternTable();
    interned_str_client_id = PyUnicode_InternFromString("client_id");
    interned_str_req_no = PyUnicode_InternFromString("req_no");
    interned_str_digest = PyUnicode_InternFromString("digest");
    interned_str_seq_no = PyUnicode_InternFromString("seq_no");
    interned_str_epoch = PyUnicode_InternFromString("epoch");

    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return nullptr;
    Py_INCREF(&PlaneType);
    if (PyModule_AddObject(m, "AckPlane", (PyObject *)&PlaneType) < 0) {
        Py_DECREF(&PlaneType);
        Py_DECREF(m);
        return nullptr;
    }
    Py_INCREF(&SeqPlaneType);
    if (PyModule_AddObject(m, "SeqPlane", (PyObject *)&SeqPlaneType) < 0) {
        Py_DECREF(&SeqPlaneType);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
