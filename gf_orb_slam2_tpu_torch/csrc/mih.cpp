// Multi-index hashing over 256-bit ORB descriptors — native host runtime.
//
// Replacement for the reference's MultiIndexHashing (reference:
// src/Hashing.cc / include/Hashing.h): the descriptor is split into
// `n_tables` substrings of `bits_per_substring` bits; each substring indexes
// one table of 2^bits buckets; buckets are bounded rings (MAX_BUCKET_SIZE=20,
// latest-entry dedup — Hashing.cc:105-330). Query gathers candidates from the
// first `n_active` tables (NUM_ACTIVE_HASHTABLES, online table selection
// chooses which — Hashing.h:63).
//
// Host code by design: hash-table mutation is pointer-chasing control flow,
// while the descriptor Hamming re-ranking of the candidates runs on the GPU
// (matching/hamming.py, kernel csrc/hamming_best2.cu). The tables are plain
// std::vectors with no lock of their own: the caller serializes every call
// (the port holds the map store's lock around each one). Built with g++ as a
// plain shared library, bound via ctypes (hashing/mih.py).


#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Bucket {
    std::vector<int32_t> ids;  // bounded ring, newest last
};

struct MIH {
    int n_tables;
    int bits;          // bits per substring
    int n_buckets;     // 2^bits
    int max_bucket;
    std::vector<Bucket> buckets;  // [n_tables * n_buckets]

    inline uint32_t substring(const uint32_t* d, int t) const {
        // extract `bits` bits starting at t*bits from the 256-bit descriptor
        int start = t * bits;
        int word = start >> 5;
        int off = start & 31;
        uint64_t lo = d[word];
        uint64_t hi = (word + 1 < 8) ? d[word + 1] : 0;
        uint64_t v = (lo >> off) | (hi << (32 - off));
        return static_cast<uint32_t>(v & ((1ull << bits) - 1));
    }
};

}  // namespace

extern "C" {

void* mih_create(int n_tables, int bits, int max_bucket) {
    MIH* h = new MIH;
    h->n_tables = n_tables;
    h->bits = bits;
    h->n_buckets = 1 << bits;
    h->max_bucket = max_bucket;
    h->buckets.resize(static_cast<size_t>(n_tables) * h->n_buckets);
    return h;
}

void mih_destroy(void* ptr) { delete static_cast<MIH*>(ptr); }

void mih_clear(void* ptr) {
    MIH* h = static_cast<MIH*>(ptr);
    for (auto& b : h->buckets) b.ids.clear();
}

// Insert `n` descriptors (uint32[n][8]) with their ids. Returns how many
// entries were evicted from full buckets to make room.
int mih_insert(void* ptr, const uint32_t* desc, const int32_t* ids, int n) {
    MIH* h = static_cast<MIH*>(ptr);
    int evicted = 0;
    for (int i = 0; i < n; ++i) {
        const uint32_t* d = desc + 8 * i;
        int32_t id = ids[i];
        for (int t = 0; t < h->n_tables; ++t) {
            uint32_t key = h->substring(d, t);
            Bucket& b = h->buckets[static_cast<size_t>(t) * h->n_buckets + key];
            // latest-entry dedup (reference: Bucket dedup, Hashing.cc:105-330)
            if (!b.ids.empty() && b.ids.back() == id) continue;
            if (static_cast<int>(b.ids.size()) >= h->max_bucket) {
                b.ids.erase(b.ids.begin());  // evict oldest
                ++evicted;
            }
            b.ids.push_back(id);
        }
    }
    return evicted;
}

// Remove an id from every bucket it appears in (point culled/replaced).
void mih_erase(void* ptr, int32_t id) {
    MIH* h = static_cast<MIH*>(ptr);
    for (auto& b : h->buckets) {
        for (size_t k = 0; k < b.ids.size();) {
            if (b.ids[k] == id)
                b.ids.erase(b.ids.begin() + k);
            else
                ++k;
        }
    }
}

// Query `n` descriptors against the first `n_active` tables (or a subset
// given by `table_sel`, length n_active). Appends unique candidate ids into
// `out` (capacity `max_out`), marking presence via the `seen` scratch
// (caller-provided bytes of size seen_size, zeroed). Returns count.
int mih_query(void* ptr, const uint32_t* desc, int n, const int32_t* table_sel,
              int n_active, int32_t* out, int max_out, uint8_t* seen,
              int seen_size) {
    MIH* h = static_cast<MIH*>(ptr);
    int count = 0;
    for (int i = 0; i < n && count < max_out; ++i) {
        const uint32_t* d = desc + 8 * i;
        for (int ti = 0; ti < n_active && count < max_out; ++ti) {
            int t = table_sel ? table_sel[ti] : ti;
            if (t < 0 || t >= h->n_tables) continue;
            uint32_t key = h->substring(d, t);
            const Bucket& b =
                h->buckets[static_cast<size_t>(t) * h->n_buckets + key];
            for (int32_t id : b.ids) {
                if (id >= 0 && id < seen_size && !seen[id]) {
                    seen[id] = 1;
                    out[count++] = id;
                    if (count >= max_out) break;
                }
            }
        }
    }
    return count;
}

// Per-table bucket occupancy stats for online table selection
// (reference: Tracking::UpdateQueryNumByHashTable Tracking.cc:3111).
void mih_table_sizes(void* ptr, int64_t* out) {
    MIH* h = static_cast<MIH*>(ptr);
    for (int t = 0; t < h->n_tables; ++t) {
        int64_t s = 0;
        for (int k = 0; k < h->n_buckets; ++k)
            s += h->buckets[static_cast<size_t>(t) * h->n_buckets + k].ids.size();
        out[t] = s;
    }
}

}  // extern "C"
