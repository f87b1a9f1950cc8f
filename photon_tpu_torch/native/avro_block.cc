// Native Avro block decoder for the streaming ingest path.
//
// The reference reads training data with spark-avro executors-wide
// (SURVEY.md §2.3 AvroDataReader); this library is the TPU rebuild's
// host-side equivalent: it decodes Avro *block payloads* (the container
// framing, codec inflate, and chunk assembly stay in Python —
// photon_tpu/io/streaming.py) straight into columnar buffers with zero
// per-record Python objects.
//
// Design:
//  * The Python side compiles the writer schema + reader config into
//    (a) a flattened pre-order TYPE TREE (int32 array) used for generic
//    value skipping, and (b) a PROGRAM: one op per top-level record field
//    (skip / numeric column / string column / feature bag / metadataMap).
//  * Feature (name, term) -> column-id lookup is an open-addressing hash
//    table (MurmurHash64A, linear probing) built by Python from the IndexMap
//    via ph_hash_keys — both sides share this file's hash implementation.
//  * String columns (uid, entity-id tags) are DICTIONARY-ENCODED: per-column
//    string->code maps persist across the whole stream, so Python only ever
//    materializes the unique values.
//  * All reads are bounds-checked; malformed input returns a negative error
//    code (never UB) which Python raises as SchemaError.
//
// ABI: plain C, driven via ctypes. All pointers passed into ph_create are
// copied; nothing is retained.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---- type-tree kinds (must match photon_tpu/io/streaming.py) ----
enum Kind : int32_t {
  K_NULL = 0, K_BOOL = 1, K_INT = 2, K_LONG = 3, K_FLOAT = 4, K_DOUBLE = 5,
  K_BYTES = 6, K_STRING = 7, K_FIXED = 8, K_ENUM = 9, K_ARRAY = 10,
  K_MAP = 11, K_RECORD = 12, K_UNION = 13,
};

// ---- program opcodes ----
enum Op : int32_t {
  OP_SKIP = 0,   // [op, ttree_off]
  OP_NUM = 1,    // [op, ttree_off, dst_col, only_if_unset]
  OP_STR = 2,    // [op, ttree_off, str_col, null_to_empty]
  OP_BAG = 3,    // [op, ttree_off, name_fpos, term_fpos, value_fpos, fast,
                 //  n_shards, shard_id * n_shards]  (one bag can feed several
                 //  feature shards, each through its own index table; fast=1
                 //  marks the exact NameTermValueAvro layout
                 //  [name: string, term: [null, string], value: double] which
                 //  takes a straight-line parse)
  OP_META = 4,   // [op, ttree_off, ntags, (tag_str_col, tag_name_id) * ntags]
};

enum Err : int64_t {
  E_TRUNCATED = -1, E_BADVARINT = -2, E_BADUNION = -3, E_BADTYPE = -4,
  E_TAGMISSING = -5, E_DEPTH = -6, E_NOMEM = -7,
};

struct Reader {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;
  bool fail = false;
  int64_t err = 0;

  bool need(int64_t k) {
    if (pos + k > n) { fail = true; err = E_TRUNCATED; return false; }
    return true;
  }
  int64_t varint() {  // zigzag long
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = p[pos++];
      acc |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) { fail = true; err = E_BADVARINT; return 0; }
    }
    return (int64_t)(acc >> 1) ^ -(int64_t)(acc & 1);
  }
  double f32() {
    if (!need(4)) return 0;
    float v; std::memcpy(&v, p + pos, 4); pos += 4; return (double)v;
  }
  double f64() {
    if (!need(8)) return 0;
    double v; std::memcpy(&v, p + pos, 8); pos += 8; return v;
  }
  // Returns (ptr, len) of a length-prefixed byte region (string/bytes).
  const uint8_t* lenprefixed(int64_t* len) {
    int64_t k = varint();
    if (fail || k < 0 || !need(k)) { fail = true; if (!err) err = E_TRUNCATED; *len = 0; return nullptr; }
    const uint8_t* r = p + pos;
    pos += k;
    *len = k;
    return r;
  }
};

// MurmurHash64A — 8 bytes per round (FNV-1a was the bottleneck of the bag
// hot loop at ~10 cycles/byte). The Python-side tables are built through
// ph_hash_keys, so both sides always share this exact function.
uint64_t hash64(const uint8_t* key, int64_t len) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = 0x8445d61a4e774912ULL ^ ((uint64_t)len * m);
  const uint8_t* p = key;
  const uint8_t* end = p + (len & ~7LL);
  while (p != end) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    p += 8;
    k *= m; k ^= k >> r; k *= m;
    h ^= k; h *= m;
  }
  int tail = len & 7;
  if (tail) {
    uint64_t k = 0;
    std::memcpy(&k, p, tail);
    h ^= k; h *= m;
  }
  h ^= h >> r; h *= m; h ^= h >> r;
  return h;
}

constexpr uint8_t KEY_DELIM = 0x01;  // feature_key's name\x01term delimiter


// Alloc-free interning dictionary: open addressing keyed by the shared
// hash64, values appended to one heap; collisions verified against the heap
// bytes. The probe array holds ONLY the 8-byte hashes (payloads ride in a
// parallel array): at 10^6+ keys the table outgrows cache, and a repeat
// intern — the overwhelming case at 10^9 lookups over 10^6 uniques — then
// costs one miss on an 8B slot instead of one on a 24B slot (measured 1.24x
// end-to-end on the config-5 1M-feature index scan: 568s -> 459s over 31GB).
struct StrDict {
  struct Payload { int64_t off; int32_t len; int32_t code; };
  std::vector<uint64_t> hashes;
  std::vector<Payload> payloads;
  std::string heap;
  std::vector<int64_t> offsets{0};  // len = n_unique + 1
  size_t n = 0;

  StrDict() : hashes(1024), payloads(1024) {}

  void grow() {
    std::vector<uint64_t> oldh;
    std::vector<Payload> oldp;
    oldh.swap(hashes);
    oldp.swap(payloads);
    hashes.assign(oldh.size() * 2, 0);
    payloads.assign(oldp.size() * 2, Payload{0, 0, 0});
    uint64_t mask = hashes.size() - 1;
    for (size_t j = 0; j < oldh.size(); j++) {
      if (oldh[j] == 0) continue;
      uint64_t i = oldh[j] & mask;
      while (hashes[i] != 0) i = (i + 1) & mask;
      hashes[i] = oldh[j];
      payloads[i] = oldp[j];
    }
  }

  int32_t intern(const char* s, int64_t len) {
    if (2 * (n + 1) > hashes.size()) grow();
    uint64_t h = hash64((const uint8_t*)s, len);
    if (h == 0) h = 1;
    uint64_t mask = hashes.size() - 1;
    uint64_t i = h & mask;
    while (true) {
      uint64_t hv = hashes[i];
      if (hv == 0) {
        hashes[i] = h;
        payloads[i] = Payload{(int64_t)heap.size(), (int32_t)len,
                              (int32_t)n};
        n++;
        heap.append(s, (size_t)len);
        offsets.push_back((int64_t)heap.size());
        return payloads[i].code;
      }
      if (hv == h) {
        const Payload& p = payloads[i];
        if (p.len == len &&
            std::memcmp(heap.data() + p.off, s, (size_t)len) == 0)
          return p.code;
      }
      i = (i + 1) & mask;
    }
  }
};

struct ShardOut {
  // Feature hash table: split hash/value arrays. At bench-scale tables
  // (<=2^18 features) either layout is cache-resident; at config-5 scale
  // (10^6 features, 2M slots) the 16 MB hash-only probe array stays far
  // closer to cache than 32 MB of interleaved slots, and the 4-byte value
  // is touched only on a hit.
  std::vector<uint64_t> table_h;
  std::vector<int32_t> table_v;
  uint64_t mask = 0;
  // Per-chunk triples, emitted in row-major order.
  std::vector<int32_t> rows;
  std::vector<int32_t> idx;
  std::vector<double> val;
  // Parsed-but-unprobed features for the CURRENT container block (SoA).
  // Probing is deferred to a per-block flush whose software-pipelined
  // prefetch gives every table lookup a controlled ~16-probe lead: the
  // measured ablation on the ingest bench is 73 ns/entry probing inline,
  // 45 ns with per-row batching, and the block flush beats both because
  // the prefetch distance no longer depends on the row's bag length.
  std::vector<uint64_t> pend_h;
  std::vector<int32_t> pend_row;
  std::vector<double> pend_val;
  size_t pend_mark = 0;  // pend size at current record start (error rollback)
  // Index-build ("collect") mode: no table; every decoded feature key
  // (name\x01term) interns here in first-seen order, no triples emitted.
  bool collect = false;
  StrDict keys;
};

struct State {
  std::vector<int32_t> ttree;
  std::vector<int32_t> ops;          // flattened program
  std::vector<int32_t> op_starts;    // offset of each op in `ops`
  int32_t n_num = 0, n_str = 0;
  std::vector<double> null_defaults; // per numeric column
  std::vector<std::string> tag_names;
  std::vector<ShardOut> shards;
  std::vector<StrDict> dicts;        // per string column
  // chunk buffers
  std::vector<std::vector<double>> num_cols;
  std::vector<std::vector<int32_t>> str_codes;  // -1 = unset
  int64_t n_rows = 0;
  // scratch (per record)
  std::vector<double> cur_num;
  std::vector<int32_t> cur_str;
  std::vector<uint8_t> keybuf;       // scratch for collect-mode key assembly
  char fmtbuf[64];
};

// THE one key-layout definition (name\x01term) shared by the probe hash
// (stack or keybuf destination) and collect-mode interning, so the bytes
// the tables were built from and the bytes probed can never drift.
inline int64_t assemble_feature_key(uint8_t* dst, const uint8_t* name,
                                    int64_t nlen, const uint8_t* term,
                                    int64_t tlen) {
  std::memcpy(dst, name, (size_t)nlen);
  dst[nlen] = KEY_DELIM;
  if (tlen) std::memcpy(dst + nlen + 1, term, (size_t)tlen);
  return nlen + 1 + tlen;
}

// Assemble into st.keybuf (reused across calls — no per-call allocation
// once warm): the heap destination for collect-mode interning and
// over-long keys.
int64_t build_feature_key(State& st, const uint8_t* name, int64_t nlen,
                          const uint8_t* term, int64_t tlen) {
  st.keybuf.resize((size_t)(nlen + 1 + tlen));
  return assemble_feature_key(st.keybuf.data(), name, nlen, term, tlen);
}

// Returns 0 never (0 is the probe table's empty sentinel).
uint64_t hash_feature_key(State& st, const uint8_t* name, int64_t nlen,
                          const uint8_t* term, int64_t tlen) {
  const int64_t len = nlen + 1 + tlen;
  if (len <= 56) {
    // Hot case (feature keys are short): concatenate on the stack — no
    // vector resize branch, no heap indirection, and the compiler keeps
    // the buffer in registers/L1 for the immediately-following hash.
    uint8_t buf[56];
    assemble_feature_key(buf, name, nlen, term, tlen);
    uint64_t h = hash64(buf, len);
    return h == 0 ? 1 : h;
  }
  build_feature_key(st, name, nlen, term, tlen);
  uint64_t h = hash64(st.keybuf.data(), len);
  return h == 0 ? 1 : h;
}

void collect_feature(State& st, const int32_t* op, int32_t n_sh,
                     const uint8_t* name, int64_t nlen,
                     const uint8_t* term, int64_t tlen) {
  int64_t klen = build_feature_key(st, name, nlen, term, tlen);
  for (int32_t si = 0; si < n_sh; si++) {
    ShardOut& sh = st.shards[op[7 + si]];
    if (sh.collect)
      sh.keys.intern((const char*)st.keybuf.data(), klen);
  }
}

// ---- generic skip driven by the type tree ----
bool skip_value(const State& st, Reader& r, int32_t o, int depth) {
  if (depth > 64) { r.fail = true; r.err = E_DEPTH; return false; }
  const int32_t* t = st.ttree.data();
  switch (t[o]) {
    case K_NULL: return true;
    case K_BOOL: if (!r.need(1)) return false; r.pos += 1; return true;
    case K_INT: case K_LONG: case K_ENUM: r.varint(); return !r.fail;
    case K_FLOAT: if (!r.need(4)) return false; r.pos += 4; return true;
    case K_DOUBLE: if (!r.need(8)) return false; r.pos += 8; return true;
    case K_BYTES: case K_STRING: {
      int64_t len; r.lenprefixed(&len); return !r.fail;
    }
    case K_FIXED: {
      int64_t k = t[o + 1];
      if (!r.need(k)) return false; r.pos += k; return true;
    }
    case K_ARRAY: case K_MAP: {
      bool is_map = t[o] == K_MAP;
      int32_t child = t[o + 1];
      while (true) {
        int64_t cnt = r.varint();
        if (r.fail) return false;
        if (cnt == 0) return true;
        if (cnt < 0) {  // block with byte size: skip wholesale
          int64_t bytes = r.varint();
          if (r.fail || bytes < 0 || !r.need(bytes)) { r.fail = true; if (!r.err) r.err = E_TRUNCATED; return false; }
          r.pos += bytes;
          continue;
        }
        for (int64_t i = 0; i < cnt; i++) {
          if (is_map) { int64_t len; r.lenprefixed(&len); if (r.fail) return false; }
          if (!skip_value(st, r, child, depth + 1)) return false;
        }
      }
    }
    case K_RECORD: {
      int32_t nf = t[o + 1];
      for (int32_t i = 0; i < nf; i++)
        if (!skip_value(st, r, t[o + 2 + i], depth + 1)) return false;
      return true;
    }
    case K_UNION: {
      int64_t br = r.varint();
      if (r.fail) return false;
      if (br < 0 || br >= t[o + 1]) { r.fail = true; r.err = E_BADUNION; return false; }
      return skip_value(st, r, t[o + 2 + br], depth + 1);
    }
    default: r.fail = true; r.err = E_BADTYPE; return false;
  }
}

// Walk through unions at runtime to a concrete node; returns -1 on error.
int32_t resolve_node(const State& st, Reader& r, int32_t o) {
  const int32_t* t = st.ttree.data();
  int guard = 0;
  while (t[o] == K_UNION) {
    int64_t br = r.varint();
    if (r.fail) return -1;
    if (br < 0 || br >= t[o + 1]) { r.fail = true; r.err = E_BADUNION; return -1; }
    o = t[o + 2 + br];
    if (++guard > 16) { r.fail = true; r.err = E_DEPTH; return -1; }
  }
  return o;
}

// Read a concrete-node numeric value as double. has_value=false for null.
bool read_numeric(const State& st, Reader& r, int32_t o, double* out, bool* has_value) {
  const int32_t* t = st.ttree.data();
  *has_value = true;
  switch (t[o]) {
    case K_NULL: *has_value = false; return true;
    case K_BOOL: if (!r.need(1)) return false; *out = r.p[r.pos++] ? 1.0 : 0.0; return true;
    case K_INT: case K_LONG: *out = (double)r.varint(); return !r.fail;
    case K_FLOAT: *out = r.f32(); return !r.fail;
    case K_DOUBLE: *out = r.f64(); return !r.fail;
    default: r.fail = true; r.err = E_BADTYPE; return false;
  }
}

// Read a concrete node as a string (for uid / tags / metadata values).
// Numerics are stringified like Python str(): longs as decimal, doubles with
// %.17g plus a ".0" suffix when integral-looking. null -> has_value=false.
bool read_stringish(State& st, Reader& r, int32_t o, const char** s, int64_t* len, bool* has_value) {
  const int32_t* t = st.ttree.data();
  *has_value = true;
  switch (t[o]) {
    case K_NULL: *has_value = false; return true;
    case K_STRING: case K_BYTES: {
      const uint8_t* p = r.lenprefixed(len);
      if (r.fail) return false;
      *s = (const char*)p;
      return true;
    }
    case K_INT: case K_LONG: {
      int64_t v = r.varint();
      if (r.fail) return false;
      *len = std::snprintf(st.fmtbuf, sizeof st.fmtbuf, "%lld", (long long)v);
      *s = st.fmtbuf;
      return true;
    }
    case K_FLOAT: case K_DOUBLE: {
      double v = t[o] == K_FLOAT ? r.f32() : r.f64();
      if (r.fail) return false;
      // Shortest round-trip repr (std::to_chars), matching Python's str():
      // str(0.1) == "0.1", not "%.17g"'s "0.10000000000000001".
      int n;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
      auto res = std::to_chars(st.fmtbuf, st.fmtbuf + sizeof st.fmtbuf - 2, v);
      n = (int)(res.ptr - st.fmtbuf);
#else
      // libstdc++ < 11 has no floating-point to_chars: emit the shortest
      // %g repr that round-trips (tries rising precision, like repr()).
      // snprintf and strtod share LC_NUMERIC, so the round-trip check is
      // locale-consistent; the separator then normalizes to '.' so a
      // host process that setlocale()d can't leak "3,14" into output.
      n = 0;
      for (int prec = 15; prec <= 17; prec++) {
        n = std::snprintf(st.fmtbuf, sizeof st.fmtbuf - 2, "%.*g", prec, v);
        char* endp = nullptr;
        double back = std::strtod(st.fmtbuf, &endp);
        if (endp == st.fmtbuf + n && back == v) break;  // NaN: runs to 17
      }
      for (int i = 0; i < n; i++)
        if (st.fmtbuf[i] == ',') st.fmtbuf[i] = '.';
#endif
      // str(3.0) == "3.0": add .0 when the repr has no '.', 'e', or specials.
      bool plain = true;
      for (int i = 0; i < n; i++) {
        char c = st.fmtbuf[i];
        if (c == '.' || c == 'e' || c == 'E' || c == 'n' || c == 'i') plain = false;
      }
      if (plain && n + 2 < (int)sizeof st.fmtbuf) {
        st.fmtbuf[n] = '.'; st.fmtbuf[n + 1] = '0'; n += 2;
      }
      *len = n; *s = st.fmtbuf;
      return true;
    }
    case K_BOOL: {
      if (!r.need(1)) return false;
      bool b = r.p[r.pos++];
      *len = std::snprintf(st.fmtbuf, sizeof st.fmtbuf, b ? "True" : "False");
      *s = st.fmtbuf;
      return true;
    }
    case K_ENUM: { r.varint(); if (r.fail) return false; *has_value = false; return true; }
    default: r.fail = true; r.err = E_BADTYPE; return false;
  }
}

int32_t probe(const ShardOut& sh, uint64_t h) {
  if (sh.mask == 0) return -1;
  uint64_t i = h & sh.mask;
  while (true) {
    uint64_t hv = sh.table_h[i];
    if (hv == h) return sh.table_v[i];
    if (hv == 0) return -1;  // empty sentinel (hash 0 excluded at build)
    i = (i + 1) & sh.mask;
  }
}

// Probe + emit every pending feature of the block, software-pipelined:
// prefetch the table lines PD probes ahead so the (L2/L3-resident at real
// feature counts) random lookups overlap instead of serializing.
void flush_pending(State& st) {
  constexpr size_t PD = 16;
  for (ShardOut& sh : st.shards) {
    const size_t n = sh.pend_h.size();
    if (n == 0) continue;
    for (size_t i = 0; i < n; i++) {
      if (sh.mask && i + PD < n) {
        const uint64_t hp = sh.pend_h[i + PD];
        __builtin_prefetch(&sh.table_h[hp & sh.mask], 0, 1);
        __builtin_prefetch(&sh.table_v[hp & sh.mask], 0, 1);
      }
      const int32_t col = probe(sh, sh.pend_h[i]);
      if (col >= 0) {
        sh.rows.push_back(sh.pend_row[i]);
        sh.idx.push_back(col);
        sh.val.push_back(sh.pend_val[i]);
      }
    }
    sh.pend_h.clear();
    sh.pend_row.clear();
    sh.pend_val.clear();
  }
}

bool decode_record(State& st, Reader& r) {
  const int32_t* t = st.ttree.data();
  std::fill(st.cur_num.begin(), st.cur_num.end(), NAN);
  std::fill(st.cur_str.begin(), st.cur_str.end(), -1);

  for (size_t oi = 0; oi < st.op_starts.size(); oi++) {
    const int32_t* op = st.ops.data() + st.op_starts[oi];
    switch (op[0]) {
      case OP_SKIP: {
        if (!skip_value(st, r, op[1], 0)) return false;
        break;
      }
      case OP_NUM: {
        int32_t o = resolve_node(st, r, op[1]);
        if (o < 0) return false;
        double v; bool has;
        if (!read_numeric(st, r, o, &v, &has)) return false;
        if (has && !(op[3] && !std::isnan(st.cur_num[op[2]])))
          st.cur_num[op[2]] = v;
        break;
      }
      case OP_STR: {
        int32_t o = resolve_node(st, r, op[1]);
        if (o < 0) return false;
        const char* s = ""; int64_t len = 0; bool has;
        if (!read_stringish(st, r, o, &s, &len, &has)) return false;
        if (!has && op[3]) { s = ""; len = 0; has = true; }  // null -> ""
        // Unconditional write: a non-null top-level field always wins over a
        // metadataMap entry regardless of schema field order (OP_META is
        // fill-if-unset; this op overwrites).
        if (has)
          st.cur_str[op[2]] = st.dicts[op[2]].intern(s, len);
        break;
      }
      case OP_BAG: {
        int32_t o = resolve_node(st, r, op[1]);  // null union -> no bag
        if (o < 0) return false;
        if (t[o] == K_NULL) break;
        if (t[o] != K_ARRAY) { r.fail = true; r.err = E_BADTYPE; return false; }
        int32_t rec_o = t[o + 1];
        if (t[rec_o] != K_RECORD) { r.fail = true; r.err = E_BADTYPE; return false; }
        int32_t nf = t[rec_o + 1];
        bool fast = op[5];
        int32_t n_sh = op[6];
        bool any_coll = false, any_probe = false;
        for (int32_t si = 0; si < n_sh; si++) {
          if (st.shards[op[7 + si]].collect) any_coll = true;
          else any_probe = true;
        }
        while (true) {
          int64_t cnt = r.varint();
          if (r.fail) return false;
          if (cnt == 0) break;
          if (cnt < 0) { r.varint(); cnt = -cnt; if (r.fail) return false; }
          if (fast) {
            // Exact NameTermValueAvro layout: straight-line parse. Probing
            // is deferred to flush_pending's block-granular pipeline (see
            // its comment) — this loop only hashes and queues.
            for (int64_t item = 0; item < cnt; item++) {
              int64_t nlen; const uint8_t* np_ = r.lenprefixed(&nlen);
              if (r.fail) return false;
              int64_t br = r.varint();
              if (r.fail) return false;
              const uint8_t* tp = nullptr; int64_t tlen = 0;
              if (br == 1) {
                tp = r.lenprefixed(&tlen);
                if (r.fail) return false;
              } else if (br != 0) { r.fail = true; r.err = E_BADUNION; return false; }
              double v = r.f64();
              if (r.fail) return false;
              if (any_coll)
                collect_feature(st, op, n_sh, np_, nlen, tp, tlen);
              if (any_probe) {  // pure-collect ops skip hash/probe entirely
                uint64_t h = hash_feature_key(st, np_, nlen, tp, tlen);
                for (int32_t si = 0; si < n_sh; si++) {
                  ShardOut& sh = st.shards[op[7 + si]];
                  if (sh.collect) continue;
                  sh.pend_h.push_back(h);
                  sh.pend_row.push_back((int32_t)st.n_rows);
                  sh.pend_val.push_back(v);
                }
              }
            }
          } else {
            for (int64_t item = 0; item < cnt; item++) {
              const char* name = nullptr; int64_t name_len = 0;
              const char* term = nullptr; int64_t term_len = 0;
              double fval = 0; bool have_val = false;
              for (int32_t f = 0; f < nf; f++) {
                int32_t fo = t[rec_o + 2 + f];
                if (f == op[2] || f == op[3]) {  // name / term
                  int32_t c = resolve_node(st, r, fo);
                  if (c < 0) return false;
                  const char* s = nullptr; int64_t len = 0; bool has;
                  if (!read_stringish(st, r, c, &s, &len, &has)) return false;
                  // name/term point into the payload (strings only there);
                  // stringified numerics would alias fmtbuf — treat absent.
                  if (has && s != st.fmtbuf) {
                    if (f == op[2]) { name = s; name_len = len; }
                    else { term = s; term_len = len; }
                  }
                } else if (f == op[4]) {  // value
                  int32_t c = resolve_node(st, r, fo);
                  if (c < 0) return false;
                  if (!read_numeric(st, r, c, &fval, &have_val)) return false;
                } else {
                  if (!skip_value(st, r, fo, 0)) return false;
                }
              }
              if (name == nullptr) continue;
              // Index build sees every named feature — including ones with
              // a null value, which emit no triple but ARE indexed (parity
              // with the per-record scan).
              if (any_coll)
                collect_feature(st, op, n_sh, (const uint8_t*)name, name_len,
                                (const uint8_t*)(term != nullptr ? term : ""),
                                term != nullptr ? term_len : 0);
              if (!have_val || !any_probe) continue;
              uint64_t h = hash_feature_key(
                  st, (const uint8_t*)name, name_len,
                  (const uint8_t*)(term != nullptr ? term : ""),
                  term != nullptr ? term_len : 0);
              for (int32_t si = 0; si < n_sh; si++) {
                ShardOut& sh = st.shards[op[7 + si]];
                if (sh.collect) continue;
                sh.pend_h.push_back(h);
                sh.pend_row.push_back((int32_t)st.n_rows);
                sh.pend_val.push_back(fval);
              }
            }
          }
        }
        // Probing is deferred to flush_pending (block granularity).
        break;
      }
      case OP_META: {
        int32_t o = resolve_node(st, r, op[1]);
        if (o < 0) return false;
        if (t[o] == K_NULL) break;
        if (t[o] != K_MAP) { r.fail = true; r.err = E_BADTYPE; return false; }
        int32_t val_o = t[o + 1];
        int32_t ntags = op[2];
        while (true) {
          int64_t cnt = r.varint();
          if (r.fail) return false;
          if (cnt == 0) break;
          if (cnt < 0) { r.varint(); cnt = -cnt; if (r.fail) return false; }
          for (int64_t item = 0; item < cnt; item++) {
            int64_t klen; const uint8_t* k = r.lenprefixed(&klen);
            if (r.fail) return false;
            int32_t hit_col = -1;
            for (int32_t tg = 0; tg < ntags; tg++) {
              const std::string& nm = st.tag_names[op[3 + 2 * tg + 1]];
              if ((int64_t)nm.size() == klen && std::memcmp(nm.data(), k, klen) == 0) {
                hit_col = op[3 + 2 * tg];
                break;
              }
            }
            if (hit_col >= 0 && st.cur_str[hit_col] < 0) {
              int32_t c = resolve_node(st, r, val_o);
              if (c < 0) return false;
              const char* s = ""; int64_t len = 0; bool has;
              if (!read_stringish(st, r, c, &s, &len, &has)) return false;
              if (has) st.cur_str[hit_col] = st.dicts[hit_col].intern(s, len);
            } else {
              if (!skip_value(st, r, val_o, 0)) return false;
            }
          }
        }
        break;
      }
      default: r.fail = true; r.err = E_BADTYPE; return false;
    }
  }

  for (int32_t c = 0; c < st.n_num; c++) {
    double v = st.cur_num[c];
    st.num_cols[c].push_back(std::isnan(v) ? st.null_defaults[c] : v);
  }
  for (int32_t c = 0; c < st.n_str; c++)
    st.str_codes[c].push_back(st.cur_str[c]);
  st.n_rows++;
  return true;
}

}  // namespace

extern "C" {

void ph_hash_keys(const uint8_t* blob, const int64_t* offs, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = hash64(blob + offs[i], offs[i + 1] - offs[i]);
    out[i] = h == 0 ? 1 : h;
  }
}

// try/catch at EVERY allocating ABI entry: a std::bad_alloc (host under
// memory pressure — e.g. a co-located 60 GB training run) thrown through
// the extern "C" / ctypes boundary is undefined behavior that in practice
// reaches std::terminate -> abort -> a "Fatal Python error: Aborted" that
// kills the whole interpreter. Allocation failure must surface as a
// catchable Python exception (nullptr / E_NOMEM), not a crashed process.
void* ph_create(
    const int32_t* ttree, int64_t ttree_len,
    const int32_t* ops, int64_t ops_len,
    const int64_t* op_starts, int64_t n_ops,
    int32_t n_num, const double* null_defaults,
    int32_t n_str,
    const uint8_t* tag_blob, const int64_t* tag_offs, int64_t n_tag_names,
    int32_t n_shards, const uint64_t** table_hashes, const int32_t** table_vals,
    const int64_t* table_sizes) try {
  std::unique_ptr<State> owned(new State());
  State* st = owned.get();
  st->ttree.assign(ttree, ttree + ttree_len);
  st->ops.assign(ops, ops + ops_len);
  st->op_starts.assign(op_starts, op_starts + n_ops);
  st->n_num = n_num;
  st->null_defaults.assign(null_defaults, null_defaults + n_num);
  st->n_str = n_str;
  for (int64_t i = 0; i < n_tag_names; i++)
    st->tag_names.emplace_back((const char*)tag_blob + tag_offs[i],
                               (size_t)(tag_offs[i + 1] - tag_offs[i]));
  st->shards.resize(n_shards);
  for (int32_t s = 0; s < n_shards; s++) {
    ShardOut& sh = st->shards[s];
    if (table_sizes[s] < 0) {  // collect (index-build) mode: no table
      sh.collect = true;
      continue;
    }
    sh.table_h.assign(table_hashes[s], table_hashes[s] + table_sizes[s]);
    sh.table_v.assign(table_vals[s], table_vals[s] + table_sizes[s]);
    sh.mask = table_sizes[s] ? (uint64_t)(table_sizes[s] - 1) : 0;
  }
  st->dicts.resize(n_str);
  st->num_cols.resize(n_num);
  st->str_codes.resize(n_str);
  st->cur_num.resize(n_num);
  st->cur_str.resize(n_str);
  return owned.release();
} catch (...) {
  return nullptr;  // caller raises MemoryError("ph_create failed")
}

void ph_destroy(void* p) { delete (State*)p; }

// Decode `count` records from an (already-inflated) block payload.
// Returns rows decoded so far in this chunk, or a negative error code.
int64_t ph_decode_block(void* p, const uint8_t* payload, int64_t size, int64_t count) try {
  State& st = *(State*)p;
  Reader r{payload, size};
  for (int64_t i = 0; i < count; i++) {
    for (ShardOut& sh : st.shards) sh.pend_mark = sh.pend_h.size();
    if (!decode_record(st, r)) {
      // Roll the failed record's partially-queued features back BEFORE the
      // flush: they carry row id == n_rows, which is never incremented for
      // the failed record — emitting them would alias the next decoded
      // record's row (and can index past a caller's (n, k) ELL arrays).
      // Completed rows' features stay valid.
      for (ShardOut& sh : st.shards) {
        sh.pend_h.resize(sh.pend_mark);
        sh.pend_row.resize(sh.pend_mark);
        sh.pend_val.resize(sh.pend_mark);
      }
      flush_pending(st);
      return r.err ? r.err : E_TRUNCATED;
    }
  }
  flush_pending(st);
  if (r.pos != r.n) return E_TRUNCATED;  // trailing garbage = framing bug
  return st.n_rows;
} catch (...) {
  // Almost certainly bad_alloc from a buffer growth mid-decode; the chunk
  // state is now incoherent, so the caller must treat this decoder as
  // dead (the raised error aborts the stream — correct: rows were lost).
  return E_NOMEM;
}

int64_t ph_chunk_rows(void* p) { return ((State*)p)->n_rows; }

// Scatter row-major (row, col, value) triples into preinitialized padded ELL
// arrays ([n_rows, k]; iarr prefilled with the ghost column, varr with 0).
// `rows` must be nondecreasing — exactly the order ph_get_shard_triples
// emits — so each entry's slot is a running position within its row, no
// per-row counts or index arithmetic arrays needed (replaces the numpy
// fancy-index scatter that was ~26% of ingest time).
void ph_ell_scatter_f32(const int32_t* rows, const int32_t* idx,
                        const double* val, int64_t nnz, int64_t k,
                        int64_t base, int32_t* iarr, float* varr) {
  int64_t pos = 0;
  int32_t cur = -1;
  for (int64_t e = 0; e < nnz; e++) {
    int32_t r = rows[e];
    if (r != cur) { cur = r; pos = base; }
    int64_t o = (int64_t)r * k + pos++;
    iarr[o] = idx[e];
    varr[o] = (float)val[e];
  }
}

void ph_ell_scatter_f64(const int32_t* rows, const int32_t* idx,
                        const double* val, int64_t nnz, int64_t k,
                        int64_t base, int32_t* iarr, double* varr) {
  int64_t pos = 0;
  int32_t cur = -1;
  for (int64_t e = 0; e < nnz; e++) {
    int32_t r = rows[e];
    if (r != cur) { cur = r; pos = base; }
    int64_t o = (int64_t)r * k + pos++;
    iarr[o] = idx[e];
    varr[o] = val[e];
  }
}

void ph_get_num_col(void* p, int32_t col, double* out) {
  State& st = *(State*)p;
  std::memcpy(out, st.num_cols[col].data(), st.num_cols[col].size() * 8);
}

void ph_get_str_codes(void* p, int32_t col, int32_t* out) {
  State& st = *(State*)p;
  std::memcpy(out, st.str_codes[col].data(), st.str_codes[col].size() * 4);
}

int64_t ph_shard_nnz(void* p, int32_t shard) {
  return (int64_t)((State*)p)->shards[shard].rows.size();
}

void ph_get_shard_triples(void* p, int32_t shard, int32_t* rows, int32_t* idx, double* val) {
  ShardOut& sh = ((State*)p)->shards[shard];
  std::memcpy(rows, sh.rows.data(), sh.rows.size() * 4);
  std::memcpy(idx, sh.idx.data(), sh.idx.size() * 4);
  std::memcpy(val, sh.val.data(), sh.val.size() * 8);
}

// Direct ELL assembly from the internal row-major triples: ONE pass writes
// entries AND ghost padding straight into the caller's (n_rows, k) arrays.
// Replaces the take-triples -> numpy-bincount -> full/zeros-fill -> scatter
// pipeline on the Python side (three extra O(nnz)+O(n_rows*k) passes and
// ~20 B/entry of copies) with a single native walk.
int64_t ph_shard_max_run(void* p, int32_t shard) {
  // rows is row-major ordered, so the per-row count = longest run.
  ShardOut& sh = ((State*)p)->shards[shard];
  int64_t best = 0, cur = 0;
  int32_t prev = -1;
  for (int32_t r : sh.rows) {
    if (r == prev) {
      cur++;
    } else {
      prev = r;
      cur = 1;
    }
    if (cur > best) best = cur;
  }
  return best;
}

}  // extern "C" — a template cannot carry C linkage; reopened below.

template <typename T>
static void ell_direct(const ShardOut& sh, int64_t n_rows, int64_t k,
                       int64_t icol, int64_t pad_col, int32_t* iarr,
                       T* varr) {
  const int64_t base = icol >= 0 ? 1 : 0;
  const int64_t nnz = (int64_t)sh.rows.size();
  int64_t t = 0;
  for (int64_t r = 0; r < n_rows; r++) {
    int32_t* ip = iarr + r * k;
    T* vp = varr + r * k;
    int64_t c = 0;
    if (base) {
      ip[0] = (int32_t)icol;
      vp[0] = (T)1.0;
      c = 1;
    }
    // Bounded by c < k: callers derive k from ph_shard_max_run, but that
    // invariant crosses a ctypes boundary — a mismatched k must truncate
    // the row, never write past the caller's (n, k) slot. The scan still
    // consumes the whole run so row alignment survives truncation.
    for (; t < nnz && sh.rows[t] == (int32_t)r; t++) {
      if (c < k) {
        ip[c] = sh.idx[t];
        vp[c] = (T)sh.val[t];
        c++;
      }
    }
    for (; c < k; c++) {
      ip[c] = (int32_t)pad_col;
      vp[c] = (T)0.0;
    }
  }
}

extern "C" void ph_shard_ell_f32(void* p, int32_t shard, int64_t n_rows,
                                 int64_t k, int64_t icol, int64_t pad_col,
                                 int32_t* iarr, float* varr) {
  ell_direct(((State*)p)->shards[shard], n_rows, k, icol, pad_col, iarr, varr);
}

extern "C" void ph_shard_ell_f64(void* p, int32_t shard, int64_t n_rows,
                                 int64_t k, int64_t icol, int64_t pad_col,
                                 int32_t* iarr, double* varr) {
  ell_direct(((State*)p)->shards[shard], n_rows, k, icol, pad_col, iarr, varr);
}

extern "C" {  // remaining exports continue with C linkage

// Dictionary snapshots for one string column. The *_range forms fetch only
// entries [start, size) so per-chunk snapshots cost O(new entries), not
// O(all entries) — dictionaries grow monotonically across the stream.
static int64_t dict_size(const StrDict& d) {
  return (int64_t)d.offsets.size() - 1;
}
static int64_t dict_heap_bytes_from(const StrDict& d, int64_t start) {
  return (int64_t)d.heap.size() - d.offsets[start];
}
static void dict_range(const StrDict& d, int64_t start, uint8_t* heap,
                       int64_t* offsets) {
  int64_t base = d.offsets[start];
  int64_t n = (int64_t)d.offsets.size() - 1 - start;
  std::memcpy(heap, d.heap.data() + base, d.heap.size() - base);
  for (int64_t i = 0; i <= n; i++) offsets[i] = d.offsets[start + i] - base;
}

int64_t ph_dict_size(void* p, int32_t col) {
  return dict_size(((State*)p)->dicts[col]);
}
int64_t ph_dict_heap_bytes_from(void* p, int32_t col, int64_t start) {
  return dict_heap_bytes_from(((State*)p)->dicts[col], start);
}
void ph_get_dict_range(void* p, int32_t col, int64_t start, uint8_t* heap,
                       int64_t* offsets) {
  dict_range(((State*)p)->dicts[col], start, heap, offsets);
}

// Collected feature-key dictionaries for collect-mode shards (same range
// protocol as the string-column dicts; keys are name\x01term bytes in
// first-seen order, persisting across chunk resets).
int64_t ph_shard_dict_size(void* p, int32_t shard) {
  return dict_size(((State*)p)->shards[shard].keys);
}
int64_t ph_shard_dict_heap_bytes_from(void* p, int32_t shard, int64_t start) {
  return dict_heap_bytes_from(((State*)p)->shards[shard].keys, start);
}
void ph_shard_dict_range(void* p, int32_t shard, int64_t start, uint8_t* heap,
                         int64_t* offsets) {
  dict_range(((State*)p)->shards[shard].keys, start, heap, offsets);
}

// Clear per-chunk row buffers; dictionaries persist across chunks.
void ph_reset_chunk(void* p) {
  State& st = *(State*)p;
  st.n_rows = 0;
  for (auto& c : st.num_cols) c.clear();
  for (auto& c : st.str_codes) c.clear();
  for (auto& sh : st.shards) {
    sh.rows.clear(); sh.idx.clear(); sh.val.clear();
    sh.pend_h.clear(); sh.pend_row.clear(); sh.pend_val.clear();
  }
}

}  // extern "C"
