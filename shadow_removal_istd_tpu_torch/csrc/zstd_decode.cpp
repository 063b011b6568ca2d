// A zstd frame decoder (RFC 8878), decode only, for the orbax checkpoint
// reader (utils/zstd.py). Covers the frame header (single-segment and
// window forms, dictionary ID 0, the optional content checksum, checked
// with the XXH64 below), raw, RLE and compressed blocks, literals (raw,
// RLE, Huffman with 1 or 4 streams, treeless), sequences (predefined, RLE,
// FSE and repeat modes), repeat offsets, concatenated and skippable frames.
// Every read is bounds-checked; a corrupt input returns an error message
// and no output.
//
// C ABI (ctypes):
//   int64_t srit_zstd_content_size(const uint8_t* src, size_t n);
//     the decoded size when every frame's header states its content
//     size, found by walking the block headers; -1 otherwise.
//   int srit_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
//                            size_t cap, uint8_t** out, size_t* out_n,
//                            char* err, size_t err_n);
//     With dst, decodes into dst[0, cap) and fails past it; without,
//     into memory from malloc (*out, free with srit_zstd_free). 0 on
//     success, else -1 with a message in err.
//   void srit_zstd_free(uint8_t* p);

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

// The decoded bytes: a caller's fixed buffer, or memory from malloc that
// grows.
struct Out {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  bool fixed = false;
  ~Out() {
    if (!fixed) std::free(p);
  }
  void reserve(size_t c) {
    if (c <= cap) return;
    if (fixed) fail("output larger than its stated content size");
    size_t nc = cap * 2 > c ? cap * 2 : c;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, nc ? nc : 1));
    if (!q) fail("out of memory");
    p = q;
    cap = nc;
  }
  uint8_t* extend(size_t k) {  // k more bytes at the end
    reserve(n + k);
    uint8_t* q = p + n;
    n += k;
    return q;
  }
  void append(const uint8_t* src, size_t k) {
    if (k) std::memcpy(extend(k), src, k);
  }
  uint8_t* release() {
    uint8_t* q = p;
    p = nullptr;
    return q;
  }
};

inline uint64_t rd_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highest_bit(uint32_t v) {  // index of the highest set bit
  return 31 - __builtin_clz(v);
}

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      uint64_t w[4];
      std::memcpy(w, p, 32);
      v1 = xround(v1, w[0]);
      v2 = xround(v2, w[1]);
      v3 = xround(v3, w[2]);
      v4 = xround(v4, w[3]);
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    h ^= xround(0, k);
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    uint32_t k;
    std::memcpy(&k, p, 4);
    h ^= uint64_t(k) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers

// Forward (little-endian, least significant bit first): FSE table headers.
struct ForwardBits {
  const uint8_t* p;
  size_t n;       // bytes
  size_t pos = 0; // bits consumed
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t read(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i, ++pos)  // zeros past the end
      if ((pos >> 3) < n) v |= uint32_t((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  void rewind(int bits) { pos -= bits; }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Backward: Huffman and sequence bitstreams, read from the end; the last
// byte's highest set bit marks where the stream starts. A read past the
// start yields zero bits and drives `off` negative.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t off;  // bits not yet consumed, counted from the start
  BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream without its end marker");
    off = int64_t(n) * 8 - (8 - highest_bit(last));
  }
  // `bits` <= 56
  inline uint64_t read(int bits) {
    if (bits == 0) return 0;
    off -= bits;
    int64_t start = off;
    int nb = bits;
    if (start < 0) {
      nb += int(start);
      start = 0;
      if (nb <= 0) return 0;
    }
    size_t byte = size_t(start >> 3);
    uint64_t w;
    if (byte + 8 <= n) {
      std::memcpy(&w, p + byte, 8);
    } else {
      w = rd_le(p + byte, int(n - byte));
    }
    uint64_t v = (w >> (start & 7)) & ((uint64_t(1) << nb) - 1);
    if (off < 0) v <<= -off;
    return v;
  }
};

// ------------------------------------------------------------------- FSE

struct FSETable {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
  bool ready = false;
};

void fse_build(FSETable& t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high == 0) fail("FSE table overfull");
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    uint16_t d = next[t.sym[u]]++;
    if (d == 0) fail("FSE table symbol without probability");
    int nb = log - highest_bit(d);
    t.nbits[u] = uint8_t(nb);
    t.base[u] = uint16_t((d << nb) - size);
  }
  t.ready = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read_header(FSETable& t, const uint8_t* p, size_t n, int max_log,
                       int max_sym) {
  ForwardBits in(p, n);
  int log = 5 + int(in.read(4));
  if (log > max_log) fail("FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int s = 0;
  while (remaining > 0 && s <= max_sym) {
    int bits = highest_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t thr = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < thr) {
      in.rewind(1);
      val &= lower;
    } else if (val > lower) {
      val -= thr;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      int rep = int(in.read(2));
      for (;;) {
        for (int i = 0; i < rep; ++i) {
          if (s > max_sym) fail("FSE zero run past the alphabet");
          norm[s++] = 0;
        }
        if (rep != 3) break;
        rep = int(in.read(2));
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  if (in.bytes_used() > n) fail("FSE table header runs past its block");
  fse_build(t, norm, s, log);
  return in.bytes_used();
}

void fse_rle(FSETable& t, uint8_t symbol) {
  t.log = 0;
  t.sym.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
  t.ready = true;
}

// --------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
  bool ready = false;
};

void huf_build(HufTable& t, const uint8_t* weights, int nw) {
  // the last symbol's weight is implied: the weights' 2^(w-1) sum to a
  // power of two
  if (nw < 1 || nw > 255) fail("Huffman weights count out of range");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highest_bit(total) + 1;
  uint32_t left = (1u << max_bits) - total;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights do not close");
  if (max_bits > 11) fail("Huffman code too long");
  int nsym = nw + 1;
  uint8_t bits[256];
  for (int i = 0; i < nw; ++i)
    bits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
  bits[nw] = uint8_t(max_bits + 1 - (highest_bit(left) + 1));
  int size = 1 << max_bits;
  t.max_bits = max_bits;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t count[13] = {0}, idx[13] = {0};
  for (int i = 0; i < nsym; ++i) count[bits[i]]++;
  idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    idx[b - 1] = idx[b] + count[b] * (1u << (max_bits - b));
    for (uint32_t u = idx[b]; u < idx[b - 1]; ++u) t.nbits[u] = uint8_t(b);
  }
  if (idx[0] != uint32_t(size)) fail("Huffman table does not fill");
  for (int i = 0; i < nsym; ++i) {
    if (!bits[i]) continue;
    uint32_t code = idx[bits[i]], len = 1u << (max_bits - bits[i]);
    std::memset(&t.sym[code], i, len);
    idx[bits[i]] += len;
  }
  t.ready = true;
}

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read_tree(HufTable& t, const uint8_t* p, size_t n) {
  if (n < 1) fail("missing Huffman tree description");
  uint8_t head = p[0];
  uint8_t w[256];
  int nw = 0;
  size_t used;
  if (head >= 128) {
    nw = head - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail("Huffman weights past the literals");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    used = 1 + bytes;
  } else {
    size_t csize = head;
    if (1 + csize > n || csize == 0) fail("Huffman weights past the literals");
    const uint8_t* q = p + 1;
    FSETable ft;
    size_t hdr = fse_read_header(ft, q, csize, 6, 255);
    if (hdr >= csize) fail("Huffman weight stream empty");
    BackBits in(q + hdr, csize - hdr);
    uint32_t s1 = uint32_t(in.read(ft.log)), s2 = uint32_t(in.read(ft.log));
    for (;;) {
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = ft.sym[s1];
      s1 = ft.base[s1] + uint32_t(in.read(ft.nbits[s1]));
      if (in.off < 0) {
        if (nw >= 255) fail("too many Huffman weights");
        w[nw++] = ft.sym[s2];
        break;
      }
      if (nw >= 255) fail("too many Huffman weights");
      w[nw++] = ft.sym[s2];
      s2 = ft.base[s2] + uint32_t(in.read(ft.nbits[s2]));
      if (in.off < 0) {
        if (nw >= 255) fail("too many Huffman weights");
        w[nw++] = ft.sym[s1];
        break;
      }
    }
    used = 1 + csize;
  }
  huf_build(t, w, nw);
  return used;
}

void huf_stream(const HufTable& t, const uint8_t* p, size_t n, uint8_t* out,
                size_t count) {
  BackBits in(p, n);
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  uint32_t state = uint32_t(in.read(mb));
  for (size_t i = 0; i < count; ++i) {
    out[i] = t.sym[state];
    int nb = t.nbits[state];
    state = ((state << nb) | uint32_t(in.read(nb))) & mask;
  }
  if (in.off != -mb) fail("Huffman stream size does not match its content");
}

// ---------------------------------------------------------------- frames

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FSETable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

// Decodes the literals section; returns its size in bytes.
size_t decode_literals(FrameState& fs, const uint8_t* p, size_t n) {
  if (n < 1) fail("empty compressed block");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  size_t regen, csize = 0, hdr;
  if (type < 2) {
    if ((fmt & 1) == 0) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (fmt == 1) {
      if (n < 2) fail("literals header truncated");
      hdr = 2;
      regen = (p[0] >> 4) | (size_t(p[1]) << 4);
    } else {
      if (n < 3) fail("literals header truncated");
      hdr = 3;
      regen = (p[0] >> 4) | (size_t(p[1]) << 4) | (size_t(p[2]) << 12);
    }
    fs.lit.resize(regen);
    if (type == 0) {
      if (hdr + regen > n) fail("raw literals past the block");
      std::memcpy(fs.lit.data(), p + hdr, regen);
      return hdr + regen;
    }
    if (hdr + 1 > n) fail("RLE literals past the block");
    std::memset(fs.lit.data(), p[hdr], regen);
    return hdr + 1;
  }
  int streams = fmt == 0 ? 1 : 4;
  if (fmt < 2) {
    if (n < 3) fail("literals header truncated");
    uint32_t v = uint32_t(rd_le(p, 3));
    hdr = 3;
    regen = (v >> 4) & 0x3FF;
    csize = (v >> 14) & 0x3FF;
  } else if (fmt == 2) {
    if (n < 4) fail("literals header truncated");
    uint32_t v = uint32_t(rd_le(p, 4));
    hdr = 4;
    regen = (v >> 4) & 0x3FFF;
    csize = v >> 18;
  } else {
    if (n < 5) fail("literals header truncated");
    uint64_t v = rd_le(p, 5);
    hdr = 5;
    regen = (v >> 4) & 0x3FFFF;
    csize = (v >> 22) & 0x3FFFF;
  }
  if (regen > (128u << 10)) fail("literals larger than a block");
  if (hdr + csize > n) fail("compressed literals past the block");
  const uint8_t* q = p + hdr;
  size_t qn = csize;
  if (type == 2) {
    size_t t = huf_read_tree(fs.huf, q, qn);
    q += t;
    qn -= t;
  } else if (!fs.huf.ready) {
    fail("treeless literals without a previous Huffman table");
  }
  fs.lit.resize(regen);
  if (streams == 1) {
    huf_stream(fs.huf, q, qn, fs.lit.data(), regen);
  } else {
    if (qn < 6) fail("literals jump table truncated");
    size_t s1 = rd_le(q, 2), s2 = rd_le(q + 2, 2), s3 = rd_le(q + 4, 2);
    if (6 + s1 + s2 + s3 > qn) fail("literals streams past the block");
    size_t s4 = qn - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("literals too short for four streams");
    const uint8_t* sp = q + 6;
    uint8_t* o = fs.lit.data();
    huf_stream(fs.huf, sp, s1, o, seg);
    huf_stream(fs.huf, sp + s1, s2, o + seg, seg);
    huf_stream(fs.huf, sp + s1 + s2, s3, o + 2 * seg, seg);
    huf_stream(fs.huf, sp + s1 + s2 + s3, s4, o + 3 * seg, regen - 3 * seg);
  }
  return hdr + csize;
}

size_t read_table(FSETable& t, int mode, const int16_t* dflt, int dflt_n,
                  int dflt_log, int max_log, int max_sym, const uint8_t* p,
                  size_t n) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, dflt_n, dflt_log);
      return 0;
    case 1:
      if (n < 1) fail("RLE sequence table truncated");
      if (p[0] > max_sym) fail("RLE sequence symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read_header(t, p, n, max_log, max_sym);
    default:
      if (!t.ready) fail("repeat sequence table without a previous one");
      return 0;
  }
}

void decode_block(FrameState& fs, const uint8_t* p, size_t n,
                  Out& out, size_t frame_start) {
  size_t used = decode_literals(fs, p, n);
  p += used;
  n -= used;
  if (n < 1) fail("sequences section missing");
  size_t nseq, h;
  if (p[0] < 128) {
    nseq = p[0];
    h = 1;
  } else if (p[0] < 255) {
    if (n < 2) fail("sequence count truncated");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    h = 2;
  } else {
    if (n < 3) fail("sequence count truncated");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    h = 3;
  }
  p += h;
  n -= h;
  const uint8_t* lit = fs.lit.data();
  size_t nlit = fs.lit.size(), li = 0;
  if (nseq == 0) {
    if (n != 0) fail("bytes after an empty sequences section");
    out.append(lit, nlit);
    return;
  }
  if (n < 1) fail("sequence modes missing");
  uint8_t modes = p[0];
  if (modes & 3) fail("reserved sequence mode bits set");
  p += 1;
  n -= 1;
  size_t t = read_table(fs.ll, modes >> 6, LL_DEFAULT, 36, 6, 9, 35, p, n);
  p += t;
  n -= t;
  t = read_table(fs.of, (modes >> 4) & 3, OF_DEFAULT, 29, 5, 8, 31, p, n);
  p += t;
  n -= t;
  t = read_table(fs.ml, (modes >> 2) & 3, ML_DEFAULT, 53, 6, 9, 52, p, n);
  p += t;
  n -= t;
  BackBits in(p, n);
  uint32_t sl = uint32_t(in.read(fs.ll.log));
  uint32_t so = uint32_t(in.read(fs.of.log));
  uint32_t sm = uint32_t(in.read(fs.ml.log));
  for (size_t s = 0; s < nseq; ++s) {
    int llc = fs.ll.sym[sl], ofc = fs.of.sym[so], mlc = fs.ml.sym[sm];
    if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
    uint64_t ofv = (uint64_t(1) << ofc) + in.read(ofc);
    uint64_t ml = ML_BASE[mlc] + in.read(ML_BITS[mlc]);
    uint64_t ll = LL_BASE[llc] + in.read(LL_BITS[llc]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = off;
    } else {
      uint32_t idx = uint32_t(ofv) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        off = fs.rep[0];
      } else {
        off = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      }
    }
    if (s + 1 < nseq) {
      sl = fs.ll.base[sl] + uint32_t(in.read(fs.ll.nbits[sl]));
      sm = fs.ml.base[sm] + uint32_t(in.read(fs.ml.nbits[sm]));
      so = fs.of.base[so] + uint32_t(in.read(fs.of.nbits[so]));
    }
    if (ll > nlit - li) fail("sequence takes more literals than decoded");
    out.append(lit + li, ll);
    li += ll;
    size_t have = out.n - frame_start;
    if (off == 0 || off > have) fail("match offset before the frame start");
    size_t from = out.n - off;
    out.extend(ml);
    uint8_t* o = out.p;
    size_t to = out.n - ml;
    if (off >= ml) {
      std::memcpy(o + to, o + from, ml);
    } else {
      for (size_t i = 0; i < ml; ++i) o[to + i] = o[from + i];
    }
  }
  if (in.off != 0) fail("sequence bitstream size does not match");
  out.append(lit + li, nlit - li);
}

// Decodes one frame at p (magic already checked); returns its size.
size_t decode_frame(const uint8_t* p, size_t n, Out& out) {
  size_t i = 4;
  if (i >= n) fail("frame header truncated");
  uint8_t fhd = p[i++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  int dict_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set");
  uint64_t window = 0;
  if (!single) {
    if (i >= n) fail("frame header truncated");
    uint8_t wd = p[i++];
    int exp = wd >> 3, man = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exp);
    window = base + (base / 8) * man;
  }
  static const int dict_bytes[4] = {0, 1, 2, 4};
  int db = dict_bytes[dict_flag];
  if (i + db > n) fail("frame header truncated");
  if (db && rd_le(p + i, db) != 0) fail("frames with a dictionary are not supported");
  i += db;
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  bool has_fcs = fb > 0;
  uint64_t fcs = 0;
  if (i + fb > n) fail("frame header truncated");
  if (fb) {
    fcs = rd_le(p + i, fb);
    if (fb == 2) fcs += 256;
    i += fb;
  }
  if (single) window = fcs;
  uint64_t block_max = window < (128u << 10) ? window : (128u << 10);
  size_t start = out.n;
  if (has_fcs && fcs < (uint64_t(1) << 40) && !out.fixed)
    out.reserve(start + size_t(fcs));
  FrameState fs;
  for (;;) {
    if (i + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(rd_le(p + i, 3));
    i += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      if (size > block_max) fail("block larger than the window allows");
      if (i + 1 > n) fail("RLE block truncated");
      std::memset(out.extend(size), p[i], size);
      i += 1;
    } else {
      if (i + size > n) fail("block runs past the input");
      if (type == 0) {
        if (size > block_max) fail("block larger than the window allows");
        out.append(p + i, size);
      } else {
        if (size > block_max) fail("block larger than the window allows");
        size_t before = out.n;
        decode_block(fs, p + i, size, out, start);
        if (out.n - before > block_max && block_max > 0)
          fail("block decodes past the block size limit");
      }
      i += size;
    }
    if (has_fcs && out.n - start > fcs) fail("frame larger than its content size");
    if (last) break;
  }
  if (has_fcs && out.n - start != fcs) fail("frame content size mismatch");
  if (checksum) {
    if (i + 4 > n) fail("content checksum truncated");
    uint32_t want = uint32_t(rd_le(p + i, 4));
    uint32_t got = uint32_t(xxh64(out.p + start, out.n - start, 0));
    if (want != got) fail("content checksum mismatch");
    i += 4;
  }
  return i;
}

void decompress(const uint8_t* p, size_t n, Out& out) {
  size_t i = 0;
  if (n == 0) fail("empty input");
  while (i < n) {
    if (n - i < 4) fail("trailing bytes after the last frame");
    uint32_t magic = uint32_t(rd_le(p + i, 4));
    if (magic == 0xFD2FB528u) {
      i += decode_frame(p + i, n - i, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - i < 8) fail("skippable frame truncated");
      uint64_t size = rd_le(p + i + 4, 4);
      if (size > n - i - 8) fail("skippable frame runs past the input");
      i += 8 + size_t(size);
    } else {
      fail("not a zstd frame (bad magic)");
    }
  }
}

// The content size of the frame at p, or -1 when its header has none;
// *size is set to the frame's size in bytes (block headers walked).
int64_t frame_content_size(const uint8_t* p, size_t n, size_t* size) {
  size_t i = 4;
  if (i >= n) fail("frame header truncated");
  uint8_t fhd = p[i++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  static const int dict_bytes[4] = {0, 1, 2, 4};
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  i += (single ? 0 : 1) + dict_bytes[fhd & 3];
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  if (i + fb > n) fail("frame header truncated");
  int64_t fcs = -1;
  if (fb) fcs = int64_t(rd_le(p + i, fb) + (fb == 2 ? 256 : 0));
  i += fb;
  for (;;) {
    if (i + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(rd_le(p + i, 3));
    i += 3;
    i += ((bh >> 1) & 3) == 1 ? 1 : (bh >> 3);
    if (i > n) fail("block runs past the input");
    if (bh & 1) break;
  }
  *size = i + (checksum ? 4 : 0);
  return fcs;
}

}  // namespace

extern "C" {

int64_t srit_zstd_content_size(const uint8_t* src, size_t n) {
  try {
    int64_t total = 0;
    size_t i = 0;
    while (i < n) {
      if (n - i < 8) return -1;
      uint32_t magic = uint32_t(rd_le(src + i, 4));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        i += 8 + size_t(rd_le(src + i + 4, 4));
        continue;
      }
      if (magic != 0xFD2FB528u) return -1;
      size_t size;
      int64_t fcs = frame_content_size(src + i, n - i, &size);
      if (fcs < 0) return -1;
      total += fcs;
      i += size;
    }
    return total;
  } catch (const std::exception&) {
    return -1;
  }
}

int srit_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t cap, uint8_t** out, size_t* out_n, char* err,
                         size_t err_n) {
  if (out) *out = nullptr;
  *out_n = 0;
  Out buf;
  if (dst) {
    buf.p = dst;
    buf.cap = cap;
    buf.fixed = true;
  }
  try {
    decompress(src, n, buf);
  } catch (const std::exception& e) {
    if (err_n) {
      std::strncpy(err, e.what(), err_n - 1);
      err[err_n - 1] = 0;
    }
    return -1;
  }
  *out_n = buf.n;
  if (!dst) *out = buf.release();
  return 0;
}

void srit_zstd_free(uint8_t* p) { std::free(p); }

}  // extern "C"
