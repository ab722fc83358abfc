// A Zstandard decoder (RFC 8878) and the CRC-32C that OCDBT files end with.
//
// Orbax checkpoints store every array chunk and every OCDBT manifest and
// B-tree node as zstd frames, and the machine that runs the port has no zstd
// library, so the port decodes them itself. This file is the whole decoder:
// frames (with or without the content-size field, skippable frames skipped),
// raw, RLE and compressed blocks, literals (raw, RLE, Huffman-coded in one or
// four streams, treeless; weights direct or FSE-coded), sequences
// (predefined, RLE, FSE-coded and repeat tables; the three repeat offsets
// with the literal-length-0 rule) and the XXH64 content checksum, which is
// verified. Dictionaries are not supported: a frame that names one fails.
//
// Every read is bounds-checked. Malformed input never crashes and never
// yields short output: `zstd_decompress` returns -1 with a message naming
// the input offset. The caller owns the output buffer; -2 says it is too
// small (with the size a frame header declares, when one does) and the
// caller retries with a larger one.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.cpp assumes a little-endian host"
#endif

namespace {

constexpr int64_t kBlockMax = 1 << 17;        // 128 KiB
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkipMagicMask = 0xFFFFFFF0u;
constexpr uint32_t kSkipMagic = 0x184D2A50u;
constexpr int kHufMaxBits = 11;

struct Fail {
  char* msg;
  int64_t cap;
  bool set = false;
};

// Records the first failure; every caller returns false right after.
bool fail(Fail& f, int64_t at, const char* what) {
  if (!f.set && f.cap > 0) {
    snprintf(f.msg, (size_t)f.cap, "%s (input byte %lld)", what,
             (long long)at);
  }
  f.set = true;
  return false;
}

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- bits ----

// Little-endian bit stream read forward (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  int64_t n;
  int64_t bit;
  bool read(int nb, uint32_t* out) {
    if (bit + nb > n * 8) return false;
    uint64_t w = 0;
    int64_t b = bit >> 3;
    for (int i = 0; i < 8 && b + i < n; ++i) w |= (uint64_t)p[b + i] << (8 * i);
    *out = (uint32_t)((w >> (bit & 7)) & ((1ull << nb) - 1));
    bit += nb;
    return true;
  }
};

// Little-endian bit stream read backward from its last set bit (Huffman,
// FSE and sequence streams). `pos` counts the bits not yet read; bits below
// the start read as zero, and a stream read past its start has pos < 0.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;
  bool init(const uint8_t* src, int64_t len) {
    p = src;
    n = len;
    if (len < 1 || src[len - 1] == 0) return false;
    pos = (len - 1) * 8 + highbit(src[len - 1]);
    return true;
  }
  // The nb (<= 56) bits just below pos, the highest bit first.
  inline uint64_t peek(int nb) const {
    const int64_t s = pos - nb;
    if (s >= 0) {
      const int64_t b = s >> 3;
      uint64_t w;
      if (b + 8 <= n) {
        w = rd64(p + b);
      } else {
        w = 0;
        for (int64_t i = b; i < n; ++i) w |= (uint64_t)p[i] << (8 * (i - b));
      }
      return (w >> (s & 7)) & ((1ull << nb) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t w = 0;
    for (int64_t i = 0; i < n && i < 8; ++i) w |= (uint64_t)p[i] << (8 * i);
    w &= (1ull << pos) - 1;
    return w << (-s);
  }
  inline uint64_t read(int nb) {
    const uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ----------------------------------------------------------------- FSE ----

struct FseCell {
  uint16_t base;
  uint8_t nbits;
  uint8_t sym;
};

struct FseTable {
  int log = -1;  // -1: no table yet (for the repeat mode)
  FseCell cell[512];
};

// Reads an FSE table description (RFC 8878 4.1.1) from src[0, n); sets the
// normalised counts, the largest symbol, the accuracy log and the bytes used.
bool read_ncount(const uint8_t* src, int64_t n, int max_log, int max_sym,
                 int16_t* norm, int* nsym, int* log, int64_t* used,
                 int64_t at, Fail& f) {
  FwdBits br{src, n, 0};
  uint32_t v;
  if (!br.read(4, &v)) return fail(f, at, "truncated FSE table description");
  const int al = (int)v + 5;
  if (al > max_log) return fail(f, at, "FSE accuracy log too large");
  int remaining = (1 << al) + 1;
  int threshold = 1 << al;
  int nbits = al + 1;
  int sym = 0;
  while (remaining > 1 && sym <= max_sym) {
    const int max = (2 * threshold - 1) - remaining;
    uint32_t low;
    if (!br.read(nbits - 1, &low))
      return fail(f, at, "truncated FSE table description");
    int count;
    if ((int)low < max) {
      count = (int)low;
    } else {
      uint32_t top;
      if (!br.read(1, &top))
        return fail(f, at, "truncated FSE table description");
      count = (int)(low | (top << (nbits - 1)));
      if (count >= threshold) count -= max;
    }
    count -= 1;  // -1 means "less than 1"
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) return fail(f, at, "FSE probabilities exceed the table");
    norm[sym++] = (int16_t)count;
    if (count == 0) {
      // 2-bit repeat flags: how many more zero probabilities follow
      for (;;) {
        uint32_t rep;
        if (!br.read(2, &rep))
          return fail(f, at, "truncated FSE table description");
        for (uint32_t i = 0; i < rep; ++i) {
          if (sym > max_sym) return fail(f, at, "FSE symbol out of range");
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return fail(f, at, "FSE probabilities do not sum up");
  *nsym = sym;
  *log = al;
  *used = (br.bit + 7) >> 3;
  return true;
}

bool build_fse(const int16_t* norm, int nsym, int log, FseTable* t,
               int64_t at, Fail& f) {
  const int size = 1 << log;
  const int mask = size - 1;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->cell[high--].sym = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->cell[pos].sym = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return fail(f, at, "FSE table spread does not close");
  for (int u = 0; u < size; ++u) {
    const int s = t->cell[u].sym;
    const uint32_t ns = next[s]++;
    const int nb = log - highbit(ns);
    t->cell[u].nbits = (uint8_t)nb;
    t->cell[u].base = (uint16_t)((ns << nb) - size);
  }
  t->log = log;
  return true;
}

void rle_fse(FseTable* t, uint8_t sym) {
  t->log = 0;
  t->cell[0] = FseCell{0, 0, sym};
}

// ------------------------------------------------------------- Huffman ----

struct HufTable {
  int max_bits = 0;  // 0: no table yet (for treeless literals)
  uint8_t sym[1 << kHufMaxBits];
  uint8_t nbits[1 << kHufMaxBits];
};

// Reads a Huffman tree description; sets the bytes it used.
bool read_huf_tree(const uint8_t* src, int64_t n, HufTable* t, int64_t* used,
                   int64_t at, Fail& f) {
  if (n < 1) return fail(f, at, "truncated Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  const int hb = src[0];
  if (hb >= 128) {
    nw = hb - 127;
    const int bytes = (nw + 1) / 2;
    if (1 + bytes > n) return fail(f, at, "truncated Huffman weights");
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    *used = 1 + bytes;
  } else {
    if (hb == 0 || 1 + hb > n)
      return fail(f, at, "truncated FSE-coded Huffman weights");
    int16_t norm[256];
    int nsym, log;
    int64_t nc;
    if (!read_ncount(src + 1, hb, 6, 255, norm, &nsym, &log, &nc, at + 1, f))
      return false;
    FseTable ft;
    if (!build_fse(norm, nsym, log, &ft, at + 1, f)) return false;
    BackBits br;
    if (!br.init(src + 1 + nc, hb - nc))
      return fail(f, at, "bad Huffman weight stream");
    uint32_t s1 = (uint32_t)br.read(log), s2 = (uint32_t)br.read(log);
    if (br.pos < 0) return fail(f, at, "truncated Huffman weight stream");
    // Two interleaved states; the stream ends when an update reads past it.
    for (;;) {
      if (nw > 253) return fail(f, at, "too many Huffman weights");
      w[nw++] = ft.cell[s1].sym;
      s1 = ft.cell[s1].base + (uint32_t)br.read(ft.cell[s1].nbits);
      if (br.pos < 0) {
        w[nw++] = ft.cell[s2].sym;
        break;
      }
      w[nw++] = ft.cell[s2].sym;
      s2 = ft.cell[s2].base + (uint32_t)br.read(ft.cell[s2].nbits);
      if (br.pos < 0) {
        w[nw++] = ft.cell[s1].sym;
        break;
      }
    }
    *used = 1 + hb;
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kHufMaxBits) return fail(f, at, "Huffman weight too large");
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) return fail(f, at, "Huffman weights are all zero");
  const int max_bits = highbit(sum) + 1;
  if (max_bits > kHufMaxBits) return fail(f, at, "Huffman code too long");
  const uint32_t rest = (1u << max_bits) - sum;
  if (rest & (rest - 1)) return fail(f, at, "Huffman weights do not close");
  if (nw >= 256) return fail(f, at, "too many Huffman weights");
  w[nw++] = (uint8_t)(highbit(rest) + 1);
  // Lowest weight first, symbols in order within a weight.
  uint32_t start[kHufMaxBits + 2] = {0};
  uint32_t count[kHufMaxBits + 2] = {0};
  for (int i = 0; i < nw; ++i) count[w[i]]++;
  uint32_t p = 0;
  for (int k = 1; k <= max_bits; ++k) {
    start[k] = p;
    p += count[k] << (k - 1);
  }
  for (int s = 0; s < nw; ++s) {
    if (!w[s]) continue;
    const uint32_t len = 1u << (w[s] - 1);
    const uint8_t nb = (uint8_t)(max_bits + 1 - w[s]);
    for (uint32_t i = 0; i < len; ++i) {
      t->sym[start[w[s]] + i] = (uint8_t)s;
      t->nbits[start[w[s]] + i] = nb;
    }
    start[w[s]] += len;
  }
  t->max_bits = max_bits;
  return true;
}

bool huf_stream(const HufTable& t, const uint8_t* src, int64_t n,
                uint8_t* out, int64_t count, int64_t at, Fail& f) {
  BackBits br;
  if (!br.init(src, n)) return fail(f, at, "bad Huffman stream");
  const int mb = t.max_bits;
  for (int64_t i = 0; i < count; ++i) {
    const uint32_t v = (uint32_t)br.peek(mb);
    out[i] = t.sym[v];
    br.pos -= t.nbits[v];
  }
  if (br.pos != 0) return fail(f, at, "Huffman stream not consumed exactly");
  return true;
}

// ----------------------------------------------------------- sequences ----

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    Fail f{nullptr, 0};
    build_fse(kLLDefault, 36, 6, &ll, 0, f);
    build_fse(kMLDefault, 53, 6, &ml, 0, f);
    build_fse(kOFDefault, 29, 5, &of, 0, f);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// --------------------------------------------------------------- frame ----

struct Frame {
  uint8_t* dst;        // start of the whole output
  int64_t cap;
  int64_t out;         // bytes written so far
  int64_t frame_start; // output offset where this frame began
  int64_t window;
  uint64_t rep[3];
  HufTable huf;
  FseTable ll, ml, of;
  uint8_t lit[kBlockMax + 8];
  bool too_small = false;
  int64_t want = 0;  // output size a frame header declared, when too small
};

bool need(Frame& fr, int64_t nbytes) {
  if (fr.out + nbytes > fr.cap) {
    fr.too_small = true;
    return false;
  }
  return true;
}

bool decode_literals(Frame& fr, const uint8_t* src, int64_t n, int64_t at,
                     const uint8_t** lit, int64_t* nlit, int64_t* used,
                     Fail& f) {
  if (n < 1) return fail(f, at, "truncated literals section");
  const int type = src[0] & 3;
  const int sf = (src[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    int64_t size, hs;
    if ((sf & 1) == 0) {
      hs = 1;
      size = src[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < 2) return fail(f, at, "truncated literals header");
      size = (src[0] >> 4) | ((int64_t)src[1] << 4);
    } else {
      hs = 3;
      if (n < 3) return fail(f, at, "truncated literals header");
      size = (src[0] >> 4) | ((int64_t)src[1] << 4) | ((int64_t)src[2] << 12);
    }
    if (size > kBlockMax) return fail(f, at, "literals exceed a block");
    if (type == 0) {
      if (hs + size > n) return fail(f, at, "truncated raw literals");
      *lit = src + hs;
      *used = hs + size;
    } else {
      if (hs + 1 > n) return fail(f, at, "truncated RLE literals");
      memset(fr.lit, src[hs], (size_t)size);
      *lit = fr.lit;
      *used = hs + 1;
    }
    *nlit = size;
    return true;
  }
  // Huffman-coded (2) or treeless (3)
  int64_t hs, regen, csize;
  if (sf < 2) {
    hs = 3;
    if (n < 3) return fail(f, at, "truncated literals header");
    const uint32_t h = src[0] | (src[1] << 8) | (src[2] << 16);
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    hs = 4;
    if (n < 4) return fail(f, at, "truncated literals header");
    const uint32_t h = rd32(src);
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    hs = 5;
    if (n < 5) return fail(f, at, "truncated literals header");
    const uint64_t h = rd32(src) | ((uint64_t)src[4] << 32);
    regen = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
  }
  if (regen > kBlockMax) return fail(f, at, "literals exceed a block");
  if (hs + csize > n) return fail(f, at, "truncated compressed literals");
  const uint8_t* p = src + hs;
  int64_t rem = csize;
  if (type == 2) {
    int64_t tu;
    if (!read_huf_tree(p, rem, &fr.huf, &tu, at + hs, f)) return false;
    p += tu;
    rem -= tu;
  } else if (fr.huf.max_bits == 0) {
    return fail(f, at, "treeless literals without a previous Huffman table");
  }
  const int64_t pat = at + (p - src);
  if (sf == 0) {
    if (!huf_stream(fr.huf, p, rem, fr.lit, regen, pat, f)) return false;
  } else {
    if (rem < 10) return fail(f, at, "truncated Huffman jump table");
    const int64_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                  s3 = p[4] | (p[5] << 8);
    const int64_t s4 = rem - 6 - s1 - s2 - s3;
    if (s4 < 1) return fail(f, at, "bad Huffman jump table");
    const int64_t seg = (regen + 3) / 4;
    const int64_t last = regen - 3 * seg;
    if (last < 0) return fail(f, at, "bad four-stream literal count");
    const uint8_t* q = p + 6;
    int64_t qat = pat + 6;
    if (!huf_stream(fr.huf, q, s1, fr.lit, seg, qat, f)) return false;
    if (!huf_stream(fr.huf, q + s1, s2, fr.lit + seg, seg, qat + s1, f))
      return false;
    if (!huf_stream(fr.huf, q + s1 + s2, s3, fr.lit + 2 * seg, seg,
                    qat + s1 + s2, f))
      return false;
    if (!huf_stream(fr.huf, q + s1 + s2 + s3, s4, fr.lit + 3 * seg, last,
                    qat + s1 + s2 + s3, f))
      return false;
  }
  *lit = fr.lit;
  *nlit = regen;
  *used = hs + csize;
  return true;
}

bool seq_table(int mode, const uint8_t* src, int64_t n, int max_log,
               int max_sym, const FseTable& dflt, FseTable* t, int64_t* used,
               int64_t at, Fail& f) {
  *used = 0;
  switch (mode) {
    case 0:
      *t = dflt;
      return true;
    case 1:
      if (n < 1) return fail(f, at, "truncated RLE sequence table");
      if (src[0] > max_sym) return fail(f, at, "RLE sequence symbol too large");
      rle_fse(t, src[0]);
      *used = 1;
      return true;
    case 2: {
      int16_t norm[256];
      int nsym, log;
      if (!read_ncount(src, n, max_log, max_sym, norm, &nsym, &log, used, at,
                       f))
        return false;
      return build_fse(norm, nsym, log, t, at, f);
    }
    default:
      if (t->log < 0) return fail(f, at, "repeat mode without a previous table");
      return true;
  }
}

bool copy_literals(Frame& fr, const uint8_t* lit, int64_t len) {
  if (!need(fr, len)) return false;
  memcpy(fr.dst + fr.out, lit, (size_t)len);
  fr.out += len;
  return true;
}

bool decode_block(Frame& fr, const uint8_t* src, int64_t n, int64_t at,
                  int64_t block_max, Fail& f) {
  const uint8_t* lit;
  int64_t nlit, lu;
  if (!decode_literals(fr, src, n, at, &lit, &nlit, &lu, f)) return false;
  const uint8_t* p = src + lu;
  int64_t rem = n - lu;
  int64_t pat = at + lu;
  const int64_t block_start = fr.out;
  if (rem < 1) return fail(f, pat, "missing sequences section");
  int64_t nseq, hs;
  if (p[0] < 128) {
    nseq = p[0];
    hs = 1;
  } else if (p[0] < 255) {
    if (rem < 2) return fail(f, pat, "truncated sequences header");
    nseq = ((p[0] - 128) << 8) + p[1];
    hs = 2;
  } else {
    if (rem < 3) return fail(f, pat, "truncated sequences header");
    nseq = p[1] + (p[2] << 8) + 0x7F00;
    hs = 3;
  }
  p += hs;
  rem -= hs;
  pat += hs;
  if (nseq == 0) {
    if (rem != 0) return fail(f, pat, "bytes after an empty sequences section");
    if (nlit > block_max) return fail(f, at, "block exceeds its maximum size");
    return copy_literals(fr, lit, nlit);
  }
  if (rem < 1) return fail(f, pat, "truncated sequences header");
  const int modes = p[0];
  if (modes & 3) return fail(f, pat, "reserved sequence mode bits set");
  p += 1;
  rem -= 1;
  pat += 1;
  const Defaults& d = defaults();
  int64_t used;
  if (!seq_table((modes >> 6) & 3, p, rem, 9, 35, d.ll, &fr.ll, &used, pat, f))
    return false;
  p += used, rem -= used, pat += used;
  if (!seq_table((modes >> 4) & 3, p, rem, 8, 31, d.of, &fr.of, &used, pat, f))
    return false;
  p += used, rem -= used, pat += used;
  if (!seq_table((modes >> 2) & 3, p, rem, 9, 52, d.ml, &fr.ml, &used, pat, f))
    return false;
  p += used, rem -= used, pat += used;

  BackBits br;
  if (!br.init(p, rem)) return fail(f, pat, "bad sequences bitstream");
  const FseTable &ll = fr.ll, &of = fr.of, &ml = fr.ml;
  uint32_t sll = (uint32_t)br.read(ll.log);
  uint32_t sof = (uint32_t)br.read(of.log);
  uint32_t sml = (uint32_t)br.read(ml.log);
  int64_t li = 0;  // literals used
  for (int64_t i = 0; i < nseq; ++i) {
    if (br.pos < 0) return fail(f, pat, "sequences bitstream overread");
    const int ofc = of.cell[sof].sym;
    const int llc = ll.cell[sll].sym;
    const int mlc = ml.cell[sml].sym;
    if (ofc > 31) return fail(f, pat, "offset code too large");
    const uint64_t ofv = (1ull << ofc) + br.read(ofc);
    const int64_t mlen = kMLBase[mlc] + (int64_t)br.read(kMLBits[mlc]);
    const int64_t llen = kLLBase[llc] + (int64_t)br.read(kLLBits[llc]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      fr.rep[2] = fr.rep[1];
      fr.rep[1] = fr.rep[0];
      fr.rep[0] = off;
    } else {
      const int idx = (int)ofv - 1 + (llen == 0 ? 1 : 0);
      if (idx == 0) {
        off = fr.rep[0];
      } else {
        off = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
        if (idx > 1) fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = off;
      }
    }
    if (llen > nlit - li) return fail(f, pat, "sequence overruns the literals");
    if (fr.out - block_start + llen + mlen > block_max)
      return fail(f, at, "block exceeds its maximum size");
    if (!copy_literals(fr, lit + li, llen)) return false;
    li += llen;
    const int64_t produced = fr.out - fr.frame_start;
    if (off == 0 || (int64_t)off > produced || (int64_t)off > fr.window)
      return fail(f, pat, "match offset out of range");
    if (!need(fr, mlen)) return false;
    uint8_t* o = fr.dst + fr.out;
    const uint8_t* m = o - off;
    if ((int64_t)off >= mlen) {
      memcpy(o, m, (size_t)mlen);
    } else {
      for (int64_t k = 0; k < mlen; ++k) o[k] = m[k];
    }
    fr.out += mlen;
    if (i + 1 < nseq) {
      sll = ll.cell[sll].base + (uint32_t)br.read(ll.cell[sll].nbits);
      sml = ml.cell[sml].base + (uint32_t)br.read(ml.cell[sml].nbits);
      sof = of.cell[sof].base + (uint32_t)br.read(of.cell[sof].nbits);
    }
  }
  if (br.pos != 0) return fail(f, pat, "sequences bitstream not consumed exactly");
  if (fr.out - block_start + (nlit - li) > block_max)
    return fail(f, at, "block exceeds its maximum size");
  return copy_literals(fr, lit + li, nlit - li);
}

// --------------------------------------------------------------- XXH64 ----

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ ((uint64_t)rd32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (*p * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// Decodes one zstd frame starting at src[0] (magic already checked); sets
// the bytes it spans.
bool decode_frame(Frame& fr, const uint8_t* src, int64_t n, int64_t at,
                  int64_t* span, Fail& f) {
  if (n < 5) return fail(f, at, "truncated frame header");
  const int fhd = src[4];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  if (fhd & 8) return fail(f, at + 4, "reserved frame header bit set");
  int64_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) return fail(f, at, "truncated frame header");
    const int wd = src[pos++];
    const int wlog = 10 + (wd >> 3);
    const uint64_t base = 1ull << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  const int did_size[4] = {0, 1, 2, 4};
  uint32_t did = 0;
  if (pos + did_size[did_flag] > n) return fail(f, at, "truncated frame header");
  for (int i = 0; i < did_size[did_flag]; ++i)
    did |= (uint32_t)src[pos + i] << (8 * i);
  pos += did_size[did_flag];
  if (did != 0)
    return fail(f, at, "frame needs a dictionary, which is not supported");
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0)
                                     : (fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
  int64_t fcs = -1;
  if (fcs_size) {
    if (pos + fcs_size > n) return fail(f, at, "truncated frame header");
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; ++i) v |= (uint64_t)src[pos + i] << (8 * i);
    if (fcs_size == 2) v += 256;
    if (v > (uint64_t)INT64_MAX / 2) return fail(f, at, "content size too large");
    fcs = (int64_t)v;
    pos += fcs_size;
  }
  if (single) window = (uint64_t)fcs;
  const int64_t block_max =
      window < (uint64_t)kBlockMax ? (int64_t)window : kBlockMax;
  fr.frame_start = fr.out;
  fr.window = window > (uint64_t)INT64_MAX ? INT64_MAX : (int64_t)window;
  fr.rep[0] = 1;
  fr.rep[1] = 4;
  fr.rep[2] = 8;
  fr.huf.max_bits = 0;
  fr.ll.log = fr.ml.log = fr.of.log = -1;
  if (fcs >= 0 && fr.out + fcs > fr.cap) {
    fr.too_small = true;
    fr.want = fr.out + fcs;
    return false;
  }
  for (;;) {
    if (pos + 3 > n) return fail(f, at + pos, "truncated block header");
    const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const int64_t size = bh >> 3;
    const int64_t bat = at + pos;
    pos += 3;
    if (type == 3) return fail(f, bat, "reserved block type");
    if (size > block_max) return fail(f, bat, "block exceeds its maximum size");
    if (type == 1) {
      if (pos + 1 > n) return fail(f, bat, "truncated RLE block");
      if (!need(fr, size)) return false;
      memset(fr.dst + fr.out, src[pos], (size_t)size);
      fr.out += size;
      pos += 1;
    } else {
      if (pos + size > n) return fail(f, bat, "truncated block");
      if (type == 0) {
        if (!copy_literals(fr, src + pos, size)) return false;
      } else if (!decode_block(fr, src + pos, size, at + pos, block_max, f)) {
        return false;
      }
      pos += size;
    }
    if (last) break;
  }
  const int64_t produced = fr.out - fr.frame_start;
  if (fcs >= 0 && produced != fcs)
    return fail(f, at, "frame content size does not match its header");
  if (checksum) {
    if (pos + 4 > n) return fail(f, at + pos, "truncated content checksum");
    const uint32_t want = rd32(src + pos);
    const uint32_t got =
        (uint32_t)xxh64(fr.dst + fr.frame_start, produced);
    if (want != got) return fail(f, at + pos, "content checksum mismatch");
    pos += 4;
  }
  *span = pos;
  return true;
}

}  // namespace

extern "C" {

// Decodes the zstd frames in src[0, n) into dst[0, cap). Returns the number
// of bytes decoded, -1 on malformed input (the reason, with the input
// offset, in err), or -2 when cap is too small; *want is then the output
// size up to the end of the frame that did not fit when its header declares
// its content size, else 0.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, int64_t* want, char* err,
                        int64_t err_cap) {
  Fail f{err, err_cap};
  *want = 0;
  if (n <= 0) {
    fail(f, 0, "no zstd frame in an empty input");
    return -1;
  }
  Frame* fr = new (std::nothrow) Frame;
  if (!fr) {
    fail(f, 0, "out of memory");
    return -1;
  }
  fr->dst = dst;
  fr->cap = cap;
  fr->out = 0;
  int64_t pos = 0;
  int64_t result = 0;
  while (pos < n) {
    if (pos + 4 > n) {
      fail(f, pos, "truncated frame magic");
      result = -1;
      break;
    }
    const uint32_t magic = rd32(src + pos);
    if ((magic & kSkipMagicMask) == kSkipMagic) {
      if (pos + 8 > n) {
        fail(f, pos, "truncated skippable frame");
        result = -1;
        break;
      }
      const int64_t size = rd32(src + pos + 4);
      if (pos + 8 + size > n) {
        fail(f, pos, "truncated skippable frame");
        result = -1;
        break;
      }
      pos += 8 + size;
      continue;
    }
    if (magic != kFrameMagic) {
      fail(f, pos, "bad zstd frame magic");
      result = -1;
      break;
    }
    int64_t span = 0;
    if (!decode_frame(*fr, src + pos, n - pos, pos, &span, f)) {
      result = fr->too_small && !f.set ? -2 : -1;
      *want = fr->want;
      break;
    }
    pos += span;
  }
  if (result == 0) result = fr->out;
  delete fr;
  return result;
}

// CRC-32C (Castagnoli, reflected, as OCDBT's footers hold it) of data[0, n).
uint32_t crc32c(const uint8_t* data, int64_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
