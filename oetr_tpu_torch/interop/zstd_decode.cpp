// A Zstandard frame decoder (RFC 8878), decode only, for the host.
//
// It reads what tensorstore's OCDBT and zarr write into orbax checkpoints
// (B-tree nodes, manifests, array chunks), and any other frame without a
// dictionary: raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
// streams, weights direct or FSE-coded) and treeless literals; sequences
// with predefined, RLE, FSE and repeat tables and the three repeat
// offsets; the XXH64 content checksum; concatenated and skippable frames.
// Every malformed input throws, with a reason, and nothing is returned.
//
// C interface (bound with ctypes by interop/zstd.py):
//   int oetr_zstd_decompress(src, n, max_out, &out, &out_n, err, err_cap)
//     0 and a malloc'd buffer of out_n bytes; else nonzero, the reason in
//     err and no buffer. max_out bounds the whole output.
//   void oetr_zstd_free(out)
//   uint32_t oetr_crc32c(p, n)     CRC-32C (Castagnoli), as OCDBT uses it
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw Error(why); }

inline int highbit(u64 v) { return 63 - __builtin_clzll(v); }  // v > 0

constexpr size_t kBlockMax = 128 * 1024;

// ---------------------------------------------------------------- bits
// Little-endian bit fields of [p, p + len): bits [pos, pos + n), n <= 56;
// positions below 0 read as zeros (a backward stream read past its start).
u64 bits_at(const u8* p, size_t len, int64_t pos, int n) {
  if (n == 0) return 0;
  if (pos < 0) {
    if (pos + n <= 0) return 0;
    return bits_at(p, len, 0, n + static_cast<int>(pos)) << (-pos);
  }
  size_t byte = static_cast<size_t>(pos >> 3);
  int shift = static_cast<int>(pos & 7);
  u64 word = 0;
  if (byte + 8 <= len) {
    std::memcpy(&word, p + byte, 8);
  } else {
    for (size_t i = 0; byte + i < len && i < 8; ++i)
      word |= static_cast<u64>(p[byte + i]) << (8 * i);
  }
  return (word >> shift) & ((u64{1} << n) - 1);
}

// Forward reader, for FSE table descriptions.
struct ForwardBits {
  const u8* p;
  size_t len;
  int64_t pos = 0;
  u64 read(int n) {  // past the end reads zeros: see fse_read_table
    u64 v = bits_at(p, len, pos, n);
    pos += n;
    return v;
  }
  size_t bytes_used() const { return static_cast<size_t>((pos + 7) >> 3); }
};

// Backward reader: starts below the end mark (the highest set bit of the
// last byte) and reads toward the first byte.
struct BackwardBits {
  const u8* p;
  size_t len;
  int64_t pos;
  BackwardBits(const u8* p_, size_t len_) : p(p_), len(len_) {
    if (len == 0) fail("empty bitstream");
    u8 last = p[len - 1];
    if (last == 0) fail("bitstream without its end mark");
    pos = static_cast<int64_t>(8 * (len - 1)) + highbit(last);
  }
  u64 read(int n) {
    pos -= n;
    return bits_at(p, len, pos, n);
  }
};

// ---------------------------------------------------------------- FSE
struct FseTable {
  int log = 0;
  std::vector<u8> symbol;
  std::vector<u8> nbits;
  std::vector<u16> base;
  bool ready = false;
};

void fse_build(FseTable& t, const std::vector<int16_t>& norm, int log) {
  const u32 size = 1u << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<u32> next(norm.size(), 0);
  u32 high = size;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high == 0) fail("FSE table: too many low-probability symbols");
      t.symbol[--high] = static_cast<u8>(s);
      next[s] = 1;
    }
  }
  const u32 step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  u32 pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] <= 0) continue;
    next[s] = static_cast<u32>(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = static_cast<u8>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table: probabilities do not spread");
  for (u32 i = 0; i < size; ++i) {
    u32 state = next[t.symbol[i]]++;
    int nb = log - highbit(state);
    t.nbits[i] = static_cast<u8>(nb);
    t.base[i] = static_cast<u16>((state << nb) - size);
  }
  t.ready = true;
}

void fse_rle(FseTable& t, u8 symbol) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
  t.ready = true;
}

// Reads a table description at the start of [p, len); returns its bytes.
size_t fse_read_table(FseTable& t, const u8* p, size_t len, int max_log,
                      size_t max_symbols) {
  ForwardBits in{p, len};
  int log = static_cast<int>(in.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log above its limit");
  int32_t remaining = 1 << log;
  std::vector<int16_t> norm;
  while (remaining > 0) {
    if (norm.size() >= max_symbols) fail("FSE table: too many symbols");
    int nb = highbit(static_cast<u64>(remaining) + 1) + 1;
    u32 val = static_cast<u32>(in.read(nb));
    u32 lower = (1u << (nb - 1)) - 1;
    u32 threshold = (1u << nb) - 1 - (static_cast<u32>(remaining) + 1);
    if ((val & lower) < threshold) {
      in.pos -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = static_cast<int>(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm.push_back(static_cast<int16_t>(proba));
    if (proba == 0) {
      for (;;) {
        int repeat = static_cast<int>(in.read(2));
        for (int i = 0; i < repeat; ++i) {
          if (norm.size() >= max_symbols) fail("FSE table: too many symbols");
          norm.push_back(0);
        }
        if (repeat != 3) break;
      }
    }
  }
  if (in.pos > static_cast<int64_t>(8 * len))
    fail("FSE table description runs past its section");
  if (remaining != 0) fail("FSE table: probabilities do not sum up");
  fse_build(t, norm, log);
  return in.bytes_used();
}

// ---------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<u8> symbol;
  std::vector<u8> nbits;
  bool ready = false;
};

void huf_build(HufTable& t, std::vector<u8> weights) {
  if (weights.empty() || weights.size() > 255)
    fail("Huffman: bad number of weights");
  u32 total = 0;
  for (u8 w : weights) {
    if (w > 11) fail("Huffman: weight above 11");
    if (w) total += 1u << (w - 1);
  }
  if (total == 0) fail("Huffman: all weights zero");
  int max_bits = highbit(total) + 1;
  u32 rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman: weights leave no power of two");
  weights.push_back(static_cast<u8>(highbit(rest) + 1));
  if (max_bits > 11) fail("Huffman: codes longer than 11 bits");
  const size_t n = weights.size();
  std::vector<u8> bits(n);
  u32 rank_count[13] = {0};
  for (size_t s = 0; s < n; ++s) {
    bits[s] = weights[s] ? static_cast<u8>(max_bits + 1 - weights[s]) : 0;
    rank_count[bits[s]]++;
  }
  const u32 size = 1u << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  u32 rank_idx[13] = {0};
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("Huffman: code space overflows");
    std::memset(&t.nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman: code space not filled");
  for (size_t s = 0; s < n; ++s) {
    if (!bits[s]) continue;
    u32 code = rank_idx[bits[s]], len = 1u << (max_bits - bits[s]);
    std::memset(&t.symbol[code], static_cast<int>(s), len);
    rank_idx[bits[s]] += len;
  }
  t.ready = true;
}

// Reads a Huffman tree description; returns its bytes.
size_t huf_read_table(HufTable& t, const u8* p, size_t len) {
  if (len < 1) fail("Huffman tree description missing");
  u32 header = p[0];
  std::vector<u8> weights;
  if (header >= 128) {
    size_t n = header - 127, bytes = (n + 1) / 2;
    if (1 + bytes > len) fail("Huffman weights run past the literals");
    for (size_t i = 0; i < n; ++i) {
      u8 b = p[1 + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    huf_build(t, weights);
    return 1 + bytes;
  }
  if (header == 0 || 1 + header > len)
    fail("FSE-coded Huffman weights run past the literals");
  const u8* q = p + 1;
  FseTable fse;
  size_t used = fse_read_table(fse, q, header, 6, 256);
  if (used >= header) fail("FSE-coded Huffman weights: no bitstream");
  BackwardBits in(q + used, header - used);
  u32 s1 = static_cast<u32>(in.read(fse.log));
  u32 s2 = static_cast<u32>(in.read(fse.log));
  auto decode = [&](u32& s) {
    u8 sym = fse.symbol[s];
    s = fse.base[s] + static_cast<u32>(in.read(fse.nbits[s]));
    return sym;
  };
  for (;;) {
    if (weights.size() > 253) fail("Huffman: more than 255 weights");
    weights.push_back(decode(s1));
    if (in.pos < 0) {
      weights.push_back(fse.symbol[s2]);
      break;
    }
    weights.push_back(decode(s2));
    if (in.pos < 0) {
      weights.push_back(fse.symbol[s1]);
      break;
    }
  }
  huf_build(t, weights);
  return 1 + header;
}

void huf_stream(const HufTable& t, const u8* p, size_t len, u8* out,
                size_t n) {
  BackwardBits in(p, len);
  const int mb = t.max_bits;
  const u32 mask = (1u << mb) - 1;
  u32 state = static_cast<u32>(in.read(mb));
  for (size_t i = 0; i < n; ++i) {
    out[i] = t.symbol[state];
    int nb = t.nbits[state];
    state = ((state << nb) + static_cast<u32>(in.read(nb))) & mask;
  }
  if (in.pos != -mb) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- tables
const u32 kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                         10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                         24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                         2048, 4096, 8192, 16384, 32768, 65536};
const u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                        15, 16};
const u32 kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,  131, 259, 515,  1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,  2,  2,  1,
                             1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2,  3,  2,  1,
                             1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------- XXH64
constexpr u64 P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
              P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
              P5 = 2870177450012600261ULL;
inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
inline u64 rd64(const u8* p) {
  u64 v;
  std::memcpy(&v, p, 8);
  return v;
}
inline u32 rd32(const u8* p) {
  u32 v;
  std::memcpy(&v, p, 4);
  return v;
}
inline u64 xround(u64 acc, u64 in) { return rotl(acc + in * P2, 31) * P1; }
inline u64 xmerge(u64 acc, u64 v) { return (acc ^ xround(0, v)) * P1 + P4; }

u64 xxh64(const u8* p, size_t len) {
  const u8* end = p + len;
  u64 h;
  if (len >= 32) {
    u64 v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (static_cast<u64>(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- frames
struct Decoder {
  std::vector<u8>& out;
  size_t max_out;
  // per frame
  size_t frame_start = 0;
  u64 window = 0;
  size_t block_max = kBlockMax;
  HufTable huf;
  FseTable ll, of, ml;
  u32 rep[3] = {1, 4, 8};
  std::vector<u8> lits;

  void grow(size_t n) {
    if (out.size() + n > max_out || out.size() + n < out.size())
      fail("output exceeds its limit of " + std::to_string(max_out) +
           " bytes");
  }

  void literals(const u8* p, size_t len, size_t& used) {
    if (len < 1) fail("literals section missing");
    int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    size_t regen, comp = 0, hdr;
    int streams = 1;
    if (type < 2) {
      if (fmt == 0 || fmt == 2) {
        regen = p[0] >> 3;
        hdr = 1;
      } else if (fmt == 1) {
        if (len < 2) fail("literals header truncated");
        regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
        hdr = 2;
      } else {
        if (len < 3) fail("literals header truncated");
        regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) +
                (static_cast<size_t>(p[2]) << 12);
        hdr = 3;
      }
      if (regen > kBlockMax) fail("literals above the block size");
      lits.resize(regen);
      if (type == 0) {
        if (hdr + regen > len) fail("raw literals truncated");
        std::memcpy(lits.data(), p + hdr, regen);
        used = hdr + regen;
      } else {
        if (hdr + 1 > len) fail("RLE literals truncated");
        std::memset(lits.data(), p[hdr], regen);
        used = hdr + 1;
      }
      return;
    }
    if (fmt == 0 || fmt == 1) {
      if (len < 3) fail("literals header truncated");
      u32 c = p[0] | (p[1] << 8) | (static_cast<u32>(p[2]) << 16);
      regen = (c >> 4) & 0x3FF;
      comp = (c >> 14) & 0x3FF;
      hdr = 3;
      streams = fmt == 0 ? 1 : 4;
    } else if (fmt == 2) {
      if (len < 4) fail("literals header truncated");
      u32 c = rd32(p);
      regen = (c >> 4) & 0x3FFF;
      comp = (c >> 18) & 0x3FFF;
      hdr = 4;
      streams = 4;
    } else {
      if (len < 5) fail("literals header truncated");
      u64 c = rd32(p) | (static_cast<u64>(p[4]) << 32);
      regen = (c >> 4) & 0x3FFFF;
      comp = (c >> 22) & 0x3FFFF;
      hdr = 5;
      streams = 4;
    }
    if (regen > kBlockMax) fail("literals above the block size");
    if (hdr + comp > len) fail("compressed literals truncated");
    const u8* q = p + hdr;
    size_t qlen = comp;
    if (type == 2) {
      size_t t = huf_read_table(huf, q, qlen);
      q += t;
      qlen -= t;
    } else if (!huf.ready) {
      fail("treeless literals without an earlier Huffman table");
    }
    lits.resize(regen);
    if (streams == 1) {
      huf_stream(huf, q, qlen, lits.data(), regen);
    } else {
      if (qlen < 10) fail("4-stream literals without their jump table");
      size_t s[4];
      s[0] = q[0] | (q[1] << 8);
      s[1] = q[2] | (q[3] << 8);
      s[2] = q[4] | (q[5] << 8);
      if (6 + s[0] + s[1] + s[2] > qlen) fail("jump table past the literals");
      s[3] = qlen - 6 - s[0] - s[1] - s[2];
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals too short");
      const u8* r = q + 6;
      size_t o = 0;
      for (int i = 0; i < 4; ++i) {
        size_t n = i < 3 ? seg : regen - 3 * seg;
        huf_stream(huf, r, s[i], lits.data() + o, n);
        r += s[i];
        o += n;
      }
    }
    used = hdr + comp;
  }

  size_t table(FseTable& t, int mode, const u8* p, size_t len,
               const int16_t* norm, size_t nnorm, int norm_log, int max_log,
               size_t max_symbols, const char* name) {
    switch (mode) {
      case 0:
        fse_build(t, std::vector<int16_t>(norm, norm + nnorm), norm_log);
        return 0;
      case 1:
        if (len < 1) fail(std::string(name) + " RLE symbol missing");
        if (p[0] >= max_symbols) fail(std::string(name) + " RLE symbol too big");
        fse_rle(t, p[0]);
        return 1;
      case 2:
        return fse_read_table(t, p, len, max_log, max_symbols);
      default:
        if (!t.ready)
          fail(std::string(name) + " repeat mode without an earlier table");
        return 0;
    }
  }

  void block(const u8* p, size_t len) {
    size_t used = 0;
    literals(p, len, used);
    p += used;
    len -= used;
    const size_t block_start = out.size();
    if (len < 1) fail("sequences section missing");
    size_t nseq;
    if (p[0] == 0) {
      nseq = 0;
      used = 1;
    } else if (p[0] < 128) {
      nseq = p[0];
      used = 1;
    } else if (p[0] < 255) {
      if (len < 2) fail("sequence count truncated");
      nseq = ((p[0] - 128) << 8) + p[1];
      used = 2;
    } else {
      if (len < 3) fail("sequence count truncated");
      nseq = p[1] + (p[2] << 8) + 0x7F00;
      used = 3;
    }
    p += used;
    len -= used;
    size_t lit_pos = 0;
    if (nseq > 0) {
      if (len < 1) fail("sequence modes missing");
      u8 modes = p[0];
      if (modes & 3) fail("sequence modes: reserved bits set");
      p += 1;
      len -= 1;
      used = table(ll, modes >> 6, p, len, kLLNorm, 36, 6, 9, 36,
                   "literal lengths");
      p += used, len -= used;
      used = table(of, (modes >> 4) & 3, p, len, kOFNorm, 29, 5, 8, 32,
                   "offsets");
      p += used, len -= used;
      used = table(ml, (modes >> 2) & 3, p, len, kMLNorm, 53, 6, 9, 53,
                   "match lengths");
      p += used, len -= used;
      BackwardBits in(p, len);
      u32 sll = static_cast<u32>(in.read(ll.log));
      u32 sof = static_cast<u32>(in.read(of.log));
      u32 sml = static_cast<u32>(in.read(ml.log));
      for (size_t i = 0; i < nseq; ++i) {
        u32 ofc = of.symbol[sof], llc = ll.symbol[sll], mlc = ml.symbol[sml];
        if (ofc > 31) fail("offset code above 31");
        if (llc > 35 || mlc > 52) fail("length code out of range");
        u64 ofv = (u64{1} << ofc) + in.read(static_cast<int>(ofc));
        size_t mlen = kMLBase[mlc] + in.read(kMLBits[mlc]);
        size_t llen = kLLBase[llc] + in.read(kLLBits[llc]);
        if (i + 1 < nseq) {
          sll = ll.base[sll] + static_cast<u32>(in.read(ll.nbits[sll]));
          sml = ml.base[sml] + static_cast<u32>(in.read(ml.nbits[sml]));
          sof = of.base[sof] + static_cast<u32>(in.read(of.nbits[sof]));
        }
        u64 offset;
        if (ofv > 3) {
          offset = ofv - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<u32>(offset);
        } else {
          u32 idx = static_cast<u32>(ofv) - 1 + (llen == 0 ? 1 : 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx < 3 ? rep[idx] : rep[0] - 1u;
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = static_cast<u32>(offset);
          }
        }
        if (llen > lits.size() - lit_pos) fail("sequence takes more literals than there are");
        grow(llen + mlen);
        out.insert(out.end(), lits.begin() + lit_pos,
                   lits.begin() + lit_pos + llen);
        lit_pos += llen;
        size_t have = out.size() - frame_start;
        if (offset == 0 || offset > have || offset > window)
          fail("match offset outside the decoded data");
        size_t from = out.size() - offset;
        for (size_t k = 0; k < mlen; ++k) out.push_back(out[from + k]);
        if (out.size() - block_start > block_max)
          fail("block decodes past the block size");
      }
      if (in.pos != 0) fail("sequence bitstream not consumed exactly");
    } else if (len != 0) {
      fail("bytes after a block without sequences");
    }
    size_t rest = lits.size() - lit_pos;
    grow(rest);
    out.insert(out.end(), lits.begin() + lit_pos, lits.end());
    if (out.size() - block_start > block_max)
      fail("block decodes past the block size");
  }

  // Decodes the frame at p; returns its bytes.
  size_t frame(const u8* p, size_t len) {
    if (len < 4) fail("truncated frame: no magic");
    u32 magic = rd32(p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (len < 8) fail("truncated skippable frame");
      u64 n = rd32(p + 4);
      if (8 + n > len) fail("truncated skippable frame");
      return 8 + n;
    }
    if (magic != 0xFD2FB528u) fail("bad magic: not a zstd frame");
    if (len < 5) fail("truncated frame header");
    u8 fhd = p[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) fail("frame header: reserved bit set");
    size_t pos = 5;
    window = 0;
    if (!single) {
      if (pos + 1 > len) fail("truncated frame header");
      u8 wd = p[pos++];
      int wlog = 10 + (wd >> 3);
      if (wlog > 41) fail("window above 2^41");
      u64 base = u64{1} << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    static const int did_size[4] = {0, 1, 2, 4};
    if (pos + did_size[did_flag] > len) fail("truncated frame header");
    u64 did = 0;
    for (int i = 0; i < did_size[did_flag]; ++i)
      did |= static_cast<u64>(p[pos + i]) << (8 * i);
    pos += did_size[did_flag];
    if (did != 0) fail("frame needs dictionary " + std::to_string(did));
    static const int fcs_sizes[4] = {0, 2, 4, 8};
    int fcs_size = fcs_flag == 0 && single ? 1 : fcs_sizes[fcs_flag];
    bool has_fcs = fcs_size > 0;
    u64 fcs = 0;
    if (pos + fcs_size > len) fail("truncated frame header");
    for (int i = 0; i < fcs_size; ++i)
      fcs |= static_cast<u64>(p[pos + i]) << (8 * i);
    if (fcs_size == 2) fcs += 256;
    pos += fcs_size;
    if (single) window = fcs;
    if (has_fcs && fcs > max_out - out.size())
      fail("frame content size " + std::to_string(fcs) +
           " exceeds the output limit of " + std::to_string(max_out) +
           " bytes");
    frame_start = out.size();
    huf = HufTable();
    ll = FseTable();
    of = FseTable();
    ml = FseTable();
    rep[0] = 1, rep[1] = 4, rep[2] = 8;
    block_max = window < kBlockMax ? static_cast<size_t>(window) : kBlockMax;
    for (;;) {
      if (pos + 3 > len) fail("truncated frame: block header missing");
      u32 bh = p[pos] | (p[pos + 1] << 8) | (static_cast<u32>(p[pos + 2]) << 16);
      pos += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (size > (type == 2 ? kBlockMax : block_max))
        fail("block larger than the window allows");
      switch (type) {
        case 0:
          if (pos + size > len) fail("truncated frame: raw block");
          grow(size);
          out.insert(out.end(), p + pos, p + pos + size);
          pos += size;
          break;
        case 1:
          if (pos + 1 > len) fail("truncated frame: RLE block");
          grow(size);
          out.insert(out.end(), size, p[pos]);
          pos += 1;
          break;
        case 2:
          if (pos + size > len) fail("truncated frame: compressed block");
          block(p + pos, size);
          pos += size;
          break;
        default:
          fail("reserved block type");
      }
      if (last) break;
    }
    const size_t got = out.size() - frame_start;
    if (has_fcs && got != fcs)
      fail("frame decodes to " + std::to_string(got) +
           " bytes, its header says " + std::to_string(fcs));
    if (checksum) {
      if (pos + 4 > len) fail("truncated frame: checksum missing");
      u32 want = rd32(p + pos);
      u32 have = static_cast<u32>(xxh64(out.data() + frame_start, got));
      if (want != have) fail("content checksum mismatch");
      pos += 4;
    }
    return pos;
  }
};

u32 crc32c_table[256];
bool crc32c_init() {
  for (u32 i = 0; i < 256; ++i) {
    u32 c = i;
    for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc32c_table[i] = c;
  }
  return true;
}
const bool crc32c_ready = crc32c_init();

}  // namespace

extern "C" {

int oetr_zstd_decompress(const uint8_t* src, size_t n, size_t max_out,
                         uint8_t** out, size_t* out_n, char* err,
                         size_t err_cap) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<u8> buf;
    Decoder d{buf, max_out};
    if (n == 0) fail("no frame: empty input");
    size_t pos = 0;
    while (pos < n) pos += d.frame(src + pos, n - pos);
    uint8_t* res = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
    if (!res) fail("out of memory");
    if (!buf.empty()) std::memcpy(res, buf.data(), buf.size());
    *out = res;
    *out_n = buf.size();
    return 0;
  } catch (const std::exception& e) {
    if (err_cap) std::snprintf(err, err_cap, "%s", e.what());
    return 1;
  }
}

void oetr_zstd_free(uint8_t* p) { std::free(p); }

uint32_t oetr_crc32c(const uint8_t* p, size_t n) {
  (void)crc32c_ready;
  u32 c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc32c_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
