// Zstandard decompression (RFC 8878) for reading Orbax checkpoints.
//
// An Orbax StandardCheckpointer directory stores its B-tree nodes and its
// zarr chunks as zstd frames. This file decodes them with no zstd library:
//
//   * frames: the frame header (FHD, window descriptor, dictionary ID 0,
//     frame content size), several frames in a row, skippable frames, and
//     the XXH64 content checksum where the frame sets its flag;
//   * blocks: raw, RLE and compressed;
//   * literals: raw, RLE, Huffman-coded with 1 or 4 streams (the 6-byte
//     jump table), treeless (the previous block's Huffman table), and
//     Huffman weights sent directly or FSE-compressed;
//   * sequences: predefined, RLE, FSE-compressed and repeat modes for the
//     literal-length, offset and match-length codes, the three repeat
//     offsets, and matches that reach back into earlier blocks.
//
// Dictionaries are refused. The caller gives the decoded size it expects
// (a zarr chunk's prod(chunks) * itemsize, or the frames' content size);
// input that decodes to any other size is an error, and so is every
// malformed field. Each frame decodes into the caller's buffer, which is
// also the match window, so no window is allocated.
//
//   * zstd_decode        — decode the frames of one buffer.
//   * zstd_decode_many   — decode many inputs, packed in one buffer, into
//                          one buffer, across a thread pool.
//   * zstd_content_size  — the summed content size of a buffer's frames.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw ZstdError(what); }

inline void require(bool ok, const char* what) {
  if (!ok) fail(what);
}

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kMaxBlockSize = 128 * 1024;

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t read_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // the library is built for little-endian hosts
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64 (seed 0): the frame's content checksum is its low 32 bits.

constexpr uint64_t P1 = 11400714785074694791ull;
constexpr uint64_t P2 = 14029467366897019727ull;
constexpr uint64_t P3 = 1609587929392839161ull;
constexpr uint64_t P4 = 9650029242287828579ull;
constexpr uint64_t P5 = 2870177450012600261ull;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  return rotl64(acc, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, read_le64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(read_le32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bit streams.

// A forward stream, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* src;
  size_t size;
  size_t pos = 0;  // bits read

  uint32_t peek(int n) const {  // n <= 25; bits past the end read as 0
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5 && byte + i < size; ++i) v |= uint64_t(src[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) { pos += n; }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// A backward stream (Huffman streams, FSE streams): written forward, read
// from its last bit towards its first. The highest set bit of the last
// byte marks the end and is not data. ``pos`` counts the bits still to
// read; reading past the start yields zeros and leaves ``pos`` negative,
// which is how an overflow is seen.
struct BackwardBits {
  const uint8_t* src;
  int64_t size;
  int64_t pos;

  BackwardBits(const uint8_t* s, size_t n) : src(s), size(int64_t(n)) {
    require(n > 0, "empty backward bit stream");
    uint8_t last = s[n - 1];
    require(last != 0, "backward bit stream without its end mark");
    pos = int64_t(n - 1) * 8 + highbit32(last);
  }

  uint64_t load64(int64_t byte) const {
    if (byte >= 0 && byte + 8 <= size) return read_le64(src + byte);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      int64_t j = byte + i;
      if (j >= 0 && j < size) v |= uint64_t(src[j]) << (8 * i);
    }
    return v;
  }

  uint64_t peek(int n) const {  // n <= 56
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) return (load64(lo >> 3) >> (lo & 7)) & ((1ull << n) - 1);
    if (pos <= 0) return 0;
    return (load64(0) & ((1ull << pos) - 1)) << (-lo);
  }
  void skip(int n) { pos -= n; }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
  bool overflowed() const { return pos < 0; }
  bool finished() const { return pos == 0; }
};

// ---------------------------------------------------------------------------
// FSE tables.

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;  // the next state, before the bits read are added
};

struct FseTable {
  int accuracy_log = 0;
  std::vector<FseEntry> entries;
};

// The table description of RFC 8878 4.1.1. Returns the bytes it used.
size_t read_fse_description(const uint8_t* src, size_t size, int max_accuracy, int max_symbol,
                            std::vector<int16_t>& norm, int& accuracy_log) {
  require(size > 0, "FSE table description is empty");
  ForwardBits bits{src, size};
  accuracy_log = int(bits.peek(4)) + 5;
  bits.skip(4);
  require(accuracy_log <= max_accuracy, "FSE accuracy log too large");
  norm.assign(max_symbol + 1, 0);
  int remaining = (1 << accuracy_log) + 1;
  int threshold = 1 << accuracy_log;
  int nbits = accuracy_log + 1;
  int symbol = 0;
  bool previous_zero = false;
  while (remaining > 1) {
    if (previous_zero) {
      // 2-bit repeat flags: each tells how many more zeros follow; 3 means
      // another flag follows
      int run = 0;
      for (;;) {
        uint32_t flag = bits.peek(2);
        bits.skip(2);
        run += int(flag);
        if (flag != 3) break;
        require(bits.pos <= size * 8, "FSE table description is truncated");
      }
      require(symbol + run <= max_symbol, "FSE zero run passes the last symbol");
      symbol += run;  // norm[] is already zero there
    }
    require(symbol <= max_symbol, "FSE table description has too many symbols");
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = bits.peek(nbits);
    if (int(low & (threshold - 1)) < max) {
      count = int(low & (threshold - 1));
      bits.skip(nbits - 1);
    } else {
      count = int(low & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.skip(nbits);
    }
    --count;  // -1 is the "less than 1" probability
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous_zero = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
    require(bits.pos <= size * 8, "FSE table description is truncated");
  }
  require(remaining == 1, "FSE table description does not sum to its table size");
  norm.resize(symbol);
  return bits.bytes_used();
}

void build_fse_table(const std::vector<int16_t>& norm, int accuracy_log, FseTable& table) {
  const int size = 1 << accuracy_log;
  table.accuracy_log = accuracy_log;
  table.entries.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      // "less than 1" symbols take one cell each, from the top down
      table.entries[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.entries[pos].symbol = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  require(pos == 0, "FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = table.entries[u];
    uint32_t state = next[e.symbol]++;
    e.nbits = uint8_t(accuracy_log - highbit32(state));
    e.base = uint16_t((state << e.nbits) - size);
  }
}

void build_rle_table(int symbol, FseTable& table) {
  table.accuracy_log = 0;
  table.entries.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

struct FseState {
  const FseTable* table;
  uint32_t state;
  void init(BackwardBits& bits, const FseTable& t) {
    table = &t;
    state = uint32_t(bits.read(t.accuracy_log));
  }
  int symbol() const { return table->entries[state].symbol; }
  void update(BackwardBits& bits) {
    const FseEntry& e = table->entries[state];
    state = e.base + uint32_t(bits.read(e.nbits));
  }
};

// The predefined distributions of RFC 8878 3.1.1.3.2.2.
const int16_t kLiteralLengthDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                           2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                           2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMatchLengthDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOffsetDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLiteralLengthBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLiteralLengthBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                        0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                        4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMatchLengthBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,   17,   18,    19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,   33,   34,   35,   37,    39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMatchLengthBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                      2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------------------
// Huffman tables.

struct HuffEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HuffTable {
  int max_bits = 0;
  std::vector<HuffEntry> entries;  // indexed by the next max_bits bits
};

// Reads a Huffman tree description (RFC 8878 4.2.1). Returns its size.
size_t read_huffman_table(const uint8_t* src, size_t size, HuffTable& table) {
  require(size > 0, "Huffman tree description is empty");
  uint8_t weights[257];
  int count = 0;
  const uint8_t header = src[0];
  size_t used;
  if (header >= 128) {
    // weights sent directly, 4 bits each, high nibble first
    count = header - 127;
    used = 1 + (count + 1) / 2;
    require(used <= size, "Huffman weights are truncated");
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    // FSE-compressed weights: two interleaved states over one stream
    used = 1 + size_t(header);
    require(used <= size && header > 0, "Huffman FSE weights are truncated");
    std::vector<int16_t> norm;
    int accuracy_log;
    size_t desc = read_fse_description(src + 1, header, 6, 255, norm, accuracy_log);
    require(desc < header, "Huffman FSE weights have no bit stream");
    FseTable fse;
    build_fse_table(norm, accuracy_log, fse);
    BackwardBits bits(src + 1 + desc, header - desc);
    FseState s1, s2;
    s1.init(bits, fse);
    s2.init(bits, fse);
    // the reference decoder's loop: a symbol from each state in turn, until
    // a state update reads past the start of the stream; then the other
    // state's symbol is the last weight
    const int capacity = 255;
    for (;;) {
      require(count <= capacity - 2, "too many Huffman weights");
      weights[count++] = uint8_t(s1.symbol());
      s1.update(bits);
      if (bits.overflowed()) {
        weights[count++] = uint8_t(s2.symbol());
        break;
      }
      require(count <= capacity - 2, "too many Huffman weights");
      weights[count++] = uint8_t(s2.symbol());
      s2.update(bits);
      if (bits.overflowed()) {
        weights[count++] = uint8_t(s1.symbol());
        break;
      }
    }
  }
  // the last symbol's weight is implied: the one that brings the sum of
  // 2^(w-1) to a power of two
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    require(weights[i] <= 12, "Huffman weight above 12");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  require(total > 0, "Huffman weights are all zero");
  const int max_bits = highbit32(total) + 1;
  // RFC 8878 caps codes at 11 bits; libzstd's decoder accepts 12
  require(max_bits <= 12, "Huffman code longer than 12 bits");
  const uint32_t rest = (1u << max_bits) - total;
  require((rest & (rest - 1)) == 0, "Huffman weights do not complete a tree");
  require(count < 256, "too many Huffman symbols");
  weights[count++] = uint8_t(highbit32(rest) + 1);

  table.max_bits = max_bits;
  table.entries.assign(size_t(1) << max_bits, HuffEntry{0, 0});
  // codes go to the lowest weights first, symbols in order within a weight
  size_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    const size_t span = size_t(1) << (w - 1);
    const uint8_t nbits = uint8_t(max_bits + 1 - w);
    for (int s = 0; s < count; ++s) {
      if (weights[s] != w) continue;
      for (size_t k = 0; k < span; ++k) table.entries[next + k] = HuffEntry{uint8_t(s), nbits};
      next += span;
    }
  }
  require(next == table.entries.size(), "Huffman table is not full");
  return used;
}

void decode_huffman_stream(const uint8_t* src, size_t size, const HuffTable& table,
                           uint8_t* out, size_t count) {
  BackwardBits bits(src, size);
  const int max_bits = table.max_bits;
  const HuffEntry* entries = table.entries.data();
  size_t i = 0;
  // while 56 bits lie above the start, decode from one 64-bit load as many
  // symbols as those bits surely hold
  const uint64_t mask = (1ull << max_bits) - 1;
  while (bits.pos >= 56 && count - i >= 56) {
    const int64_t lo = bits.pos - 56;
    const uint64_t window = read_le64(src + (lo >> 3)) >> (lo & 7);
    int avail = 56;
    while (avail >= max_bits) {
      const HuffEntry e = entries[(window >> (avail - max_bits)) & mask];
      out[i++] = e.symbol;
      avail -= e.nbits;
    }
    bits.skip(56 - avail);
  }
  for (; i < count; ++i) {
    const HuffEntry e = entries[bits.peek(max_bits)];
    out[i] = e.symbol;
    bits.skip(e.nbits);
  }
  require(bits.finished(), "Huffman stream does not end with its last symbol");
}

// ---------------------------------------------------------------------------
// Frame decoding.

// The frame header after the magic number (RFC 8878 3.1.1.1).
struct FrameHeader {
  size_t size;  // bytes of the header
  bool has_content_size;
  uint64_t content_size;
  bool checksum;
};

FrameHeader read_frame_header(const uint8_t* src, size_t size) {
  require(size >= 1, "truncated frame header");
  const uint8_t fhd = src[0];
  const int fcs_flag = fhd >> 6;
  const bool single_segment = (fhd >> 5) & 1;
  const int did_flag = fhd & 3;
  require(((fhd >> 3) & 1) == 0, "reserved bit set in the frame header");
  size_t pos = 1;
  if (!single_segment) {
    require(pos < size, "truncated window descriptor");
    const uint8_t wd = src[pos++];
    require((wd >> 3) <= 31 - 10, "window too large");
  }
  const int did_bytes[4] = {0, 1, 2, 4};
  require(pos + did_bytes[did_flag] <= size, "truncated dictionary ID");
  uint32_t did = 0;
  for (int i = 0; i < did_bytes[did_flag]; ++i) did |= uint32_t(src[pos + i]) << (8 * i);
  pos += did_bytes[did_flag];
  require(did == 0, "frame needs a dictionary, which is not supported");
  const int fcs_bytes = (fcs_flag == 0) ? (single_segment ? 1 : 0) : (1 << fcs_flag);
  require(pos + fcs_bytes <= size, "truncated frame content size");
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  return FrameHeader{pos + fcs_bytes, fcs_bytes > 0, fcs, bool((fhd >> 2) & 1)};
}

struct Sequence {
  uint32_t literal_length;
  uint32_t match_length;
  uint32_t offset;
};

class FrameDecoder {
 public:
  // Decodes every frame of src into dst[0, dst_size); returns the bytes
  // written. With ``exact`` they must fill dst exactly.
  size_t decode_all(const uint8_t* src, size_t src_size, uint8_t* dst, size_t dst_size,
                    bool exact) {
    size_t in = 0, out = 0;
    require(src_size > 0, "no zstd frame");
    while (in < src_size) {
      require(src_size - in >= 4, "truncated frame magic");
      uint32_t magic = read_le32(src + in);
      if ((magic & kSkippableMask) == kSkippableMagic) {
        require(src_size - in >= 8, "truncated skippable frame");
        uint64_t n = read_le32(src + in + 4);
        require(n <= src_size - in - 8, "truncated skippable frame");
        in += 8 + size_t(n);
        continue;
      }
      require(magic == kFrameMagic, "not a zstd frame (bad magic number)");
      size_t used = 0;
      out += decode_frame(src + in + 4, src_size - in - 4, dst + out, dst_size - out, used);
      in += 4 + used;
    }
    if (exact && out != dst_size) {
      char msg[128];
      std::snprintf(msg, sizeof msg, "frames decode to %zu bytes, expected %zu", out, dst_size);
      fail(msg);
    }
    return out;
  }

 private:
  HuffTable huff_;
  bool have_huff_ = false;
  FseTable ll_, of_, ml_;
  bool have_ll_ = false, have_of_ = false, have_ml_ = false;
  uint32_t rep_[3] = {1, 4, 8};
  std::vector<uint8_t> literals_;
  std::vector<Sequence> sequences_;

  size_t decode_frame(const uint8_t* src, size_t size, uint8_t* dst, size_t capacity,
                      size_t& used) {
    const FrameHeader header = read_frame_header(src, size);
    size_t pos = header.size;
    if (header.has_content_size) {
      require(header.content_size <= capacity, "frame content size exceeds the expected size");
    }

    // a new frame starts with no tables and the initial repeat offsets
    have_huff_ = have_ll_ = have_of_ = have_ml_ = false;
    rep_[0] = 1;
    rep_[1] = 4;
    rep_[2] = 8;

    size_t out = 0;
    for (;;) {
      require(pos + 3 <= size, "truncated block header");
      const uint32_t bh = uint32_t(src[pos]) | uint32_t(src[pos + 1]) << 8 |
                          uint32_t(src[pos + 2]) << 16;
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      require(bsize <= kMaxBlockSize, "block larger than 128 KiB");
      if (type == 0) {  // raw
        require(pos + bsize <= size, "truncated raw block");
        require(out + bsize <= capacity, "frame decodes past the expected size");
        std::memcpy(dst + out, src + pos, bsize);
        pos += bsize;
        out += bsize;
      } else if (type == 1) {  // RLE
        require(pos + 1 <= size, "truncated RLE block");
        require(out + bsize <= capacity, "frame decodes past the expected size");
        std::memset(dst + out, src[pos], bsize);
        pos += 1;
        out += bsize;
      } else if (type == 2) {
        require(pos + bsize <= size, "truncated compressed block");
        out += decode_block(src + pos, bsize, dst, out, capacity);
        pos += bsize;
      } else {
        fail("reserved block type");
      }
      if (last) break;
    }
    if (header.has_content_size && out != header.content_size) {
      fail("frame decodes to another size than its content size");
    }
    if (header.checksum) {
      require(pos + 4 <= size, "truncated content checksum");
      const uint32_t want = read_le32(src + pos);
      pos += 4;
      require(uint32_t(xxh64(dst, out)) == want, "content checksum mismatch");
    }
    used = pos;
    return out;
  }

  // Decodes one compressed block into dst[start, ...). ``dst`` from 0 is
  // the frame so far, the window of its matches.
  size_t decode_block(const uint8_t* src, size_t size, uint8_t* dst, size_t start,
                      size_t capacity) {
    const uint8_t* lit = nullptr;
    size_t lit_size = 0;
    size_t pos = decode_literals(src, size, lit, lit_size);
    require(pos < size, "compressed block has no sequences section");

    // the sequences section header
    size_t nseq = src[pos++];
    if (nseq >= 128) {
      if (nseq == 255) {
        require(pos + 2 <= size, "truncated sequence count");
        nseq = src[pos] + (size_t(src[pos + 1]) << 8) + 0x7F00;
        pos += 2;
      } else {
        require(pos + 1 <= size, "truncated sequence count");
        nseq = ((nseq - 128) << 8) + src[pos];
        pos += 1;
      }
    }
    size_t out = start;
    sequences_.clear();
    if (nseq == 0) {
      require(pos == size, "bytes after an empty sequences section");
    } else {
      require(pos < size, "truncated symbol compression modes");
      const uint8_t modes = src[pos++];
      require((modes & 3) == 0, "reserved bits set in the symbol compression modes");
      pos += read_table(src + pos, size - pos, (modes >> 6) & 3, ll_, have_ll_,
                        kLiteralLengthDefault, 36, 6, 9, 35);
      pos += read_table(src + pos, size - pos, (modes >> 4) & 3, of_, have_of_, kOffsetDefault,
                        29, 5, 8, 31);
      pos += read_table(src + pos, size - pos, (modes >> 2) & 3, ml_, have_ml_,
                        kMatchLengthDefault, 53, 6, 9, 52);
      require(pos < size, "compressed block has no sequence bit stream");
      decode_sequences(src + pos, size - pos, nseq);
    }

    // execute: literals, then the match, for each sequence
    size_t lit_pos = 0;
    for (const Sequence& s : sequences_) {
      require(s.literal_length <= lit_size - lit_pos, "sequence takes more literals than decoded");
      require(out + s.literal_length + s.match_length <= capacity,
              "frame decodes past the expected size");
      std::memcpy(dst + out, lit + lit_pos, s.literal_length);
      out += s.literal_length;
      lit_pos += s.literal_length;
      require(s.offset <= out, "match offset reaches before the frame");
      uint8_t* op = dst + out;
      const uint8_t* match = op - s.offset;
      if (s.offset >= s.match_length) {
        std::memcpy(op, match, s.match_length);
      } else {
        for (uint32_t k = 0; k < s.match_length; ++k) op[k] = match[k];
      }
      out += s.match_length;
    }
    const size_t tail = lit_size - lit_pos;
    require(out + tail <= capacity, "frame decodes past the expected size");
    std::memcpy(dst + out, lit + lit_pos, tail);
    out += tail;
    require(out - start <= kMaxBlockSize, "block decodes to more than 128 KiB");
    return out - start;
  }

  // The literals section (RFC 8878 3.1.1.3.1). Points ``lit`` at the
  // literals (into src for raw literals) and returns the section's size.
  size_t decode_literals(const uint8_t* src, size_t size, const uint8_t*& lit,
                         size_t& lit_size) {
    require(size >= 1, "truncated literals section");
    const int type = src[0] & 3;
    const int format = (src[0] >> 2) & 3;
    if (type == 0 || type == 1) {  // raw or RLE
      size_t header, regen;
      if (format == 0 || format == 2) {
        header = 1;
        regen = src[0] >> 3;
      } else if (format == 1) {
        require(size >= 2, "truncated literals header");
        header = 2;
        regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      } else {
        require(size >= 3, "truncated literals header");
        header = 3;
        regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      }
      require(regen <= kMaxBlockSize, "literals larger than 128 KiB");
      lit_size = regen;
      if (type == 0) {
        require(header + regen <= size, "truncated raw literals");
        lit = src + header;
        return header + regen;
      }
      require(header + 1 <= size, "truncated RLE literals");
      literals_.assign(regen, src[header]);
      lit = literals_.data();
      return header + 1;
    }
    // Huffman-coded (2) or treeless (3)
    size_t header, regen, compressed;
    int streams = format == 0 ? 1 : 4;
    if (format <= 1) {
      require(size >= 3, "truncated literals header");
      const uint32_t h = uint32_t(src[0]) | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
      header = 3;
      regen = (h >> 4) & 0x3FF;
      compressed = (h >> 14) & 0x3FF;
    } else if (format == 2) {
      require(size >= 4, "truncated literals header");
      const uint32_t h = read_le32(src);
      header = 4;
      regen = (h >> 4) & 0x3FFF;
      compressed = (h >> 18) & 0x3FFF;
    } else {
      require(size >= 5, "truncated literals header");
      const uint64_t h = uint64_t(read_le32(src)) | uint64_t(src[4]) << 32;
      header = 5;
      regen = size_t((h >> 4) & 0x3FFFF);
      compressed = size_t((h >> 22) & 0x3FFFF);
    }
    require(regen <= kMaxBlockSize, "literals larger than 128 KiB");
    require(header + compressed <= size, "truncated Huffman literals");
    const uint8_t* p = src + header;
    size_t n = compressed;
    if (type == 2) {
      size_t tree = read_huffman_table(p, n, huff_);
      have_huff_ = true;
      p += tree;
      n -= tree;
    } else {
      require(have_huff_, "treeless literals without an earlier Huffman table");
    }
    literals_.resize(regen);
    lit = literals_.data();
    lit_size = regen;
    if (streams == 1) {
      decode_huffman_stream(p, n, huff_, literals_.data(), regen);
    } else {
      require(n >= 6, "truncated literals jump table");
      const size_t s1 = p[0] | size_t(p[1]) << 8;
      const size_t s2 = p[2] | size_t(p[3]) << 8;
      const size_t s3 = p[4] | size_t(p[5]) << 8;
      require(6 + s1 + s2 + s3 <= n, "literals jump table passes the section");
      const size_t s4 = n - 6 - s1 - s2 - s3;
      const size_t each = (regen + 3) / 4;
      require(3 * each <= regen, "too few literals for four streams");
      const uint8_t* q = p + 6;
      uint8_t* o = literals_.data();
      decode_huffman_stream(q, s1, huff_, o, each);
      decode_huffman_stream(q + s1, s2, huff_, o + each, each);
      decode_huffman_stream(q + s1 + s2, s3, huff_, o + 2 * each, each);
      decode_huffman_stream(q + s1 + s2 + s3, s4, huff_, o + 3 * each, regen - 3 * each);
    }
    return header + compressed;
  }

  size_t read_table(const uint8_t* src, size_t size, int mode, FseTable& table, bool& have,
                    const int16_t* defaults, int n_defaults, int default_log, int max_log,
                    int max_symbol) {
    if (mode == 0) {  // predefined
      build_fse_table(std::vector<int16_t>(defaults, defaults + n_defaults), default_log, table);
      have = true;
      return 0;
    }
    if (mode == 1) {  // RLE
      require(size >= 1, "truncated RLE table");
      require(src[0] <= max_symbol, "RLE symbol out of range");
      build_rle_table(src[0], table);
      have = true;
      return 1;
    }
    if (mode == 2) {  // FSE-compressed
      std::vector<int16_t> norm;
      int accuracy_log;
      size_t used = read_fse_description(src, size, max_log, max_symbol, norm, accuracy_log);
      build_fse_table(norm, accuracy_log, table);
      have = true;
      return used;
    }
    require(have, "repeat mode without an earlier table");  // repeat
    return 0;
  }

  void decode_sequences(const uint8_t* src, size_t size, size_t nseq) {
    BackwardBits bits(src, size);
    FseState ll, of, ml;
    ll.init(bits, ll_);
    of.init(bits, of_);
    ml.init(bits, ml_);
    sequences_.resize(nseq);
    for (size_t i = 0; i < nseq; ++i) {
      const int of_code = of.symbol();
      const int ml_code = ml.symbol();
      const int ll_code = ll.symbol();
      require(of_code <= 31, "offset code out of range");
      // extra bits: offset, then match length, then literal length
      const uint32_t of_value = (1u << of_code) + uint32_t(bits.read(of_code));
      const uint32_t match_length = kMatchLengthBase[ml_code] + uint32_t(bits.read(kMatchLengthBits[ml_code]));
      const uint32_t literal_length =
          kLiteralLengthBase[ll_code] + uint32_t(bits.read(kLiteralLengthBits[ll_code]));
      uint32_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = offset;
      } else {
        // repeat offsets, shifted by one when the literal length is 0
        const uint32_t idx = of_value - 1 + (literal_length == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep_[0];
        } else {
          offset = idx == 3 ? rep_[0] - 1 : rep_[idx];
          require(offset != 0, "repeat offset of zero");
          if (idx != 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = offset;
        }
      }
      sequences_[i] = Sequence{literal_length, match_length, offset};
      if (i + 1 < nseq) {  // state updates: literal length, match length, offset
        ll.update(bits);
        ml.update(bits);
        of.update(bits);
      }
      require(!bits.overflowed(), "sequence bit stream overflows");
    }
    require(bits.finished(), "sequence bit stream has bits left over");
  }
};

uint64_t content_size(const uint8_t* src, size_t size, bool& known) {
  // the summed content sizes of every frame; ``known`` false if one frame
  // does not state its size
  known = true;
  uint64_t total = 0;
  size_t in = 0;
  require(size > 0, "no zstd frame");
  while (in < size) {
    require(size - in >= 4, "truncated frame magic");
    const uint32_t magic = read_le32(src + in);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      require(size - in >= 8, "truncated skippable frame");
      uint64_t n = read_le32(src + in + 4);
      require(n <= size - in - 8, "truncated skippable frame");
      in += 8 + size_t(n);
      continue;
    }
    require(magic == kFrameMagic, "not a zstd frame (bad magic number)");
    const uint8_t* p = src + in + 4;
    const size_t n = size - in - 4;
    const FrameHeader header = read_frame_header(p, n);
    known = known && header.has_content_size;
    total += header.content_size;
    size_t pos = header.size;
    // walk the blocks to find the next frame
    for (;;) {
      require(pos + 3 <= n, "truncated block header");
      const uint32_t bh = uint32_t(p[pos]) | uint32_t(p[pos + 1]) << 8 | uint32_t(p[pos + 2]) << 16;
      pos += 3;
      const int type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 1) bsize = 1;
      require(type != 3, "reserved block type");
      require(pos + bsize <= n, "truncated block");
      pos += bsize;
      if (bh & 1) break;
    }
    if (header.checksum) pos += 4;
    require(pos <= n, "truncated content checksum");
    in += 4 + pos;
  }
  return total;
}

void set_error(char* err, size_t err_len, const char* what) {
  if (err && err_len) {
    std::strncpy(err, what, err_len - 1);
    err[err_len - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes the frames of src into dst. With exact != 0 they must decode to
// exactly dst_size bytes. Returns the bytes written, or -1 with a message
// in err.
int64_t zstd_decode(const uint8_t* src, size_t src_size, uint8_t* dst, size_t dst_size,
                    int exact, char* err, size_t err_len) {
  try {
    FrameDecoder decoder;
    return int64_t(decoder.decode_all(src, src_size, dst, dst_size, exact != 0));
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
    return -1;
  }
}

// Decodes n inputs, the bytes src[src_offsets[i], + src_sizes[i]), each to
// exactly dst_sizes[i] bytes at dst + dst_offsets[i], across a thread pool
// (num_threads <= 0: hardware concurrency). status[i] is 0 or -1. Returns
// the number of failures; the first failure's message is in err.
int zstd_decode_many(int n, const uint8_t* src, const uint64_t* src_offsets,
                     const uint64_t* src_sizes, uint8_t* dst, const uint64_t* dst_offsets,
                     const uint64_t* dst_sizes, int num_threads, int* status, char* err,
                     size_t err_len) {
  if (n <= 0) return 0;
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = std::min(num_threads, n);
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  std::atomic<int> first_failure{n};
  std::vector<std::string> messages(n);
  auto worker = [&]() {
    FrameDecoder decoder;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      try {
        decoder.decode_all(src + src_offsets[i], src_sizes[i], dst + dst_offsets[i],
                           dst_sizes[i], true);
        status[i] = 0;
      } catch (const std::exception& e) {
        status[i] = -1;
        messages[i] = e.what();
        failures.fetch_add(1);
        int seen = first_failure.load();
        while (i < seen && !first_failure.compare_exchange_weak(seen, i)) {
        }
      }
    }
  };
  if (num_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  if (failures.load()) set_error(err, err_len, messages[first_failure.load()].c_str());
  return failures.load();
}

// The summed content size of src's frames, -1 if a frame does not state
// it, -2 with a message in err if src is not a sequence of frames.
int64_t zstd_content_size(const uint8_t* src, size_t src_size, char* err, size_t err_len) {
  try {
    bool known;
    uint64_t total = content_size(src, src_size, known);
    return known ? int64_t(total) : -1;
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
    return -2;
  }
}

int zstd_abi_version() { return 2; }

}  // extern "C"
