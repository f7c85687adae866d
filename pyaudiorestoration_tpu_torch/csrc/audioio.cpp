// audioio: minimal native audio I/O runtime of the PyTorch/CUDA port, a copy
// of pyaudiorestoration_tpu/native/audioio.cpp kept byte-compatible with it.
//
// Provides WAV (PCM 8/16/24/32, IEEE float32/64) reading, WAV (float32/PCM16)
// writing, and a self-contained FLAC decoder (constant / verbatim / fixed /
// LPC subframes, rice & rice2 residuals, all stereo decorrelation modes).
//
// It replaces the reference tool's dependency on libsndfile (its
// util/io_ops.py read_file / write_file) with a first-party native component.
// Exposed through a C ABI consumed via ctypes (see ../utils/audio_io.py),
// which builds it with the host C++ compiler at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if !defined(_WIN32)
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#endif

// 64-bit-clean file positioning: plain fseek/ftell take a 32-bit long on
// LLP64 (Windows), truncating offsets in >2 GiB RF64/WAV files.
#if defined(_WIN32)
#define FSEEK64(f, off, whence) _fseeki64((f), (long long)(off), (whence))
#define FTELL64(f) _ftelli64(f)
#else
#define FSEEK64(f, off, whence) fseeko((f), (off_t)(off), (whence))
#define FTELL64(f) ftello(f)
#endif

namespace {

// ---------------------------------------------------------------------------
// Bit reader over an in-memory buffer (MSB-first, as FLAC requires).
// ---------------------------------------------------------------------------
// MSB-first bit reader with a 64-bit cache: the rice residual loop (unary +
// k-bit reads per sample, unaligned almost always) is the decoder's hot path,
// so unary counts come from one clz on the cache and k-bit reads from one
// shift — not per-bit loops.  The cache's valid bits live in the TOP ncache
// bits; everything below is zero, so any set bit is inside the valid region.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;   // next byte to LOAD into the cache (runs ahead)
  uint64_t cache = 0;    // next stream bit = bit 63
  int ncache = 0;        // valid bits in cache
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  void refill() {
    // bulk path: one unaligned 64-bit load + bswap tops the cache up from
    // any fill level (the rice loop refills once per sample via read_unary,
    // so the byte-at-a-time loop was the decoder's hot spot).  Only the top
    // ``take`` bytes of the loaded word are kept before the shift, so the
    // below-valid-region bits of the cache stay zero — read_unary's
    // any-set-bit-is-valid invariant depends on that.
    if (byte_pos + 8 <= size) {
      int take = (63 - ncache) >> 3;  // whole bytes that fit above ncache
      if (take > 0) {                 // take <= 7, so take * 8 <= 56
        uint64_t w;
        memcpy(&w, data + byte_pos, 8);
        w = __builtin_bswap64(w) & ~((~0ULL) >> (take * 8));
        cache |= w >> ncache;
        byte_pos += (size_t)take;
        ncache += take * 8;
      }
      return;
    }
    while (ncache <= 56 && byte_pos < size) {
      cache |= (uint64_t)data[byte_pos++] << (56 - ncache);
      ncache += 8;
    }
  }

  // logical byte offset of the next unread bit (exact at byte-aligned
  // points, which is where the frame indexer samples it)
  size_t tell_byte() const { return byte_pos - (size_t)(ncache >> 3); }

  void seek_byte(size_t pos) {
    byte_pos = pos;
    cache = 0;
    ncache = 0;
  }

  bool eof() const { return tell_byte() >= size; }

  uint64_t read_bits(int n) {
    if (n <= 0) return 0;
    if (ncache < n) {
      refill();
      if (ncache < n) {  // ran off the buffer: zero-pad and flag
        error = true;
        uint64_t v = cache >> (64 - n);
        cache = 0;
        ncache = 0;
        return v;
      }
    }
    uint64_t v = cache >> (64 - n);
    cache <<= n;
    ncache -= n;
    return v;
  }

  uint32_t read_bit() { return (uint32_t)read_bits(1); }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    // sign-extend
    if (n > 0 && (v >> (n - 1)) & 1u) v |= (~0ULL) << n;
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if (cache != 0) {  // a set bit is always within the valid top bits
        int z = __builtin_clzll(cache);
        q += (uint32_t)z;
        // z can be 63 (lone bit at the bottom): << 64 is UB, so split the shift
        cache = (cache << z) << 1;
        ncache -= z + 1;
        return q;
      }
      q += (uint32_t)ncache;  // all-valid-zeros: consume the whole cache
      ncache = 0;
      refill();
      if (ncache == 0) {
        error = true;
        return q;
      }
    }
  }

  void align_byte() {
    int rem = (int)((byte_pos * 8 - (size_t)ncache) & 7);
    if (rem) read_bits(8 - rem);
  }
};

// UTF-8-style coded number used for FLAC frame headers (up to 36 bits).
uint64_t read_utf8_coded(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  int extra = 0;
  uint64_t v = 0;
  if ((b0 & 0x80u) == 0) {
    return b0;
  } else if ((b0 & 0xE0u) == 0xC0u) {
    extra = 1;
    v = b0 & 0x1Fu;
  } else if ((b0 & 0xF0u) == 0xE0u) {
    extra = 2;
    v = b0 & 0x0Fu;
  } else if ((b0 & 0xF8u) == 0xF0u) {
    extra = 3;
    v = b0 & 0x07u;
  } else if ((b0 & 0xFCu) == 0xF8u) {
    extra = 4;
    v = b0 & 0x03u;
  } else if ((b0 & 0xFEu) == 0xFCu) {
    extra = 5;
    v = b0 & 0x01u;
  } else if (b0 == 0xFEu) {
    extra = 6;
    v = 0;
  } else {
    br.error = true;
    return 0;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0u) != 0x80u) {
      br.error = true;
      return 0;
    }
    v = (v << 6) | (b & 0x3Fu);
  }
  return v;
}

struct AudioData {
  std::vector<float> samples;  // interleaved, range [-1, 1]
  int sample_rate = 0;
  int channels = 0;
  int64_t frames = 0;
  // Zero-copy fast path for float32 WAV: ``view`` points at the interleaved
  // sample payload inside the mmap'd container (kept as bytes — WAV chunks
  // are only 2-byte aligned), so reads are ONE memcpy from the page cache
  // instead of fread + two intermediate copies (each with a zero-init
  // pass).  When set, ``samples`` stays empty and the map is owned here.
  const uint8_t* view = nullptr;
  void* map_base = nullptr;
  size_t map_len = 0;

  AudioData() = default;
  AudioData(const AudioData&) = delete;
  AudioData& operator=(const AudioData&) = delete;
  ~AudioData() {
#if !defined(_WIN32)
    if (map_base) munmap(map_base, map_len);
#endif
  }
};

// ---------------------------------------------------------------------------
// FLAC decoding
// ---------------------------------------------------------------------------
struct FlacStreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits_per_sample = 0;
  uint64_t total_samples = 0;
};

bool decode_flac_residual(BitReader& br, uint32_t block_size, int pred_order,
                          int64_t* out) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = (uint32_t)br.read_bits(4);
  uint32_t n_parts = 1u << part_order;
  if (block_size % n_parts) return false;
  uint32_t part_len = block_size >> part_order;
  // Spec requires (block_size >> partition_order) > predictor order for every
  // partitioning; otherwise the first partition's count underflows as uint32
  // and the write loop runs far past the block_size-sized buffer.
  if (part_len <= (uint32_t)pred_order) return false;
  uint32_t idx = 0;
  for (uint32_t p = 0; p < n_parts; ++p) {
    uint32_t count = part_len - (p == 0 ? pred_order : 0);
    uint32_t param = (uint32_t)br.read_bits(param_bits);
    if (br.error) return false;
    if (param == escape) {
      uint32_t raw_bits = (uint32_t)br.read_bits(5);
      for (uint32_t i = 0; i < count; ++i)
        out[idx++] = raw_bits ? br.read_signed((int)raw_bits) : 0;
    } else {
      // no per-sample error branch: br.error is sticky, reads return zeros
      // once the buffer is exhausted, and the loop is bounded by count —
      // one check per partition keeps the hot loop at unary+bits+zigzag
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits((int)param);
        uint64_t u = ((uint64_t)q << param) | r;
        // zigzag decode
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_flac_subframe(BitReader& br, uint32_t block_size, int bps,
                          std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // padding bit must be 0
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bit()) {
    wasted = 1 + br.read_unary();
    bps -= (int)wasted;
  }
  // every decode path below writes all block_size entries (warmup + residual
  // spans the block), so resize — not assign — avoids a 32 KB re-zeroing
  // memset per subframe on reused channel buffers
  out.resize(block_size);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = (int)(type & 7u);
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_flac_residual(br, block_size, order, out.data() + order))
      return false;
    // apply fixed predictors
    switch (order) {
      case 0:
        break;
      case 1:
        for (uint32_t i = 1; i < block_size; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < block_size; ++i)
          out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < block_size; ++i)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < block_size; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
        break;
      default:
        return false;
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (int)(type & 31u) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_flac_residual(br, block_size, order, out.data() + order))
      return false;
    for (uint32_t i = (uint32_t)order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
  }
  return !br.error;
}

static const uint32_t kFlacBlockSizes[16] = {
    0, 192, 576, 1152, 2304, 4608, 0, 0, 256, 512, 1024, 2048, 4096, 8192,
    16384, 32768};
static const uint32_t kFlacSampleRates[16] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000, 32000, 44100, 48000,
    96000, 0, 0, 0, 0};

// Parse the fLaC marker + metadata blocks; on success ``first_frame`` is the
// byte offset of the first audio frame.
bool parse_flac_header(const uint8_t* buf, size_t n, FlacStreamInfo& info,
                       size_t& first_frame) {
  if (n < 8 || memcmp(buf, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool have_info = false;
  while (pos + 4 <= n) {
    uint8_t hdr = buf[pos];
    bool last = hdr & 0x80u;
    uint8_t type = hdr & 0x7Fu;
    uint32_t len = ((uint32_t)buf[pos + 1] << 16) | ((uint32_t)buf[pos + 2] << 8) |
                   buf[pos + 3];
    pos += 4;
    if (pos + len > n) return false;
    if (type == 0 && len >= 34) {
      const uint8_t* p = buf + pos;
      info.min_block = ((uint32_t)p[0] << 8) | p[1];
      info.max_block = ((uint32_t)p[2] << 8) | p[3];
      info.sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) |
                         (p[12] >> 4);
      info.channels = ((p[12] >> 1) & 0x7u) + 1;
      info.bits_per_sample = (((p[12] & 1u) << 4) | (p[13] >> 4)) + 1;
      info.total_samples = ((uint64_t)(p[13] & 0x0Fu) << 32) |
                           ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                           ((uint64_t)p[16] << 8) | p[17];
      have_info = true;
    }
    pos += len;
    if (last) break;
  }
  if (!have_info || info.sample_rate == 0) return false;
  first_frame = pos;
  return true;
}

// Decode ONE frame at br's position into ``chan``; 1 = frame decoded,
// 0 = clean end (sync mismatch / EOF, trailing junk tolerated), -1 = error.
int decode_flac_frame(BitReader& br, const FlacStreamInfo& info,
                      std::vector<std::vector<int64_t>>& chan,
                      uint32_t& block_size) {
  if (br.tell_byte() + 2 >= br.size || br.error) return 0;
  uint32_t sync = (uint32_t)br.read_bits(14);
  if (br.error) return 0;
  if (sync != 0x3FFE) return 0;  // trailing junk tolerated
  br.read_bit();  // reserved
  br.read_bit();  // blocking strategy
  uint32_t bs_code = (uint32_t)br.read_bits(4);
  uint32_t sr_code = (uint32_t)br.read_bits(4);
  uint32_t ch_code = (uint32_t)br.read_bits(4);
  uint32_t ss_code = (uint32_t)br.read_bits(3);
  br.read_bit();  // reserved
  read_utf8_coded(br);
  if (bs_code == 6)
    block_size = (uint32_t)br.read_bits(8) + 1;
  else if (bs_code == 7)
    block_size = (uint32_t)br.read_bits(16) + 1;
  else
    block_size = kFlacBlockSizes[bs_code];
  if (sr_code == 12)
    br.read_bits(8);
  else if (sr_code == 13 || sr_code == 14)
    br.read_bits(16);
  br.read_bits(8);  // CRC-8
  if (block_size == 0 || br.error) return -1;

  int bps = (int)info.bits_per_sample;
  switch (ss_code) {
    case 0: break;  // from STREAMINFO
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }

  uint32_t nch;
  if (ch_code < 8) {
    nch = ch_code + 1;
    if (nch != info.channels) return -1;
    for (uint32_t c = 0; c < nch; ++c)
      if (!decode_flac_subframe(br, block_size, bps, chan[c])) return -1;
  } else if (ch_code <= 10) {
    nch = 2;
    if (info.channels != 2) return -1;
    // side channel carries one extra bit
    int bps0 = bps + (ch_code == 9 ? 1 : 0);
    int bps1 = bps + (ch_code != 9 ? 1 : 0);
    if (!decode_flac_subframe(br, block_size, bps0, chan[0])) return -1;
    if (!decode_flac_subframe(br, block_size, bps1, chan[1])) return -1;
    if (ch_code == 8) {  // left/side -> right = left - side
      for (uint32_t i = 0; i < block_size; ++i)
        chan[1][i] = chan[0][i] - chan[1][i];
    } else if (ch_code == 9) {  // side/right -> left = side + right
      for (uint32_t i = 0; i < block_size; ++i)
        chan[0][i] = chan[0][i] + chan[1][i];
    } else {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t mid = chan[0][i];
        int64_t side = chan[1][i];
        mid = (mid << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }
  } else {
    return -1;
  }
  br.align_byte();
  br.read_bits(16);  // CRC-16
  if (br.error) return -1;
  return 1;
}

bool decode_flac(const uint8_t* buf, size_t n, AudioData& out) {
  FlacStreamInfo info;
  size_t pos;
  if (!parse_flac_header(buf, n, info, pos)) return false;

  out.sample_rate = (int)info.sample_rate;
  out.channels = (int)info.channels;
  out.frames = 0;
  if (info.total_samples)
    out.samples.reserve((size_t)info.total_samples * info.channels);

  BitReader br(buf, n);
  br.seek_byte(pos);
  const double scale = 1.0 / (double)(1u << (info.bits_per_sample - 1));
  std::vector<std::vector<int64_t>> chan(info.channels);

  // STREAMINFO knows the total, so size the output ONCE — per-frame resize
  // re-zeroed and realloc-copied the growing buffer (tens of MB of pure
  // memory traffic on a multi-minute take).  total_samples is an UNTRUSTED
  // header field (36 bits; a fuzzed value would allocate 100s of GB), so the
  // upfront claim is heuristically capped at one sample/channel per payload
  // byte plus an absolute lid.  The cap is NOT a decode bound (CONSTANT
  // frames expand far beyond it) — correctness comes from the in-loop
  // resize, which still grows past a too-small guess; real takes encode
  // well above 1 byte/sample, so they hit the single-allocation fast path.
  if (info.total_samples) {
    uint64_t by_payload = (uint64_t)br.size + 4096;  // >= samples/channel
    uint64_t claim = info.total_samples < by_payload ? info.total_samples
                                                     : by_payload;
    const uint64_t kMaxUpfront = 1ull << 31;  // 8 GB of floats w/ channels<=4
    if (claim * info.channels < kMaxUpfront)
      out.samples.resize((size_t)(claim * info.channels));
  }
  for (;;) {
    uint32_t block_size = 0;
    int rc = decode_flac_frame(br, info, chan, block_size);
    if (rc == 0) break;
    if (rc < 0) return false;
    size_t base = (size_t)out.frames * info.channels;
    size_t need = base + (size_t)block_size * info.channels;
    if (out.samples.size() < need) out.samples.resize(need);
    if (info.channels == 2) {
      // specialized stereo interleave: the generic nested loop re-tests the
      // 2-trip channel loop per sample and defeats vectorization
      const int64_t* c0 = chan[0].data();
      const int64_t* c1 = chan[1].data();
      float* dst = out.samples.data() + base;
      for (uint32_t i = 0; i < block_size; ++i) {
        dst[2 * (size_t)i] = (float)(c0[i] * scale);
        dst[2 * (size_t)i + 1] = (float)(c1[i] * scale);
      }
    } else {
      for (uint32_t i = 0; i < block_size; ++i)
        for (uint32_t c = 0; c < info.channels; ++c)
          out.samples[base + (size_t)i * info.channels + c] =
              (float)(chan[c][i] * scale);
    }
    out.frames += block_size;
    if (info.total_samples && (uint64_t)out.frames >= info.total_samples) break;
  }
  if ((size_t)out.frames * info.channels < out.samples.size())
    out.samples.resize((size_t)out.frames * info.channels);
  return out.frames > 0;
}

// ---------------------------------------------------------------------------
// WAV decoding / encoding
// ---------------------------------------------------------------------------
uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

uint64_t rd_u64(const uint8_t* p) {
  return (uint64_t)rd_u32(p) | ((uint64_t)rd_u32(p + 4) << 32);
}

bool decode_wav(const uint8_t* buf, size_t n, AudioData& out,
                bool allow_view = false) {
  if (n < 44 || memcmp(buf + 8, "WAVE", 4) != 0) return false;
  // RF64 (EBU Tech 3306): 64-bit sizes live in a ds64 chunk; the 32-bit
  // RIFF/data size fields hold the 0xFFFFFFFF sentinel
  bool rf64 = memcmp(buf, "RF64", 4) == 0 || memcmp(buf, "BW64", 4) == 0;
  if (!rf64 && memcmp(buf, "RIFF", 4) != 0) return false;
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  uint64_t ds64_data = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= n) {
    const uint8_t* chunk_id = buf + pos;
    uint64_t chunk_len = rd_u32(buf + pos + 4);
    pos += 8;
    if (memcmp(chunk_id, "data", 4) == 0 && chunk_len == 0xFFFFFFFFull && rf64)
      chunk_len = ds64_data;
    // compare against the remaining bytes, NOT pos + chunk_len (a near-max
    // attacker-controlled 64-bit ds64 size would wrap the addition past n)
    if (chunk_len > (uint64_t)(n - pos)) chunk_len = (uint64_t)(n - pos);
    if (memcmp(chunk_id, "ds64", 4) == 0 && chunk_len >= 16) {
      ds64_data = rd_u64(buf + pos + 8);
    } else if (memcmp(chunk_id, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(buf + pos);
      channels = rd_u16(buf + pos + 2);
      sr = rd_u32(buf + pos + 4);
      bits = rd_u16(buf + pos + 14);
      if (fmt == 0xFFFE && chunk_len >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: subformat GUID starts with the format tag
        fmt = rd_u16(buf + pos + 24);
      }
    } else if (memcmp(chunk_id, "data", 4) == 0) {
      data = buf + pos;
      data_len = (size_t)chunk_len;
    }
    pos += (size_t)(chunk_len + (chunk_len & 1));  // chunks are word-aligned
  }
  if (!data || !channels || !sr) return false;
  size_t bytes_per = bits / 8;
  if (!bytes_per) return false;
  size_t total = data_len / bytes_per;
  out.sample_rate = (int)sr;
  out.channels = (int)channels;
  out.frames = (int64_t)(total / channels);
  total = (size_t)out.frames * channels;
  if (fmt == 3 && bits == 32 && allow_view) {
    out.view = data;  // defer to one memcpy at read time (mapped container)
    return true;
  }
  out.samples.resize(total);
  if (fmt == 3 && bits == 32) {
    memcpy(out.samples.data(), data, total * 4);
  } else if (fmt == 3 && bits == 64) {
    for (size_t i = 0; i < total; ++i) {
      double v;
      memcpy(&v, data + i * 8, 8);
      out.samples[i] = (float)v;
    }
  } else if (fmt == 1 && bits == 16) {
    for (size_t i = 0; i < total; ++i) {
      int16_t v = (int16_t)rd_u16(data + i * 2);
      out.samples[i] = (float)(v / 32768.0);
    }
  } else if (fmt == 1 && bits == 24) {
    for (size_t i = 0; i < total; ++i) {
      const uint8_t* p = data + i * 3;
      int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                            (uint32_t)p[2] << 24) >> 8;
      out.samples[i] = (float)(v / 8388608.0);
    }
  } else if (fmt == 1 && bits == 32) {
    for (size_t i = 0; i < total; ++i) {
      int32_t v = (int32_t)rd_u32(data + i * 4);
      out.samples[i] = (float)(v / 2147483648.0);
    }
  } else if (fmt == 1 && bits == 8) {
    for (size_t i = 0; i < total; ++i)
      out.samples[i] = (float)((data[i] - 128) / 128.0);
  } else {
    return false;
  }
  return true;
}

bool read_whole_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  FSEEK64(f, 0, SEEK_END);
  int64_t sz = FTELL64(f);
  FSEEK64(f, 0, SEEK_SET);
  if (sz <= 0) {
    fclose(f);
    return false;
  }
  buf.resize((size_t)sz);
  size_t got = fread(buf.data(), 1, (size_t)sz, f);
  fclose(f);
  return got == (size_t)sz;
}

bool decode_any(const char* path, AudioData& out) {
#if !defined(_WIN32)
  // mmap the container: FLAC/PCM decode reads straight from the page cache
  // (no fread pass, no zero-init of a staging vector), and float32 WAV
  // skips decode entirely (the payload IS the samples — view fast path)
  int fd = open(path, O_RDONLY);
  if (fd >= 0) {
    struct stat st;
    void* m = MAP_FAILED;
    if (fstat(fd, &st) == 0 && st.st_size > 4)
      m = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (m != MAP_FAILED) {
      const uint8_t* p = (const uint8_t*)m;
      size_t len = (size_t)st.st_size;
      bool ok = (len >= 4 && memcmp(p, "fLaC", 4) == 0)
                    ? decode_flac(p, len, out)
                    : decode_wav(p, len, out, /*allow_view=*/true);
      if (ok && out.view) {
        out.map_base = m;  // view points into the map; AudioData owns it
        out.map_len = len;
      } else {
        munmap(m, len);
      }
      return ok;
    }
  }
#endif
  std::vector<uint8_t> buf;
  if (!read_whole_file(path, buf)) return false;
  if (buf.size() >= 4 && memcmp(buf.data(), "fLaC", 4) == 0)
    return decode_flac(buf.data(), buf.size(), out);
  return decode_wav(buf.data(), buf.size(), out);
}

// ---------------------------------------------------------------------------
// FLAC encoding (fixed predictors + rice residuals).  The reference can only
// write WAV (io_ops.py:19-23); archives live as FLAC, so the framework
// closes the loop: frames of 4096 samples, per-subframe best fixed
// predictor (order 0-4 by residual cost), rice method 0 with one partition,
// independent channels, proper CRC-8/CRC-16.  Decodable by any FLAC reader.
// ---------------------------------------------------------------------------
// MSB-first bit writer with a 64-bit accumulator (bits live in the TOP nbits
// of acc; whole bytes drain eagerly so nbits stays < 8 between calls and the
// byte vector is always current at aligned points, where the frame CRCs are
// computed).  The rice residual loop writes unary + k bits per sample, so
// per-bit pushes were the encoder's hot path.
struct BitWriter {
  // ``bytes`` is sized ahead (grow()) and ``len`` tracks the logical end, so
  // drain() can store the accumulator's whole-byte prefix with ONE 8-byte
  // big-endian store (plus up to 7 garbage bytes that later stores or the
  // final shrink overwrite) instead of per-byte push_backs — the rice
  // residual loop drains once per sample, making this the encoder's
  // hottest store path.
  std::vector<uint8_t> bytes;
  size_t len = 0;
  uint64_t acc = 0;
  int nbits = 0;  // < 8 between calls

  void reset() {
    len = 0;
    acc = 0;
    nbits = 0;
  }

  void grow(size_t need) {
    if (bytes.size() < len + need + 16) bytes.resize(len + need + 16);
  }

  void drain() {
    uint64_t be = __builtin_bswap64(acc);
    memcpy(bytes.data() + len, &be, 8);  // 8-byte slack guaranteed by grow()
    int nb = nbits >> 3;
    len += (size_t)nb;
    acc <<= nb * 8;
    nbits &= 7;
  }

  void put_bits(uint64_t v, int n) {
    if (n <= 0) return;
    if (bytes.size() < len + 24) grow(64);
    if (n < 64) v &= (~0ULL >> (64 - n));
    if (n <= 56) {  // always fits: nbits < 8 here
      acc |= v << (64 - nbits - n);
      nbits += n;
    } else {
      int hi = n - 32;
      acc |= (v >> 32) << (64 - nbits - hi);
      nbits += hi;
      drain();
      acc |= (v & 0xFFFFFFFFull) << (64 - nbits - 32);
      nbits += 32;
    }
    drain();
  }

  void put_unary(uint32_t q) {
    while (q >= 32) {
      put_bits(0, 32);
      q -= 32;
    }
    put_bits(1, (int)q + 1);  // q zeros then a one
  }

  void align() {
    if (nbits) put_bits(0, 8 - nbits);
  }
};

// Table-driven CRCs: the bitwise loops were the encoder's second-largest
// cost (8 shift/xor steps per OUTPUT byte; crc16 runs over every frame's
// full byte span).  Same polynomials (x^8+x^2+x+1, x^16+x^15+x^2+1), so the
// emitted stream is byte-identical — the tables just hoist the 8 inner
// steps into one lookup per byte (~8x on this path, measured).
struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int v = 0; v < 256; ++v) {
      uint8_t crc = (uint8_t)v;
      for (int b = 0; b < 8; ++b)
        crc = (crc & 0x80u) ? (uint8_t)((crc << 1) ^ 0x07u)
                            : (uint8_t)(crc << 1);
      t[v] = crc;
    }
  }
};

// Slice-by-8 CRC-16: the byte-at-a-time table walk is one dependent
// load per byte (~10 cycles of load-to-use latency on this core, measured
// 26 ms per 34 s stereo take).  t[0] is the classic table; t[k][v] is the
// CRC of byte v followed by k zero bytes, so eight independent lookups
// cover 8 input bytes per iteration and the dependency chain shrinks 8x.
// Same polynomial (x^16+x^15+x^2+1) — the value is bit-identical.
struct Crc16Table {
  uint16_t t[8][256];
  Crc16Table() {
    for (int v = 0; v < 256; ++v) {
      uint16_t crc = (uint16_t)(v << 8);
      for (int b = 0; b < 8; ++b)
        crc = (crc & 0x8000u) ? (uint16_t)((crc << 1) ^ 0x8005u)
                              : (uint16_t)(crc << 1);
      t[0][v] = crc;
    }
    for (int k = 1; k < 8; ++k)
      for (int v = 0; v < 256; ++v) {
        uint16_t c = t[k - 1][v];
        t[k][v] = (uint16_t)((c << 8) ^ t[0][c >> 8]);
      }
  }
};

uint8_t flac_crc8(const uint8_t* d, size_t n) {
  static const Crc8Table kT;
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) crc = kT.t[crc ^ d[i]];
  return crc;
}

uint16_t flac_crc16(const uint8_t* d, size_t n) {
  static const Crc16Table kT;
  uint16_t crc = 0;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    crc = (uint16_t)(kT.t[7][((crc >> 8) ^ d[i]) & 0xFF] ^
                     kT.t[6][((crc & 0xFF) ^ d[i + 1])] ^
                     kT.t[5][d[i + 2]] ^ kT.t[4][d[i + 3]] ^
                     kT.t[3][d[i + 4]] ^ kT.t[2][d[i + 5]] ^
                     kT.t[1][d[i + 6]] ^ kT.t[0][d[i + 7]]);
  }
  for (; i < n; ++i)
    crc = (uint16_t)((crc << 8) ^ kT.t[0][(crc >> 8) ^ d[i]]);
  return crc;
}

void put_utf8_coded(BitWriter& bw, uint64_t v) {
  if (v < 0x80) {
    bw.put_bits(v, 8);
  } else if (v < 0x800) {
    bw.put_bits(0xC0u | (v >> 6), 8);
    bw.put_bits(0x80u | (v & 0x3Fu), 8);
  } else if (v < 0x10000) {
    bw.put_bits(0xE0u | (v >> 12), 8);
    bw.put_bits(0x80u | ((v >> 6) & 0x3Fu), 8);
    bw.put_bits(0x80u | (v & 0x3Fu), 8);
  } else if (v < 0x200000) {
    bw.put_bits(0xF0u | (v >> 18), 8);
    bw.put_bits(0x80u | ((v >> 12) & 0x3Fu), 8);
    bw.put_bits(0x80u | ((v >> 6) & 0x3Fu), 8);
    bw.put_bits(0x80u | (v & 0x3Fu), 8);
  } else {  // up to 2^26-1 frames is ample (4096-sample frames)
    bw.put_bits(0xF8u | (v >> 24), 8);
    for (int sh = 18; sh >= 0; sh -= 6)
      bw.put_bits(0x80u | ((v >> sh) & 0x3Fu), 8);
  }
}

// residual after a fixed predictor of the given order
// Levinson-Durbin LPC fit (double autocorrelation); false on degenerate
// input.
bool compute_lpc(const int64_t* x, uint32_t n, int order, double* lpc) {
  // convert once: the per-lag int64->double casts were 9 redundant passes,
  // and the all-double dot products below auto-vectorize (AVX fma).
  // The block fits L1 (4096 doubles = 32 KB), so per-lag passes can run at
  // 8-wide fma throughput — but a plain `s +=` FP reduction cannot legally
  // vectorize under -O3 (no fast-math), so the 8 partial sums are explicit:
  // the fixed-length inner loop maps to one AVX-512 fma per 8 samples.
  thread_local std::vector<double> xd;
  xd.resize(n);
  for (uint32_t i = 0; i < n; ++i) xd[i] = (double)x[i];
  std::vector<double> ac(order + 1, 0.0);
  for (int lag = 0; lag <= order; ++lag) {
    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t i = (uint32_t)lag;
    for (; i + 8 <= n; i += 8)
      for (int j = 0; j < 8; ++j) acc[j] += xd[i + j] * xd[i + j - lag];
    double s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
               ((acc[4] + acc[5]) + (acc[6] + acc[7]));
    for (; i < n; ++i) s += xd[i] * xd[i - lag];
    ac[lag] = s;
  }
  if (!(ac[0] > 0)) return false;
  std::vector<double> a(order, 0.0);
  double e = ac[0];
  for (int i = 0; i < order; ++i) {
    double acc = ac[i + 1];
    for (int j = 0; j < i; ++j) acc -= a[j] * ac[i - j];
    double k = acc / e;
    std::vector<double> na(a);
    na[i] = k;
    for (int j = 0; j < i; ++j) na[j] = a[j] - k * a[i - 1 - j];
    a = na;
    e *= (1 - k * k);
    if (!(e > 0)) break;
  }
  for (int j = 0; j < order; ++j) {
    if (!std::isfinite(a[j])) return false;
    lpc[j] = a[j];
  }
  return true;
}

void write_flac_subframe(BitWriter& bw, const int64_t* x, uint32_t n, int bps,
                         bool try_lpc) {
  bw.put_bits(0, 1);  // padding
  // pick the fixed order with the smallest total |residual|: all five order
  // costs in ONE forward pass over x via the binomial residual formulas
  // (no loop-carried state, so the int64 lanes vectorize), replacing the
  // old five in-place differencing passes.  Integer cost sums are exact
  // (a 4096-sample block of 33-bit residuals tops out near 2^45).
  // The same pass detects a CONSTANT subframe for free: c[1] == 0 iff
  // sum |x[i] - x[i-1]| == 0 iff every sample equals x[0] — the old
  // dedicated scan was a whole extra pass on the non-constant (i.e. every
  // real) block.
  thread_local std::vector<int64_t> best;
  int best_order = 0;
  long double best_cost = -1;
  uint64_t c[5] = {0, 0, 0, 0, 0};
  {
    auto uabs = [](int64_t v) { return v < 0 ? (uint64_t)(-v) : (uint64_t)v; };
    for (uint32_t i = 0; i < n && i < 4; ++i) {
      c[0] += uabs(x[i]);
      if (i >= 1) c[1] += uabs(x[i] - x[i - 1]);
      if (i >= 2) c[2] += uabs(x[i] - 2 * x[i - 1] + x[i - 2]);
      if (i >= 3) c[3] += uabs(x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3]);
    }
    for (uint32_t i = 4; i < n; ++i) {
      int64_t x0 = x[i], x1 = x[i - 1], x2 = x[i - 2], x3 = x[i - 3],
              x4 = x[i - 4];
      c[0] += uabs(x0);
      c[1] += uabs(x0 - x1);
      c[2] += uabs(x0 - 2 * x1 + x2);
      c[3] += uabs(x0 - 3 * x1 + 3 * x2 - x3);
      c[4] += uabs(x0 - 4 * x1 + 6 * x2 - 4 * x3 + x4);
    }
    if (n == 1 || c[1] == 0) {  // constant (n == 1 trivially so)
      bw.put_bits(0, 6);  // CONSTANT
      bw.put_bits(0, 1);  // no wasted bits
      bw.put_bits((uint64_t)x[0] & ((bps < 64 ? (1ull << bps) : 0ull) - 1ull),
                  bps);
      return;
    }
    for (int order = 0; order <= 4 && (uint32_t)order < n; ++order) {
      if (best_cost < 0 || (long double)c[order] < best_cost) {
        best_cost = (long double)c[order];
        best_order = order;
      }
    }
  }
  // LPC candidate (order 8, precision 14): quantize coefficients with the
  // decoder's exact integer prediction (pred >> shift) and keep it when its
  // residual beats the best fixed predictor's (whose residual is only
  // materialized below if it actually wins)
  const int kLpcOrder = 8, kPrec = 14;
  bool use_lpc = false;
  std::vector<int64_t> qcoef(kLpcOrder);
  int lpc_shift = 0;
  if (try_lpc && n > (uint32_t)kLpcOrder * 2) {
    double lpc[kLpcOrder];
    if (compute_lpc(x, n, kLpcOrder, lpc)) {
      double cmax = 0;
      for (int j = 0; j < kLpcOrder; ++j)
        cmax = std::max(cmax, std::fabs(lpc[j]));
      if (cmax > 0) {
        int headroom = 0;
        while ((1 << headroom) <= (int)cmax + 1 && headroom < 16) ++headroom;
        lpc_shift = kPrec - 1 - headroom;
        if (lpc_shift > 15) lpc_shift = 15;
        if (lpc_shift >= 0) {
          int64_t cmin_q = -(1ll << (kPrec - 1));
          int64_t cmax_q = (1ll << (kPrec - 1)) - 1;
          for (int j = 0; j < kLpcOrder; ++j) {
            double v = lpc[j] * (double)(1ll << lpc_shift);
            int64_t q = (int64_t)(v >= 0 ? v + 0.5 : v - 0.5);
            qcoef[j] = q < cmin_q ? cmin_q : (q > cmax_q ? cmax_q : q);
          }
          // predictions accumulate j-outer: each of the 8 coefficient
          // passes is an independent shifted multiply-add over the block
          // (vectorizes over samples), instead of an 8-term horizontal
          // reduction per sample; int adds are associative, so the result
          // is bit-identical to the per-sample form the decoder uses
          thread_local std::vector<int64_t> lres, pred;
          lres.resize(n);
          pred.assign(n, 0);
          for (int j = 0; j < kLpcOrder; ++j) {
            const int64_t c = qcoef[j];
            for (uint32_t i = kLpcOrder; i < n; ++i)
              pred[i] += c * x[i - 1 - j];
          }
          uint64_t lcost_u = 0;
          for (uint32_t i = kLpcOrder; i < n; ++i) {
            lres[i] = x[i] - (pred[i] >> lpc_shift);
            lcost_u += lres[i] < 0 ? (uint64_t)(-lres[i]) : (uint64_t)lres[i];
          }
          long double lcost = (long double)lcost_u;
          // compare at equal footing: cost per coded sample plus the
          // coefficient overhead (~order * precision bits)
          if (lcost + (long double)kLpcOrder * kPrec / 8.0 < best_cost) {
            use_lpc = true;
            best.swap(lres);  // both thread_local scratch; avoids a copy
            best_order = kLpcOrder;
            best_cost = lcost;
          }
        }
      }
    }
  }
  uint32_t count = n - (uint32_t)best_order;
  // rice parameter from the mean magnitude
  long double mean = best_cost / (count ? count : 1) + 1;
  int k = 0;
  while ((1ll << (k + 1)) < mean && k < 14) ++k;
  // ONE fused pass producing the zigzag codes the packer consumes directly,
  // plus the rice-vs-raw statistics: for the fixed path the residual is
  // computed in-flight (the old flow materialized it with fixed_residual,
  // then re-walked it once for the stats and once more inside the pack
  // loop, re-zigzagging both times — three passes where one suffices).
  thread_local std::vector<uint64_t> uzz;
  uzz.resize(n);
  uint64_t rice_bits = 0;
  uint64_t umax = 0;
  {
    auto zz = [](int64_t r) {
      return r >= 0 ? ((uint64_t)r << 1) : (((uint64_t)(-r) << 1) - 1);
    };
    uint64_t* u = uzz.data();
    if (use_lpc) {
      for (uint32_t i = (uint32_t)best_order; i < n; ++i) u[i] = zz(best[i]);
    } else {
      switch (best_order) {
        case 0:
          for (uint32_t i = 0; i < n; ++i) u[i] = zz(x[i]);
          break;
        case 1:
          for (uint32_t i = 1; i < n; ++i) u[i] = zz(x[i] - x[i - 1]);
          break;
        case 2:
          for (uint32_t i = 2; i < n; ++i)
            u[i] = zz(x[i] - 2 * x[i - 1] + x[i - 2]);
          break;
        case 3:
          for (uint32_t i = 3; i < n; ++i)
            u[i] = zz(x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3]);
          break;
        default:
          for (uint32_t i = 4; i < n; ++i)
            u[i] = zz(x[i] - 4 * x[i - 1] + 6 * x[i - 2] - 4 * x[i - 3] +
                      x[i - 4]);
          break;
      }
    }
    for (uint32_t i = (uint32_t)best_order; i < n; ++i) {
      rice_bits += (u[i] >> k) + 1 + (uint64_t)k;
      if (u[i] > umax) umax = u[i];
    }
  }
  if (use_lpc) {
    bw.put_bits(32u | (uint32_t)(kLpcOrder - 1), 6);  // LPC
    bw.put_bits(0, 1);                                // no wasted bits
    for (int i = 0; i < kLpcOrder; ++i)
      bw.put_bits((uint64_t)x[i] & ((1ull << bps) - 1ull), bps);
    bw.put_bits((uint32_t)(kPrec - 1), 4);
    bw.put_bits((uint64_t)lpc_shift & 0x1Fu, 5);
    for (int i = 0; i < kLpcOrder; ++i)
      bw.put_bits((uint64_t)qcoef[i] & ((1ull << kPrec) - 1ull), kPrec);
  } else {
    bw.put_bits(8u | (uint32_t)best_order, 6);  // FIXED
    bw.put_bits(0, 1);                          // no wasted bits
    for (int i = 0; i < best_order; ++i)
      bw.put_bits((uint64_t)x[i] & ((1ull << bps) - 1ull), bps);
  }
  bw.put_bits(0, 2);  // residual method 0 (4-bit rice)
  bw.put_bits(0, 4);  // partition order 0
  // escape to raw if rice would explode (k capped at 14; 15 = escape).
  // NB: order-r fixed residuals can need up to bps + r + 1 bits, so the raw
  // width comes from the actual maximum, not from bps.
  const uint64_t* u = uzz.data();
  int raw_bits = 1;
  while (raw_bits < 40 && (umax >> raw_bits)) ++raw_bits;
  ++raw_bits;  // sign bit (u is the zigzag magnitude; residual needs one more)
  // the 5-bit width field caps raw residuals at 31 bits; wider residuals
  // (possible near 2^29 from an order-4 predictor on 24-bit input) must
  // stay rice-coded — put_bits(32, 5) would truncate to 0 and corrupt the
  // frame.
  if (raw_bits <= 31 &&
      rice_bits > (uint64_t)count * (uint64_t)raw_bits) {
    bw.put_bits(0xF, 4);  // escape: raw residuals
    bw.put_bits((uint32_t)raw_bits, 5);
    for (uint32_t i = (uint32_t)best_order; i < n; ++i) {
      // un-zigzag: identical two's-complement bytes to the old
      // residual-array write
      int64_t r = (int64_t)(u[i] >> 1) ^ -(int64_t)(u[i] & 1);
      bw.put_bits((uint64_t)r & ((1ull << raw_bits) - 1ull), raw_bits);
    }
    return;
  }
  bw.put_bits((uint32_t)k, 4);
  const uint64_t kmask = k ? ((1ull << k) - 1ull) : 0ull;
  for (uint32_t i = (uint32_t)best_order; i < n; ++i) {
    // one call per sample: q zeros, a one, then the k low bits — the same
    // stream as put_unary + put_bits, fused while it fits the accumulator
    uint64_t q = u[i] >> k;
    int nb = (int)q + 1 + k;
    if (nb <= 56) {
      bw.put_bits((1ull << k) | (u[i] & kmask), nb);
    } else {
      bw.put_unary((uint32_t)q);
      if (k) bw.put_bits(u[i] & kmask, k);
    }
  }
}

const uint32_t kFlacEncBlock = 4096;

// STREAMINFO bytes (the 18 used ones) at the given total-frame count; the
// streaming writer rewrites these in place at close once the count is known.
void fill_flac_streaminfo(uint8_t* p, int64_t frames, int channels,
                          int sample_rate, int bps) {
  const uint32_t kBlock = kFlacEncBlock;
  uint32_t last_block = (uint32_t)(frames % kBlock);
  uint32_t min_block = frames > kBlock ? kBlock : (last_block ? last_block : kBlock);
  p[0] = (uint8_t)(min_block >> 8); p[1] = (uint8_t)min_block;
  p[2] = (uint8_t)(kBlock >> 8); p[3] = (uint8_t)kBlock;
  // min/max frame size unknown (0)
  p[10] = (uint8_t)(sample_rate >> 12);
  p[11] = (uint8_t)(sample_rate >> 4);
  p[12] = (uint8_t)(((sample_rate & 0xF) << 4) | (((channels - 1) & 7) << 1) |
                    (((bps - 1) >> 4) & 1));
  p[13] = (uint8_t)((((bps - 1) & 0xF) << 4) | ((frames >> 32) & 0xF));
  p[14] = (uint8_t)(frames >> 24); p[15] = (uint8_t)(frames >> 16);
  p[16] = (uint8_t)(frames >> 8); p[17] = (uint8_t)frames;
}

// One FLAC frame from an interleaved float block.  Shared by the whole-file
// encoder and the streaming writer, so both paths stay byte-identical.
bool encode_flac_block(FILE* f, const float* data, uint32_t bs, int channels,
                       int bps, uint64_t frame_no, int level) {
  const bool try_lpc = level > 0;
  const double scale = (double)(1u << (bps - 1));
  const int64_t lim = (1ll << (bps - 1)) - 1;
  thread_local std::vector<std::vector<int64_t>> chan;
  if ((int)chan.size() < channels) chan.resize(channels);
  {
    // stereo decorrelation: pick mid/side when its order-2 residual cost
    // beats the independent channels' (tape transfers are highly correlated)
    bool use_ms = false;
    thread_local std::vector<int64_t> mid, side;
    if (channels == 2 && bs > 4) {
      // ONE fused pass: deinterleave+quantize both channels, fill mid/side,
      // and accumulate all four order-2 residual costs in-flight — the old
      // flow was seven passes over the block (2x quantize, mid/side fill,
      // 4x cost scan).  Exact uint64 |residual| sums (a block of <=2^27
      // residuals stays far below 2^64).
      chan[0].resize(bs);
      chan[1].resize(bs);
      mid.resize(bs);
      side.resize(bs);
      auto quant = [&](double v) {
        int64_t q = (int64_t)(v >= 0 ? v + 0.5 : v - 0.5);
        return q > lim ? lim : (q < -lim - 1 ? -lim - 1 : q);
      };
      auto uabs = [](int64_t v) { return v < 0 ? (uint64_t)(-v) : (uint64_t)v; };
      uint64_t cl = 0, cr = 0, cm = 0, cs = 0;
      // rolling registers for the order-2 windows (loading back the values
      // just stored into chan/mid/side costs a store-forward stall per lane)
      int64_t l1 = 0, l2 = 0, r1 = 0, r2 = 0, m1 = 0, m2 = 0, s1 = 0, s2 = 0;
      for (uint32_t i = 0; i < bs; ++i) {
        int64_t l = quant((double)data[(size_t)i * 2] * scale);
        int64_t r = quant((double)data[(size_t)i * 2 + 1] * scale);
        chan[0][i] = l;
        chan[1][i] = r;
        int64_t s = l - r;
        int64_t m = (l + r) >> 1;
        side[i] = s;
        mid[i] = m;
        if (i >= 2) {
          cl += uabs(l - 2 * l1 + l2);
          cr += uabs(r - 2 * r1 + r2);
          cm += uabs(m - 2 * m1 + m2);
          cs += uabs(s - 2 * s1 + s2);
        }
        l2 = l1; l1 = l;
        r2 = r1; r1 = r;
        m2 = m1; m1 = m;
        s2 = s1; s1 = s;
      }
      use_ms = cm + cs < cl + cr;
    } else {
      for (int c = 0; c < channels; ++c) {
        chan[c].resize(bs);
        for (uint32_t i = 0; i < bs; ++i) {
          double v = data[(size_t)i * channels + c] * scale;
          int64_t q = (int64_t)(v >= 0 ? v + 0.5 : v - 0.5);
          chan[c][i] = q > lim ? lim : (q < -lim - 1 ? -lim - 1 : q);
        }
      }
    }
    // reused across frames (capacity persists): worst realistic frame is
    // ~5 bytes/sample (raw escape at <=40 bits); typical rice frames less
    thread_local BitWriter bw;
    bw.reset();
    bw.grow((size_t)bs * channels * 5 + 64);
    bw.put_bits(0x3FFE, 14);
    bw.put_bits(0, 1);  // reserved
    bw.put_bits(0, 1);  // fixed blocksize stream
    bw.put_bits(7, 4);  // blocksize: explicit 16-bit (bs - 1)
    bw.put_bits(0, 4);  // sample rate: from STREAMINFO
    bw.put_bits(use_ms ? 10u : (uint32_t)(channels - 1), 4);
    bw.put_bits(bps == 16 ? 4u : (bps == 24 ? 6u : 7u), 3);
    bw.put_bits(0, 1);  // reserved
    put_utf8_coded(bw, frame_no);
    bw.put_bits(bs - 1, 16);
    bw.put_bits(flac_crc8(bw.bytes.data(), bw.len), 8);
    if (use_ms) {
      write_flac_subframe(bw, mid.data(), bs, bps, try_lpc);   // mid at bps
      write_flac_subframe(bw, side.data(), bs, bps + 1, try_lpc);  // side +1
    } else {
      for (int c = 0; c < channels; ++c)
        write_flac_subframe(bw, chan[c].data(), bs, bps, try_lpc);
    }
    bw.align();
    uint16_t crc = flac_crc16(bw.bytes.data(), bw.len);
    bw.put_bits(crc, 16);
    if (fwrite(bw.bytes.data(), 1, bw.len, f) != bw.len)
      return false;
  }
  return true;
}

bool encode_flac(FILE* f, const float* data, int64_t frames, int channels,
                 int sample_rate, int bps, int level) {
  const uint32_t kBlock = kFlacEncBlock;
  // fLaC + STREAMINFO (md5 zero = unknown, permitted)
  uint8_t si[4 + 4 + 34] = {'f', 'L', 'a', 'C', 0x80, 0, 0, 34};
  fill_flac_streaminfo(si + 8, frames, channels, sample_rate, bps);
  if (fwrite(si, 1, sizeof(si), f) != sizeof(si)) return false;

  uint64_t frame_no = 0;
  for (int64_t pos = 0; pos < frames; pos += kBlock, ++frame_no) {
    uint32_t bs = (uint32_t)((frames - pos) < kBlock ? (frames - pos) : kBlock);
    if (!encode_flac_block(f, data + (size_t)pos * channels, bs, channels,
                           bps, frame_no, level))
      return false;
  }
  return true;
}

// Incremental FLAC writer: header first (frame count patched on close), then
// every ``write`` drains whole 4096-sample frames and carries the remainder,
// so peak memory is one block no matter how long the export runs.  The
// output half of the larger-than-memory path for the archive format, pairing
// with the streaming reader above (reference writes only whole WAVs,
// io_ops.py:19-23).
struct FlacStreamWriter {
  FILE* f = nullptr;
  int channels = 0, sample_rate = 0, bps = 0;
  int level = 1;  // 0 = fixed-only (fast decode), 1 = +LPC candidate
  uint64_t frame_no = 0;
  int64_t total = 0;            // frames written (incl. carry)
  std::vector<float> carry;     // < kFlacEncBlock frames, interleaved
  bool failed = false;
};

bool flac_stream_write(FlacStreamWriter& w, const float* data, int64_t frames) {
  if (w.failed || frames < 0) return false;
  w.total += frames;
  const size_t block_vals = (size_t)kFlacEncBlock * w.channels;
  // top up the carry to a whole block first
  if (!w.carry.empty()) {
    size_t need = block_vals - w.carry.size();
    size_t take = (size_t)frames * w.channels;
    if (take > need) take = need;
    w.carry.insert(w.carry.end(), data, data + take);
    data += take;
    frames -= (int64_t)(take / w.channels);
    if (w.carry.size() < block_vals) return true;
    if (!encode_flac_block(w.f, w.carry.data(), kFlacEncBlock, w.channels,
                           w.bps, w.frame_no++, w.level))
      return (w.failed = true, false);
    w.carry.clear();
  }
  while (frames >= (int64_t)kFlacEncBlock) {
    if (!encode_flac_block(w.f, data, kFlacEncBlock, w.channels, w.bps,
                           w.frame_no++, w.level))
      return (w.failed = true, false);
    data += block_vals;
    frames -= kFlacEncBlock;
  }
  if (frames > 0)
    w.carry.assign(data, data + (size_t)frames * w.channels);
  return true;
}

bool flac_stream_finish(FlacStreamWriter& w) {
  if (w.failed) return false;
  if (!w.carry.empty()) {
    uint32_t bs = (uint32_t)(w.carry.size() / w.channels);
    if (!encode_flac_block(w.f, w.carry.data(), bs, w.channels, w.bps,
                           w.frame_no++, w.level))
      return false;
    w.carry.clear();
  }
  // patch STREAMINFO now the frame count is known (offset 8 = metadata data);
  // zero-init keeps the min/max-frame-size fields (bytes 4-9) at "unknown"
  uint8_t p[18] = {0};
  fill_flac_streaminfo(p, w.total, w.channels, w.sample_rate, w.bps);
  if (FSEEK64(w.f, 8, SEEK_SET) != 0) return false;
  if (fwrite(p, 1, sizeof(p), w.f) != sizeof(p)) return false;
  return fflush(w.f) == 0;
}

void wr_u32(FILE* f, uint32_t v) {
  uint8_t b[4] = {(uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                  (uint8_t)(v >> 24)};
  fwrite(b, 1, 4, f);
}
void wr_u16(FILE* f, uint16_t v) {
  uint8_t b[2] = {(uint8_t)v, (uint8_t)(v >> 8)};
  fwrite(b, 1, 2, f);
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// Streaming reader: random-access block reads without decoding whole files.
// WAV reads sample ranges directly; FLAC maps the container (mmap where
// available), indexes frame offsets once at open (one header+subframe walk,
// O(1) retained memory), then decodes only the frames a read touches.
// ---------------------------------------------------------------------------
struct StreamReader {
  FILE* file = nullptr;       // open for WAV streaming
  int64_t data_offset = 0;    // byte offset of sample data
  uint16_t fmt = 0;           // 1 = PCM, 3 = float
  uint16_t bits = 0;
  int sample_rate = 0;
  int channels = 0;
  int64_t frames = 0;
  AudioData decoded;          // used when streaming is not possible
  bool in_memory = false;

  // FLAC streaming state
  bool flac = false;
  const uint8_t* flac_data = nullptr;
  size_t flac_size = 0;
  bool flac_mapped = false;          // mmap vs owned buffer
  std::vector<uint8_t> flac_owned;   // fallback when mmap is unavailable
  FlacStreamInfo flac_info;
  struct FlacFrameIdx { int64_t sample; size_t offset; };
  std::vector<FlacFrameIdx> flac_index;  // frame starts (sample, byte)

  ~StreamReader();
};

StreamReader::~StreamReader() {
  if (file) fclose(file);
#if !defined(_WIN32)
  if (flac_mapped && flac_data) munmap((void*)flac_data, flac_size);
#endif
}

// Map (or read) the whole container and index every FLAC frame's byte
// offset + first sample by walking headers and subframes once (samples are
// decoded into a scratch and discarded — container bytes are the only
// retained state, and with mmap those stay on disk until touched).
bool open_flac_stream(const char* path, StreamReader& s) {
#if !defined(_WIN32)
  int fd = open(path, O_RDONLY);
  if (fd >= 0) {
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size > 4) {
      void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
      if (m != MAP_FAILED) {
        s.flac_data = (const uint8_t*)m;
        s.flac_size = (size_t)st.st_size;
        s.flac_mapped = true;
      }
    }
    close(fd);
  }
#endif
  if (!s.flac_data) {
    if (!read_whole_file(path, s.flac_owned)) return false;
    s.flac_data = s.flac_owned.data();
    s.flac_size = s.flac_owned.size();
  }
  size_t pos;
  if (!parse_flac_header(s.flac_data, s.flac_size, s.flac_info, pos)) {
#if !defined(_WIN32)
    if (s.flac_mapped) munmap((void*)s.flac_data, s.flac_size);
#endif
    s.flac_data = nullptr;
    s.flac_size = 0;
    s.flac_mapped = false;
    s.flac_owned.clear();
    s.flac_owned.shrink_to_fit();
    return false;
  }
  // frame-index sidecar: the index walk decodes every frame once; streamed
  // tools open a file several times (profile pass, engine pass), so cache
  // the index next to the file, keyed by the container size AND a
  // fingerprint of the header bytes (the first 256 bytes cover STREAMINFO
  // incl. the audio MD5, so a same-size replacement invalidates the cache)
  std::string idx_path = std::string(path) + ".flacidx";
  uint64_t fp = 1469598103934665603ull;  // FNV-1a over the header bytes
  {
    size_t n = s.flac_size < 256 ? s.flac_size : 256;
    for (size_t i = 0; i < n; ++i)
      fp = (fp ^ s.flac_data[i]) * 1099511628211ull;
  }
  int64_t total_from_cache = -1;
  {
    FILE* fi = fopen(idx_path.c_str(), "rb");
    if (fi) {
      uint64_t hdr[5];  // magic, container size, fingerprint, n, total
      if (fread(hdr, sizeof(uint64_t), 5, fi) == 5 &&
          hdr[0] == 0x464C414349445832ull && hdr[1] == (uint64_t)s.flac_size &&
          hdr[2] == fp && hdr[3] > 0 && hdr[3] < (1ull << 40)) {
        std::vector<uint64_t> raw(2 * hdr[3]);
        if (fread(raw.data(), sizeof(uint64_t), raw.size(), fi) == raw.size()) {
          s.flac_index.resize(hdr[3]);
          for (uint64_t i = 0; i < hdr[3]; ++i)
            s.flac_index[i] = {(int64_t)raw[2 * i], (size_t)raw[2 * i + 1]};
          total_from_cache = (int64_t)hdr[4];
        }
      }
      fclose(fi);
    }
  }
  int64_t sample = 0;
  if (total_from_cache >= 0) {
    sample = total_from_cache;
  } else {
    BitReader br(s.flac_data, s.flac_size);
    br.seek_byte(pos);
    std::vector<std::vector<int64_t>> chan(s.flac_info.channels);
    for (;;) {
      size_t frame_off = br.tell_byte();
      uint32_t block_size = 0;
      int rc = decode_flac_frame(br, s.flac_info, chan, block_size);
      if (rc == 0) break;
      if (rc < 0) {
        if (s.flac_index.empty()) return false;
        break;  // keep the valid prefix of a truncated file
      }
      s.flac_index.push_back({sample, frame_off});
      sample += block_size;
      if (s.flac_info.total_samples &&
          (uint64_t)sample >= s.flac_info.total_samples)
        break;
    }
    const char* no_idx = getenv("AUDIOIO_NO_IDX");
    bool idx_opt_out = no_idx && no_idx[0] && strcmp(no_idx, "0") != 0;
    if (!s.flac_index.empty() && !idx_opt_out) {
      // AUDIOIO_NO_IDX=1 opts out of sidecar writes entirely (e.g. when
      // reading from a directory that must stay pristine but happens to be
      // writable); read-only dirs skip the cache on their own (best-effort)
      FILE* fo = fopen(idx_path.c_str(), "wb");
      if (fo) {
        uint64_t hdr[5] = {0x464C414349445832ull, (uint64_t)s.flac_size, fp,
                           (uint64_t)s.flac_index.size(), (uint64_t)sample};
        std::vector<uint64_t> raw;
        raw.reserve(2 * s.flac_index.size());
        for (auto& e : s.flac_index) {
          raw.push_back((uint64_t)e.sample);
          raw.push_back((uint64_t)e.offset);
        }
        bool ok = fwrite(hdr, sizeof(uint64_t), 5, fo) == 5 &&
                  fwrite(raw.data(), sizeof(uint64_t), raw.size(), fo) ==
                      raw.size();
        fclose(fo);
        if (!ok) remove(idx_path.c_str());
      }
    }
  }
  if (s.flac_index.empty()) return false;
  s.flac = true;
  s.sample_rate = (int)s.flac_info.sample_rate;
  s.channels = (int)s.flac_info.channels;
  s.frames = sample;
  return true;
}

int flac_stream_read(StreamReader& s, int64_t start, int64_t count, float* out) {
  const double scale =
      1.0 / (double)(1u << (s.flac_info.bits_per_sample - 1));
  // first frame whose span can contain `start`
  size_t lo = 0, hi = s.flac_index.size();
  while (lo + 1 < hi) {
    size_t mid = (lo + hi) / 2;
    if (s.flac_index[mid].sample <= start)
      lo = mid;
    else
      hi = mid;
  }
  BitReader br(s.flac_data, s.flac_size);
  br.seek_byte(s.flac_index[lo].offset);
  int64_t sample = s.flac_index[lo].sample;
  std::vector<std::vector<int64_t>> chan(s.flac_info.channels);
  int64_t end = start + count;
  while (sample < end) {
    uint32_t block_size = 0;
    int rc = decode_flac_frame(br, s.flac_info, chan, block_size);
    if (rc <= 0) return -1;
    int64_t f0 = sample;
    int64_t f1 = sample + block_size;
    int64_t a = f0 > start ? f0 : start;
    int64_t b = f1 < end ? f1 : end;
    for (int64_t i = a; i < b; ++i)
      for (uint32_t c = 0; c < s.flac_info.channels; ++c)
        out[(size_t)(i - start) * s.channels + c] =
            (float)(chan[c][(size_t)(i - f0)] * scale);
    sample = f1;
  }
  return 0;
}

bool open_wav_stream(const char* path, StreamReader& s) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return false;
  }
  bool rf64 = memcmp(hdr, "RF64", 4) == 0 || memcmp(hdr, "BW64", 4) == 0;
  if (!rf64 && memcmp(hdr, "RIFF", 4) != 0) {
    fclose(f);
    return false;
  }
  uint64_t ds64_data = 0;
  uint8_t chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint64_t len = rd_u32(chunk + 4);
    if (memcmp(chunk, "ds64", 4) == 0 && len >= 16) {
      uint8_t body[16];
      if (fread(body, 1, 16, f) != 16) break;
      ds64_data = rd_u64(body + 8);
      FSEEK64(f, len - 16 + (len & 1), SEEK_CUR);
    } else if (memcmp(chunk, "fmt ", 4) == 0) {
      // Mirror decode_wav: a fmt chunk shorter than the 16 fixed bytes would
      // make body.data() null / under-sized for the field reads below.
      if (len < 16) {
        FSEEK64(f, len + (len & 1), SEEK_CUR);
        continue;
      }
      std::vector<uint8_t> body((size_t)len);
      if (fread(body.data(), 1, (size_t)len, f) != (size_t)len) break;
      s.fmt = rd_u16(body.data());
      s.channels = rd_u16(body.data() + 2);
      s.sample_rate = (int)rd_u32(body.data() + 4);
      s.bits = rd_u16(body.data() + 14);
      if (s.fmt == 0xFFFE && len >= 40) s.fmt = rd_u16(body.data() + 24);
      if (len & 1) FSEEK64(f, 1, SEEK_CUR);
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (len == 0xFFFFFFFFull && rf64) len = ds64_data;
      s.data_offset = FTELL64(f);
      size_t bytes_per = s.bits / 8;
      if (!bytes_per || !s.channels) break;
      // clamp to the bytes actually present (a truncated transfer or bogus
      // ds64 size must not promise unreadable frames)
      FSEEK64(f, 0, SEEK_END);
      int64_t fsz = FTELL64(f);
      FSEEK64(f, s.data_offset, SEEK_SET);
      if (fsz > s.data_offset && len > (uint64_t)(fsz - s.data_offset))
        len = (uint64_t)(fsz - s.data_offset);
      s.frames = (int64_t)(len / (bytes_per * s.channels));
      s.file = f;
      return true;
    } else {
      FSEEK64(f, len + (len & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return false;
}

int stream_read_block(StreamReader& s, int64_t start, int64_t count, float* out) {
  if (start < 0 || start + count > s.frames) return -1;
  if (s.flac) return flac_stream_read(s, start, count, out);
  if (s.in_memory) {
    size_t byte_off = (size_t)start * s.channels * sizeof(float);
    const uint8_t* base = s.decoded.view
                              ? s.decoded.view
                              : (const uint8_t*)s.decoded.samples.data();
    memcpy(out, base + byte_off, (size_t)count * s.channels * sizeof(float));
    return 0;
  }
  size_t bytes_per = s.bits / 8;
  size_t stride = bytes_per * s.channels;
  if (FSEEK64(s.file, s.data_offset + (int64_t)start * (int64_t)stride, SEEK_SET))
    return -1;
  std::vector<uint8_t> raw((size_t)count * stride);
  if (fread(raw.data(), 1, raw.size(), s.file) != raw.size()) return -1;
  size_t total = (size_t)count * s.channels;
  const uint8_t* data = raw.data();
  if (s.fmt == 3 && s.bits == 32) {
    memcpy(out, data, total * 4);
  } else if (s.fmt == 1 && s.bits == 16) {
    for (size_t i = 0; i < total; ++i)
      out[i] = (float)((int16_t)rd_u16(data + i * 2) / 32768.0);
  } else if (s.fmt == 1 && s.bits == 24) {
    for (size_t i = 0; i < total; ++i) {
      const uint8_t* p = data + i * 3;
      int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                            (uint32_t)p[2] << 24) >> 8;
      out[i] = (float)(v / 8388608.0);
    }
  } else if (s.fmt == 1 && s.bits == 32) {
    for (size_t i = 0; i < total; ++i)
      out[i] = (float)((int32_t)rd_u32(data + i * 4) / 2147483648.0);
  } else {
    return -2;
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// ---- streaming API --------------------------------------------------------
void* audioio_stream_open(const char* path) {
  StreamReader* s = new StreamReader();
  if (open_wav_stream(path, *s)) return s;
  if (open_flac_stream(path, *s)) return s;
  // fall back: decode fully (odd WAV layouts)
  if (decode_any(path, s->decoded)) {
    s->in_memory = true;
    s->sample_rate = s->decoded.sample_rate;
    s->channels = s->decoded.channels;
    s->frames = s->decoded.frames;
    return s;
  }
  delete s;
  return nullptr;
}

// Header-only probe: sample rate / channels / frames WITHOUT decoding or
// indexing (WAV chunk walk, or FLAC STREAMINFO).  Returns 0 on success.
// The auto-stream thresholds use this so "should this file stream?" costs
// a few KB of header reads, never a decode pass.
int audioio_probe(const char* path, int* sample_rate, int* channels,
                  long long* frames) {
  {
    StreamReader s;
    if (open_wav_stream(path, s)) {
      *sample_rate = s.sample_rate;
      *channels = s.channels;
      *frames = s.frames;
      return 0;
    }
  }
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // STREAMINFO is mandatory and FIRST (FLAC spec): marker + block header +
  // 34-byte payload = 46 bytes is all the probe needs
  uint8_t head[46];
  size_t got = fread(head, 1, sizeof(head), f);
  fclose(f);
  if (got == sizeof(head) && memcmp(head, "fLaC", 4) == 0 &&
      (head[4] & 0x7Fu) == 0) {
    const uint8_t* p = head + 8;
    uint32_t sr = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) | (p[12] >> 4);
    if (sr) {
      *sample_rate = (int)sr;
      *channels = (int)(((p[12] >> 1) & 0x7u) + 1);
      *frames = (long long)(((uint64_t)(p[13] & 0x0Fu) << 32) |
                            ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                            ((uint64_t)p[16] << 8) | p[17]);
      return 0;
    }
  }
  return -1;
}

int audioio_stream_sample_rate(void* h) { return ((StreamReader*)h)->sample_rate; }
int audioio_stream_channels(void* h) { return ((StreamReader*)h)->channels; }
long long audioio_stream_frames(void* h) { return ((StreamReader*)h)->frames; }

int audioio_stream_read(void* h, long long start, long long count, float* out) {
  return stream_read_block(*(StreamReader*)h, start, count, out);
}

void audioio_stream_close(void* h) { delete (StreamReader*)h; }

// Opens and fully decodes the file; returns an opaque handle (or null).
void* audioio_open(const char* path) {
  AudioData* d = new AudioData();
  if (!decode_any(path, *d)) {
    delete d;
    return nullptr;
  }
  return d;
}

int audioio_sample_rate(void* h) { return ((AudioData*)h)->sample_rate; }
int audioio_channels(void* h) { return ((AudioData*)h)->channels; }
long long audioio_frames(void* h) { return ((AudioData*)h)->frames; }

// Copies interleaved float32 samples into out (frames*channels floats).
int audioio_read(void* h, float* out) {
  AudioData* d = (AudioData*)h;
  size_t bytes = (size_t)(d->frames * d->channels) * sizeof(float);
  memcpy(out, d->view ? (const void*)d->view : (const void*)d->samples.data(),
         bytes);
  return 0;
}

void audioio_close(void* h) { delete (AudioData*)h; }

// Writes a FLAC file from interleaved float samples quantized to
// ``bits_per_sample`` (16 or 24).  ``level`` trades compression for codec
// speed like the reference flac tool's -0/-8 presets: 0 = fixed predictors
// only (~2.5x faster DECODE and ~20% faster encode, measured; the decoder's
// serial order-8 LPC apply is its hot loop), 1 = +order-8 LPC candidate
// (default, best compression).  Returns 0 on success.
int audioio_write_flac(const char* path, const float* data, long long frames,
                       int channels, int sample_rate, int bits_per_sample,
                       int level) {
  if (bits_per_sample != 16 && bits_per_sample != 24) return -2;
  if (channels < 1 || channels > 8 || frames <= 0) return -2;
  if (level < 0 || level > 1) return -2;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  bool ok = encode_flac(f, data, frames, channels, sample_rate,
                        bits_per_sample, level);
  fclose(f);
  if (!ok) remove(path);
  return ok ? 0 : -1;
}

// Opens an incremental FLAC writer (frame count patched on close).
void* audioio_flac_wopen(const char* path, int channels, int sample_rate,
                         int bits_per_sample, int level) {
  if (bits_per_sample != 16 && bits_per_sample != 24) return nullptr;
  if (channels < 1 || channels > 8 || sample_rate <= 0) return nullptr;
  if (level < 0 || level > 1) return nullptr;
  FILE* f = fopen(path, "wb+");
  if (!f) return nullptr;
  uint8_t si[4 + 4 + 34] = {'f', 'L', 'a', 'C', 0x80, 0, 0, 34};
  fill_flac_streaminfo(si + 8, 0, channels, sample_rate, bits_per_sample);
  if (fwrite(si, 1, sizeof(si), f) != sizeof(si)) {
    fclose(f);
    remove(path);
    return nullptr;
  }
  FlacStreamWriter* w = new FlacStreamWriter;
  w->f = f;
  w->channels = channels;
  w->sample_rate = sample_rate;
  w->bps = bits_per_sample;
  w->level = level;
  return w;
}

// Appends interleaved float frames.  Returns 0 on success.
int audioio_flac_wwrite(void* h, const float* data, long long frames) {
  FlacStreamWriter* w = (FlacStreamWriter*)h;
  return flac_stream_write(*w, data, frames) ? 0 : -1;
}

// Flushes the carry block, patches STREAMINFO, closes and frees.  Returns 0
// on success (the file is removed on failure so a broken stream never looks
// like a finished archive).
int audioio_flac_wclose(void* h) {
  FlacStreamWriter* w = (FlacStreamWriter*)h;
  bool ok = flac_stream_finish(*w);
  fclose(w->f);
  delete w;
  return ok ? 0 : -1;
}

// Writes an IEEE float32 WAV file from interleaved samples.
int audioio_write_wav_f32(const char* path, const float* data, long long frames,
                          int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(frames * channels * 4);
  fwrite("RIFF", 1, 4, f);
  // 4 (WAVE) + 24 (fmt) + 12 (fact) + 8 (data hdr) + payload
  wr_u32(f, 48 + data_bytes);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  wr_u32(f, 16);
  wr_u16(f, 3);  // IEEE float
  wr_u16(f, (uint16_t)channels);
  wr_u32(f, (uint32_t)sample_rate);
  wr_u32(f, (uint32_t)(sample_rate * channels * 4));
  wr_u16(f, (uint16_t)(channels * 4));
  wr_u16(f, 32);
  // non-PCM formats require a fact chunk (dwSampleLength)
  fwrite("fact", 1, 4, f);
  wr_u32(f, 4);
  wr_u32(f, (uint32_t)frames);
  fwrite("data", 1, 4, f);
  wr_u32(f, data_bytes);
  size_t written = fwrite(data, 4, (size_t)frames * channels, f);
  fclose(f);
  return written == (size_t)(frames * channels) ? 0 : -1;
}

// Writes a PCM16 WAV file from interleaved float samples (clipped).
int audioio_write_wav_pcm16(const char* path, const float* data,
                            long long frames, int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(frames * channels * 2);
  fwrite("RIFF", 1, 4, f);
  wr_u32(f, 36 + data_bytes);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  wr_u32(f, 16);
  wr_u16(f, 1);
  wr_u16(f, (uint16_t)channels);
  wr_u32(f, (uint32_t)sample_rate);
  wr_u32(f, (uint32_t)(sample_rate * channels * 2));
  wr_u16(f, (uint16_t)(channels * 2));
  wr_u16(f, 16);
  fwrite("data", 1, 4, f);
  wr_u32(f, data_bytes);
  for (long long i = 0; i < frames * channels; ++i) {
    float v = data[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    int16_t s = (int16_t)(v * 32767.0f);
    uint8_t b[2] = {(uint8_t)(uint16_t)s, (uint8_t)((uint16_t)s >> 8)};
    fwrite(b, 1, 2, f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
