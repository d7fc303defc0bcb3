// Native "shorten" v1/v2 bitstream decoder for NIST SPHERE audio.
//
// C++ port of the Python decoder in speech_tpu_torch/io/sphere.py (the
// always-available fallback and correctness oracle); the per-sample
// bit-reading loop is the hot path that Python cannot run fast.  Decodes a
// whole in-memory compressed payload in one call.  The reference
// implementation is a Python port of sph2pipe
// (reference: src/pydrobert/speech/_sphere.py:122-317); this file is
// written from our own Python decoder, not from either of those.
//
// Build: g++ -O2 -shared -fPIC -o _shorten.so shorten.cpp
// API: extern "C" stpu_decode_shorten (see below).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int FN_DIFF0 = 0, FN_DIFF1 = 1, FN_DIFF2 = 2, FN_DIFF3 = 3;
constexpr int FN_QUIT = 4, FN_BLOCKSIZE = 5, FN_BITSHIFT = 6, FN_QLPC = 7,
              FN_ZERO = 8;
constexpr int TYPE_AU1 = 0, TYPE_U8 = 2, TYPE_S16HL = 3, TYPE_U16HL = 4,
              TYPE_S16LH = 5, TYPE_U16LH = 6, TYPE_AU2 = 8;
constexpr int ULONGSIZE = 2, FNSIZE = 2, ENERGYSIZE = 3, BITSHIFTSIZE = 2;
constexpr int LPCQSIZE = 2, LPCQUANT = 5, XBYTESIZE = 7, NWRAP = 3;
constexpr int MAX_SUPPORTED_VERSION = 2;
constexpr int NEGATIVE_ULAW_ZERO = 0x7F;

struct BitReader {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  uint32_t word = 0;
  int avail = 0;
  bool overrun = false;

  BitReader(const uint8_t* b, size_t l) : buf(b), len(l) {}

  void next_word() {
    if (pos + 4 > len) {
      overrun = true;
      word = 0;
      avail = 32;
      return;
    }
    word = (uint32_t(buf[pos]) << 24) | (uint32_t(buf[pos + 1]) << 16) |
           (uint32_t(buf[pos + 2]) << 8) | uint32_t(buf[pos + 3]);
    pos += 4;
    avail = 32;
  }

  // Rice-style code: unary high part then nbits literal low bits.
  int64_t uvar(int nbits) {
    int64_t result = 0;
    for (;;) {
      if (!avail) next_word();
      if (overrun) return -1;
      --avail;
      if (word & (uint32_t(1) << avail)) break;
      ++result;
    }
    int64_t low = 0;
    int n = nbits;
    while (n) {
      if (!avail) next_word();
      if (overrun) return -1;
      int take = n < avail ? n : avail;
      avail -= take;
      low = (low << take) | ((word >> avail) & ((uint64_t(1) << take) - 1));
      n -= take;
    }
    return (result << nbits) | low;
  }

  int64_t ulong_() {
    int64_t nbit = uvar(ULONGSIZE);
    if (nbit < 0 || nbit > 31) {
      overrun = true;
      return -1;
    }
    return uvar(int(nbit));
  }

  int64_t var_(int nbits) {
    int64_t u = uvar(nbits + 1);
    return (u & 1) ? ~(u >> 1) : (u >> 1);
  }
};

inline int64_t trunc_div(int64_t a, int64_t b) {
  return a / b;  // C++ division truncates toward zero
}

}  // namespace

// Decode a shorten payload (starting at the "ajkg" magic) into `out`
// (interleaved int32 samples, post bitshift-fixup; the caller applies any
// u-law -> PCM table afterwards).  Returns per-channel samples decoded, or
// a negative error code: -1 truncated stream, -2 unsupported version,
// -3 bad file type, -4 bad command, -5 output/channel mismatch.
extern "C" long long stpu_decode_shorten(
    const uint8_t* payload, size_t payload_len, int32_t* out, size_t out_len,
    const uint8_t* ulaw_outward /* [13][256] */, int* ftype_out) {
  if (payload_len < 5 || std::memcmp(payload, "ajkg", 4) != 0) return -3;
  int version = payload[4];
  if (version > MAX_SUPPORTED_VERSION) return -2;
  BitReader bits(payload + 5, payload_len - 5);

  int64_t ftype = bits.ulong_();
  if (ftype < 0 || ftype >= 9) return -3;
  if (ftype_out) *ftype_out = int(ftype);
  int64_t nchan = bits.ulong_();
  int64_t blocksize = bits.ulong_();
  int64_t maxnlpc = bits.ulong_();
  int64_t nmean = bits.ulong_();
  int64_t nskip = bits.ulong_();
  if (bits.overrun || nchan <= 0 || blocksize <= 0 || maxnlpc < 0 ||
      nmean < 0 || nskip < 0)
    return -1;
  // Header values that look valid but exceed this decoder's working limits:
  // signal "unsupported by native" (-6) so the caller can fall back to the
  // pure-Python decoder instead of hard-failing on an unusual-but-valid file.
  if (nchan > 16 || blocksize > (1 << 20) || maxnlpc > 1024 || nmean > 65536)
    return -6;
  for (int64_t i = 0; i < nskip; ++i) bits.uvar(XBYTESIZE);

  const int64_t nwrap = maxnlpc > NWRAP ? maxnlpc : NWRAP;
  std::vector<int64_t> history(size_t(nchan * nwrap), 0);

  int64_t mean;
  switch (ftype) {
    case TYPE_U8:
      mean = 0x8;  // sph2pipe quirk (not 0x80)
      break;
    case TYPE_U16HL:
    case TYPE_U16LH:
      mean = 0x8000;
      break;
    default:
      mean = 0;
  }
  const int64_t nblock = nmean > 1 ? nmean : 1;
  std::vector<int64_t> offsets(size_t(nchan * nblock), mean);

  int bitshift = 0;
  const int64_t lpcqoffset = version > 1 ? (int64_t(1) << LPCQUANT) : 0;
  int64_t sampsdone = 0;
  size_t write_pos = 0;
  int64_t chan = 0;
  std::vector<int64_t> block(size_t(blocksize), 0);
  std::vector<int64_t> pending(size_t(nchan * blocksize), 0);
  std::vector<int64_t> qlpc;
  std::vector<int64_t> ext;

  for (;;) {
    int64_t cmd = bits.uvar(FNSIZE);
    if (bits.overrun) return -1;
    if (cmd == FN_QUIT) break;
    if (cmd == FN_BLOCKSIZE) {
      int64_t nb = bits.ulong_();
      if (nb <= 0 || nb > (1 << 20) || bits.overrun) return -1;
      if (nb != blocksize) {
        blocksize = nb;
        block.assign(size_t(blocksize), 0);
        pending.assign(size_t(nchan * blocksize), 0);
      }
      continue;
    }
    if (cmd == FN_BITSHIFT) {
      int64_t bs = bits.uvar(BITSHIFTSIZE);
      if (bs < 0 || bs > 31 || bits.overrun) return -1;
      // The u-law fixup indexes ulaw_outward[bitshift], a 13x256 table; a
      // stream declaring bitshift > 12 for an AU type would read out of
      // bounds (the Python decoder raises on the same input).
      if ((ftype == TYPE_AU1 || ftype == TYPE_AU2) && bs > 12) return -4;
      bitshift = int(bs);
      continue;
    }
    if (cmd != FN_ZERO && cmd != FN_DIFF0 && cmd != FN_DIFF1 &&
        cmd != FN_DIFF2 && cmd != FN_DIFF3 && cmd != FN_QLPC)
      return -4;

    int resn = 0;
    if (cmd != FN_ZERO) {
      int64_t r = bits.uvar(ENERGYSIZE);
      if (r < 0 || r > 31 || bits.overrun) return -1;
      resn = int(r);
    }

    int64_t* off = &offsets[size_t(chan * nblock)];
    int64_t coffset;
    if (nmean) {
      int64_t total = version < 2 ? 0 : nmean / 2;
      for (int64_t i = 0; i < nmean; ++i) total += off[i];
      coffset = trunc_div(total, nmean);
      if (version >= 2) coffset >>= bitshift;
    } else {
      coffset = off[0];
    }

    int64_t* hist = &history[size_t(chan * nwrap)];
    if (cmd == FN_ZERO) {
      std::fill(block.begin(), block.end(), int64_t(0));
    } else if (cmd == FN_DIFF0) {
      for (int64_t i = 0; i < blocksize; ++i)
        block[size_t(i)] = bits.var_(resn) + coffset;
    } else if (cmd == FN_DIFF1) {
      int64_t prev = hist[nwrap - 1];
      for (int64_t i = 0; i < blocksize; ++i) {
        prev = bits.var_(resn) + prev;
        block[size_t(i)] = prev;
      }
    } else if (cmd == FN_DIFF2) {
      int64_t p1 = hist[nwrap - 1], p2 = hist[nwrap - 2];
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t cur = bits.var_(resn) + 2 * p1 - p2;
        block[size_t(i)] = cur;
        p2 = p1;
        p1 = cur;
      }
    } else if (cmd == FN_DIFF3) {
      int64_t p1 = hist[nwrap - 1], p2 = hist[nwrap - 2],
              p3 = hist[nwrap - 3];
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t cur = bits.var_(resn) + 3 * (p1 - p2) + p3;
        block[size_t(i)] = cur;
        p3 = p2;
        p2 = p1;
        p1 = cur;
      }
    } else {  // FN_QLPC
      int64_t nlpc = bits.uvar(LPCQSIZE);
      if (nlpc < 0 || nlpc > nwrap || bits.overrun) return -1;
      qlpc.assign(size_t(nlpc), 0);
      for (int64_t j = 0; j < nlpc; ++j) qlpc[size_t(j)] = bits.var_(LPCQUANT);
      ext.assign(size_t(nlpc + blocksize), 0);
      for (int64_t j = 0; j < nlpc; ++j)
        ext[size_t(j)] = hist[nwrap - nlpc + j] - coffset;
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t acc = lpcqoffset;
        for (int64_t j = 0; j < nlpc; ++j)
          acc += qlpc[size_t(j)] * ext[size_t(nlpc + i - j - 1)];
        ext[size_t(nlpc + i)] = bits.var_(resn) + (acc >> LPCQUANT);
      }
      for (int64_t i = 0; i < blocksize; ++i) {
        block[size_t(i)] = ext[size_t(nlpc + i)];
        if (coffset) block[size_t(i)] += coffset;
      }
    }
    if (bits.overrun) return -1;

    if (nmean > 0) {
      int64_t total = version < 2 ? 0 : blocksize / 2;
      for (int64_t i = 0; i < blocksize; ++i) total += block[size_t(i)];
      for (int64_t i = 0; i + 1 < nmean; ++i) off[i] = off[i + 1];
      off[nmean - 1] = trunc_div(total, blocksize);
      if (version >= 2) off[nmean - 1] <<= bitshift;
    }

    // wrap history for the next block's predictors
    if (nwrap <= blocksize) {
      for (int64_t i = 0; i < nwrap; ++i)
        hist[i] = block[size_t(blocksize - nwrap + i)];
    } else {
      for (int64_t i = 0; i < nwrap - blocksize; ++i) hist[i] = hist[i + blocksize];
      for (int64_t i = 0; i < blocksize; ++i)
        hist[nwrap - blocksize + i] = block[size_t(i)];
    }

    // bitshift fix-up into the pending (emit) buffer
    int64_t* pend = &pending[size_t(chan * blocksize)];
    if (ftype == TYPE_AU1) {
      const uint8_t* row = ulaw_outward + size_t(bitshift) * 256;
      for (int64_t i = 0; i < blocksize; ++i)
        pend[i] = row[(block[size_t(i)] + 128) & 0xFF];
    } else if (ftype == TYPE_AU2) {
      const uint8_t* row = ulaw_outward + size_t(bitshift) * 256;
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t v = block[size_t(i)];
        if (v >= 0)
          pend[i] = row[(v < 127 ? v : 127) + 128];
        else if (v == -1)
          pend[i] = NEGATIVE_ULAW_ZERO;
        else
          pend[i] = row[((v > -129 ? v : -129) + 129)];
      }
    } else if (bitshift) {
      for (int64_t i = 0; i < blocksize; ++i)
        pend[i] = block[size_t(i)] << bitshift;
    } else {
      std::memcpy(pend, block.data(), size_t(blocksize) * sizeof(int64_t));
    }

    if (chan == nchan - 1) {
      // interleave all channels' pending blocks into the output
      size_t nitem = size_t(blocksize * nchan);
      if (write_pos + nitem > out_len)
        nitem = out_len > write_pos ? out_len - write_pos : 0;
      for (size_t k = 0; k < nitem; ++k) {
        size_t samp = k / size_t(nchan), ch = k % size_t(nchan);
        out[write_pos + k] =
            int32_t(pending[ch * size_t(blocksize) + samp]);
      }
      write_pos += nitem;
      sampsdone += blocksize;
    }
    chan = (chan + 1) % nchan;
  }
  return sampsdone;
}
