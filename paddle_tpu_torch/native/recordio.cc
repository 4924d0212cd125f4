// RecordIO: chunked, CRC-checked, optionally compressed record container.
//
// Reference parity: paddle/fluid/recordio/{header,chunk,writer,scanner}.cc
// (~688 LoC) — chunked layout for fault-tolerant appends and seekable
// parallel scans (recordio/README.md). This is a fresh implementation with
// a C ABI so Python binds via ctypes (no pybind11 in this build).
//
// File layout: a sequence of chunks.
//   chunk := magic "RIOC" | u32 n_records | u32 codec (0 none, 1 zlib)
//          | u64 raw_len | u64 stored_len | u32 crc32(stored bytes)
//          | stored bytes
//   raw bytes := n_records x (u32 len | payload)
// All integers little-endian. A torn final chunk (bad magic/short read/CRC
// mismatch/implausible length) terminates the scan cleanly — earlier chunks
// stay readable, which is the fault-tolerant-append property the reference
// documents.
//
// NOTE: only the *API* is reference parity. The on-disk layout is NOT the
// reference's (magic 0x01020304, {num_records, checksum, compressor,
// compress_size} header, snappy/gzip codecs) — files are not interchangeable
// between the two toolchains.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x434f4952;  // "RIOC" little-endian
constexpr uint32_t kCodecNone = 0;
constexpr uint32_t kCodecZlib = 1;

struct Writer {
  FILE* f = nullptr;
  uint32_t codec = kCodecZlib;
  uint32_t max_records = 1000;
  size_t max_bytes = 1 << 20;
  std::vector<std::string> pending;
  size_t pending_bytes = 0;
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<std::string> chunk;  // decoded records of current chunk
  size_t pos = 0;                  // next record index in chunk
};

bool write_chunk(Writer* w) {
  if (w->pending.empty()) return true;
  std::string raw;
  raw.reserve(w->pending_bytes + 4 * w->pending.size());
  for (const auto& r : w->pending) {
    uint32_t len = static_cast<uint32_t>(r.size());
    raw.append(reinterpret_cast<const char*>(&len), 4);
    raw.append(r);
  }
  std::string stored;
  uint32_t codec = w->codec;
  if (codec == kCodecZlib) {
    uLongf bound = compressBound(raw.size());
    stored.resize(bound);
    if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &bound,
                  reinterpret_cast<const Bytef*>(raw.data()), raw.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
      return false;
    }
    stored.resize(bound);
  } else {
    stored = raw;
  }
  uint32_t n = static_cast<uint32_t>(w->pending.size());
  uint64_t raw_len = raw.size(), stored_len = stored.size();
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                       stored.size());
  if (fwrite(&kMagic, 4, 1, w->f) != 1) return false;
  if (fwrite(&n, 4, 1, w->f) != 1) return false;
  if (fwrite(&codec, 4, 1, w->f) != 1) return false;
  if (fwrite(&raw_len, 8, 1, w->f) != 1) return false;
  if (fwrite(&stored_len, 8, 1, w->f) != 1) return false;
  if (fwrite(&crc, 4, 1, w->f) != 1) return false;
  if (stored_len &&
      fwrite(stored.data(), stored.size(), 1, w->f) != 1) return false;
  fflush(w->f);
  w->pending.clear();
  w->pending_bytes = 0;
  return true;
}

// Cap on a single decoded chunk: headers claiming more than this are treated
// as corruption, not honored with a giant allocation that could abort the
// embedding process via bad_alloc across the C ABI.
constexpr uint64_t kMaxChunkBytes = 1ull << 30;

bool read_chunk(Scanner* s) try {
  uint32_t magic = 0, n = 0, codec = 0, crc = 0;
  uint64_t raw_len = 0, stored_len = 0;
  if (fread(&magic, 4, 1, s->f) != 1 || magic != kMagic) return false;
  if (fread(&n, 4, 1, s->f) != 1) return false;
  if (fread(&codec, 4, 1, s->f) != 1) return false;
  if (fread(&raw_len, 8, 1, s->f) != 1) return false;
  if (fread(&stored_len, 8, 1, s->f) != 1) return false;
  if (fread(&crc, 4, 1, s->f) != 1) return false;
  if (raw_len > kMaxChunkBytes || stored_len > kMaxChunkBytes) return false;
  // A stored_len larger than the bytes left in the file is a torn/corrupt
  // header; reject before allocating.
  long cur = ftell(s->f);
  if (cur >= 0 && fseek(s->f, 0, SEEK_END) == 0) {
    long end = ftell(s->f);
    if (fseek(s->f, cur, SEEK_SET) != 0) return false;
    if (end >= 0 && stored_len > static_cast<uint64_t>(end - cur)) {
      return false;
    }
  }
  std::string stored(stored_len, '\0');
  if (stored_len &&
      fread(&stored[0], stored_len, 1, s->f) != 1) return false;
  if (crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
            stored.size()) != crc) return false;
  std::string raw;
  if (codec == kCodecZlib) {
    raw.resize(raw_len);
    uLongf got = raw_len;
    if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &got,
                   reinterpret_cast<const Bytef*>(stored.data()),
                   stored.size()) != Z_OK || got != raw_len) {
      return false;
    }
  } else {
    raw = std::move(stored);
  }
  s->chunk.clear();
  s->pos = 0;
  size_t off = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + 4 > raw.size()) return false;
    uint32_t len;
    memcpy(&len, raw.data() + off, 4);
    off += 4;
    if (off + len > raw.size()) return false;
    s->chunk.emplace_back(raw.data() + off, len);
    off += len;
  }
  return true;
} catch (...) {
  // Corruption-triggered allocation/decode failure must end the scan, not
  // propagate across the extern "C" boundary and abort the process.
  return false;
}

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, int codec, int max_records) {
  FILE* f = fopen(path, "ab");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->codec = codec ? kCodecZlib : kCodecNone;
  if (max_records > 0) w->max_records = max_records;
  return w;
}

int rio_writer_write(void* wp, const char* buf, uint64_t len) {
  auto* w = static_cast<Writer*>(wp);
  // Writer enforces the same chunk bound the scanner trusts (kMaxChunkBytes):
  // a record that cannot fit in one chunk is an error here, not silent data
  // loss at read time; a record that would overflow the pending chunk
  // flushes first.
  uint64_t framed = len + 4;
  if (framed + 4 * (w->pending.size() + 1) + w->pending_bytes >
      kMaxChunkBytes) {
    if (w->pending.empty()) return -1;  // single record exceeds the format cap
    if (!write_chunk(w)) return -1;
    if (framed + 4 > kMaxChunkBytes) return -1;
  }
  w->pending.emplace_back(buf, len);
  w->pending_bytes += len;
  if (w->pending.size() >= w->max_records ||
      w->pending_bytes >= w->max_bytes) {
    return write_chunk(w) ? 0 : -1;
  }
  return 0;
}

int rio_writer_flush(void* wp) {
  return write_chunk(static_cast<Writer*>(wp)) ? 0 : -1;
}

void rio_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  write_chunk(w);
  fclose(w->f);
  delete w;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner();
  s->f = f;
  return s;
}

// Returns 1 and sets (*buf,*len) when a record is available; caller must
// rio_free(*buf). Returns 0 at end of stream (or first corrupt chunk).
int rio_scanner_next(void* sp, char** buf, uint64_t* len) {
  auto* s = static_cast<Scanner*>(sp);
  while (s->pos >= s->chunk.size()) {
    if (!read_chunk(s)) return 0;
  }
  const std::string& r = s->chunk[s->pos++];
  *buf = static_cast<char*>(malloc(r.size()));
  memcpy(*buf, r.data(), r.size());
  *len = r.size();
  return 1;
}

// Batch read: up to max_records records from the CURRENT chunk in one call
// (one malloc + one ctypes crossing instead of per-record round-trips).
// *buf receives the concatenated payloads, *lens the per-record lengths;
// the caller frees both via rio_free. May return fewer than requested at a
// chunk boundary; 0 at end of stream (or first corrupt chunk).
int rio_scanner_next_batch(void* sp, int max_records, char** buf,
                           uint64_t** lens) {
  auto* s = static_cast<Scanner*>(sp);
  if (max_records <= 0) return 0;
  while (s->pos >= s->chunk.size()) {
    if (!read_chunk(s)) return 0;
  }
  size_t n = s->chunk.size() - s->pos;
  if (n > static_cast<size_t>(max_records)) n = max_records;
  size_t total = 0;
  for (size_t i = 0; i < n; ++i) total += s->chunk[s->pos + i].size();
  *buf = static_cast<char*>(malloc(total ? total : 1));
  *lens = static_cast<uint64_t*>(malloc(n * sizeof(uint64_t)));
  if (!*buf || !*lens) {
    free(*buf);
    free(*lens);
    return 0;
  }
  size_t off = 0;
  for (size_t i = 0; i < n; ++i) {
    const std::string& r = s->chunk[s->pos + i];
    memcpy(*buf + off, r.data(), r.size());
    (*lens)[i] = r.size();
    off += r.size();
  }
  s->pos += n;
  return static_cast<int>(n);
}

// Skip up to n records; whole chunks are fseek'd past WITHOUT reading or
// decompressing their payload (the seekable-shard fast path: a 1-of-N
// stride shard decodes only the chunks it owns records in). Returns the
// number actually skipped (< n only at end of stream). Note: a chunk
// skipped wholesale is not CRC-verified — corruption there surfaces when
// some scanner actually reads it.
uint64_t rio_scanner_skip(void* sp, uint64_t n) {
  auto* s = static_cast<Scanner*>(sp);
  uint64_t skipped = 0;
  while (skipped < n) {
    if (s->pos < s->chunk.size()) {
      uint64_t avail = s->chunk.size() - s->pos;
      uint64_t take = n - skipped < avail ? n - skipped : avail;
      s->pos += take;
      skipped += take;
      continue;
    }
    // peek the next chunk header; if every record in it is skipped, seek
    // past the stored payload undecoded
    long hdr = ftell(s->f);
    uint32_t magic = 0, cn = 0, codec = 0, crc = 0;
    uint64_t raw_len = 0, stored_len = 0;
    bool ok = fread(&magic, 4, 1, s->f) == 1 && magic == kMagic &&
              fread(&cn, 4, 1, s->f) == 1 &&
              fread(&codec, 4, 1, s->f) == 1 &&
              fread(&raw_len, 8, 1, s->f) == 1 &&
              fread(&stored_len, 8, 1, s->f) == 1 &&
              fread(&crc, 4, 1, s->f) == 1 &&
              raw_len <= kMaxChunkBytes && stored_len <= kMaxChunkBytes;
    if (!ok) {
      if (hdr >= 0) fseek(s->f, hdr, SEEK_SET);
      return skipped;
    }
    if (cn <= n - skipped) {
      if (fseek(s->f, static_cast<long>(stored_len), SEEK_CUR) != 0) {
        return skipped;
      }
      skipped += cn;
      continue;
    }
    // partially-skipped chunk: rewind and decode it normally
    if (fseek(s->f, hdr, SEEK_SET) != 0) return skipped;
    if (!read_chunk(s)) return skipped;
  }
  return skipped;
}

void rio_scanner_reset(void* sp) {
  auto* s = static_cast<Scanner*>(sp);
  fseek(s->f, 0, SEEK_SET);
  s->chunk.clear();
  s->pos = 0;
}

void rio_scanner_close(void* sp) {
  auto* s = static_cast<Scanner*>(sp);
  fclose(s->f);
  delete s;
}

void rio_free(char* buf) { free(buf); }

}  // extern "C"
