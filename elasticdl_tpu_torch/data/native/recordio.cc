// EDLR: a chunked, indexed, checksummed record file format + C API.
//
// Reference parity: the reference's training data lives in RecordIO files
// read through the external C++ `pyrecordio` library, whose (file, offset,
// count) spans define tasks (SURVEY §2.4, §2.7 item 3). This is a fresh
// format and implementation with the same role: sharded binary records,
// O(1) seek to any record index via a trailing chunk index, per-chunk CRC.
//
// Layout (all integers little-endian):
//   file   := "EDLR" u32(version=1) chunk* index footer
//   chunk  := "CHNK" u32(num_records) u64(payload_len) u32(crc32(payload))
//             payload
//   payload:= { u32(record_len) bytes }*
//   index  := "INDX" u32(num_chunks) { u64(chunk_off) u64(first_record) }*
//   footer := u64(index_off) "EDLR"
//
// Build: g++ -O2 -shared -fPIC recordio.cc -o libedlrecordio.so
// (no external deps; crc32 implemented inline).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kFileMagic[4] = {'E', 'D', 'L', 'R'};
constexpr char kChunkMagic[4] = {'C', 'H', 'N', 'K'};
constexpr char kIndexMagic[4] = {'I', 'N', 'D', 'X'};
constexpr uint32_t kVersion = 1;

uint32_t crc32_table[256];
bool crc32_init_done = false;

void crc32_init() {
  if (crc32_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_init_done = true;
}

uint32_t crc32(const uint8_t* data, size_t n) {
  crc32_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct ChunkIndexEntry {
  uint64_t offset;        // file offset of the chunk header
  uint64_t first_record;  // global index of the chunk's first record
};

struct Reader {
  FILE* f = nullptr;
  std::vector<ChunkIndexEntry> index;
  uint64_t num_records = 0;
  std::string error;
  // chunk cache
  int64_t cached_chunk = -1;
  std::vector<uint8_t> payload;
  std::vector<std::pair<uint32_t, uint32_t>> record_spans;  // (off, len)
  // read() output buffer
  std::vector<uint8_t> out;
};

struct Writer {
  FILE* f = nullptr;
  std::vector<ChunkIndexEntry> index;
  std::vector<uint8_t> payload;
  uint32_t chunk_records = 0;
  uint64_t total_records = 0;
  uint64_t chunk_target_bytes = 1 << 20;
  std::string error;
};

template <typename T>
bool read_pod(FILE* f, T* v) {
  return fread(v, sizeof(T), 1, f) == 1;
}

template <typename T>
bool write_pod(FILE* f, const T& v) {
  return fwrite(&v, sizeof(T), 1, f) == 1;
}

bool load_chunk(Reader* r, size_t chunk_i) {
  if ((int64_t)chunk_i == r->cached_chunk) return true;
  // The payload buffer is overwritten below; until the new chunk fully
  // validates, the cache must not claim to hold any chunk, or a failed load
  // would leave a stale cache serving the wrong bytes on a later fast-path hit.
  r->cached_chunk = -1;
  const ChunkIndexEntry& e = r->index[chunk_i];
  if (fseek(r->f, (long)e.offset, SEEK_SET) != 0) {
    r->error = "seek failed";
    return false;
  }
  char magic[4];
  uint32_t num_records, crc;
  uint64_t payload_len;
  if (fread(magic, 4, 1, r->f) != 1 || memcmp(magic, kChunkMagic, 4) != 0) {
    r->error = "bad chunk magic";
    return false;
  }
  if (!read_pod(r->f, &num_records) || !read_pod(r->f, &payload_len) ||
      !read_pod(r->f, &crc)) {
    r->error = "truncated chunk header";
    return false;
  }
  r->payload.resize(payload_len);
  if (payload_len && fread(r->payload.data(), 1, payload_len, r->f) != payload_len) {
    r->error = "truncated chunk payload";
    return false;
  }
  if (crc32(r->payload.data(), payload_len) != crc) {
    r->error = "chunk crc mismatch";
    return false;
  }
  r->record_spans.clear();
  r->record_spans.reserve(num_records);
  size_t off = 0;
  for (uint32_t i = 0; i < num_records; ++i) {
    if (off + 4 > payload_len) {
      r->error = "corrupt record framing";
      return false;
    }
    uint32_t len;
    memcpy(&len, r->payload.data() + off, 4);
    off += 4;
    if (off + len > payload_len) {
      r->error = "corrupt record length";
      return false;
    }
    r->record_spans.emplace_back((uint32_t)off, len);
    off += len;
  }
  r->cached_chunk = (int64_t)chunk_i;
  return true;
}

}  // namespace

extern "C" {

// ------------------------------ reader ------------------------------ //

void* edlr_reader_open(const char* path) {
  Reader* r = new Reader();
  r->f = fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  char magic[4];
  uint32_t version;
  if (fread(magic, 4, 1, r->f) != 1 || memcmp(magic, kFileMagic, 4) != 0 ||
      !read_pod(r->f, &version) || version != kVersion) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  // footer: last 12 bytes = u64 index_off + magic
  if (fseek(r->f, -12, SEEK_END) != 0) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  uint64_t index_off;
  char tail[4];
  if (!read_pod(r->f, &index_off) || fread(tail, 4, 1, r->f) != 1 ||
      memcmp(tail, kFileMagic, 4) != 0 ||
      fseek(r->f, (long)index_off, SEEK_SET) != 0) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  char imagic[4];
  uint32_t num_chunks;
  if (fread(imagic, 4, 1, r->f) != 1 || memcmp(imagic, kIndexMagic, 4) != 0 ||
      !read_pod(r->f, &num_chunks)) {
    fclose(r->f);
    delete r;
    return nullptr;
  }
  r->index.resize(num_chunks);
  for (uint32_t i = 0; i < num_chunks; ++i) {
    if (!read_pod(r->f, &r->index[i].offset) ||
        !read_pod(r->f, &r->index[i].first_record)) {
      fclose(r->f);
      delete r;
      return nullptr;
    }
  }
  // total records = first_record of a virtual end chunk: read last chunk hdr
  if (num_chunks == 0) {
    r->num_records = 0;
  } else {
    const ChunkIndexEntry& last = r->index.back();
    if (fseek(r->f, (long)(last.offset + 4), SEEK_SET) != 0) {
      fclose(r->f);
      delete r;
      return nullptr;
    }
    uint32_t n;
    if (!read_pod(r->f, &n)) {
      fclose(r->f);
      delete r;
      return nullptr;
    }
    r->num_records = last.first_record + n;
  }
  return r;
}

long long edlr_reader_num_records(void* h) {
  return h ? (long long)((Reader*)h)->num_records : -1;
}

// Packs records [start, end) as {u32 len, bytes}* into an internal buffer.
// Returns byte size, or -1 on error. Buffer valid until the next call.
// Out-of-range spans clamp to the file (matching the Python twin), they are
// not errors.
long long edlr_reader_read(void* h, long long start, long long end) {
  Reader* r = (Reader*)h;
  if (!r) return -1;
  if (start < 0) start = 0;
  if (end < 0) end = 0;
  if ((uint64_t)end > r->num_records) end = (long long)r->num_records;
  r->out.clear();
  if (start >= end) return 0;
  // binary search the chunk containing `start`
  size_t lo = 0, hi = r->index.size();
  while (lo + 1 < hi) {
    size_t mid = (lo + hi) / 2;
    if (r->index[mid].first_record <= (uint64_t)start) lo = mid;
    else hi = mid;
  }
  for (size_t ci = lo; ci < r->index.size(); ++ci) {
    if (r->index[ci].first_record >= (uint64_t)end) break;
    if (!load_chunk(r, ci)) return -1;
    uint64_t base = r->index[ci].first_record;
    for (size_t k = 0; k < r->record_spans.size(); ++k) {
      uint64_t gid = base + k;
      if (gid < (uint64_t)start) continue;
      if (gid >= (uint64_t)end) break;
      uint32_t off = r->record_spans[k].first, len = r->record_spans[k].second;
      size_t pos = r->out.size();
      r->out.resize(pos + 4 + len);
      memcpy(r->out.data() + pos, &len, 4);
      memcpy(r->out.data() + pos + 4, r->payload.data() + off, len);
    }
  }
  return (long long)r->out.size();
}

const uint8_t* edlr_reader_buffer(void* h) {
  return h ? ((Reader*)h)->out.data() : nullptr;
}

const char* edlr_reader_error(void* h) {
  return h ? ((Reader*)h)->error.c_str() : "null handle";
}

void edlr_reader_close(void* h) {
  if (!h) return;
  Reader* r = (Reader*)h;
  if (r->f) fclose(r->f);
  delete r;
}

// ------------------------------ writer ------------------------------ //

static bool flush_chunk(Writer* w) {
  if (w->chunk_records == 0) return true;
  ChunkIndexEntry e;
  e.offset = (uint64_t)ftell(w->f);
  e.first_record = w->total_records - w->chunk_records;
  uint32_t crc = crc32(w->payload.data(), w->payload.size());
  uint64_t payload_len = w->payload.size();
  if (fwrite(kChunkMagic, 4, 1, w->f) != 1 || !write_pod(w->f, w->chunk_records) ||
      !write_pod(w->f, payload_len) || !write_pod(w->f, crc) ||
      (payload_len &&
       fwrite(w->payload.data(), 1, payload_len, w->f) != payload_len)) {
    w->error = "chunk write failed";
    return false;
  }
  w->index.push_back(e);
  w->payload.clear();
  w->chunk_records = 0;
  return true;
}

void* edlr_writer_open(const char* path, long long chunk_bytes) {
  Writer* w = new Writer();
  w->f = fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  if (chunk_bytes > 0) w->chunk_target_bytes = (uint64_t)chunk_bytes;
  if (fwrite(kFileMagic, 4, 1, w->f) != 1 || !write_pod(w->f, kVersion)) {
    fclose(w->f);
    delete w;
    return nullptr;
  }
  return w;
}

int edlr_writer_write(void* h, const uint8_t* data, long long len) {
  Writer* w = (Writer*)h;
  if (!w || len < 0 || (unsigned long long)len > UINT32_MAX) return -1;
  uint32_t len32 = (uint32_t)len;
  size_t pos = w->payload.size();
  w->payload.resize(pos + 4 + len32);
  memcpy(w->payload.data() + pos, &len32, 4);
  if (len32) memcpy(w->payload.data() + pos + 4, data, len32);
  w->chunk_records++;
  w->total_records++;
  if (w->payload.size() >= w->chunk_target_bytes) {
    if (!flush_chunk(w)) return -1;
  }
  return 0;
}

long long edlr_writer_close(void* h) {
  Writer* w = (Writer*)h;
  if (!w) return -1;
  long long total = -1;
  if (flush_chunk(w)) {
    uint64_t index_off = (uint64_t)ftell(w->f);
    uint32_t num_chunks = (uint32_t)w->index.size();
    bool ok = fwrite(kIndexMagic, 4, 1, w->f) == 1 && write_pod(w->f, num_chunks);
    for (size_t i = 0; ok && i < w->index.size(); ++i) {
      ok = write_pod(w->f, w->index[i].offset) &&
           write_pod(w->f, w->index[i].first_record);
    }
    ok = ok && write_pod(w->f, index_off) && fwrite(kFileMagic, 4, 1, w->f) == 1;
    if (ok) total = (long long)w->total_records;
  }
  fclose(w->f);
  delete w;
  return total;
}

}  // extern "C"
