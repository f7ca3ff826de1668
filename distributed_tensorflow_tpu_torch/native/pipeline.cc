// Native data-pipeline core: threaded record reader + prefetch ring.
//
// The port's own copy of distributed_tensorflow_tpu/native/pipeline.cc
// (the same C ABI, byte for byte the same behaviour), built by
// input/native_loader.py into build/torch_native/ at first use. The
// reference's input pipeline bottoms out in tensorflow/core/data/ C++
// iterators with prefetch + parallel interleave; here the hot loop —
// file IO, shuffling, batch assembly — runs in native threads, off the
// Python GIL, so the host keeps the card fed.
//
// Design:
//  - Fixed-size binary records in one or more files (the on-disk layout
//    a converter writes once; ≙ TFRecord without the varint framing).
//  - Worker threads read+assemble whole batches into reusable buffers.
//  - A bounded MPMC ring hands filled buffers to the consumer (Python via
//    ctypes, zero-copy numpy view), which returns them to a free list.
//  - Per-epoch Fisher-Yates shuffle of the record index (seeded), sharded
//    by (num_shards, shard_index) for multi-host input
//    (≙ AutoShardPolicy.DATA, reference input_ops.py:28).
//
// C ABI only — consumed with ctypes; no pybind11 dependency.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <map>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// GZIP (1f 8b) / ZLIB (78 xx) compressed files (≙ TFRecordOptions
// compression_type, tensorflow/python/lib/io/tf_record.py): compressed
// streams cannot be seek-indexed, so such files are inflated ONCE into
// memory at open and both the scan and the worker reads run against
// the buffer. Plain files keep the zero-copy seek/read path.
enum class FileCompression { kNone, kGzip, kZlib };

FileCompression SniffCompression(FILE* f) {
  uint8_t magic[2];
  size_t got = std::fread(magic, 1, 2, f);
  std::fseek(f, 0, SEEK_SET);
  if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b)
    return FileCompression::kGzip;
  if (got == 2 && magic[0] == 0x78 &&
      (magic[1] == 0x01 || magic[1] == 0x5e || magic[1] == 0x9c ||
       magic[1] == 0xda))
    return FileCompression::kZlib;
  return FileCompression::kNone;
}

bool InflateFile(FILE* f, FileCompression comp, std::vector<uint8_t>* out) {
  std::fseek(f, 0, SEEK_END);
  int64_t csize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> comp_buf(csize);
  if (std::fread(comp_buf.data(), 1, csize, f) !=
      static_cast<size_t>(csize))
    return false;
  z_stream strm{};
  int window = comp == FileCompression::kGzip ? 16 + MAX_WBITS : MAX_WBITS;
  if (inflateInit2(&strm, window) != Z_OK) return false;
  strm.next_in = comp_buf.data();
  strm.avail_in = static_cast<uInt>(csize);
  out->clear();
  out->resize(std::max<int64_t>(csize * 4, 1 << 16));
  int ret = Z_OK;
  for (;;) {
    strm.next_out = out->data() + strm.total_out;
    strm.avail_out = static_cast<uInt>(out->size() - strm.total_out);
    ret = inflate(&strm, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) break;
    if (ret != Z_OK && ret != Z_BUF_ERROR) { inflateEnd(&strm); return false; }
    if (strm.avail_out == 0) out->resize(out->size() * 2);
    else if (ret == Z_BUF_ERROR) { inflateEnd(&strm); return false; }
  }
  out->resize(strm.total_out);
  inflateEnd(&strm);
  return true;
}

struct Batch {
  std::vector<uint8_t> data;
  std::vector<int64_t> lengths;  // per-row payload bytes (TFRecord mode)
  int64_t epoch = -1;
  int64_t batch_index = -1;
};

// crc32c (Castagnoli, reflected) + the TFRecord mask — for verifying the
// framing of files we index (≙ tensorflow/core/lib/io/record_reader).
struct Crc32c {
  uint32_t table[256];
  Crc32c() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
  uint32_t operator()(const uint8_t* p, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }
  uint32_t Masked(const uint8_t* p, size_t n) const {
    uint32_t c = (*this)(p, n);
    return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
  }
};

class Pipeline {
 public:
  // record_bytes > 0: fixed-size records (row = record_bytes).
  // record_bytes == 0: TFRecord framing — scan each file's
  // length/crc/payload/crc structure to index variable-length records;
  // rows are padded to the longest payload and per-row lengths reported.
  Pipeline(const char** paths, int num_paths, int64_t record_bytes,
           int64_t batch_size, int shuffle, uint64_t seed, int num_threads,
           int64_t queue_depth, int64_t num_shards, int64_t shard_index,
           int drop_remainder, int verify_crc = 0)
      : record_bytes_(record_bytes),
        batch_size_(batch_size),
        shuffle_(shuffle),
        seed_(seed),
        num_shards_(num_shards < 1 ? 1 : num_shards),
        shard_index_(shard_index),
        drop_remainder_(drop_remainder),
        tfrecord_(record_bytes == 0),
        verify_crc_(verify_crc) {
    int64_t max_len = 0;
    for (int i = 0; i < num_paths; ++i) {
      FILE* f = std::fopen(paths[i], "rb");
      if (!f) { ok_ = false; return; }
      FileCompression comp = SniffCompression(f);
      // A VALID plain TFRecord header (length crc32c matches at offset
      // 8) beats any magic-byte coincidence: an uncompressed file
      // whose first record length encodes to 78 01 / 1f 8b would
      // otherwise be misdetected as compressed.
      if (comp != FileCompression::kNone && tfrecord_ &&
          HasValidPlainHeader(f))
        comp = FileCompression::kNone;
      if (comp != FileCompression::kNone) {
        std::vector<uint8_t> raw;
        if (InflateFile(f, comp, &raw)) {
          if (tfrecord_) {
            if (!ScanTFRecordMem(raw, i, verify_crc, &max_len)) {
              std::fclose(f);
              ok_ = false;
              return;
            }
          } else {
            int64_t n = static_cast<int64_t>(raw.size()) / record_bytes_;
            for (int64_t r = 0; r < n; ++r)
              index_.push_back({i, r * record_bytes_, record_bytes_});
          }
          mem_files_[i] = std::move(raw);
        } else {
          // magic-byte false positive on a non-compressed file: fall
          // back to the plain path rather than rejecting a valid file
          std::fseek(f, 0, SEEK_SET);
          comp = FileCompression::kNone;
        }
      }
      if (comp == FileCompression::kNone &&
          mem_files_.find(i) == mem_files_.end()) {
        if (tfrecord_) {
          if (!ScanTFRecord(f, i, verify_crc, &max_len)) {
            std::fclose(f);
            ok_ = false;
            return;
          }
        } else {
          std::fseek(f, 0, SEEK_END);
          int64_t bytes = std::ftell(f);
          int64_t n = bytes / record_bytes_;
          for (int64_t r = 0; r < n; ++r)
            index_.push_back({i, r * record_bytes_, record_bytes_});
        }
      }
      std::fclose(f);
      files_.emplace_back(paths[i]);
    }
    if (tfrecord_) record_bytes_ = max_len;  // row stride = longest payload
    // Static shard over records (≙ DATA autoshard policy).
    std::vector<Entry> mine;
    for (size_t i = shard_index_; i < index_.size(); i += num_shards_)
      mine.push_back(index_[i]);
    index_.swap(mine);
    if (index_.empty() || record_bytes_ <= 0) { ok_ = false; return; }

    int64_t nb = static_cast<int64_t>(index_.size()) / batch_size_;
    if (!drop_remainder_ && index_.size() % batch_size_) ++nb;
    if (nb == 0) { ok_ = false; return; }  // shard < batch: no SIGFPE
    batches_per_epoch_ = nb;

    for (int64_t i = 0; i < queue_depth; ++i) {
      auto* b = new Batch();
      b->data.resize(record_bytes_ * batch_size_);
      b->lengths.resize(batch_size_);
      free_.push_back(b);
    }
    int64_t nt = num_threads < 1 ? 1 : num_threads;
    for (int64_t t = 0; t < nt; ++t)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  // True iff the file starts with a crc-valid plain TFRecord header.
  static bool HasValidPlainHeader(FILE* f) {
    static const Crc32c crc;
    uint8_t header[12];
    size_t got = std::fread(header, 1, 12, f);
    std::fseek(f, 0, SEEK_SET);
    if (got != 12) return false;
    uint32_t len_crc;
    std::memcpy(&len_crc, header + 8, 4);
    return crc.Masked(header, 8) == len_crc;
  }

  // TFRecord framing: u64le length, u32le masked-crc(length), payload,
  // u32le masked-crc(payload). The scan is seek-only (headers validated,
  // lengths bounds-checked against the file size — a corrupt length
  // cannot index past EOF, OOM the row stride, or wrap negative);
  // payload CRCs are verified by the WORKERS at read time, so dataset
  // bytes are read exactly once and startup never reads the data.
  bool ScanTFRecord(FILE* f, int file_idx, int verify_crc,
                    int64_t* max_len) {
    static const Crc32c crc;
    std::fseek(f, 0, SEEK_END);
    const int64_t fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    uint8_t header[12];
    for (;;) {
      size_t got = std::fread(header, 1, 12, f);
      if (got == 0) return true;          // clean EOF
      if (got != 12) return false;        // truncated header
      uint64_t len;
      uint32_t len_crc;
      std::memcpy(&len, header, 8);
      std::memcpy(&len_crc, header + 8, 4);
      if (verify_crc && crc.Masked(header, 8) != len_crc) return false;
      int64_t payload_off = std::ftell(f);
      int64_t slen = static_cast<int64_t>(len);
      if (slen < 0 || payload_off + slen + 4 > fsize) return false;
      if (std::fseek(f, slen + 4, SEEK_CUR) != 0) return false;
      index_.push_back({file_idx, payload_off, slen});
      if (slen > *max_len) *max_len = slen;
    }
  }

  // Same framing walk over an inflated in-memory file.
  bool ScanTFRecordMem(const std::vector<uint8_t>& buf, int file_idx,
                       int verify_crc, int64_t* max_len) {
    static const Crc32c crc;
    const int64_t fsize = static_cast<int64_t>(buf.size());
    int64_t pos = 0;
    for (;;) {
      if (pos == fsize) return true;      // clean EOF
      if (pos + 12 > fsize) return false;  // truncated header
      uint64_t len;
      uint32_t len_crc;
      std::memcpy(&len, buf.data() + pos, 8);
      std::memcpy(&len_crc, buf.data() + pos + 8, 4);
      if (verify_crc && crc.Masked(buf.data() + pos, 8) != len_crc)
        return false;
      int64_t payload_off = pos + 12;
      int64_t slen = static_cast<int64_t>(len);
      if (slen < 0 || payload_off + slen + 4 > fsize) return false;
      index_.push_back({file_idx, payload_off, slen});
      if (slen > *max_len) *max_len = slen;
      pos = payload_off + slen + 4;
    }
  }

  ~Pipeline() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto* b : free_) delete b;
    for (auto* b : ready_) delete b;
    for (auto* b : lent_) delete b;
  }

  bool ok() const { return ok_; }
  bool failed() const { return failed_; }
  int64_t num_records() const { return static_cast<int64_t>(index_.size()); }
  int64_t batches_per_epoch() const { return batches_per_epoch_; }
  int64_t row_bytes() const { return record_bytes_; }

  // Blocks until the batch with the next sequential batch_index is ready;
  // returns its buffer (caller must Return() it). Delivering strictly in
  // batch order makes the stream deterministic for any num_threads: every
  // in-flight batch owns its buffer, so the next-expected batch can always
  // complete even while later batches sit in ready_. actual_records
  // reports the (possibly short) batch size.
  Batch* Next(int64_t* actual_records, int64_t* epoch) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [this] {
      return stop_ || (!ready_.empty() &&
                       ready_.front()->batch_index == next_deliver_);
    });
    if (stop_ &&
        (ready_.empty() || ready_.front()->batch_index != next_deliver_))
      return nullptr;
    Batch* b = ready_.front();
    ready_.pop_front();
    lent_.push_back(b);
    ++next_deliver_;
    *actual_records = last_sizes_[b];
    *epoch = b->epoch;
    return b;
  }

  void Return(Batch* b) {
    std::lock_guard<std::mutex> lk(mu_);
    lent_.erase(std::find(lent_.begin(), lent_.end(), b));
    free_.push_back(b);
    cv_free_.notify_one();
  }

 private:
  struct Entry { int file; int64_t offset; int64_t length; };

  void WorkerLoop() {
    // Each worker owns a FILE* per input file (no seek contention).
    std::vector<FILE*> fps;
    for (auto& p : files_) fps.push_back(std::fopen(p.c_str(), "rb"));

    while (true) {
      Batch* buf = nullptr;
      int64_t my_batch, my_epoch, count;
      std::vector<Entry> picks;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_free_.wait(lk, [this] { return stop_ || !free_.empty(); });
        if (stop_) break;
        buf = free_.back();
        free_.pop_back();
        my_batch = next_batch_++;
        my_epoch = my_batch / batches_per_epoch_;
        if (epoch_order_.empty() || shuffled_epoch_ != my_epoch)
          ShuffleEpochLocked(my_epoch);
        // Resolve record picks while the epoch order is still this
        // epoch's (another worker may reshuffle right after we unlock).
        int64_t start = (my_batch % batches_per_epoch_) * batch_size_;
        count = std::min<int64_t>(batch_size_, num_records() - start);
        picks.resize(count);
        for (int64_t i = 0; i < count; ++i)
          picks[i] = index_[epoch_order_[start + i]];
      }
      static const Crc32c crc;
      bool bad = false;
      for (int64_t i = 0; i < count; ++i) {
        uint8_t* row = buf->data.data() + i * record_bytes_;
        auto mem = mem_files_.find(picks[i].file);
        if (mem != mem_files_.end()) {
          // inflated (gzip/zlib) file: copy from the in-memory buffer
          const std::vector<uint8_t>& src = mem->second;
          std::memcpy(row, src.data() + picks[i].offset, picks[i].length);
          if (tfrecord_ && verify_crc_) {
            uint32_t data_crc;
            std::memcpy(&data_crc,
                        src.data() + picks[i].offset + picks[i].length, 4);
            if (crc.Masked(row, picks[i].length) != data_crc) bad = true;
          }
        } else {
          FILE* f = fps[picks[i].file];
          std::fseek(f, picks[i].offset, SEEK_SET);
          size_t got = std::fread(row, 1, picks[i].length, f);
          if (static_cast<int64_t>(got) != picks[i].length) { bad = true; }
          if (tfrecord_ && verify_crc_ && !bad) {
            // payload crc sits right after the payload; data's in hand —
            // verify here so dataset bytes are read exactly once
            uint32_t data_crc;
            if (std::fread(&data_crc, 1, 4, f) != 4 ||
                crc.Masked(row, picks[i].length) != data_crc)
              bad = true;
          }
        }
        if (picks[i].length < record_bytes_)
          std::memset(row + picks[i].length, 0,
                      record_bytes_ - picks[i].length);
        buf->lengths[i] = picks[i].length;
      }
      if (bad) {
        std::lock_guard<std::mutex> lk(mu_);
        failed_ = true;
        stop_ = true;
        cv_ready_.notify_all();
        cv_free_.notify_all();
        break;
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        buf->epoch = my_epoch;
        buf->batch_index = my_batch;
        last_sizes_[buf] = count;
        // Insert in batch order so consumers see a deterministic stream.
        auto it = ready_.begin();
        while (it != ready_.end() && (*it)->batch_index < my_batch) ++it;
        ready_.insert(it, buf);
      }
      cv_ready_.notify_all();
    }
    for (FILE* f : fps)
      if (f) std::fclose(f);
  }

  void ShuffleEpochLocked(int64_t epoch) {
    epoch_order_.resize(index_.size());
    for (size_t i = 0; i < index_.size(); ++i) epoch_order_[i] = i;
    if (shuffle_) {
      std::mt19937_64 rng(seed_ + 0x9e3779b97f4a7c15ull * (epoch + 1));
      for (size_t i = index_.size() - 1; i > 0; --i) {
        std::uniform_int_distribution<size_t> d(0, i);
        std::swap(epoch_order_[i], epoch_order_[d(rng)]);
      }
    }
    shuffled_epoch_ = epoch;
  }

  std::vector<std::string> files_;
  std::map<int, std::vector<uint8_t>> mem_files_;  // inflated gzip/zlib
  std::vector<Entry> index_;
  std::vector<size_t> epoch_order_;
  int64_t shuffled_epoch_ = -1;

  int64_t record_bytes_, batch_size_;
  bool tfrecord_ = false;
  int verify_crc_ = 0;
  int shuffle_;
  uint64_t seed_;
  int64_t num_shards_, shard_index_;
  int drop_remainder_;
  int64_t batches_per_epoch_ = 0;
  bool ok_ = true;

  std::mutex mu_;
  std::condition_variable cv_free_, cv_ready_;
  std::deque<Batch*> free_;
  std::deque<Batch*> ready_;   // kept sorted by batch_index
  std::vector<Batch*> lent_;
  std::map<Batch*, int64_t> last_sizes_;
  int64_t next_batch_ = 0;
  int64_t next_deliver_ = 0;
  bool stop_ = false;
  std::atomic<bool> failed_{false};   // IO error / crc mismatch mid-read

  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* dtx_pipeline_create(const char** paths, int num_paths,
                          int64_t record_bytes, int64_t batch_size,
                          int shuffle, uint64_t seed, int num_threads,
                          int64_t queue_depth, int64_t num_shards,
                          int64_t shard_index, int drop_remainder) {
  auto* p = new Pipeline(paths, num_paths, record_bytes, batch_size,
                         shuffle, seed, num_threads, queue_depth,
                         num_shards, shard_index, drop_remainder);
  if (!p->ok()) { delete p; return nullptr; }
  return p;
}

int64_t dtx_pipeline_num_records(void* h) {
  return static_cast<Pipeline*>(h)->num_records();
}

int64_t dtx_pipeline_batches_per_epoch(void* h) {
  return static_cast<Pipeline*>(h)->batches_per_epoch();
}

// Returns an opaque batch handle; fills *data/*n_records/*epoch.
void* dtx_pipeline_next(void* h, uint8_t** data, int64_t* n_records,
                        int64_t* epoch) {
  Batch* b = static_cast<Pipeline*>(h)->Next(n_records, epoch);
  if (!b) return nullptr;
  *data = b->data.data();
  return b;
}

void dtx_pipeline_return(void* h, void* batch) {
  static_cast<Pipeline*>(h)->Return(static_cast<Batch*>(batch));
}

void dtx_pipeline_destroy(void* h) { delete static_cast<Pipeline*>(h); }

// -- TFRecord mode (variable-length framed records) -------------------------

void* dtx_tfrecord_create(const char** paths, int num_paths,
                          int64_t batch_size, int shuffle, uint64_t seed,
                          int num_threads, int64_t queue_depth,
                          int64_t num_shards, int64_t shard_index,
                          int drop_remainder, int verify_crc) {
  auto* p = new Pipeline(paths, num_paths, /*record_bytes=*/0, batch_size,
                         shuffle, seed, num_threads, queue_depth,
                         num_shards, shard_index, drop_remainder,
                         verify_crc);
  if (!p->ok()) { delete p; return nullptr; }
  return p;
}

int64_t dtx_pipeline_row_bytes(void* h) {
  return static_cast<Pipeline*>(h)->row_bytes();
}

// 1 if a worker hit an IO error or crc mismatch (the stream stopped
// because the DATA is bad, not because it ended).
int dtx_pipeline_failed(void* h) {
  return static_cast<Pipeline*>(h)->failed() ? 1 : 0;
}

// Like dtx_pipeline_next but also exposes the per-row payload lengths
// (rows are zero-padded to row_bytes).
void* dtx_pipeline_next2(void* h, uint8_t** data, int64_t** lengths,
                         int64_t* n_records, int64_t* epoch) {
  Batch* b = static_cast<Pipeline*>(h)->Next(n_records, epoch);
  if (!b) return nullptr;
  *data = b->data.data();
  *lengths = b->lengths.data();
  return b;
}

}  // extern "C"
