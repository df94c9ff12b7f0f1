// Native data-path: mmap'd binarized-dataset reader with threaded batch
// cropping.
//
// A copy of fastdiff_tpu/native/indexed_io.cpp with the same C ABI and the
// same v2 layout. The pickle path unpickles whole records per item; the
// binarizer additionally writes a flat v2 format (see
// fastdiff_tpu_torch/data/native_io.py for the layout) that this library
// serves without any deserialization:
//
//   - the .bin file is mmap'd once; records are [hdr][mel f32][wav f16],
//   - fd_batch_crop() fills caller-allocated (B, F, M) mel-f32 and
//     (B, F*hop) wav-f32 buffers for random aligned crops, one worker
//     thread per batch item — no GIL, no copies beyond the crop itself.
//
// Exposed as a plain C ABI for ctypes (no pybind11 needed).
//
// One difference from the JAX package's copy: its half_to_float gives a
// subnormal half (|x| < 2^-14) half its value (exponent 112 - shift where
// 113 - shift is right). Here it is exact, so a native crop equals the
// pickle path's float16 -> float32 cast bit for bit.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Dataset {
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<int64_t> offsets;  // n_items + 1 entries
  int fd = -1;
};

struct RecordHeader {
  int32_t n_frames;
  int32_t n_mels;
  int32_t wav_len;
  int32_t reserved;
};

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: mant * 2^-24 == 1.m' * 2^(-14 - shift)
      int shift = 0;
      while (!(mant & 0x400)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ff;
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

}  // namespace

extern "C" {

// Open a v2 dataset: <prefix>.bin (records) + <prefix>.bidx (offsets).
// Returns an opaque handle or nullptr.
void* fd_open(const char* bin_path, const char* idx_path) {
  FILE* idx = std::fopen(idx_path, "rb");
  if (!idx) return nullptr;
  int64_t n = 0;
  if (std::fread(&n, sizeof(n), 1, idx) != 1 || n < 0) {
    std::fclose(idx);
    return nullptr;
  }
  auto* ds = new Dataset();
  ds->offsets.resize(n + 1);
  if (std::fread(ds->offsets.data(), sizeof(int64_t), n + 1, idx) !=
      (size_t)(n + 1)) {
    std::fclose(idx);
    delete ds;
    return nullptr;
  }
  std::fclose(idx);

  ds->fd = ::open(bin_path, O_RDONLY);
  if (ds->fd < 0) {
    delete ds;
    return nullptr;
  }
  struct stat st;
  if (fstat(ds->fd, &st) != 0) {
    ::close(ds->fd);
    delete ds;
    return nullptr;
  }
  ds->size = (size_t)st.st_size;
  void* map = mmap(nullptr, ds->size, PROT_READ, MAP_SHARED, ds->fd, 0);
  if (map == MAP_FAILED) {
    ::close(ds->fd);
    delete ds;
    return nullptr;
  }
  ds->base = (const uint8_t*)map;
  madvise(map, ds->size, MADV_WILLNEED);
  return ds;
}

int64_t fd_num_items(void* handle) {
  auto* ds = (Dataset*)handle;
  return (int64_t)ds->offsets.size() - 1;
}

// Frame count of one item (for length filtering without touching payload).
int32_t fd_item_frames(void* handle, int64_t item) {
  auto* ds = (Dataset*)handle;
  if (item < 0 || item + 1 >= (int64_t)ds->offsets.size()) return -1;
  const auto* hdr = (const RecordHeader*)(ds->base + ds->offsets[item]);
  return hdr->n_frames;
}

// Fill one batch of aligned random crops.
//   items[b], start_frames[b]: per-item crop positions (host RNG decides)
//   out_mels: (batch, max_frames, n_mels) float32, C-contiguous
//   out_wavs: (batch, max_frames*hop) float32
// Returns 0 on success, <0 on error.
int32_t fd_batch_crop(void* handle, const int64_t* items,
                      const int64_t* start_frames, int32_t batch,
                      int32_t max_frames, int32_t hop, int32_t n_mels,
                      float* out_mels, float* out_wavs) {
  auto* ds = (Dataset*)handle;
  std::vector<int32_t> status(batch, 0);

  auto work = [&](int b) {
    int64_t item = items[b];
    if (item < 0 || item + 1 >= (int64_t)ds->offsets.size()) {
      status[b] = -1;
      return;
    }
    const uint8_t* rec = ds->base + ds->offsets[item];
    const auto* hdr = (const RecordHeader*)rec;
    if (hdr->n_mels != n_mels || hdr->n_frames < max_frames) {
      status[b] = -2;
      return;
    }
    int64_t start = start_frames[b];
    if (start < 0 || start + max_frames > hdr->n_frames) {
      status[b] = -3;
      return;
    }
    const float* mel = (const float*)(rec + sizeof(RecordHeader));
    const uint16_t* wav =
        (const uint16_t*)(rec + sizeof(RecordHeader) +
                          (size_t)hdr->n_frames * hdr->n_mels * sizeof(float));
    std::memcpy(out_mels + (size_t)b * max_frames * n_mels,
                mel + (size_t)start * n_mels,
                (size_t)max_frames * n_mels * sizeof(float));
    float* wav_out = out_wavs + (size_t)b * max_frames * hop;
    const uint16_t* wav_src = wav + (size_t)start * hop;
    int64_t n = (int64_t)max_frames * hop;
    if (start * hop + n > hdr->wav_len) {
      status[b] = -4;
      return;
    }
    for (int64_t i = 0; i < n; ++i) wav_out[i] = half_to_float(wav_src[i]);
  };

  if (batch <= 1) {
    for (int b = 0; b < batch; ++b) work(b);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(batch);
    for (int b = 0; b < batch; ++b) threads.emplace_back(work, b);
    for (auto& t : threads) t.join();
  }
  for (int b = 0; b < batch; ++b)
    if (status[b] != 0) return status[b];
  return 0;
}

// Copy one full item (inference path): caller sizes buffers from
// fd_item_frames / fd_item_wav_len.
int32_t fd_item_wav_len(void* handle, int64_t item) {
  auto* ds = (Dataset*)handle;
  if (item < 0 || item + 1 >= (int64_t)ds->offsets.size()) return -1;
  const auto* hdr = (const RecordHeader*)(ds->base + ds->offsets[item]);
  return hdr->wav_len;
}

int32_t fd_item_n_mels(void* handle, int64_t item) {
  auto* ds = (Dataset*)handle;
  if (item < 0 || item + 1 >= (int64_t)ds->offsets.size()) return -1;
  const auto* hdr = (const RecordHeader*)(ds->base + ds->offsets[item]);
  return hdr->n_mels;
}

int32_t fd_read_item(void* handle, int64_t item, float* out_mel,
                     float* out_wav) {
  auto* ds = (Dataset*)handle;
  if (item < 0 || item + 1 >= (int64_t)ds->offsets.size()) return -1;
  const uint8_t* rec = ds->base + ds->offsets[item];
  const auto* hdr = (const RecordHeader*)rec;
  const float* mel = (const float*)(rec + sizeof(RecordHeader));
  std::memcpy(out_mel, mel,
              (size_t)hdr->n_frames * hdr->n_mels * sizeof(float));
  const uint16_t* wav =
      (const uint16_t*)(rec + sizeof(RecordHeader) +
                        (size_t)hdr->n_frames * hdr->n_mels * sizeof(float));
  for (int64_t i = 0; i < hdr->wav_len; ++i) out_wav[i] = half_to_float(wav[i]);
  return 0;
}

void fd_close(void* handle) {
  auto* ds = (Dataset*)handle;
  if (ds->base) munmap((void*)ds->base, ds->size);
  if (ds->fd >= 0) ::close(ds->fd);
  delete ds;
}

}  // extern "C"
