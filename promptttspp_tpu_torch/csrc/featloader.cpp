// Feature-batch loader of the training input pipeline, for the host CPU.
//
// One multithreaded C++ pass per batch: read each utterance's .npy
// features, normalize the mel with the corpus statistics, compute the
// energy contour, transpose [n_mels, T] -> [T, n_mels], and zero-pad
// everything into the caller's preallocated, bucketed batch buffers. Its
// threads run outside Python's interpreter lock.
//
// Copy of the JAX package's native/featloader.cpp (the same C ABI,
// ffl_load_batch and ffl_npy_shape), for the PyTorch port: built from this
// file at first use by promptttspp_tpu_torch/ops/kernels/_build.py with
// the host C++ compiler, and bound with ctypes by
// promptttspp_tpu_torch/data/native_loader.py. Little-endian float32 or
// float64 .npy (v1.x/2.x), C or Fortran order: what the preprocessing
// writes. One difference from the original: the mel is divided by its
// standard deviation, not multiplied by the reciprocal, so a batch of
// float32 files equals the Python dataset's bit for bit.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::vector<float> data;
  std::vector<int64_t> shape;
  bool ok = false;
  std::string err;
};

// Minimal .npy (v1.x/2.x) reader for little-endian float32/float64.
NpyArray read_npy(const char* path) {
  NpyArray out;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out.err = std::string("cannot open ") + path;
    return out;
  }
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    out.err = "bad magic";
    std::fclose(f);
    return out;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t hl;
    if (std::fread(&hl, 2, 1, f) != 1) { out.err = "bad header"; std::fclose(f); return out; }
    header_len = hl;
  } else {
    if (std::fread(&header_len, 4, 1, f) != 1) { out.err = "bad header"; std::fclose(f); return out; }
  }
  std::string header(header_len, '\0');
  if (std::fread(header.data(), 1, header_len, f) != header_len) {
    out.err = "short header";
    std::fclose(f);
    return out;
  }
  bool is_f8 = header.find("'<f8'") != std::string::npos;
  if (header.find("'<f4'") == std::string::npos && !is_f8) {
    out.err = "dtype must be <f4 or <f8: " + header;
    std::fclose(f);
    return out;
  }
  bool fortran = header.find("'fortran_order': True") != std::string::npos;
  if (!fortran && header.find("'fortran_order': False") == std::string::npos) {
    out.err = "cannot parse fortran_order";
    std::fclose(f);
    return out;
  }
  size_t sp = header.find("'shape':");
  size_t lp = header.find('(', sp), rp = header.find(')', sp);
  if (sp == std::string::npos || lp == std::string::npos) {
    out.err = "no shape";
    std::fclose(f);
    return out;
  }
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  int64_t total = 1;
  {
    const char* p = dims.c_str();
    while (*p) {
      while (*p == ' ' || *p == ',') p++;
      if (!*p) break;
      int64_t d = std::strtoll(p, const_cast<char**>(&p), 10);
      out.shape.push_back(d);
      total *= d;
    }
  }
  if (out.shape.empty()) {  // 0-d: scalar
    out.err = "scalar npy unsupported";
    std::fclose(f);
    return out;
  }
  out.data.resize(total);
  if (is_f8) {
    std::vector<double> tmp(total);
    if (std::fread(tmp.data(), 8, total, f) != (size_t)total) {
      out.err = "short data";
      std::fclose(f);
      return out;
    }
    for (int64_t i = 0; i < total; i++) out.data[i] = (float)tmp[i];
  } else if (std::fread(out.data.data(), 4, total, f) != (size_t)total) {
    out.err = "short data";
    std::fclose(f);
    return out;
  }
  std::fclose(f);
  // Fortran (column-major) payloads: convert to the row-major layout the
  // rest of the loader assumes. Rank-1 arrays are identical either way;
  // rank-2 gets an explicit transpose (np.save writes mel.T of a C-order
  // [T, 80] array as an F-order [80, T] without copying — common in real
  // corpora). Higher ranks never occur in the feature files.
  if (fortran && out.shape.size() == 2) {
    const int64_t R = out.shape[0], C = out.shape[1];
    std::vector<float> cmaj(total);
    for (int64_t c = 0; c < C; c++)
      for (int64_t r = 0; r < R; r++) cmaj[r * C + c] = out.data[c * R + r];
    out.data.swap(cmaj);
  } else if (fortran && out.shape.size() > 2) {
    out.err = "fortran order unsupported for rank > 2";
    return out;
  }
  out.ok = true;
  return out;
}

}  // namespace

extern "C" {

// Load one batch of features into preallocated buffers.
//  mel_paths/cf0_paths/vuv_paths: n file paths
//  mel_out [n, Tf, n_mels], cf0_out/vuv_out/energy_out [n, Tf, 1]
//  frame_lens [n] (written)
// Mel files are [n_mels, T] (reference layout); cf0/vuv are [1, T] or [T].
// Returns 0 on success; on failure returns 1 and writes a message into
// errbuf (size errbuf_len).
int ffl_load_batch(const char** mel_paths, const char** cf0_paths,
                   const char** vuv_paths, int n, int t_frames, int n_mels,
                   float mel_mean, float mel_std, float* mel_out,
                   float* cf0_out, float* vuv_out, float* energy_out,
                   int32_t* frame_lens, int n_threads, char* errbuf,
                   int errbuf_len) {
  std::vector<std::string> errors(n);

  auto work = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      NpyArray mel = read_npy(mel_paths[i]);
      NpyArray cf0 = read_npy(cf0_paths[i]);
      NpyArray vuv = read_npy(vuv_paths[i]);
      if (!mel.ok || !cf0.ok || !vuv.ok) {
        errors[i] = mel.ok ? (cf0.ok ? vuv.err : cf0.err) : mel.err;
        continue;
      }
      if (mel.shape.size() != 2 || mel.shape[0] != n_mels) {
        errors[i] = "mel shape mismatch";
        continue;
      }
      int64_t T = mel.shape[1];
      int64_t Tc = T < t_frames ? T : t_frames;
      frame_lens[i] = (int32_t)Tc;

      float* mel_dst = mel_out + (int64_t)i * t_frames * n_mels;
      float* cf0_dst = cf0_out + (int64_t)i * t_frames;
      float* vuv_dst = vuv_out + (int64_t)i * t_frames;
      float* en_dst = energy_out + (int64_t)i * t_frames;
      std::memset(mel_dst, 0, sizeof(float) * t_frames * n_mels);
      std::memset(cf0_dst, 0, sizeof(float) * t_frames);
      std::memset(vuv_dst, 0, sizeof(float) * t_frames);
      std::memset(en_dst, 0, sizeof(float) * t_frames);

      for (int64_t t = 0; t < Tc; t++) {
        float esum = 0.0f;
        for (int m = 0; m < n_mels; m++) {
          float v = mel.data[(int64_t)m * T + t];
          float e = std::exp(v);
          esum += e * e;
          // a division, as the Python path's float32 numpy arithmetic
          // (not a product with 1 / std): the same bits from float32 files
          mel_dst[t * n_mels + m] = (v - mel_mean) / mel_std;
        }
        en_dst[t] = std::sqrt(esum);
      }
      const float* cf0_src =
          cf0.shape.size() == 2 ? cf0.data.data() : cf0.data.data();
      int64_t cf0_T = cf0.shape.back();
      int64_t vuv_T = vuv.shape.back();
      for (int64_t t = 0; t < Tc && t < cf0_T; t++) cf0_dst[t] = cf0_src[t];
      for (int64_t t = 0; t < Tc && t < vuv_T; t++)
        vuv_dst[t] = vuv.data[t];
    }
  };

  int threads = n_threads > 0 ? n_threads : 1;
  if (threads > n) threads = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  for (int s = 1; s < threads; s++) pool.emplace_back(work, s, threads);
  work(0, threads);
  for (auto& th : pool) th.join();

  for (int i = 0; i < n; i++) {
    if (!errors[i].empty()) {
      std::snprintf(errbuf, errbuf_len, "item %d: %s", i, errors[i].c_str());
      return 1;
    }
  }
  return 0;
}

// Standalone .npy probe: returns rank and writes shape (up to 4 dims).
int ffl_npy_shape(const char* path, int64_t* shape_out, int max_dims) {
  NpyArray a = read_npy(path);
  if (!a.ok) return -1;
  int rank = (int)a.shape.size();
  for (int i = 0; i < rank && i < max_dims; i++) shape_out[i] = a.shape[i];
  return rank;
}

}  // extern "C"
