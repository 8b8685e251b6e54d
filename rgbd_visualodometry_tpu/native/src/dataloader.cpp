// Native RGB-D dataset loader: libpng decode + multithreaded prefetch.
//
// Native runtime counterpart of the reference's host IO path
// (cv::imread color + 16-bit depth per frame inside the main loop,
// app/run_vo.cpp:91-92).  The reference decodes synchronously on the
// tracking thread; here a worker pool decodes frames ahead of the consumer
// into a bounded in-order queue, so the accelerator never waits for PNG
// inflate.  Exposed through a C ABI consumed via ctypes (no pybind11 in
// this environment).
//
// Supports the TUM RGB-D formats: 8-bit RGB(A)/gray color images and
// 16-bit grayscale depth images (network byte order, as libpng delivers).

#include <png.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;  // 3 for RGB, 1 for 16-bit depth
  int bitdepth = 8;
  std::vector<uint8_t> rgb;      // H*W*3 when color
  std::vector<uint16_t> gray16;  // H*W when depth
  bool ok = false;
};

bool decode_png(const char* path, bool as_depth, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  int bitdepth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (as_depth) {
    // TUM depth must be grayscale (8- or 16-bit); anything else (palette,
    // RGB) would silently decode to garbage depth values - reject instead
    // so vo_loader_next reports a decode error (-3)
    if (color != PNG_COLOR_TYPE_GRAY) {
      png_destroy_read_struct(&png, &info, nullptr);
      std::fclose(fp);
      return false;
    }
  } else {
    // normalize everything to 8-bit RGB
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && bitdepth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (bitdepth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);
  int final_depth = png_get_bit_depth(png, info);

  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> raw((size_t)height * rowbytes);
  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; ++y) rows[y] = raw.data() + (size_t)y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out->width = width;
  out->height = height;
  if (as_depth) {
    out->channels = 1;
    out->bitdepth = 16;
    out->gray16.resize((size_t)width * height);
    if (final_depth == 16 && rowbytes == (size_t)width * 2) {
      // PNG stores 16-bit big-endian
      for (size_t i = 0; i < out->gray16.size(); ++i)
        out->gray16[i] = (uint16_t)((raw[2 * i] << 8) | raw[2 * i + 1]);
    } else if (final_depth == 8 && rowbytes == (size_t)width) {
      for (size_t i = 0; i < out->gray16.size(); ++i) out->gray16[i] = raw[i];
    } else {
      return false;  // unexpected layout: fail loudly, never wrong depths
    }
  } else {
    out->channels = 3;
    out->bitdepth = 8;
    out->rgb.assign(raw.begin(), raw.end());
  }
  out->ok = true;
  return true;
}

struct FramePair {
  Image rgb;
  Image depth;
};

class Loader {
 public:
  Loader(std::vector<std::string> rgb_paths, std::vector<std::string> depth_paths,
         int prefetch, int workers)
      : rgb_paths_(std::move(rgb_paths)),
        depth_paths_(std::move(depth_paths)),
        prefetch_(prefetch < 1 ? 1 : prefetch),
        stop_(false),
        next_claim_(0),
        next_deliver_(0) {
    int n = workers < 1 ? 1 : workers;
    for (int i = 0; i < n; ++i) threads_.emplace_back([this] { Work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Blocks until frame `next_deliver_` is decoded; moves it out.
  // Returns index, or -1 past the end.
  int Next(FramePair* out) {
    std::unique_lock<std::mutex> lk(mu_);
    size_t idx = next_deliver_;
    if (idx >= rgb_paths_.size()) return -1;
    cv_ready_.wait(lk, [&] { return done_.count(idx) || stop_; });
    if (stop_ && !done_.count(idx)) return -1;
    *out = std::move(done_[idx]);
    done_.erase(idx);
    ++next_deliver_;
    cv_space_.notify_all();
    return (int)idx;
  }

 private:
  void Work() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ || (next_claim_ < rgb_paths_.size() &&
                           next_claim_ < next_deliver_ + prefetch_);
        });
        if (stop_ || next_claim_ >= rgb_paths_.size()) return;
        idx = next_claim_++;
      }
      FramePair fp;
      decode_png(rgb_paths_[idx].c_str(), false, &fp.rgb);
      decode_png(depth_paths_[idx].c_str(), true, &fp.depth);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(fp);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> rgb_paths_, depth_paths_;
  size_t prefetch_;
  bool stop_;
  size_t next_claim_, next_deliver_;
  std::map<size_t, FramePair> done_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::vector<std::thread> threads_;
};

}  // namespace

extern "C" {

void* vo_loader_open(const char** rgb_paths, const char** depth_paths, int n,
                     int prefetch, int workers) {
  std::vector<std::string> r(rgb_paths, rgb_paths + n);
  std::vector<std::string> d(depth_paths, depth_paths + n);
  return new Loader(std::move(r), std::move(d), prefetch, workers);
}

// Writes the next decoded frame into caller buffers (rgb: h*w*3 uint8,
// depth: h*w uint16).  Returns the frame index, or -1 at end / on error.
// Caller buffers must match (expected_w, expected_h); mismatched frames
// report -2.
int vo_loader_next(void* handle, uint8_t* rgb_out, uint16_t* depth_out,
                   int expected_w, int expected_h) {
  auto* l = static_cast<Loader*>(handle);
  FramePair fp;
  int idx = l->Next(&fp);
  if (idx < 0) return idx;
  if (!fp.rgb.ok || !fp.depth.ok) return -3;
  if (fp.rgb.width != expected_w || fp.rgb.height != expected_h ||
      fp.depth.width != expected_w || fp.depth.height != expected_h)
    return -2;
  std::memcpy(rgb_out, fp.rgb.rgb.data(), fp.rgb.rgb.size());
  std::memcpy(depth_out, fp.depth.gray16.data(), fp.depth.gray16.size() * 2);
  return idx;
}

void vo_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

// Greedy nearest-timestamp association (tools/associate.py:71-101
// semantics), native so huge file lists stay cheap.  Returns #matches;
// out_i/out_j must have capacity min(n1, n2).
int vo_associate(const double* t1, int n1, const double* t2, int n2,
                 double offset, double max_difference, int* out_i, int* out_j) {
  struct Cand {
    double diff;
    int i, j;
  };
  std::vector<Cand> cands;
  for (int i = 0; i < n1; ++i)
    for (int j = 0; j < n2; ++j) {
      double d = t1[i] - (t2[j] + offset);
      if (d < 0) d = -d;
      if (d < max_difference) cands.push_back({d, i, j});
    }
  std::stable_sort(cands.begin(), cands.end(),
                   [](const Cand& a, const Cand& b) { return a.diff < b.diff; });
  std::vector<char> used_i(n1, 0), used_j(n2, 0);
  std::vector<std::pair<double, std::pair<int, int>>> matches;
  for (const auto& c : cands) {
    if (used_i[c.i] || used_j[c.j]) continue;
    used_i[c.i] = used_j[c.j] = 1;
    matches.push_back({t1[c.i], {c.i, c.j}});
  }
  std::stable_sort(matches.begin(), matches.end());
  for (size_t k = 0; k < matches.size(); ++k) {
    out_i[k] = matches[k].second.first;
    out_j[k] = matches[k].second.second;
  }
  return (int)matches.size();
}

}  // extern "C"
