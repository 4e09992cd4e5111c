// Native data loader: multithreaded PNG decode + area resize + exposure scale.
//
// The port's copy of ex4dgs_tpu/native/loader.cpp (the same code, so the two
// decode bit for bit alike). It stands in for the reference's joblib/loky
// worker processes (scene/__init__.py:199-204): a persistent C++ thread pool
// decodes frames with libpng, box-downsamples to the render resolution,
// applies the per-camera exposure compensation, and hands float32 HWC
// buffers to Python through a ticketed queue (ctypes; no pybind dependency).
//
// Build: ex4dgs_tpu_torch/native/__init__.py (g++ -O3 -shared, links libpng)
// into ex4dgs_tpu_torch/_build/ at first use.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  int ticket;
  std::string path;
  int out_w, out_h;
  float inv_scale;  // 1 / im_scale
};

struct Result {
  std::vector<float> data;  // out_h * out_w * 3
  bool ok;
  std::string error;
};

struct Decoded {
  std::vector<uint8_t> rgb;  // h * w * 3
  int w = 0, h = 0;
};

bool decode_png(const std::string& path, Decoded* out, std::string* err) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) {
    *err = "open failed: " + path;
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    *err = "libpng decode error: " + path;
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = (int)w;
  out->h = (int)h;
  out->rgb.resize((size_t)w * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->rgb.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

// Area (box) resample uint8 RGB -> float32 RGB in [0,1], times inv_scale.
void resize_area(const Decoded& src, int ow, int oh, float inv_scale,
                 std::vector<float>* out) {
  out->assign((size_t)ow * oh * 3, 0.f);
  const float sx = (float)src.w / ow, sy = (float)src.h / oh;
  for (int y = 0; y < oh; ++y) {
    int y0 = (int)(y * sy), y1 = (int)((y + 1) * sy);
    if (y1 <= y0) y1 = y0 + 1;
    if (y1 > src.h) y1 = src.h;
    for (int x = 0; x < ow; ++x) {
      int x0 = (int)(x * sx), x1 = (int)((x + 1) * sx);
      if (x1 <= x0) x1 = x0 + 1;
      if (x1 > src.w) x1 = src.w;
      float acc[3] = {0, 0, 0};
      for (int yy = y0; yy < y1; ++yy) {
        const uint8_t* row = src.rgb.data() + ((size_t)yy * src.w + x0) * 3;
        for (int xx = x0; xx < x1; ++xx) {
          acc[0] += row[0];
          acc[1] += row[1];
          acc[2] += row[2];
          row += 3;
        }
      }
      float norm = 1.f / (255.f * (y1 - y0) * (x1 - x0));
      float* dst = out->data() + ((size_t)y * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] * norm * inv_scale;
        dst[c] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
      }
    }
  }
}

struct Loader {
  std::vector<std::thread> threads;
  std::deque<Job> queue;
  std::map<int, Result> done;
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  bool stopping = false;

  explicit Loader(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      threads.emplace_back([this] { worker(); });
  }

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      Result res;
      Decoded dec;
      res.ok = decode_png(job.path, &dec, &res.error);
      if (res.ok) resize_area(dec, job.out_w, job.out_h, job.inv_scale, &res.data);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.ticket] = std::move(res);
      }
      cv_done.notify_all();
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_job.notify_all();
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

void* loader_create(int n_threads) { return new Loader(n_threads); }

void loader_destroy(void* h) { delete static_cast<Loader*>(h); }

void loader_submit(void* h, const char* path, int out_w, int out_h,
                   float im_scale, int ticket) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->queue.push_back(Job{ticket, path, out_w, out_h,
                           im_scale != 0.f ? 1.f / im_scale : 1.f});
  }
  L->cv_job.notify_one();
}

// Blocks until `ticket` finishes; copies out_h*out_w*3 floats. Returns 0 on
// success, 1 on decode failure.
int loader_wait(void* h, int ticket, float* out, long long out_len) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_done.wait(lk, [&] { return L->done.count(ticket) != 0; });
  Result res = std::move(L->done[ticket]);
  L->done.erase(ticket);
  lk.unlock();
  if (!res.ok) return 1;
  if ((long long)res.data.size() != out_len) return 2;
  std::memcpy(out, res.data.data(), res.data.size() * sizeof(float));
  return 0;
}

}  // extern "C"
