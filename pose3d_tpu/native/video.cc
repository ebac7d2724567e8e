// Native video decode: mp4 -> model-ready tensors with no Python in the
// frame path.
//
// The reference's phase-2 ETL shells out to ffmpeg to dump %04d.jpg frames
// (run.py:31-57) and phase-4's Custom_video_dataset re-reads those via
// per-item python cv2 calls (Custom_Video_dataset.py:44-73). This is the
// Native replacement for both: libavcodec (through OpenCV's C++
// VideoCapture, which runs the codec's own thread pool) decodes straight
// into the caller's batch buffer — centre-crop square, resize, RGB — as
// uint8 (normalize-on-device path, 4x less host->HBM traffic) or float32
// in [0,1) (the /256 convention of H36_dataset.py:129-131).
//
// Exposed via a plain C ABI consumed by ctypes
// (pose3d_tpu/data/native_video.py). Build: pose3d_tpu/native/build.sh
// (separate .so so the JPEG loader does not depend on OpenCV).

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Decoder {
  cv::VideoCapture cap;
  // stride phase carries across read calls so chunked reads pick exactly
  // the frames a single big read would
  int idx = 0;
};

// centre-crop to square then resize to (size, size), BGR -> RGB.
void CropResizeRgb(const cv::Mat& bgr, int size, cv::Mat* rgb_out) {
  const int h = bgr.rows, w = bgr.cols;
  const int side = h < w ? h : w;
  const int y0 = (h - side) / 2, x0 = (w - side) / 2;
  cv::Mat crop = bgr(cv::Rect(x0, y0, side, side));
  cv::Mat resized;
  if (side == size) {
    resized = crop;
  } else {
    // INTER_LINEAR: cv2.resize's default, matching the python path
    cv::resize(crop, resized, cv::Size(size, size), 0, 0, cv::INTER_LINEAR);
  }
  cv::cvtColor(resized, *rgb_out, cv::COLOR_BGR2RGB);
}

// Codec decode is inherently sequential (cap.read), but the per-frame
// tail — centre-crop, resize, BGR->RGB, optional f32 convert, copy into
// the batch buffer — is not. This pool overlaps that tail with the
// decode: the reader thread clones each kept frame and hands it to a
// worker with its PREASSIGNED output slot, so the result is bit-identical
// to the sequential loop regardless of scheduling; the codec alone then
// bounds the decode.
class PostprocPool {
 public:
  // convert_f32: write float32/256.0 instead of uint8
  PostprocPool(int size, bool convert_f32, uint8_t* out_u8, float* out_f32)
      : size_(size), convert_f32_(convert_f32), out_u8_(out_u8),
        out_f32_(out_f32) {
    int n = static_cast<int>(std::thread::hardware_concurrency());
    if (n < 1) n = 1;
    if (n > 8) n = 8;  // the tail is memory-bound past a few cores
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Run(); });
  }

  ~PostprocPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Takes ownership of bgr (move); slot is the output frame index.
  void Submit(cv::Mat&& bgr, int slot) {
    std::unique_lock<std::mutex> lk(mu_);
    full_cv_.wait(lk, [this] { return queue_.size() < 16 || done_; });
    queue_.emplace_back(std::move(bgr), slot);
    cv_.notify_one();
  }

  // Wait until every submitted frame is written.
  void Drain() {
    std::unique_lock<std::mutex> lk(mu_);
    drained_cv_.wait(lk, [this] { return queue_.empty() && active_ == 0; });
  }

 private:
  void Run() {
    cv::Mat rgb, f32;
    for (;;) {
      std::pair<cv::Mat, int> item;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return !queue_.empty() || done_; });
        if (queue_.empty()) return;
        item = std::move(queue_.front());
        queue_.pop_front();
        ++active_;
        full_cv_.notify_one();
      }
      const size_t frame_elems = static_cast<size_t>(size_) * size_ * 3;
      CropResizeRgb(item.first, size_, &rgb);
      if (convert_f32_) {
        rgb.convertTo(f32, CV_32FC3, 1.0 / 256.0);
        std::memcpy(out_f32_ + item.second * frame_elems, f32.ptr<float>(),
                    frame_elems * sizeof(float));
      } else {
        std::memcpy(out_u8_ + item.second * frame_elems, rgb.data,
                    frame_elems);
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        --active_;
        if (queue_.empty() && active_ == 0) drained_cv_.notify_all();
      }
    }
  }

  const int size_;
  const bool convert_f32_;
  uint8_t* const out_u8_;
  float* const out_f32_;
  std::vector<std::thread> workers_;
  std::deque<std::pair<cv::Mat, int>> queue_;
  std::mutex mu_;
  std::condition_variable cv_, full_cv_, drained_cv_;
  int active_ = 0;
  bool done_ = false;
};

}  // namespace

extern "C" {

void* vd_open(const char* path) {
  auto* d = new Decoder();
  if (!d->cap.open(path)) {
    delete d;
    return nullptr;
  }
  return d;
}

void vd_close(void* handle) { delete static_cast<Decoder*>(handle); }

// n_frames may be 0 for streams whose container lies; fps may be 0.
void vd_info(void* handle, int* n_frames, int* width, int* height,
             double* fps) {
  auto* d = static_cast<Decoder*>(handle);
  *n_frames = static_cast<int>(d->cap.get(cv::CAP_PROP_FRAME_COUNT));
  *width = static_cast<int>(d->cap.get(cv::CAP_PROP_FRAME_WIDTH));
  *height = static_cast<int>(d->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
  *fps = d->cap.get(cv::CAP_PROP_FPS);
}

// Read up to max_frames frames (every stride-th), centre-crop square,
// resize to (size, size), RGB uint8 into out (max_frames, size, size, 3).
// Returns the number of frames written.
int vd_read_frames_u8(void* handle, int size, int stride, int max_frames,
                      uint8_t* out) {
  auto* d = static_cast<Decoder*>(handle);
  PostprocPool pool(size, /*convert_f32=*/false, out, nullptr);
  cv::Mat bgr;
  int written = 0;
  while (written < max_frames && d->cap.read(bgr)) {
    if (d->idx++ % stride) continue;
    pool.Submit(bgr.clone(), written);  // clone: cap.read reuses its buffer
    ++written;
  }
  pool.Drain();
  return written;
}

// Same, but float32 in [0,1) — the /256 convention.
int vd_read_frames_f32(void* handle, int size, int stride, int max_frames,
                       float* out) {
  auto* d = static_cast<Decoder*>(handle);
  PostprocPool pool(size, /*convert_f32=*/true, nullptr, out);
  cv::Mat bgr;
  int written = 0;
  while (written < max_frames && d->cap.read(bgr)) {
    if (d->idx++ % stride) continue;
    pool.Submit(bgr.clone(), written);
    ++written;
  }
  pool.Drain();
  return written;
}

// ETL parity path: dump fps-resampled frames as <out_dir>/%04d.jpg
// (1-based, the reference's run_ffmpeg layout, run.py:31-57). ``step`` is
// source frames per kept frame (>= 1.0); the fractional keep rule
// (keep when i >= next_keep, next_keep += step) matches
// pose3d_tpu/pipeline/video.py::iter_frames exactly, so native and python
// extraction choose identical frames. Returns frames written.
int vd_extract_jpegs(const char* path, const char* out_dir, int quality,
                     double step) {
  cv::VideoCapture cap(path);
  if (!cap.isOpened()) return -1;
  if (step < 1.0) step = 1.0;
  std::vector<int> params = {cv::IMWRITE_JPEG_QUALITY, quality};
  cv::Mat bgr;
  int n = 0, i = 0;
  double next_keep = 0.0;
  char name[4096];
  while (cap.read(bgr)) {
    if (i++ >= next_keep) {
      next_keep += step;
      std::snprintf(name, sizeof(name), "%s/%04d.jpg", out_dir, ++n);
      if (!cv::imwrite(name, bgr, params)) return -1;
    }
  }
  return n;
}

// fps of the container (0 when unknown) — lets the caller compute step.
double vd_fps(const char* path) {
  cv::VideoCapture cap(path);
  if (!cap.isOpened()) return -1.0;
  return cap.get(cv::CAP_PROP_FPS);
}

}  // extern "C"
