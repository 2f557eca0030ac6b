// dynfu_tpu native data loader: threaded 16-bit PNG depth-frame decoder.
//
// Native-runtime counterpart of the reference's C++ dataset path
// (DynFuApp::loadFiles + cv::imread per frame, src/apps/demo.cpp:39-55,85-90):
// a worker pool decodes depth PNGs ahead of the consumer so the device never
// waits on host-side image decode. Exposed as a minimal C ABI consumed from
// Python via ctypes (io/native_loader.py).
//
// Decoding needs no PNG library: the chunks are parsed here, the IDAT
// stream is inflated by zlib's uncompress() (resolved from libz.so.1 at
// run time, so building needs no zlib headers), and the row filters are
// undone here; frames are delivered strictly in order through a
// fixed-capacity slot ring guarded by a mutex + condvars.

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    std::vector<uint16_t> data;
    int height = 0;
    int width = 0;
    bool ready = false;
    bool failed = false;
};

// zlib's uncompress(dest, &dest_len, src, src_len) -> Z_OK (0)
using UncompressFn = int (*)(unsigned char *, unsigned long *,
                             const unsigned char *, unsigned long);

UncompressFn zlib_uncompress() {
    static const UncompressFn fn = [] {
        void *h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
        if (!h) h = dlopen("libz.so", RTLD_NOW | RTLD_LOCAL);
        return h ? reinterpret_cast<UncompressFn>(dlsym(h, "uncompress"))
                 : nullptr;
    }();
    return fn;
}

uint32_t be32(const unsigned char *p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
    int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
    return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Decode one non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG
// into out as its first channel widened to uint16 (io/meshio.load_depth_png
// semantics). Returns false on any error.
bool decode_png(const std::string &path, Frame &out) {
    FILE *fp = std::fopen(path.c_str(), "rb");
    if (!fp) return false;
    std::vector<unsigned char> file;
    unsigned char buf[1 << 16];
    size_t n;
    while ((n = std::fread(buf, 1, sizeof buf, fp)) > 0)
        file.insert(file.end(), buf, buf + n);
    std::fclose(fp);

    static const unsigned char kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (file.size() < 8 || std::memcmp(file.data(), kSig, 8) != 0) return false;
    uint32_t width = 0, height = 0;
    int depth = 0, channels = 0;
    std::vector<unsigned char> idat;
    for (size_t pos = 8; pos + 12 <= file.size();) {
        uint32_t len = be32(&file[pos]);
        const unsigned char *type = &file[pos + 4], *data = &file[pos + 8];
        if (len > file.size() - pos - 12) return false;
        if (std::memcmp(type, "IHDR", 4) == 0 && len >= 13) {
            width = be32(data);
            height = be32(data + 4);
            depth = data[8];
            static const int kChannels[7] = {1, 0, 3, 0, 2, 0, 4};
            channels = data[9] <= 6 ? kChannels[data[9]] : 0;
            if (data[10] != 0 || data[11] != 0 || data[12] != 0) return false;
        } else if (std::memcmp(type, "IDAT", 4) == 0) {
            idat.insert(idat.end(), data, data + len);
        } else if (std::memcmp(type, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + size_t(len);
    }
    if (width == 0 || height == 0 || channels == 0 || (depth != 8 && depth != 16))
        return false;
    const size_t bpp = size_t(channels) * (depth / 8);
    const size_t stride = bpp * width;
    std::vector<unsigned char> raw(height * (stride + 1));
    unsigned long raw_len = raw.size();
    UncompressFn inflate = zlib_uncompress();
    if (!inflate || inflate(raw.data(), &raw_len, idat.data(), idat.size()) != 0 ||
        raw_len != raw.size())
        return false;

    // undo the row filters in place (PNG spec section 9)
    std::vector<unsigned char> zero(stride, 0);
    for (uint32_t y = 0; y < height; ++y) {
        unsigned char *row = &raw[y * (stride + 1)];
        const unsigned char ftype = row[0];
        unsigned char *cur = row + 1;
        const unsigned char *prev = y ? &raw[(y - 1) * (stride + 1) + 1] : zero.data();
        for (size_t i = 0; i < stride; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i];
            int c = i >= bpp ? prev[i - bpp] : 0, pred;
            switch (ftype) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: pred = paeth(a, b, c); break;
                default: return false;
            }
            cur[i] = static_cast<unsigned char>(cur[i] + pred);
        }
    }

    out.height = static_cast<int>(height);
    out.width = static_cast<int>(width);
    out.data.resize(size_t(height) * width);
    for (uint32_t y = 0; y < height; ++y) {
        const unsigned char *cur = &raw[y * (stride + 1) + 1];
        uint16_t *dst = out.data.data() + size_t(y) * width;
        for (uint32_t x = 0; x < width; ++x) {
            const unsigned char *px = cur + x * bpp;  // first channel
            dst[x] = depth == 16 ? uint16_t((px[0] << 8) | px[1]) : px[0];
        }
    }
    return true;
}

class Loader {
  public:
    Loader(std::vector<std::string> paths, int queue_depth, int n_threads)
        : paths_(std::move(paths)),
          ring_(std::max(queue_depth, 1)),
          next_to_decode_(0),
          stop_(false) {
        int n = std::max(n_threads, 1);
        for (int i = 0; i < n; ++i)
            workers_.emplace_back([this] { work(); });
    }

    ~Loader() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_space_.notify_all();
        cv_ready_.notify_all();
        for (auto &t : workers_) t.join();
    }

    // Copy frame `index` into out (row-major uint16). Blocks until decoded.
    // Returns 0 ok, 1 decode failure, 2 index out of range, 3 buffer
    // small, 4 loader stopped, 5 timeout (watchdog: a stuck worker or a
    // scheduling bug must surface as a diagnosable error, never a hang —
    // a full-suite run once deadlocked here, see work()'s grant order).
    int get(size_t index, uint16_t *out, int *h, int *w, size_t capacity) {
        if (index >= paths_.size()) return 2;
        std::unique_lock<std::mutex> lk(mu_);
        Slot &s = ring_[index % ring_.size()];
        bool ok_pred = cv_ready_.wait_for(lk, std::chrono::seconds(120), [&] {
            return stop_ || (s.index == index && (s.frame.ready || s.frame.failed));
        });
        if (!ok_pred) return 5;
        if (stop_ && !(s.index == index && s.frame.ready)) return 4;
        if (s.frame.failed) {
            // the failure has been DELIVERED: release the slot (leaving it
            // unconsumed would wedge every later claim of this slot)
            s.consumed = true;
            cv_space_.notify_all();
            return 1;
        }
        if (s.frame.data.size() > capacity) return 3;
        *h = s.frame.height;
        *w = s.frame.width;
        std::memcpy(out, s.frame.data.data(),
                    s.frame.data.size() * sizeof(uint16_t));
        s.consumed = true;
        cv_space_.notify_all();
        return 0;
    }

    size_t size() const { return paths_.size(); }

  private:
    struct Slot {
        size_t index = SIZE_MAX;
        Frame frame;
        bool consumed = true;
    };

    void work() {
        for (;;) {
            size_t idx;
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (stop_ || next_to_decode_ >= paths_.size()) return;
                idx = next_to_decode_++;
                Slot &s = ring_[idx % ring_.size()];
                const size_t R = ring_.size();
                // ORDERED slot grant: the slot may only be taken when its
                // occupant is exactly this claim's predecessor (idx - R,
                // consumed). A bare "empty or consumed" predicate lets an
                // unordered condvar wakeup hand the slot to claim idx+R
                // ahead of idx when two workers wait on the same slot
                // (threads > queue_depth) — the consumer then waits for
                // idx forever while idx's worker waits for the consumer:
                // deadlock (observed as a full-suite hang).
                cv_space_.wait(lk, [&] {
                    if (stop_) return true;
                    if (idx < R) return s.index == SIZE_MAX;
                    return s.index == idx - R && s.consumed;
                });
                if (stop_) return;
                s.index = idx;
                s.consumed = false;
                s.frame = Frame{};
            }
            Frame f;
            bool ok = decode_png(paths_[idx], f);
            {
                std::lock_guard<std::mutex> lk(mu_);
                Slot &s = ring_[idx % ring_.size()];
                s.frame = std::move(f);
                s.frame.ready = ok;
                s.frame.failed = !ok;
            }
            cv_ready_.notify_all();
        }
    }

    std::vector<std::string> paths_;
    std::vector<Slot> ring_;
    size_t next_to_decode_;
    bool stop_;
    std::mutex mu_;
    std::condition_variable cv_ready_, cv_space_;
    std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void *dfl_open(const char **paths, int n_paths, int queue_depth, int n_threads) {
    std::vector<std::string> p(paths, paths + n_paths);
    return new Loader(std::move(p), queue_depth, n_threads);
}

int dfl_get(void *handle, size_t index, uint16_t *out, int *h, int *w,
            size_t capacity) {
    return static_cast<Loader *>(handle)->get(index, out, h, w, capacity);
}

size_t dfl_size(void *handle) { return static_cast<Loader *>(handle)->size(); }

void dfl_close(void *handle) { delete static_cast<Loader *>(handle); }

// 1 when zlib's uncompress() resolved, so frames can be decoded.
int dfl_zlib_ready() { return zlib_uncompress() != nullptr; }

// Single-shot decode without a loader (for probing / tests).
int dfl_decode_one(const char *path, uint16_t *out, int *h, int *w,
                   size_t capacity) {
    Frame f;
    if (!decode_png(path, f)) return 1;
    if (f.data.size() > capacity) return 3;
    *h = f.height;
    *w = f.width;
    std::memcpy(out, f.data.data(), f.data.size() * sizeof(uint16_t));
    return 0;
}

}  // extern "C"
