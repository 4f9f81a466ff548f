// popsift_tpu native host runtime.
//
// Counterpart of the reference's host-side machinery
// (/root/reference/src/popsift/popsift.cpp:33-213 two-stage thread
// pipeline over boost::sync_queue; src/application/pgmread.cpp PNM
// decode; common/plane_2d.{h,cu} pitched/pinned staging planes).
//
// Here the device-compute half of the reference pipeline is one
// asynchronously-dispatched XLA program, so what belongs in native code
// is everything *in front* of the device: file read, PNM decode,
// RGB->gray conversion, staging-buffer reuse, and the worker-thread job
// queue that overlaps disk/decode with device compute. That is exactly
// what this library provides, over a plain C ABI consumed via ctypes
// (popsift_tpu/runtime/native.py).
//
// Components:
//   * PNM codec: P2/P3/P5/P6 read (maxval rescale, OpenCV integer
//     RGB->gray, pgmread.cpp:17-33), P5 write.
//   * SlabPool: aligned, grow-only, reusable staging buffers — the
//     Plane2D/pinned-pool analog (popsift.cpp:19-28 image double-buffer).
//   * Pipeline: N worker threads + bounded job queue + per-job futures —
//     the uploadImages stage (popsift.cpp:171-180) generalized to a pool.
//
// Build: g++ -O2 -fPIC -shared -pthread (see popsift_tpu/runtime/build.py).

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// error codes
// ---------------------------------------------------------------------------
enum PsStatus {
    PS_OK = 0,
    PS_ERR_IO = 1,
    PS_ERR_FORMAT = 2,
    PS_ERR_ARG = 3,
    PS_ERR_STATE = 4,
};

// ---------------------------------------------------------------------------
// PNM decode (pgmread.cpp:17-254 semantics)
// ---------------------------------------------------------------------------

// OpenCV integer RGB->gray coefficients (pgmread.cpp:17-33):
// gray = (R*4899 + G*9617 + B*1868 + 8192) >> 14
static inline uint8_t rgb_to_gray_u8(uint32_t r, uint32_t g, uint32_t b) {
    return (uint8_t)((r * 4899u + g * 9617u + b * 1868u + 8192u) >> 14);
}

namespace {

struct Cursor {
    const uint8_t* p;
    size_t n;
    size_t i;
};

// skip whitespace and '#' comments between header tokens
static bool skip_ws(Cursor& c) {
    for (;;) {
        while (c.i < c.n && isspace(c.p[c.i])) c.i++;
        if (c.i < c.n && c.p[c.i] == '#') {
            while (c.i < c.n && c.p[c.i] != '\n') c.i++;
            continue;
        }
        return c.i < c.n;
    }
}

static bool read_uint(Cursor& c, uint32_t* out) {
    if (!skip_ws(c)) return false;
    if (!isdigit(c.p[c.i])) return false;
    uint64_t v = 0;
    while (c.i < c.n && isdigit(c.p[c.i])) {
        v = v * 10 + (c.p[c.i] - '0');
        if (v > 0xffffffffull) return false;
        c.i++;
    }
    *out = (uint32_t)v;
    return true;
}

}  // namespace

// Decode a PNM (P2/P3/P5/P6) byte buffer into uint8 grayscale.
// On success fills *w/*h and writes into `out` (caller-sized w*h); pass
// out=nullptr to query dimensions only (two-call protocol).
int ps_pnm_decode_gray(const uint8_t* data, size_t len,
                       uint32_t* w, uint32_t* h, uint8_t* out) {
    if (!data || len < 2 || !w || !h) return PS_ERR_ARG;
    if (data[0] != 'P') return PS_ERR_FORMAT;
    int kind = data[1] - '0';
    if (kind != 2 && kind != 3 && kind != 5 && kind != 6)
        return PS_ERR_FORMAT;
    bool color = (kind == 3 || kind == 6);
    bool binary = (kind == 5 || kind == 6);

    Cursor c{data, len, 2};
    uint32_t W, H, maxval;
    if (!read_uint(c, &W) || !read_uint(c, &H) || !read_uint(c, &maxval))
        return PS_ERR_FORMAT;
    if (W == 0 || H == 0 || maxval == 0 || maxval > 65535)
        return PS_ERR_FORMAT;
    *w = W;
    *h = H;
    if (!out) return PS_OK;

    const size_t npix = (size_t)W * H;
    const size_t chans = color ? 3 : 1;

    if (binary) {
        // exactly one whitespace byte after maxval (PNM spec)
        c.i++;
        const size_t bytes_per = (maxval < 256) ? 1 : 2;
        if (c.i + npix * chans * bytes_per > len) return PS_ERR_FORMAT;
        const uint8_t* src = data + c.i;
        if (!color && maxval == 255) {            // fast path: plain P5
            memcpy(out, src, npix);
            return PS_OK;
        }
        for (size_t k = 0; k < npix; k++) {
            uint32_t v[3];
            for (size_t ch = 0; ch < chans; ch++) {
                size_t off = (k * chans + ch) * bytes_per;
                uint32_t raw = (bytes_per == 1)
                    ? src[off]
                    : ((uint32_t)src[off] << 8) | src[off + 1];  // big-endian
                if (maxval != 255) raw = (raw * 255u + maxval / 2) / maxval;
                v[ch] = raw;
            }
            out[k] = color ? rgb_to_gray_u8(v[0], v[1], v[2]) : (uint8_t)v[0];
        }
        return PS_OK;
    }

    // ASCII P2/P3
    for (size_t k = 0; k < npix; k++) {
        uint32_t v[3];
        for (size_t ch = 0; ch < chans; ch++) {
            if (!read_uint(c, &v[ch])) return PS_ERR_FORMAT;
            if (maxval != 255) v[ch] = (v[ch] * 255u + maxval / 2) / maxval;
        }
        out[k] = color ? rgb_to_gray_u8(v[0], v[1], v[2]) : (uint8_t)v[0];
    }
    return PS_OK;
}

// Write a P5 PGM file (write_plane_2d.cu unscaled-u8 variant).
int ps_pgm_write(const char* path, const uint8_t* img,
                 uint32_t w, uint32_t h) {
    if (!path || !img || !w || !h) return PS_ERR_ARG;
    FILE* f = fopen(path, "wb");
    if (!f) return PS_ERR_IO;
    fprintf(f, "P5\n%u %u\n255\n", w, h);
    size_t n = (size_t)w * h;
    size_t written = fwrite(img, 1, n, f);
    fclose(f);
    return written == n ? PS_OK : PS_ERR_IO;
}

// ---------------------------------------------------------------------------
// SlabPool: aligned grow-only reusable buffers (Plane2D analog)
// ---------------------------------------------------------------------------

struct PsSlab {
    uint8_t* data = nullptr;
    size_t cap = 0;
    size_t used = 0;
};

struct PsSlabPool {
    std::mutex mu;
    std::vector<PsSlab*> free_list;
    size_t alignment;
    std::atomic<size_t> total_bytes{0};
};

void* ps_pool_create(size_t alignment) {
    auto* p = new PsSlabPool();
    p->alignment = alignment ? alignment : 4096;
    return p;
}

// Acquire a slab of >= nbytes; reuses (grow-only, like
// ImageBase::resetDimensions, s_image.cu:81-119) or allocates.
PsSlab* ps_pool_acquire(void* pool_, size_t nbytes) {
    auto* pool = (PsSlabPool*)pool_;
    {
        std::lock_guard<std::mutex> lk(pool->mu);
        // best-fit among free slabs
        int best = -1;
        for (int i = 0; i < (int)pool->free_list.size(); i++) {
            PsSlab* s = pool->free_list[i];
            if (s->cap >= nbytes &&
                (best < 0 || s->cap < pool->free_list[best]->cap))
                best = i;
        }
        if (best >= 0) {
            PsSlab* s = pool->free_list[best];
            pool->free_list.erase(pool->free_list.begin() + best);
            s->used = nbytes;
            return s;
        }
    }
    auto* s = new PsSlab();
    size_t cap = (nbytes + pool->alignment - 1) & ~(pool->alignment - 1);
    if (posix_memalign((void**)&s->data, pool->alignment, cap) != 0) {
        delete s;
        return nullptr;
    }
    s->cap = cap;
    s->used = nbytes;
    pool->total_bytes.fetch_add(cap);
    return s;
}

void ps_pool_release(void* pool_, PsSlab* slab) {
    auto* pool = (PsSlabPool*)pool_;
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->free_list.push_back(slab);
}

uint8_t* ps_slab_data(PsSlab* s) { return s ? s->data : nullptr; }
size_t ps_slab_size(PsSlab* s) { return s ? s->used : 0; }
size_t ps_pool_total_bytes(void* pool_) {
    return ((PsSlabPool*)pool_)->total_bytes.load();
}

void ps_pool_destroy(void* pool_) {
    auto* pool = (PsSlabPool*)pool_;
    for (auto* s : pool->free_list) {
        free(s->data);
        delete s;
    }
    delete pool;
}

// ---------------------------------------------------------------------------
// Pipeline: worker threads + bounded queue + futures
// ---------------------------------------------------------------------------
//
// The reference's uploadImages stage pops jobs from _queue_stage1, stages
// the image, and hands it to stage 2 (popsift.cpp:171-180). Here stage 2
// is the Python/JAX dispatcher, so the native side owns: read file ->
// decode PNM -> staged grayscale slab, under a bounded queue so a slow
// consumer applies backpressure.

struct PsJob {
    std::string path;
    // inline-memory submission (decode-only job)
    std::vector<uint8_t> mem;
    bool from_mem = false;

    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    int status = PS_OK;
    PsSlab* slab = nullptr;   // decoded gray pixels
    uint32_t w = 0, h = 0;
    void* pool = nullptr;     // owner pool for release
};

struct PsPipeline {
    std::mutex mu;
    std::condition_variable cv_push;   // waiters for queue space
    std::condition_variable cv_pop;    // workers waiting for jobs
    std::deque<PsJob*> queue;
    size_t capacity;
    bool stopping = false;
    std::vector<std::thread> workers;
    void* pool;
    std::atomic<uint64_t> jobs_done{0};
};

static void ps_worker(PsPipeline* pl) {
    for (;;) {
        PsJob* job = nullptr;
        {
            std::unique_lock<std::mutex> lk(pl->mu);
            pl->cv_pop.wait(lk, [&] { return pl->stopping || !pl->queue.empty(); });
            if (pl->stopping && pl->queue.empty()) return;
            job = pl->queue.front();
            pl->queue.pop_front();
            pl->cv_push.notify_one();
        }

        int status = PS_OK;
        std::vector<uint8_t> filebuf;
        const uint8_t* bytes = nullptr;
        size_t len = 0;
        if (job->from_mem) {
            bytes = job->mem.data();
            len = job->mem.size();
        } else {
            FILE* f = fopen(job->path.c_str(), "rb");
            if (!f) {
                status = PS_ERR_IO;
            } else {
                fseek(f, 0, SEEK_END);
                long sz = ftell(f);
                fseek(f, 0, SEEK_SET);
                if (sz <= 0) {
                    status = PS_ERR_IO;
                } else {
                    filebuf.resize((size_t)sz);
                    if (fread(filebuf.data(), 1, (size_t)sz, f) != (size_t)sz)
                        status = PS_ERR_IO;
                }
                fclose(f);
                bytes = filebuf.data();
                len = filebuf.size();
            }
        }

        uint32_t w = 0, h = 0;
        PsSlab* slab = nullptr;
        if (status == PS_OK) {
            status = ps_pnm_decode_gray(bytes, len, &w, &h, nullptr);
            if (status == PS_OK) {
                slab = ps_pool_acquire(job->pool, (size_t)w * h);
                if (!slab) status = PS_ERR_IO;
                else status = ps_pnm_decode_gray(bytes, len, &w, &h,
                                                 slab->data);
                if (status != PS_OK && slab) {
                    ps_pool_release(job->pool, slab);
                    slab = nullptr;
                }
            }
        }

        {
            std::lock_guard<std::mutex> lk(job->mu);
            job->status = status;
            job->slab = slab;
            job->w = w;
            job->h = h;
            job->done = true;
        }
        job->cv.notify_all();
        pl->jobs_done.fetch_add(1);
    }
}

void* ps_pipeline_create(int n_threads, size_t queue_capacity) {
    auto* pl = new PsPipeline();
    pl->capacity = queue_capacity ? queue_capacity : 8;
    pl->pool = ps_pool_create(4096);
    if (n_threads <= 0) n_threads = 2;
    for (int i = 0; i < n_threads; i++)
        pl->workers.emplace_back(ps_worker, pl);
    return pl;
}

static PsJob* ps_submit(PsPipeline* pl, PsJob* job) {
    job->pool = pl->pool;
    std::unique_lock<std::mutex> lk(pl->mu);
    pl->cv_push.wait(lk, [&] { return pl->stopping ||
                                      pl->queue.size() < pl->capacity; });
    if (pl->stopping) {
        delete job;
        return nullptr;
    }
    pl->queue.push_back(job);
    pl->cv_pop.notify_one();
    return job;
}

// Submit a file path for decode; returns a job handle (or NULL if the
// pipeline is stopping). Blocks when the queue is full (backpressure).
PsJob* ps_pipeline_submit_file(void* pl_, const char* path) {
    auto* pl = (PsPipeline*)pl_;
    auto* job = new PsJob();
    job->path = path;
    return ps_submit(pl, job);
}

// Submit an in-memory PNM byte buffer (copied).
PsJob* ps_pipeline_submit_bytes(void* pl_, const uint8_t* data, size_t len) {
    auto* pl = (PsPipeline*)pl_;
    auto* job = new PsJob();
    job->mem.assign(data, data + len);
    job->from_mem = true;
    return ps_submit(pl, job);
}

// Block until the job completes; returns its status.
int ps_job_wait(PsJob* job) {
    std::unique_lock<std::mutex> lk(job->mu);
    job->cv.wait(lk, [&] { return job->done; });
    return job->status;
}

int ps_job_poll(PsJob* job) {
    std::lock_guard<std::mutex> lk(job->mu);
    return job->done ? 1 : 0;
}

// Valid only after ps_job_wait returned PS_OK.
uint8_t* ps_job_data(PsJob* job, uint32_t* w, uint32_t* h) {
    if (w) *w = job->w;
    if (h) *h = job->h;
    return job->slab ? job->slab->data : nullptr;
}

// Return the job's slab to the pool and free the handle.
void ps_job_release(PsJob* job) {
    if (job->slab) ps_pool_release(job->pool, job->slab);
    delete job;
}

uint64_t ps_pipeline_jobs_done(void* pl_) {
    return ((PsPipeline*)pl_)->jobs_done.load();
}

void ps_pipeline_destroy(void* pl_) {
    auto* pl = (PsPipeline*)pl_;
    {
        std::lock_guard<std::mutex> lk(pl->mu);
        pl->stopping = true;
    }
    pl->cv_pop.notify_all();
    pl->cv_push.notify_all();
    for (auto& t : pl->workers) t.join();
    for (auto* job : pl->queue) delete job;   // never ran
    ps_pool_destroy(pl->pool);
    delete pl;
}

// ---------------------------------------------------------------------------
// Feature text serialization (Feature::print, features.cu:308-328):
// one line per descriptor, "x y 1/s^2 0 1/s^2  d0..d127", optionally
// rounding descriptor components to integers (write_as_uchar).
// The Python per-feature loop costs ~10 us/descriptor; this streams a
// 100k-descriptor set in tens of milliseconds.
// ---------------------------------------------------------------------------
int ps_features_write(const char* path,
                      uint64_t n_desc,
                      const float* x,          // [n_desc] per-descriptor
                      const float* y,
                      const float* sigma,
                      const float* desc,       // [n_desc * 128]
                      int write_as_uchar) {
    if (!path || (!x && n_desc) || (!desc && n_desc)) return PS_ERR_ARG;
    FILE* f = fopen(path, "w");
    if (!f) return PS_ERR_IO;
    std::vector<char> buf(1 << 20);
    setvbuf(f, buf.data(), _IOFBF, buf.size());
    for (uint64_t i = 0; i < n_desc; i++) {
        double s = (double)sigma[i];
        double sv = (s != 0.0) ? 1.0 / (s * s) : 0.0;
        fprintf(f, "%g %g %g 0 %g ", (double)x[i], (double)y[i], sv, sv);
        const float* d = desc + i * 128;
        if (write_as_uchar) {
            for (int k = 0; k < 128; k++)
                fprintf(f, "%d ", (int)lrintf(d[k]));
        } else {
            for (int k = 0; k < 128; k++)
                fprintf(f, "%.3g ", (double)d[k]);
        }
        fputc('\n', f);
    }
    int rc = ferror(f) ? PS_ERR_IO : PS_OK;
    fclose(f);
    return rc;
}

// ---------------------------------------------------------------------------
// version tag
// ---------------------------------------------------------------------------
const char* ps_runtime_version() { return "popsift-tpu-host-runtime 1.1"; }

}  // extern "C"
