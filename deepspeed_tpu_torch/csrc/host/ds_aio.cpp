// Async host I/O engine — the DeepNVMe analog (the port's copy of
// csrc/aio/ds_aio.cpp).
//
// Role of the reference's libaio stack (csrc/aio/common/deepspeed_aio_common.cpp,
// csrc/aio/py_lib/deepspeed_py_aio_handle.cpp: aio_handle with block_size,
// queue_depth, single_submit, overlap_events, thread_count): saturate a
// local NVMe device with deep-queue async reads/writes of tensor shards so
// ZeRO-Infinity can swap parameter/optimizer state without stalling compute.
//
// Two engines, chosen at handle creation:
//
//  * KERNEL AIO (preferred): Linux native AIO via raw syscalls
//    (io_setup/io_submit/io_getevents — the same interface libaio wraps,
//    no library dependency) over O_DIRECT descriptors.  Requests are cut
//    into block_size chunks, each chunk an iocb against a 512-aligned
//    bounce buffer (posix_memalign; numpy buffers aren't sector-aligned),
//    up to queue_depth in flight.  O_DIRECT bypasses the page cache, so
//    sustained throughput tracks the device, not memcpy-to-cache.
//    Filesystems that reject O_DIRECT (tmpfs) demote the handle to the
//    thread pool at open time.
//  * THREAD POOL (fallback): chunked pread/pwrite fanned across a
//    pthread pool — portable, correct everywhere.
//
// The C ABI below is consumed via ctypes from deepspeed_tpu_torch/ops/aio/aio.py.
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <linux/aio_abi.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// O_DIRECT transfer granularity.  512 covers most devices; NVMe
// formatted with 4096-byte logical blocks accepts the open but returns
// EINVAL at io_submit — that case demotes to the thread pool at wait()
// (and the engine is marked dead so later requests skip it), or set
// DS_AIO_SECTOR=4096 to keep kernel AIO on such devices.
static int64_t sector_size() {
    static int64_t s = [] {
        const char* e = getenv("DS_AIO_SECTOR");
        long v = e ? atol(e) : 0;
        return (v >= 512 && (v & (v - 1)) == 0) ? v : 512;
    }();
    return s;
}

static long sys_io_setup(unsigned nr, aio_context_t* ctx) { return syscall(SYS_io_setup, nr, ctx); }
static long sys_io_destroy(aio_context_t ctx) { return syscall(SYS_io_destroy, ctx); }
static long sys_io_submit(aio_context_t ctx, long n, struct iocb** ios) {
    return syscall(SYS_io_submit, ctx, n, ios);
}
static long sys_io_getevents(aio_context_t ctx, long min_nr, long nr, struct io_event* ev,
                             struct timespec* ts) {
    return syscall(SYS_io_getevents, ctx, min_nr, nr, ev, ts);
}

static int64_t round_up(int64_t x, int64_t a) { return (x + a - 1) / a * a; }

// ---------------------------------------------------------------------------
// thread-pool engine (portable fallback)
// ---------------------------------------------------------------------------

struct Request {
    int fd = -1;
    char* buf = nullptr;
    int64_t nbytes = 0;
    int64_t file_offset = 0;
    bool is_read = false;
    std::atomic<int64_t> chunks_left{0};
    std::atomic<bool> failed{false};
};

struct Chunk {
    Request* req;
    int64_t offset;  // within the request
    int64_t len;
};

class ThreadPoolEngine {
  public:
    ThreadPoolEngine(int64_t block_size, int thread_count) : block_size_(block_size) {
        int n = thread_count > 0 ? thread_count : 1;
        for (int i = 0; i < n; ++i) workers_.emplace_back([this] { worker(); });
    }

    ~ThreadPoolEngine() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
        for (auto* r : inflight_) delete r;
    }

    bool submit(int fd, char* buf, int64_t nbytes, bool is_read, int64_t file_offset) {
        auto* req = new Request();
        req->fd = fd;
        req->buf = buf;
        req->nbytes = nbytes;
        req->file_offset = file_offset;
        req->is_read = is_read;
        int64_t nchunks = (nbytes + block_size_ - 1) / block_size_;
        if (nchunks == 0) nchunks = 1;
        req->chunks_left.store(nchunks);
        {
            std::lock_guard<std::mutex> lk(mu_);
            inflight_.push_back(req);
            for (int64_t c = 0; c < nchunks; ++c) {
                int64_t off = c * block_size_;
                queue_.push_back({req, off, std::min(block_size_, nbytes - off)});
            }
            ++pending_requests_;
        }
        cv_.notify_all();
        return true;
    }

    int64_t wait() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_requests_ == 0; });
        int64_t n = completed_since_wait_;
        completed_since_wait_ = 0;
        bool ok = true;
        for (auto* r : inflight_) {
            ok = ok && !r->failed.load();
            ::close(r->fd);
            delete r;
        }
        inflight_.clear();
        return ok ? n : -1;
    }

  private:
    void worker() {
        for (;;) {
            Chunk ch;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                ch = queue_.front();
                queue_.pop_front();
            }
            Request* r = ch.req;
            int64_t remaining = ch.len;
            int64_t off = ch.offset;
            bool ok = true;
            while (remaining > 0) {
                ssize_t n = r->is_read
                                ? ::pread(r->fd, r->buf + off, remaining, r->file_offset + off)
                                : ::pwrite(r->fd, r->buf + off, remaining, r->file_offset + off);
                if (n <= 0) {
                    ok = false;
                    break;
                }
                off += n;
                remaining -= n;
            }
            if (!ok) r->failed.store(true);
            if (r->chunks_left.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lk(mu_);
                --pending_requests_;
                ++completed_since_wait_;
                if (pending_requests_ == 0) done_cv_.notify_all();
            }
        }
    }

    int64_t block_size_;
    std::vector<std::thread> workers_;
    std::deque<Chunk> queue_;
    std::vector<Request*> inflight_;
    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    int64_t pending_requests_ = 0;
    int64_t completed_since_wait_ = 0;
    bool stop_ = false;
};

// ---------------------------------------------------------------------------
// kernel-AIO engine (O_DIRECT + io_submit deep queues)
// ---------------------------------------------------------------------------

struct AioRequest {
    int fd = -1;
    char* user_buf = nullptr;   // caller's (unaligned) buffer
    char* bounce = nullptr;     // sector-aligned bounce region
    int64_t nbytes = 0;         // true payload size
    int64_t padded = 0;         // sector-rounded size on the wire
    int64_t file_offset = 0;
    bool is_read = false;
    int64_t chunks_left = 0;
    int64_t copied = 0;         // payload bytes actually delivered (reads)
    bool failed = false;
};

struct AioChunk {
    AioRequest* req;
    struct iocb cb;  // PADDED chunk against the bounce buffer
};

class KernelAioEngine {
  public:
    KernelAioEngine(int64_t block_size, int queue_depth)
        : block_size_(round_up(block_size, sector_size())), queue_depth_(queue_depth) {
        ok_ = sys_io_setup(queue_depth_, &ctx_) == 0;
    }

    ~KernelAioEngine() {
        if (ok_) sys_io_destroy(ctx_);
        for (auto* r : inflight_) free_request(r);
    }

    bool available() const { return ok_ && !submit_failed_; }

    // Writes must arrive sector-aligned in length (the handle routes any
    // unaligned tail through the buffered engine — zero-padding a write
    // would clobber pre-existing bytes past the payload); reads may be
    // any length (the bounce copy-back clips to the real payload).
    bool submit(int fd, char* buf, int64_t nbytes, bool is_read, int64_t file_offset) {
        auto* req = new AioRequest();
        req->fd = fd;
        req->user_buf = buf;
        req->nbytes = nbytes;
        req->padded = is_read ? round_up(std::max<int64_t>(nbytes, 1), sector_size()) : nbytes;
        req->file_offset = file_offset;
        req->is_read = is_read;
        if (posix_memalign(reinterpret_cast<void**>(&req->bounce), 4096, req->padded) != 0) {
            delete req;
            return false;
        }
        if (!is_read) std::memcpy(req->bounce, buf, nbytes);
        int64_t nchunks = (req->padded + block_size_ - 1) / block_size_;
        req->chunks_left = nchunks;
        inflight_.push_back(req);
        for (int64_t c = 0; c < nchunks; ++c) {
            int64_t off = c * block_size_;
            int64_t len = std::min(block_size_, req->padded - off);
            // heap-owned: the kernel holds this pointer (aio_data) until
            // the completion event is reaped
            auto* ch = new AioChunk();
            ch->req = req;
            std::memset(&ch->cb, 0, sizeof(ch->cb));
            ch->cb.aio_fildes = fd;
            ch->cb.aio_lio_opcode = is_read ? IOCB_CMD_PREAD : IOCB_CMD_PWRITE;
            ch->cb.aio_buf = reinterpret_cast<uint64_t>(req->bounce + off);
            ch->cb.aio_nbytes = len;
            ch->cb.aio_offset = file_offset + off;
            ch->cb.aio_data = reinterpret_cast<uint64_t>(ch);
            pending_.push_back(ch);
        }
        pump();
        return true;
    }

    // ``failed_out`` (optional): one flag per request in submit order, so
    // the handle can re-run exactly the failed ones through the pool.
    int64_t wait(std::vector<char>* failed_out = nullptr) {
        while (!pending_.empty() || in_kernel_ > 0) {
            pump();
            if (in_kernel_ > 0 && !reap(/*min_nr=*/1)) {
                // io_getevents error with events in flight: tear the
                // context down FIRST — io_destroy cancels/waits the
                // outstanding iocbs, so freeing the bounce buffers
                // below cannot race an in-flight DMA.  The engine is
                // dead afterwards; the handle demotes to the pool.
                sys_io_destroy(ctx_);
                ok_ = false;
                for (auto* r : inflight_) r->failed = true;
                for (auto* ch : pending_) delete ch;
                pending_.clear();
                in_kernel_ = 0;
                break;
            }
        }
        bool ok = true;
        int64_t n = 0;
        if (failed_out) failed_out->clear();
        for (auto* r : inflight_) {
            // a read that could not deliver its full payload is a
            // failure, matching the thread-pool engine's semantics
            bool req_ok = !r->failed && (!r->is_read || r->copied >= r->nbytes);
            ok = ok && req_ok;
            if (failed_out) failed_out->push_back(req_ok ? 0 : 1);
            ::close(r->fd);
            free_request(r);
            ++n;
        }
        inflight_.clear();
        return ok ? n : -1;
    }

  private:
    void free_request(AioRequest* r) {
        std::free(r->bounce);
        delete r;
    }

    // submit as many pending iocbs as the queue allows
    void pump() {
        while (!pending_.empty() && in_kernel_ < queue_depth_) {
            long room = queue_depth_ - in_kernel_;
            std::vector<struct iocb*> batch;
            for (auto it = pending_.begin(); it != pending_.end() && (long)batch.size() < room; ++it)
                batch.push_back(&(*it)->cb);
            long r = sys_io_submit(ctx_, batch.size(), batch.data());
            if (r <= 0) {
                if (in_kernel_ > 0 && reap(1)) continue;  // drain and retry
                // Nothing in flight and the kernel refuses (e.g. EINVAL:
                // 4096-byte-logical-block NVMe rejecting 512-granular
                // iocbs): fail the pending requests and mark the engine
                // unhealthy — the handle re-runs the failed requests
                // through the thread pool at wait() and stops routing
                // here (ADVICE r2: no permanent-failure mode).
                submit_failed_ = true;
                for (auto* ch : pending_) {
                    ch->req->failed = true;
                    delete ch;
                }
                pending_.clear();
                return;
            }
            for (long i = 0; i < r; ++i) pending_.pop_front();
            in_kernel_ += r;
        }
    }

    bool reap(long min_nr) {
        struct io_event events[64];
        long nr = std::min<long>(64, in_kernel_);
        long r;
        do {
            r = sys_io_getevents(ctx_, min_nr, nr, events, nullptr);
        } while (r < 0 && errno == EINTR);  // signals must not fail I/O
        if (r < 0) return false;
        for (long i = 0; i < r; ++i) {
            auto* ch = reinterpret_cast<AioChunk*>(events[i].data);
            AioRequest* req = ch->req;
            if (events[i].res < 0 ||
                (req->is_read ? false : events[i].res != (long long)ch->cb.aio_nbytes))
                req->failed = true;
            if (req->is_read && events[i].res >= 0) {
                // copy only the chunk's real-payload overlap back
                int64_t off = ch->cb.aio_offset - req->file_offset;
                int64_t real = std::min<int64_t>(events[i].res, std::max<int64_t>(req->nbytes - off, 0));
                if (real > 0) std::memcpy(req->user_buf + off, req->bounce + off, real);
                req->copied += std::max<int64_t>(real, 0);
            }
            --req->chunks_left;
            delete ch;
        }
        in_kernel_ -= r;
        return true;
    }

    int64_t block_size_;
    long queue_depth_;
    aio_context_t ctx_ = 0;
    bool ok_ = false;
    bool submit_failed_ = false;
    long in_kernel_ = 0;
    std::deque<AioChunk*> pending_;
    std::vector<AioRequest*> inflight_;
};

// ---------------------------------------------------------------------------
// handle: picks the engine per request (O_DIRECT probe at open)
// ---------------------------------------------------------------------------

class AioHandle {
  public:
    AioHandle(int64_t block_size, int queue_depth, int thread_count)
        : pool_(block_size > 0 ? block_size : (1 << 20), thread_count),
          kaio_(block_size > 0 ? block_size : (1 << 20), queue_depth > 0 ? queue_depth : 32) {
        const char* dis = getenv("DS_AIO_DISABLE_KERNEL_AIO");
        kaio_enabled_ = kaio_.available() && !(dis && dis[0] == '1');
    }

    int64_t submit(const char* path, char* buf, int64_t nbytes, bool is_read, int64_t file_offset) {
        // writes: only the sector-aligned body goes through O_DIRECT; the
        // (<512B) tail rides the buffered pool so no byte past the
        // payload is ever touched.  reads: O_DIRECT end to end (the
        // bounce copy-back clips to the payload).
        int64_t body = is_read ? nbytes : (nbytes / sector_size()) * sector_size();
        if (kaio_enabled_ && file_offset % sector_size() == 0 && body > 0) {
            int flags = (is_read ? O_RDONLY : (O_WRONLY | O_CREAT)) | O_DIRECT;
            int fd = ::open(path, flags, 0644);
            if (fd >= 0) {
                used_kernel_aio_ = true;
                if (!kaio_.submit(fd, buf, body, is_read, file_offset)) {
                    ::close(fd);
                    return -1;
                }
                // record for re-run through the pool if the kernel path
                // fails at io_submit/io_getevents time (wait() below)
                kaio_recs_.push_back(KaioRec{path, buf, body, is_read, file_offset});
                kaio_inflight_ = true;
                if (body == nbytes) {
                    ++user_requests_;
                    return 1;
                }
                // the (<512B) buffered tail must not run CONCURRENTLY
                // with the O_DIRECT body (they can share the file's last
                // page, and mixing direct + page-cache writes to one
                // page is undefined) — defer it until wait() has
                // completed the body
                int tfd = ::open(path, O_WRONLY | O_CREAT, 0644);
                if (tfd < 0) return -1;
                tails_.push_back(PendingTail{tfd, buf + body, nbytes - body, file_offset + body});
                ++user_requests_;  // body+tail are ONE user request
                return 1;
            }
            // EINVAL etc: filesystem rejects O_DIRECT — fall through
        }
        int fd = ::open(path, is_read ? O_RDONLY : (O_WRONLY | O_CREAT), 0644);
        if (fd < 0) return -1;
        pool_inflight_ = true;
        if (!pool_.submit(fd, buf, nbytes, is_read, file_offset)) return -1;
        ++user_requests_;
        return 1;
    }

    int64_t wait() {
        bool ok = true;
        if (kaio_inflight_) {
            std::vector<char> failed;
            bool kaio_ok = kaio_.wait(&failed) >= 0;
            kaio_inflight_ = false;
            if (!kaio_.available()) kaio_enabled_ = false;  // engine unhealthy
            if (!kaio_ok) {
                // Re-run exactly the failed requests through the thread
                // pool (fresh buffered fds).  Safe for both directions:
                // a repeated read refills the same caller buffer, a
                // repeated write rewrites the same payload bytes.
                bool requeued_all = true;
                for (size_t i = 0; i < kaio_recs_.size() && i < failed.size(); ++i) {
                    if (!failed[i]) continue;
                    const KaioRec& rec = kaio_recs_[i];
                    int fd = ::open(rec.path.c_str(),
                                    rec.is_read ? O_RDONLY : (O_WRONLY | O_CREAT), 0644);
                    if (fd < 0 || !pool_.submit(fd, rec.buf, rec.nbytes, rec.is_read, rec.off)) {
                        if (fd >= 0) ::close(fd);
                        requeued_all = false;
                        continue;
                    }
                    pool_inflight_ = true;
                }
                ok = ok && requeued_all;
            }
            kaio_recs_.clear();
        }
        if (pool_inflight_) {
            ok = ok && pool_.wait() >= 0;
            pool_inflight_ = false;
        }
        for (auto& t : tails_) {  // ordered strictly after the bodies
            int64_t done = 0;
            while (done < t.len) {
                ssize_t w = ::pwrite(t.fd, t.buf + done, t.len - done, t.off + done);
                if (w <= 0) {
                    ok = false;
                    break;
                }
                done += w;
            }
            ::close(t.fd);
        }
        tails_.clear();
        int64_t n = user_requests_;
        user_requests_ = 0;
        return ok ? n : -1;
    }

    int used_kernel_aio() const { return used_kernel_aio_ ? 1 : 0; }

  private:
    struct PendingTail {
        int fd;
        const char* buf;
        int64_t len;
        int64_t off;
    };

    struct KaioRec {  // enough to replay a request through the pool
        std::string path;
        char* buf;
        int64_t nbytes;
        bool is_read;
        int64_t off;
    };

    ThreadPoolEngine pool_;
    KernelAioEngine kaio_;
    std::vector<PendingTail> tails_;
    std::vector<KaioRec> kaio_recs_;
    bool kaio_enabled_ = false;
    bool kaio_inflight_ = false;
    bool pool_inflight_ = false;
    bool used_kernel_aio_ = false;
    int64_t user_requests_ = 0;
};

}  // namespace

extern "C" {

void* ds_aio_create(int64_t block_size, int queue_depth, int single_submit,
                    int overlap_events, int thread_count) {
    (void)single_submit;  // submission batching is implicit in the chunk queue
    (void)overlap_events;
    return new AioHandle(block_size, queue_depth, thread_count);
}

void ds_aio_destroy(void* h) { delete static_cast<AioHandle*>(h); }

int64_t ds_aio_pread(void* h, char* buf, int64_t nbytes, const char* path, int64_t file_offset) {
    return static_cast<AioHandle*>(h)->submit(path, buf, nbytes, /*is_read=*/true, file_offset);
}

int64_t ds_aio_pwrite(void* h, const char* buf, int64_t nbytes, const char* path, int64_t file_offset) {
    return static_cast<AioHandle*>(h)->submit(path, const_cast<char*>(buf), nbytes,
                                              /*is_read=*/false, file_offset);
}

int64_t ds_aio_wait(void* h) { return static_cast<AioHandle*>(h)->wait(); }

int ds_aio_used_kernel_aio(void* h) { return static_cast<AioHandle*>(h)->used_kernel_aio(); }

}  // extern "C"
