// tpgsd native I/O core: batched positioned reads/writes with a thread pool.
//
// This is the tpgsd counterpart of the reference's native I/O engine role
// (reference: pgsd/pgsd/pgsd.c - the MPI_File_write_at fan-out,
// pgsd.c:2225-2237): many disjoint-offset writes of one chunk's shards
// made concurrently.  Here the concurrency is C++ threads inside one
// process (per-host), with the GIL released for the whole batch; across
// hosts, each process writes only its own shards (see
// tpgsd/parallel/shard_io.py).
//
// C ABI only - consumed from Python via ctypes (no pybind11 in this
// environment).  All functions return 0 on success or -errno.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// Full-write loop: pwrite until every byte lands (short writes retried).
int pwrite_full(int fd, const char* buf, size_t len, off_t off) {
    while (len > 0) {
        ssize_t n = ::pwrite(fd, buf, len, off);
        if (n < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        buf += n;
        len -= static_cast<size_t>(n);
        off += n;
    }
    return 0;
}

int pread_full(int fd, char* buf, size_t len, off_t off) {
    while (len > 0) {
        ssize_t n = ::pread(fd, buf, len, off);
        if (n < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (n == 0) return -EIO;  // unexpected EOF
        buf += n;
        len -= static_cast<size_t>(n);
        off += n;
    }
    return 0;
}

// O_DIRECT granule: covers 512B and 4KiB logical block devices.
constexpr uint64_t kAlign = 4096;
// Per-thread bounce buffer for O_DIRECT writes (page-aligned).
constexpr size_t kBounce = 8u << 20;

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }
uint64_t align_down(uint64_t v) { return v & ~(kAlign - 1); }

// Write one slice, routing the aligned middle through the O_DIRECT fd
// via an aligned bounce buffer and the unaligned head/tail through the
// buffered fd.  The page-cache writeback path can be pathologically
// slow on virtualized block devices; O_DIRECT bypasses it while the
// memcpy into the bounce buffer costs ~1% of the direct write time.
int pwrite_direct_split(int fd, int fd_direct, const char* buf, uint64_t len,
                        int64_t off, char* bounce) {
    uint64_t head = std::min<uint64_t>(align_up(off) - off, len);
    if (head > 0) {
        int rc = pwrite_full(fd, buf, head, off);
        if (rc != 0) return rc;
        buf += head;
        off += head;
        len -= head;
    }
    uint64_t mid = align_down(len);
    while (mid > 0) {
        size_t chunk = std::min<uint64_t>(mid, kBounce);
        std::memcpy(bounce, buf, chunk);
        ssize_t w = ::pwrite(fd_direct, bounce, chunk, off);
        if (w < 0) {
            if (errno == EINTR) continue;
            // O_DIRECT can fail at runtime (e.g. FS fallback): degrade
            // to the buffered fd for the rest of this slice
            return pwrite_full(fd, buf, len, off);
        }
        buf += w;
        off += w;
        len -= static_cast<uint64_t>(w);
        mid -= static_cast<uint64_t>(w);
    }
    if (len > 0) return pwrite_full(fd, buf, len, off);
    return 0;
}

// Read one slice, routing the aligned middle through the O_DIRECT fd
// via an aligned bounce buffer and the unaligned head/tail through the
// buffered fd - the read twin of pwrite_direct_split.  Cold reads on
// virtualized block devices pay the same page-cache tax as writes
// (readahead heuristics + per-page accounting); O_DIRECT sends large
// device-sized requests while the memcpy out of the bounce buffer is
// noise.  Any O_DIRECT hiccup (EINVAL fallback FS, short read leaving
// the offset unaligned, unexpected EOF) degrades to the buffered fd
// for the rest of the slice.
int pread_direct_split(int fd, int fd_direct, char* buf, uint64_t len,
                       int64_t off, char* bounce) {
    uint64_t head = std::min<uint64_t>(align_up(off) - off, len);
    if (head > 0) {
        int rc = pread_full(fd, buf, head, off);
        if (rc != 0) return rc;
        buf += head;
        off += head;
        len -= head;
    }
    while (align_down(len) > 0 && (off & (kAlign - 1)) == 0) {
        size_t chunk = std::min<uint64_t>(align_down(len), kBounce);
        ssize_t r = ::pread(fd_direct, bounce, chunk, off);
        if (r < 0) {
            if (errno == EINTR) continue;
            return pread_full(fd, buf, len, off);
        }
        if (r == 0) return pread_full(fd, buf, len, off);
        std::memcpy(buf, bounce, static_cast<size_t>(r));
        buf += r;
        off += r;
        len -= static_cast<uint64_t>(r);
    }
    if (len > 0) return pread_full(fd, buf, len, off);
    return 0;
}

}  // namespace

extern "C" {

struct TioSlice {
    const void* buf;
    uint64_t len;
    int64_t off;
};

// Open a second descriptor on the same path with O_DIRECT; returns the
// fd or -errno (callers fall back to buffered-only when negative).
int tio_open_direct(const char* path) {
    int fd = ::open(path, O_WRONLY | O_DIRECT | O_CLOEXEC);
    return fd >= 0 ? fd : -errno;
}

// Read twin: O_DIRECT descriptor for the split read path.
int tio_open_direct_read(const char* path) {
    int fd = ::open(path, O_RDONLY | O_DIRECT | O_CLOEXEC);
    return fd >= 0 ? fd : -errno;
}

// Write every slice at its offset.  n_threads > 1 fans the slices out
// over a transient thread team; slices are claimed atomically so large
// and small slices balance.  Offsets must be disjoint.  When
// fd_direct >= 0, slices of at least direct_threshold bytes route their
// aligned middle through O_DIRECT (each worker owns an aligned bounce
// buffer).
int tio_pwrite_batch2(int fd, int fd_direct, const TioSlice* slices,
                      int64_t n, int n_threads, uint64_t direct_threshold) {
    if (n <= 0) return 0;
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);
    auto work = [&]() {
        char* bounce = nullptr;
        for (;;) {
            int64_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n || err.load(std::memory_order_relaxed) != 0) break;
            const char* buf = static_cast<const char*>(slices[i].buf);
            int rc;
            if (fd_direct >= 0 && slices[i].len >= direct_threshold) {
                if (bounce == nullptr &&
                    posix_memalign(reinterpret_cast<void**>(&bounce), kAlign,
                                   kBounce) != 0) {
                    bounce = nullptr;  // fall through to buffered
                }
                rc = bounce != nullptr
                         ? pwrite_direct_split(fd, fd_direct, buf,
                                               slices[i].len, slices[i].off,
                                               bounce)
                         : pwrite_full(fd, buf, slices[i].len, slices[i].off);
            } else {
                rc = pwrite_full(fd, buf, slices[i].len, slices[i].off);
            }
            if (rc != 0) err.store(rc, std::memory_order_relaxed);
        }
        free(bounce);
    };
    int nt = n_threads < static_cast<int>(n) ? n_threads : static_cast<int>(n);
    if (nt <= 1) {
        work();
        return err.load();
    }
    std::vector<std::thread> team;
    team.reserve(static_cast<size_t>(nt - 1));
    for (int t = 1; t < nt; ++t) team.emplace_back(work);
    work();
    for (auto& th : team) th.join();
    return err.load();
}

int tio_pwrite_batch(int fd, const TioSlice* slices, int64_t n, int n_threads) {
    return tio_pwrite_batch2(fd, -1, slices, n, n_threads, 0);
}

// Read every slice at its offset (parallel strided read-back).  When
// fd_direct >= 0, slices of at least direct_threshold bytes route
// their aligned middle through O_DIRECT - the read twin of
// tio_pwrite_batch2.
int tio_pread_batch2(int fd, int fd_direct, const TioSlice* slices,
                     int64_t n, int n_threads, uint64_t direct_threshold) {
    if (n <= 0) return 0;
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);
    auto work = [&]() {
        char* bounce = nullptr;
        for (;;) {
            int64_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n || err.load(std::memory_order_relaxed) != 0) break;
            char* buf =
                const_cast<char*>(static_cast<const char*>(slices[i].buf));
            int rc;
            if (fd_direct >= 0 && slices[i].len >= direct_threshold) {
                if (bounce == nullptr &&
                    posix_memalign(reinterpret_cast<void**>(&bounce), kAlign,
                                   kBounce) != 0) {
                    bounce = nullptr;  // fall through to buffered
                }
                rc = bounce != nullptr
                         ? pread_direct_split(fd, fd_direct, buf,
                                              slices[i].len, slices[i].off,
                                              bounce)
                         : pread_full(fd, buf, slices[i].len, slices[i].off);
            } else {
                rc = pread_full(fd, buf, slices[i].len, slices[i].off);
            }
            if (rc != 0) err.store(rc, std::memory_order_relaxed);
        }
        free(bounce);
    };
    int nt = n_threads < static_cast<int>(n) ? n_threads : static_cast<int>(n);
    if (nt <= 1) { work(); return err.load(); }
    std::vector<std::thread> team;
    team.reserve(static_cast<size_t>(nt - 1));
    for (int t = 1; t < nt; ++t) team.emplace_back(work);
    work();
    for (auto& th : team) th.join();
    return err.load();
}

int tio_pread_batch(int fd, const TioSlice* slices, int64_t n, int n_threads) {
    return tio_pread_batch2(fd, -1, slices, n, n_threads, 0);
}

// Read ONE contiguous span, striped over the thread team at aligned
// boundaries.  This is the read path for a frame's contiguous byte
// span (tpgsd/fl.py read_all_chunks fast path) and any other large
// single pread: the span is cut into >=8 MiB stripes whose offsets
// stay kAlign-aligned, each stripe claimed atomically and read through
// pread_direct_split when the span qualifies for O_DIRECT.  Mirrors
// the role of the reference's single MPI_File_read_at per chunk
// (reference: pgsd/pgsd/pgsd.c:2496-2534) with per-host thread
// parallelism instead of per-rank fan-out.
int tio_pread_span2(int fd, int fd_direct, void* buf, uint64_t len,
                    int64_t off, int n_threads, uint64_t direct_threshold) {
    if (len == 0) return 0;
    char* base = static_cast<char*>(buf);
    bool use_direct = fd_direct >= 0 && len >= direct_threshold;
    constexpr uint64_t kMinStripe = 8u << 20;
    uint64_t n_stripes = 1;
    if (n_threads > 1 && len >= 2 * kMinStripe) {
        n_stripes = std::min<uint64_t>(static_cast<uint64_t>(n_threads),
                                       len / kMinStripe);
    }
    if (n_stripes <= 1) {
        if (!use_direct) return pread_full(fd, base, len, off);
        char* bounce = nullptr;
        if (posix_memalign(reinterpret_cast<void**>(&bounce), kAlign,
                           kBounce) != 0) {
            return pread_full(fd, base, len, off);
        }
        int rc = pread_direct_split(fd, fd_direct, base, len, off, bounce);
        free(bounce);
        return rc;
    }
    // stripe boundaries land on kAlign multiples of the FILE offset so
    // every stripe's O_DIRECT middle starts aligned
    uint64_t stripe = align_up(len / n_stripes);
    std::atomic<uint64_t> next(0);
    std::atomic<int> err(0);
    auto work = [&]() {
        char* bounce = nullptr;
        for (;;) {
            uint64_t i = next.fetch_add(1, std::memory_order_relaxed);
            uint64_t start = i * stripe;
            if (start >= len || err.load(std::memory_order_relaxed) != 0)
                break;
            uint64_t sl = std::min<uint64_t>(stripe, len - start);
            int rc;
            if (use_direct) {
                if (bounce == nullptr &&
                    posix_memalign(reinterpret_cast<void**>(&bounce), kAlign,
                                   kBounce) != 0) {
                    bounce = nullptr;
                }
                rc = bounce != nullptr
                         ? pread_direct_split(fd, fd_direct, base + start, sl,
                                              off + static_cast<int64_t>(start),
                                              bounce)
                         : pread_full(fd, base + start, sl,
                                      off + static_cast<int64_t>(start));
            } else {
                rc = pread_full(fd, base + start, sl,
                                off + static_cast<int64_t>(start));
            }
            if (rc != 0) err.store(rc, std::memory_order_relaxed);
        }
        free(bounce);
    };
    int nt = static_cast<int>(
        std::min<uint64_t>(static_cast<uint64_t>(n_threads), n_stripes));
    std::vector<std::thread> team;
    team.reserve(static_cast<size_t>(nt - 1));
    for (int t = 1; t < nt; ++t) team.emplace_back(work);
    work();
    for (auto& th : team) th.join();
    return err.load();
}

int tio_pwrite(int fd, const void* buf, uint64_t len, int64_t off) {
    return pwrite_full(fd, static_cast<const char*>(buf), len, off);
}

int tio_pread(int fd, void* buf, uint64_t len, int64_t off) {
    return pread_full(fd, static_cast<char*>(buf), len, off);
}

// Gathered sequential write at one offset (namelist/index/header blocks
// assembled from pieces without a Python-side join).
int tio_pwritev(int fd, const TioSlice* slices, int64_t n, int64_t off) {
    constexpr int kMaxIov = 64;  // well under every platform's IOV_MAX
    for (int64_t i = 0; i < n;) {
        struct iovec iov[kMaxIov];
        int cnt = 0;
        size_t bytes = 0;
        while (i < n && cnt < static_cast<int>(sizeof(iov) / sizeof(iov[0]))) {
            iov[cnt].iov_base = const_cast<void*>(slices[i].buf);
            iov[cnt].iov_len = slices[i].len;
            bytes += slices[i].len;
            ++cnt;
            ++i;
        }
        size_t written = 0;
        int base = cnt;
        struct iovec* cur = iov;
        while (written < bytes) {
            ssize_t w = ::pwritev(fd, cur, base, off + written);
            if (w < 0) {
                if (errno == EINTR) continue;
                return -errno;
            }
            written += static_cast<size_t>(w);
            // advance iovec past fully written pieces
            size_t adv = static_cast<size_t>(w);
            while (base > 0 && adv >= cur->iov_len) {
                adv -= cur->iov_len;
                ++cur;
                --base;
            }
            if (base > 0 && adv > 0) {
                cur->iov_base = static_cast<char*>(cur->iov_base) + adv;
                cur->iov_len -= adv;
            }
        }
        off += written;
    }
    return 0;
}

int tio_fsync(int fd) { return ::fsync(fd) == 0 ? 0 : -errno; }

int64_t tio_file_size(int fd) {
    struct stat st;
    if (::fstat(fd, &st) != 0) return -errno;
    return st.st_size;
}

}  // extern "C"
