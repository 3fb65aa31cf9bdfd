/* Native host library of cudavideostream_tpu_torch: the port's own copy
 * of the JAX package's helper library (native/csrc/cvstpu.c there), built
 * at first use by native/__init__.py and bound with ctypes.
 *
 * The reference's host path is C++ (threads.cpp: pthread ring, pipes,
 * raw sockets). The port keeps the device path in CUDA and these native
 * helpers for the host hot path:
 *
 *   - wire_send_payload: one writev() of [u32 pos][i32 xs][u8 vals]
 *     (the reference does three write() calls, threads.cpp:229-231);
 *     short-write safe.
 *   - wire_send_segments: send of a *tiled* payload (per-unit prefixes
 *     from the kernel) without re-packing in Python: the prefixes
 *     gathered in C into one buffer, one write.
 *   - compact_bitmask: dense (delta, bitmask) -> (xs, vals) packer using
 *     64-bit word scans + ctz; compact_update: the same from the host's
 *     own (cur, prev) with prev updated in place.
 *   - client_apply: uint8 wrap-add scatter (client/opencv.cpp:64-66);
 *     client_decode: the reference client's read loop in C.
 *   - v4l2_*: minimal camera capture (ioctl + mmap), the OpenCV-free
 *     equivalent of tests/cuda_streaming/v4l.cpp.
 *   - wire_encode_v3: the adaptive v3 frame encode straight off tiled
 *     blocks, byte-identical to runtime/wire.py:encode_frame_v3_numpy.
 *
 * Changes from the JAX package's copy: send_iovs waits with poll() when
 * the socket is non-blocking (a Python socket with a timeout is one at
 * the fd level), for at most the socket's timeout, instead of failing
 * with EAGAIN; wire_send_segments gathers the segments into one buffer
 * instead of an iovec each;
 * wire_encode_v3 refuses an out-of-range count or index before it
 * writes; and client_decode takes a receive timeout.
 *
 * Build: cc -O3 -march=native -shared -fPIC cvstpu.c -o libcvstpu.so
 */

#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <linux/videodev2.h>
#include <poll.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

/* ------------------------------------------------------------------ */
/* wire                                                               */
/* ------------------------------------------------------------------ */

/* Milliseconds left before a CLOCK_MONOTONIC deadline (0 when past). */
static int ms_left(const struct timespec *deadline) {
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    int64_t ms = (int64_t)(deadline->tv_sec - now.tv_sec) * 1000 +
                 (deadline->tv_nsec - now.tv_nsec) / 1000000;
    return ms < 0 ? 0 : (ms > INT32_MAX ? INT32_MAX : (int)ms);
}

/* writev() every byte of the iovecs, 1,024 iovecs a call. A non-blocking
 * fd (a Python socket with a timeout is one at the fd level) with a full
 * send buffer is polled until it drains, for at most timeout_ms in all,
 * as sendall() honours the socket's timeout: -ETIMEDOUT when it runs
 * out. timeout_ms < 0 waits as long as it takes. */
static int send_iovs(int fd, struct iovec *iov, int iovcnt, int timeout_ms) {
    struct timespec deadline;
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (long)(timeout_ms % 1000) * 1000000;
    if (deadline.tv_nsec >= 1000000000) {
        deadline.tv_sec += 1;
        deadline.tv_nsec -= 1000000000;
    }
    while (iovcnt > 0) {
        ssize_t n = writev(fd, iov, iovcnt > 1024 ? 1024 : iovcnt);
        if (n < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                struct pollfd p = {.fd = fd, .events = POLLOUT};
                int wait = timeout_ms < 0 ? -1 : ms_left(&deadline);
                int r = poll(&p, 1, wait);
                if (r < 0 && errno != EINTR) return -errno;
                if (r == 0) return -ETIMEDOUT;
                continue;
            }
            return -errno;
        }
        while (iovcnt > 0 && (size_t)n >= iov->iov_len) {
            n -= iov->iov_len;
            ++iov;
            --iovcnt;
        }
        if (iovcnt > 0 && n > 0) {
            iov->iov_base = (char *)iov->iov_base + n;
            iov->iov_len -= n;
        }
    }
    return 0;
}

/* [u32 pos][i32 xs[pos]][u8 vals[pos]] in one gather write. */
int wire_send_payload(int fd, uint32_t pos, const int32_t *xs,
                      const uint8_t *vals, int timeout_ms) {
    struct iovec iov[3];
    iov[0].iov_base = &pos;
    iov[0].iov_len = sizeof pos;
    iov[1].iov_base = (void *)xs;
    iov[1].iov_len = (size_t)pos * sizeof *xs;
    iov[2].iov_base = (void *)vals;
    iov[2].iov_len = pos;
    return send_iovs(fd, iov, pos ? 3 : 1, timeout_ms);
}

/* Tiled payload: n_tiles segments; tile t holds counts[t] valid entries
 * at xs + t*tile_cap / vals + t*tile_cap. Sends header, all xs prefixes,
 * then all vals prefixes — wire-identical to a flat payload, with no
 * host repacking in Python. The prefixes are copied into one buffer in
 * C and sent with one write: a unit holds a few hundred bytes, and an
 * iovec a prefix took about twice as long as this copy on 1080p tiled
 * payloads (PERF.md, the host wire timings). */
int wire_send_segments(int fd, uint32_t pos, const int32_t *xs,
                       const uint8_t *vals, const int32_t *counts,
                       int n_tiles, int tile_cap, int timeout_ms) {
    size_t body = (size_t)pos * (sizeof *xs + 1);
    uint8_t *buf = malloc(sizeof pos + body);
    if (!buf) return -ENOMEM;
    uint8_t *xo = buf + sizeof pos;
    uint8_t *vo = xo + (size_t)pos * sizeof *xs;
    memcpy(buf, &pos, sizeof pos);
    for (int t = 0; t < n_tiles; ++t) {
        if (counts[t] <= 0) continue;
        size_t c = (size_t)counts[t];
        memcpy(xo, xs + (size_t)t * tile_cap, c * sizeof *xs);
        memcpy(vo, vals + (size_t)t * tile_cap, c);
        xo += c * sizeof *xs;
        vo += c;
    }
    struct iovec one = {.iov_base = buf, .iov_len = sizeof pos + body};
    int rc = send_iovs(fd, &one, 1, timeout_ms);
    free(buf);
    return rc;
}

/* ------------------------------------------------------------------ */
/* host compaction + client scatter                                   */
/* ------------------------------------------------------------------ */

/* bitmask: n/8 bytes, bit i of byte i/8 = "byte i changed" (LSB first).
 * Returns the number of entries written. */
int64_t compact_bitmask(const uint8_t *delta, const uint8_t *bitmask,
                        int64_t n, int32_t *xs_out, uint8_t *vals_out) {
    int64_t out = 0;
    int64_t words = n / 64;
    const uint64_t *bm = (const uint64_t *)bitmask;
    for (int64_t w = 0; w < words; ++w) {
        uint64_t m = bm[w];
        int64_t base = w * 64;
        while (m) {
            int b = __builtin_ctzll(m);
            int64_t i = base + b;
            xs_out[out] = (int32_t)i;
            vals_out[out] = delta[i];
            ++out;
            m &= m - 1;
        }
    }
    for (int64_t i = words * 64; i < n; ++i) {
        if (bitmask[i / 8] >> (i % 8) & 1) {
            xs_out[out] = (int32_t)i;
            vals_out[out] = delta[i];
            ++out;
        }
    }
    return out;
}

/* Host-source packer: like compact_bitmask, but the values come from
 * the host's own buffers — vals[i] = cur[x] - prev[x] (uint8 wrap) —
 * and prev is updated in place to cur at every masked byte (the
 * negative-feedback state update). The device then only ships the
 * n/8-byte bitmask instead of the n-byte dense delta. */
int64_t compact_update(const uint8_t *cur, uint8_t *prev,
                       const uint8_t *bitmask, int64_t n,
                       int32_t *xs_out, uint8_t *vals_out) {
    int64_t out = 0;
    int64_t words = n / 64;
    const uint64_t *bm = (const uint64_t *)bitmask;
    for (int64_t w = 0; w < words; ++w) {
        uint64_t m = bm[w];
        int64_t base = w * 64;
        while (m) {
            int b = __builtin_ctzll(m);
            int64_t i = base + b;
            xs_out[out] = (int32_t)i;
            vals_out[out] = (uint8_t)(cur[i] - prev[i]);
            prev[i] = cur[i];
            ++out;
            m &= m - 1;
        }
    }
    for (int64_t i = words * 64; i < n; ++i) {
        if (bitmask[i / 8] >> (i % 8) & 1) {
            xs_out[out] = (int32_t)i;
            vals_out[out] = (uint8_t)(cur[i] - prev[i]);
            prev[i] = cur[i];
            ++out;
        }
    }
    return out;
}

/* frame[xs[i]] += vals[i] (uint8 wraparound). */
void client_apply(uint8_t *frame, const int32_t *xs, const uint8_t *vals,
                  int64_t pos) {
    for (int64_t i = 0; i < pos; ++i) frame[xs[i]] = (uint8_t)(frame[xs[i]] + vals[i]);
}

/* ------------------------------------------------------------------ */
/* native decoding client — the reference client's read loop          */
/* (client/opencv.cpp:39-66) in plain C: read base frame, then loop   */
/* [u32 pos][i32 xs][u8 vals], scatter-add. Proves wire compatibility */
/* without OpenCV. Returns frames decoded, or negative errno.         */
/* ------------------------------------------------------------------ */

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>

static int read_exact(int fd, void *buf, size_t n) {
    size_t got = 0;
    while (got < n) {
        ssize_t r = read(fd, (char *)buf + got, n - got);
        if (r == 0) return -1; /* peer closed */
        if (r < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        got += (size_t)r;
    }
    return 0;
}

/* Decodes up to max_frames; writes the final reconstruction into
 * frame_out (caller-allocated n_bytes) and a running digest (sum of all
 * bytes of every reconstruction) into digest_out. timeout_ms > 0 bounds
 * each read (SO_RCVTIMEO): a stalled server ends the loop like a closed
 * one, instead of blocking forever. */
int64_t client_decode(const char *host, int port, int64_t n_bytes,
                      int64_t max_frames, uint8_t *frame_out,
                      uint64_t *digest_out, int timeout_ms) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -errno;
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof addr);
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        close(fd);
        return -22;
    }
    if (connect(fd, (struct sockaddr *)&addr, sizeof addr) < 0) {
        int e = -errno;
        close(fd);
        return e;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    if (timeout_ms > 0) {
        struct timeval tv = {.tv_sec = timeout_ms / 1000,
                             .tv_usec = (timeout_ms % 1000) * 1000};
        setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    }

    if (read_exact(fd, frame_out, (size_t)n_bytes) < 0) {
        close(fd);
        return -5;
    }
    int32_t *xs = malloc((size_t)n_bytes * sizeof *xs);
    uint8_t *vals = malloc((size_t)n_bytes);
    if (!xs || !vals) {
        free(xs);
        free(vals);
        close(fd);
        return -12;
    }
    uint64_t digest = 0;
    int64_t frames = 0;
    while (frames < max_frames) {
        uint32_t pos;
        if (read_exact(fd, &pos, sizeof pos) < 0) break;
        if (pos > (uint32_t)n_bytes) break;
        if (read_exact(fd, xs, (size_t)pos * sizeof *xs) < 0) break;
        if (read_exact(fd, vals, pos) < 0) break;
        /* network-supplied indices: validate EVERY one before the
         * scatter — a desynced or hostile stream must produce an error
         * return, never an out-of-bounds write (the uint32_t cast also
         * rejects negative int32 values) */
        int corrupt = 0;
        for (uint32_t i = 0; i < pos; ++i) {
            if ((uint32_t)xs[i] >= (uint32_t)n_bytes) {
                corrupt = 1;
                break;
            }
        }
        if (corrupt) {
            free(xs);
            free(vals);
            close(fd);
            return -6;
        }
        for (uint32_t i = 0; i < pos; ++i)
            frame_out[xs[i]] = (uint8_t)(frame_out[xs[i]] + vals[i]);
        for (int64_t i = 0; i < n_bytes; ++i) digest += frame_out[i];
        ++frames;
    }
    free(xs);
    free(vals);
    close(fd);
    if (digest_out) *digest_out = digest;
    return frames;
}

/* ------------------------------------------------------------------ */
/* v4l2 capture (single handle, mmap streaming)                       */
/* ------------------------------------------------------------------ */

#define V4L2_NBUF 4
#define V4L2_ERR_FORMAT (-2000) /* no supported pixel format negotiated */
static struct {
    int fd;
    void *buf[V4L2_NBUF];
    size_t len[V4L2_NBUF];
    int w, h;
    uint32_t fourcc;
} g_cam = {.fd = -1};

/* Negotiate the pixel format: prefer raw BGR24, accept MJPEG (the
 * reference captures 1080p as MJPG because raw BGR24 at 1080p30
 * exceeds USB2 bandwidth, threads.cpp:34-38 — MJPG frames are decoded
 * host-side by the Python layer). VIDIOC_S_FMT rewrites fmt with what
 * the driver actually granted, so the result must be checked, not
 * assumed. Returns 0 on success with *fourcc set, V4L2_ERR_FORMAT when
 * the device offers neither format, -errno on ioctl failure. */
static int v4l2_negotiate(int fd, int width, int height, uint32_t *fourcc) {
    const uint32_t want[2] = {V4L2_PIX_FMT_BGR24, V4L2_PIX_FMT_MJPEG};
    int err = V4L2_ERR_FORMAT;
    for (int i = 0; i < 2; ++i) {
        struct v4l2_format fmt;
        memset(&fmt, 0, sizeof fmt);
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        fmt.fmt.pix.width = width;
        fmt.fmt.pix.height = height;
        fmt.fmt.pix.pixelformat = want[i];
        fmt.fmt.pix.field = V4L2_FIELD_NONE;
        if (ioctl(fd, VIDIOC_S_FMT, &fmt) < 0) {
            err = -errno;
            continue;
        }
        if (fmt.fmt.pix.pixelformat == want[i]
            && fmt.fmt.pix.width == (uint32_t)width
            && fmt.fmt.pix.height == (uint32_t)height) {
            *fourcc = want[i];
            return 0;
        }
        err = V4L2_ERR_FORMAT; /* driver substituted something else */
    }
    return err;
}

/* Unmap any buffers mapped by a (possibly failed) v4l2_open attempt.
 * close(fd) alone does NOT unmap MAP_SHARED mappings, so every open
 * error path after the mmap loop must call this or each retry against
 * a flaky camera leaks up to 4 frame-sized mappings. */
static void v4l2_unmap_bufs(void) {
    for (int i = 0; i < V4L2_NBUF; ++i) {
        if (g_cam.buf[i] && g_cam.buf[i] != MAP_FAILED)
            munmap(g_cam.buf[i], g_cam.len[i]);
        g_cam.buf[i] = NULL;
        g_cam.len[i] = 0;
    }
}

int v4l2_open(const char *dev, int width, int height) {
    if (g_cam.fd >= 0) return -1;
    int fd = open(dev, O_RDWR);
    if (fd < 0) return -errno;

    uint32_t fourcc = 0;
    int rc = v4l2_negotiate(fd, width, height, &fourcc);
    if (rc < 0) {
        close(fd);
        return rc;
    }

    struct v4l2_requestbuffers req;
    memset(&req, 0, sizeof req);
    req.count = V4L2_NBUF;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (ioctl(fd, VIDIOC_REQBUFS, &req) < 0) {
        close(fd);
        return -errno;
    }
    for (unsigned i = 0; i < req.count && i < V4L2_NBUF; ++i) {
        struct v4l2_buffer b;
        memset(&b, 0, sizeof b);
        b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        b.memory = V4L2_MEMORY_MMAP;
        b.index = i;
        if (ioctl(fd, VIDIOC_QUERYBUF, &b) < 0) {
            int e = errno;
            v4l2_unmap_bufs();
            close(fd);
            return -e;
        }
        g_cam.buf[i] =
            mmap(NULL, b.length, PROT_READ | PROT_WRITE, MAP_SHARED, fd, b.m.offset);
        g_cam.len[i] = b.length;
        if (g_cam.buf[i] == MAP_FAILED) {
            int e = errno;
            g_cam.buf[i] = NULL;
            v4l2_unmap_bufs();
            close(fd);
            return -e;
        }
        if (ioctl(fd, VIDIOC_QBUF, &b) < 0) {
            int e = errno;
            v4l2_unmap_bufs();
            close(fd);
            return -e;
        }
    }
    enum v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    if (ioctl(fd, VIDIOC_STREAMON, &type) < 0) {
        int e = errno;
        v4l2_unmap_bufs();
        close(fd);
        return -e;
    }
    g_cam.fd = fd;
    g_cam.w = width;
    g_cam.h = height;
    g_cam.fourcc = fourcc;
    /* success: 0 = raw BGR24 frames, 1 = MJPEG (caller decodes) */
    return fourcc == V4L2_PIX_FMT_MJPEG ? 1 : 0;
}

/* Returns the number of payload bytes copied (frame_bytes for BGR24,
 * the compressed JPEG length for MJPEG), or -errno. */
int v4l2_grab(int handle, uint8_t *out, int64_t out_len) {
    (void)handle;
    if (g_cam.fd < 0) return -1;
    struct v4l2_buffer b;
    memset(&b, 0, sizeof b);
    b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    b.memory = V4L2_MEMORY_MMAP;
    /* DQBUF blocks ~one frame interval: retry on EINTR like every
     * other blocking call here (a stray SIGCHLD/SIGWINCH must not
     * kill the capture) */
    int rc;
    do {
        rc = ioctl(g_cam.fd, VIDIOC_DQBUF, &b);
    } while (rc < 0 && errno == EINTR);
    if (rc < 0) return -errno;
    size_t n = b.bytesused < (size_t)out_len ? b.bytesused : (size_t)out_len;
    memcpy(out, g_cam.buf[b.index], n);
    do {
        rc = ioctl(g_cam.fd, VIDIOC_QBUF, &b);
    } while (rc < 0 && errno == EINTR);
    if (rc < 0) return -errno;
    return (int)n;
}

void v4l2_close(int handle) {
    (void)handle;
    if (g_cam.fd < 0) return;
    enum v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    ioctl(g_cam.fd, VIDIOC_STREAMOFF, &type);
    for (int i = 0; i < V4L2_NBUF; ++i)
        if (g_cam.buf[i]) munmap(g_cam.buf[i], g_cam.len[i]);
    close(g_cam.fd);
    memset(&g_cam, 0, sizeof g_cam);
    g_cam.fd = -1;
}

/* ------------------------------------------------------------------ */
/* wire v3 adaptive frame encode                                      */
/* (byte-identical to runtime/wire.py:encode_frame_v3_numpy / v3_sizes)     */
/* ------------------------------------------------------------------ */

/* One-pass adaptive v3 encode over TILED payload blocks: tile t holds
 * counts[t] ascending entries at xs + t*tile_cap / vals + t*tile_cap
 * (a flat payload is the n_tiles=1, tile_cap=pos special case).
 *
 * When `apply` is nonzero the payload is first folded into the client
 * shadow with the client's own uint8 wrap-add (V3Encoder semantics);
 * with apply=0 the shadow must already be the post-apply state
 * (encode_frame_v3 semantics — broadcast/multiserve keep their own
 * reconstruction). Either way the raw mode ships the shadow.
 *
 * Emits the cheapest of delta16 / bitmask / raw with the exact numpy
 * encoder's layout and tie-breaking:
 *   delta16: [0][u32 pos][u32 n_exc][u16 gaps][u32 absolutes][vals]
 *            gap = x - prev_x (prev starts -1); gap >= 0xFFFF escapes
 *   bitmask: [1][u32 pos][LSB-first mask (n+7)/8][vals]
 *   raw:     [2][shadow bytes]
 * Returns bytes written, -1 when out_cap can't hold the worst-case
 * delta16 working area (10 + 7*pos) or the chosen mode's size, or -2
 * when a count lies outside [0, tile_cap] or an index outside [0, n):
 * both refusals come before anything is written. */
int64_t wire_encode_v3(const int32_t *counts, int64_t n_tiles,
                       int64_t tile_cap, const int32_t *xs,
                       const uint8_t *vals, uint8_t *shadow, int64_t n,
                       int apply, uint8_t *out, int64_t out_cap) {
    int64_t pos = 0;
    for (int64_t t = 0; t < n_tiles; ++t) {
        if (counts[t] < 0 || counts[t] > tile_cap) return -2;
        pos += counts[t];
    }
    /* the shadow apply and the bitmask mode write at every index */
    for (int64_t t = 0; t < n_tiles; ++t) {
        const int32_t *xt = xs + t * tile_cap;
        for (int32_t j = 0; j < counts[t]; ++j)
            if (xt[j] < 0 || (int64_t)xt[j] >= n) return -2;
    }
    /* ALL capacity refusals happen before the apply pass touches the
     * shadow: a -1 return after mutating it would leave a shadow that
     * the caller cannot tell apart from an unapplied one, corrupting the
     * v3 client-state shadow (and every later raw frame).  Which mode
     * wins needs n_exc, so check the worst case of every selectable
     * mode up front: delta16 <= 9+7*pos; if delta16 loses, the winner
     * is bitmask when size_b <= size_r else raw. */
    int64_t size_b = 1 + 4 + (n + 7) / 8 + pos;
    int64_t size_r = 1 + n;
    if (out_cap < 10 + 7 * pos) return -1;
    if (size_b <= size_r ? out_cap < size_b : out_cap < size_r) return -1;

    /* pass 1: shadow apply + delta16 gaps, each section written at its
     * FINAL offset (the exception array starts exactly at 9 + 2*pos) */
    uint8_t *g16 = out + 9;
    uint8_t *exc = out + 9 + 2 * pos;
    int64_t n_exc = 0, i = 0;
    int64_t last = -1;
    for (int64_t t = 0; t < n_tiles; ++t) {
        const int32_t *xt = xs + t * tile_cap;
        const uint8_t *vt = vals + t * tile_cap;
        for (int32_t j = 0; j < counts[t]; ++j, ++i) {
            int64_t x = xt[j];
            if (apply) shadow[x] = (uint8_t)(shadow[x] + vt[j]);
            int64_t gap = x - last;
            last = x;
            uint16_t g = 0xFFFF;
            if (gap < 0xFFFF) {
                g = (uint16_t)gap;
            } else {
                uint32_t x32 = (uint32_t)x;
                memcpy(exc + 4 * n_exc, &x32, 4);
                ++n_exc;
            }
            memcpy(g16 + 2 * i, &g, 2);
        }
    }

    int64_t size_d = 1 + 8 + 3 * pos + 4 * n_exc;
    uint32_t pos32 = (uint32_t)pos;

    if (size_d <= size_b && size_d <= size_r) {
        out[0] = 0; /* MODE_DELTA16 */
        uint32_t e32 = (uint32_t)n_exc;
        memcpy(out + 1, &pos32, 4);
        memcpy(out + 5, &e32, 4);
        uint8_t *vo = out + 9 + 2 * pos + 4 * n_exc;
        for (int64_t t = 0; t < n_tiles; ++t) {
            memcpy(vo, vals + t * tile_cap, (size_t)counts[t]);
            vo += counts[t];
        }
        return size_d;
    }
    if (size_b <= size_r) {
        out[0] = 1; /* MODE_BITMASK */
        memcpy(out + 1, &pos32, 4);
        uint8_t *mask = out + 5;
        memset(mask, 0, (size_t)((n + 7) / 8));
        uint8_t *vo = mask + (n + 7) / 8;
        for (int64_t t = 0; t < n_tiles; ++t) {
            const int32_t *xt = xs + t * tile_cap;
            for (int32_t j = 0; j < counts[t]; ++j) {
                int64_t x = xt[j];
                mask[x >> 3] |= (uint8_t)(1u << (x & 7));
            }
            memcpy(vo, vals + t * tile_cap, (size_t)counts[t]);
            vo += counts[t];
        }
        return size_b;
    }
    out[0] = 2; /* MODE_RAW */
    memcpy(out + 1, shadow, (size_t)n);
    return size_r;
}
