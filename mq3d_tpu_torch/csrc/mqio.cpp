// mqio: the native host IO runtime of mq3d_tpu_torch.
//
// Batched raw-frame reads, Android image-plane de-striding and a zlib PNG
// encoder, with thread-pool variants of the reads and the PNG batch
// writes, exposed over a plain C interface for ctypes
// (mq3d_tpu_torch/utils/native.py).  Host code only: it is built with g++,
// not nvcc, so it builds on machines without the CUDA toolkit.
//
// Build: g++ -O3 -shared -fPIC -pthread mqio.cpp -o libmqio.so -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {

// Read one binary file into out (up to max_bytes). Returns bytes read, -1 on
// open failure.
long mqio_read_file(const char* path, uint8_t* out, long max_bytes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long n = (long)fread(out, 1, (size_t)max_bytes, f);
    fclose(f);
    return n;
}

// Read n_files raw frames of frame_bytes each into a contiguous buffer.
// paths: array of C strings. ok[i] set to 1 when the full frame was read.
// Returns the number of complete frames.
int mqio_read_raw_batch(const char** paths, int n_files, long frame_bytes,
                        uint8_t* out, uint8_t* ok) {
    int complete = 0;
    for (int i = 0; i < n_files; i++) {
        uint8_t* dst = out + (long)i * frame_bytes;
        long n = mqio_read_file(paths[i], dst, frame_bytes);
        if (n == frame_bytes) {
            ok[i] = 1;
            complete++;
        } else {
            ok[i] = 0;
            if (n < 0) n = 0;
            memset(dst + n, 0, (size_t)(frame_bytes - n));
        }
    }
    return complete;
}

// Extract a (height, width) plane from a strided Android image buffer.
void mqio_destride_plane(const uint8_t* src, long src_len, long offset,
                         int width, int height, int row_stride,
                         int pixel_stride, uint8_t* out) {
    for (int r = 0; r < height; r++) {
        long base = offset + (long)r * row_stride;
        for (int c = 0; c < width; c++) {
            long idx = base + (long)c * pixel_stride;
            out[(long)r * width + c] = (idx < src_len) ? src[idx] : 0;
        }
    }
}

// ---------------------------------------------------------------------------
// PNG encoding (truecolor 8-bit or grayscale 8-bit, filter 0, zlib)
// ---------------------------------------------------------------------------

static void put_u32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

static int write_chunk(FILE* f, const char* type, const uint8_t* data,
                       uint32_t len) {
    uint8_t hdr[8];
    put_u32(hdr, len);
    memcpy(hdr + 4, type, 4);
    if (fwrite(hdr, 1, 8, f) != 8) return -1;
    if (len && fwrite(data, 1, len, f) != len) return -1;
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, (const Bytef*)type, 4);
    if (len) crc = crc32(crc, data, len);
    uint8_t crcb[4];
    put_u32(crcb, crc);
    if (fwrite(crcb, 1, 4, f) != 4) return -1;
    return 0;
}

// data: row-major; channels 1 (gray) or 3.  With swap_rb the three bytes
// of each pixel are reversed on the way (BGR in, RGB stored), otherwise
// they are stored as given.  Returns 0 on success.
static int write_png(const char* path, const uint8_t* data, int width,
                     int height, int channels, int compression_level,
                     int swap_rb) {
    if (channels != 1 && channels != 3) return -2;
    FILE* f = fopen(path, "wb");
    if (!f) return -1;

    static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    int rc = -1;
    uint8_t* raw = nullptr;
    uint8_t* comp = nullptr;
    do {
        if (fwrite(magic, 1, 8, f) != 8) break;

        uint8_t ihdr[13];
        put_u32(ihdr, (uint32_t)width);
        put_u32(ihdr + 4, (uint32_t)height);
        ihdr[8] = 8;  // bit depth
        ihdr[9] = channels == 1 ? 0 : 2;  // gray / truecolor
        ihdr[10] = 0;
        ihdr[11] = 0;
        ihdr[12] = 0;
        if (write_chunk(f, "IHDR", ihdr, 13) != 0) break;

        long row = (long)width * channels;
        long raw_len = (row + 1) * height;
        raw = (uint8_t*)malloc((size_t)raw_len);
        if (!raw) break;
        for (int r = 0; r < height; r++) {
            uint8_t* dst = raw + (row + 1) * r;
            const uint8_t* src = data + row * r;
            dst[0] = 0;  // filter: none
            if (swap_rb && channels == 3) {
                for (long c = 0; c < row; c += 3) {
                    dst[1 + c] = src[c + 2];
                    dst[2 + c] = src[c + 1];
                    dst[3 + c] = src[c];
                }
            } else {
                memcpy(dst + 1, src, (size_t)row);
            }
        }
        uLongf comp_cap = compressBound((uLong)raw_len);
        comp = (uint8_t*)malloc(comp_cap);
        if (!comp) break;
        if (compress2(comp, &comp_cap, raw, (uLong)raw_len,
                      compression_level) != Z_OK)
            break;
        if (write_chunk(f, "IDAT", comp, (uint32_t)comp_cap) != 0) break;
        if (write_chunk(f, "IEND", nullptr, 0) != 0) break;
        rc = 0;
    } while (0);

    free(raw);
    free(comp);
    fclose(f);
    return rc;
}

// RGB (or gray) in, as stored in the PNG.
int mqio_write_png(const char* path, const uint8_t* data, int width,
                   int height, int channels, int compression_level) {
    return write_png(path, data, width, height, channels, compression_level, 0);
}

// BGR (or gray) in, RGB stored: the channel swap rides on the row copy.
int mqio_write_png_bgr(const char* path, const uint8_t* data, int width,
                       int height, int channels, int compression_level) {
    return write_png(path, data, width, height, channels, compression_level, 1);
}

// ---------------------------------------------------------------------------
// Threaded batch variants: file IO and zlib overlap across cores, one
// thread per core unless the caller names a count.
// ---------------------------------------------------------------------------

static int clamp_threads(int n_threads, int n_items) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    if (n_threads <= 0) n_threads = (int)hw;
    return std::max(1, std::min(n_threads, n_items));
}

// Parallel batched raw reads.  Same contract as mqio_read_raw_batch.
int mqio_read_raw_batch_mt(const char** paths, int n_files, long frame_bytes,
                           uint8_t* out, uint8_t* ok, int n_threads) {
    n_threads = clamp_threads(n_threads, n_files);
    std::atomic<int> next(0), complete(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n_files) return;
            uint8_t* dst = out + (long)i * frame_bytes;
            long n = mqio_read_file(paths[i], dst, frame_bytes);
            if (n == frame_bytes) {
                ok[i] = 1;
                complete.fetch_add(1);
            } else {
                ok[i] = 0;
                if (n < 0) n = 0;
                memset(dst + n, 0, (size_t)(frame_bytes - n));
            }
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
    return complete.load();
}

static int write_png_batch(const char** paths, const uint8_t* data, int n,
                           int width, int height, int channels,
                           int compression_level, uint8_t* ok, int n_threads,
                           int swap_rb) {
    n_threads = clamp_threads(n_threads, n);
    long frame = (long)width * height * channels;
    std::atomic<int> next(0), complete(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            int rc = write_png(paths[i], data + (long)i * frame, width, height,
                               channels, compression_level, swap_rb);
            ok[i] = rc == 0 ? 1 : 0;
            if (rc == 0) complete.fetch_add(1);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
    return complete.load();
}

// Parallel PNG encode+write of n images sharing (width, height, channels).
// data: contiguous (n, height, width, channels), RGB (or gray). ok[i]=1 on
// success. Returns the number written.
int mqio_write_png_batch(const char** paths, const uint8_t* data, int n,
                         int width, int height, int channels,
                         int compression_level, uint8_t* ok,
                         int n_threads) {
    return write_png_batch(paths, data, n, width, height, channels,
                           compression_level, ok, n_threads, 0);
}

// The same with BGR (or gray) in, RGB stored.
int mqio_write_png_batch_bgr(const char** paths, const uint8_t* data, int n,
                             int width, int height, int channels,
                             int compression_level, uint8_t* ok,
                             int n_threads) {
    return write_png_batch(paths, data, n, width, height, channels,
                           compression_level, ok, n_threads, 1);
}

// ---------------------------------------------------------------------------
// Build facts, for logs: the thread count of n_threads = 0 and the zlib
// versions the library was compiled against and runs with.
// ---------------------------------------------------------------------------

int mqio_default_threads(void) { return clamp_threads(0, 1 << 30); }

const char* mqio_zlib_compiled_version(void) { return ZLIB_VERSION; }

const char* mqio_zlib_runtime_version(void) { return zlibVersion(); }

}  // extern "C"
