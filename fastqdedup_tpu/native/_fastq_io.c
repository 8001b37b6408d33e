/* Native FASTQ chunk parser (host I/O hot path).
 *
 * TPU-native counterpart of the reference's dnaio/xopen ingest stack
 * (/root/reference/src/fastqdedup/__init__.py:54-57,170-206): instead of
 * producing per-record Python objects, this parser streams a (possibly
 * gzip-compressed) FASTQ file straight into columnar byte buffers
 * (concatenated payload + offset arrays) that the Python layer wraps as
 * FastqChunk batches feeding the vectorized JAX kernels.
 *
 * Exposed via ctypes (see fastqdedup_tpu/native/loader.py); built with
 * `cc -O3 -shared -fPIC _fastq_io.c -o _fastq_io.so -lz`.
 */

#include <dlfcn.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>
#include <zlib.h>

/* Pre-fault a large buffer in one syscall (MADV_POPULATE_WRITE, Linux
 * 5.14+; the raw value keeps old toolchains compiling).  On virtualized
 * hosts with lazily-backed guest memory, per-page write faults measure
 * seconds per GiB while one populate call maps the range ~14x faster.
 * Harmless EINVAL on kernels without it. */
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif
static void populate_write(void *p, size_t n) {
    if (!p || n < ((size_t)64 << 20)) return;
    uintptr_t a0 = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
    uintptr_t a1 = ((uintptr_t)p + n) & ~(uintptr_t)4095;
    if (a1 > a0) madvise((void *)a0, a1 - a0, MADV_POPULATE_WRITE);
}

/* libdeflate (when present) inflates raw-deflate BGZF payloads ~2.5x
 * faster than zlib on this class of data.  Loaded via dlopen so the
 * build has no hard dependency; zlib remains the fallback and the
 * behavior is identical (whole-block decompress with known output
 * size). */
typedef void *(*ld_alloc_fn)(void);
typedef void (*ld_free_fn)(void *);
typedef int (*ld_inflate_fn)(void *, const void *, size_t, void *,
                             size_t, size_t *);
static ld_alloc_fn ld_alloc;
static ld_free_fn ld_free;
static ld_inflate_fn ld_inflate;
static pthread_once_t ld_once = PTHREAD_ONCE_INIT;

static void ld_init(void) {
    void *h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    ld_alloc_fn a = (ld_alloc_fn)dlsym(h, "libdeflate_alloc_decompressor");
    ld_free_fn f = (ld_free_fn)dlsym(h, "libdeflate_free_decompressor");
    ld_inflate_fn d =
        (ld_inflate_fn)dlsym(h, "libdeflate_deflate_decompress");
    if (a && f && d) {
        ld_alloc = a;
        ld_free = f;
        ld_inflate = d;
    }
}

/* Inflate one raw-deflate payload with a known uncompressed size.
 * ldd is a per-thread libdeflate decompressor (may be NULL), zs an
 * initialized raw-inflate z_stream.  Returns 0 on success. */
static int inflate_block(void *ldd, z_stream *zs, const unsigned char *in,
                         size_t in_len, unsigned char *out, size_t isize) {
    if (ldd) {
        size_t actual = 0;
        if (ld_inflate(ldd, in, in_len, out, isize, &actual) != 0 ||
            actual != isize)
            return 1;
        return 0;
    }
    zs->next_in = (unsigned char *)in;
    zs->avail_in = (uInt)in_len;
    zs->next_out = out;
    zs->avail_out = (uInt)isize;
    if (inflate(zs, Z_FINISH) != Z_STREAM_END || zs->avail_out != 0)
        return 1;
    inflateReset2(zs, -15);
    return 0;
}

#define FQ_OK 0
#define FQ_EOF 1
#define FQ_ERR_IO 2
#define FQ_ERR_FORMAT 3
#define FQ_ERR_NOMEM 4

#define READ_BUF_SIZE (1 << 20)

/* BGZF (blocked gzip, as written by bgzip/htslib and this library's
 * blocked writer): each <=64 KiB block is an independent gzip member
 * whose FEXTRA field carries the compressed block length, so member
 * boundaries are discoverable WITHOUT inflating — which makes inflate
 * embarrassingly parallel across cores.  Plain single-member gzip (and
 * uncompressed files) keep the sequential zlib path.
 *
 * Decompression runs as an asynchronous pipeline: a persistent producer
 * thread owns the compressed stream (readahead + member-header walk) and
 * inflates batches of blocks across itself plus BGZF_HELPERS persistent
 * helper threads into fixed-size slots of a small ring; the consumer
 * (the record scanner, on the caller's thread) swaps ready slots in as
 * its scan buffer.  Decompression and record scanning therefore overlap
 * instead of alternating, which roughly halves ingest wall time on
 * multi-core hosts.  Each slot reserves SLOT_HEADROOM bytes in front so
 * the unread tail of the previous buffer (shorter than one FASTQ line
 * in all but pathological cases) moves immediately before the new
 * payload, keeping lines contiguous without copying payloads. */
#define BGZF_BATCH 64        /* blocks inflated per parallel batch */
#define BGZF_HELPERS 2       /* inflate helpers besides the producer */
#define BGZF_SLOTS 3
#define BGZF_MAX_BLOCK 65536
#define SLOT_HEADROOM (1 << 20)
#define SLOT_PAYLOAD (BGZF_BATCH * BGZF_MAX_BLOCK)

#define SLOT_FREE 0
#define SLOT_FILLING 1
#define SLOT_READY 2
#define SLOT_HELD 3

typedef struct {
    size_t comp_off;         /* offset of deflate payload in comp buf */
    size_t comp_len;         /* deflate payload length */
    size_t out_off;          /* offset in the output area */
    size_t isize;            /* uncompressed size (from member trailer) */
} BgzfBlock;

struct BgzfAsync;

typedef struct {
    gzFile gz;
    unsigned char *buf;      /* raw (decompressed) read buffer */
    size_t buf_len;          /* valid bytes in buf */
    size_t buf_pos;          /* cursor */
    size_t buf_cap;
    int eof;                 /* no more bytes from gz */
    int64_t line_number;     /* 0-based line of next unread line */
    char error[512];
    int64_t error_line;      /* 0-based line number of the error, or -1 */
    /* Record that did not fit in the caller's buffers last call. */
    unsigned char *pend_head, *pend_seq, *pend_qual;
    size_t pend_head_len, pend_seq_len;
    int has_pending;
    /* BGZF parallel-inflate state (bgzf != 0 -> fd-based path).  The
     * comp/tail fields are owned by the producer thread once the async
     * engine starts. */
    int bgzf;
    int fd;
    unsigned char *comp;     /* compressed readahead */
    size_t comp_len, comp_pos, comp_cap;
    int comp_eof;
    int tail_plain;          /* hit a non-BGZF member: stream the rest */
    z_stream tail_zs;
    int tail_active;
    struct BgzfAsync *async; /* lazily started on first bgzf fill */
    int64_t raw_base;        /* file offset of comp[0] */
    int64_t range_hi;        /* stop before members at >= this offset
                                (-1: none) */
    int range_mode;          /* opened with fq_open_range */
    int64_t cur_unit_end;    /* raw_end of the slot the scanner holds */
    int held_slot;           /* slot the scanner is reading from, or -1 */
    unsigned char *buf0;     /* original owned buffer (freed at close) */
    unsigned char *big_buf;  /* giant-line overflow buffer, or NULL */
} FqReader;

/* ---- BGZF helpers --------------------------------------------------- */

static int bg_refill_comp(FqReader *r) {
    if (r->comp_pos > 0) {
        memmove(r->comp, r->comp + r->comp_pos,
                r->comp_len - r->comp_pos);
        r->comp_len -= r->comp_pos;
        r->raw_base += (int64_t)r->comp_pos;
        r->comp_pos = 0;
    }
    if (r->comp_len == r->comp_cap) {
        size_t nc = r->comp_cap * 2;
        unsigned char *nb = (unsigned char *)realloc(r->comp, nc);
        if (!nb) return FQ_ERR_NOMEM;
        r->comp = nb;
        r->comp_cap = nc;
    }
    ssize_t n = read(r->fd, r->comp + r->comp_len,
                     r->comp_cap - r->comp_len);
    if (n < 0) {
        snprintf(r->error, sizeof(r->error), "read error");
        return FQ_ERR_IO;
    }
    if (n == 0) r->comp_eof = 1;
    r->comp_len += (size_t)n;
    return FQ_OK;
}

/* Parse one BGZF member header at comp[pos]; returns total member size
 * (header+payload+trailer) via *msize and the deflate payload span, or
 * 0 meaning "not a BGZF member", or -1 meaning "need more bytes". */
static int bg_parse_member(const unsigned char *p, size_t avail,
                           size_t *msize, size_t *payload_off,
                           size_t *payload_len, size_t *isize) {
    if (avail < 18) return -1;
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || (p[3] & 4) == 0)
        return 0;
    size_t xlen = (size_t)p[10] | ((size_t)p[11] << 8);
    if (avail < 12 + xlen) return -1;
    /* Scan extra subfields for the BC (block size) field. */
    size_t q = 12, bsize = 0;
    int found = 0;
    while (q + 4 <= 12 + xlen) {
        size_t slen = (size_t)p[q + 2] | ((size_t)p[q + 3] << 8);
        if (p[q] == 'B' && p[q + 1] == 'C' && slen == 2) {
            bsize = ((size_t)p[q + 4] | ((size_t)p[q + 5] << 8)) + 1;
            found = 1;
        }
        q += 4 + slen;
    }
    if (!found) return 0;
    if (avail < bsize) return -1;
    *msize = bsize;
    *payload_off = 12 + xlen;
    *payload_len = bsize - (12 + xlen) - 8;
    *isize = (size_t)p[bsize - 4] | ((size_t)p[bsize - 3] << 8) |
             ((size_t)p[bsize - 2] << 16) | ((size_t)p[bsize - 1] << 24);
    return 1;
}

typedef struct {
    unsigned char *data;     /* SLOT_HEADROOM + payload capacity */
    size_t cap;              /* payload capacity */
    size_t len;              /* payload bytes */
    int64_t raw_end;         /* file offset just past this unit's members */
} BgzfSlot;

typedef struct BgzfAsync {
    FqReader *r;
    BgzfSlot slots[BGZF_SLOTS];
    int state[BGZF_SLOTS];
    int ready_q[BGZF_SLOTS]; /* FIFO of READY slot indices */
    int rq_head, rq_len;
    int eof;                 /* producer exhausted the stream */
    int err;                 /* FQ_ERR_* from the producer, or 0 */
    int shutdown;
    pthread_mutex_t mu;
    pthread_cond_t cv_prod;  /* producer: a slot became FREE / shutdown */
    pthread_cond_t cv_cons;  /* consumer: a slot became READY / eof/err */
    pthread_cond_t cv_help;  /* helpers: a new inflate job was posted */
    pthread_cond_t cv_hdone; /* producer: helpers finished the job */
    /* Current inflate job (valid while job_done < BGZF_HELPERS). */
    const unsigned char *job_comp;
    unsigned char *job_out;
    const BgzfBlock *job_blocks;
    int job_nblocks;
    unsigned job_gen;
    int job_done;
    int job_failed;
    int next_helper_id;
    pthread_t producer;
    pthread_t helpers[BGZF_HELPERS];
} BgzfAsync;

static void *bga_helper(void *arg) {
    BgzfAsync *a = (BgzfAsync *)arg;
    unsigned seen = 0;
    int my;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    int zok = inflateInit2(&zs, -15) == Z_OK;
    pthread_once(&ld_once, ld_init);
    void *ldd = ld_alloc ? ld_alloc() : NULL;

    pthread_mutex_lock(&a->mu);
    my = a->next_helper_id++;
    for (;;) {
        while (a->job_gen == seen && !a->shutdown)
            pthread_cond_wait(&a->cv_help, &a->mu);
        if (a->job_gen == seen) /* shutdown with no pending job */
            break;
        seen = a->job_gen;
        const unsigned char *comp = a->job_comp;
        unsigned char *out = a->job_out;
        const BgzfBlock *blocks = a->job_blocks;
        int nblocks = a->job_nblocks;
        pthread_mutex_unlock(&a->mu);

        int failed = !zok && !ldd;
        if (!failed) {
            for (int i = 1 + my; i < nblocks; i += 1 + BGZF_HELPERS) {
                const BgzfBlock *b = &blocks[i];
                if (inflate_block(ldd, &zs, comp + b->comp_off,
                                  b->comp_len, out + b->out_off,
                                  b->isize)) {
                    failed = 1;
                    break;
                }
            }
        }
        pthread_mutex_lock(&a->mu);
        if (failed) a->job_failed = 1;
        a->job_done++;
        pthread_cond_broadcast(&a->cv_hdone);
    }
    pthread_mutex_unlock(&a->mu);
    if (zok) inflateEnd(&zs);
    if (ldd) ld_free(ldd);
    return NULL;
}

/* Inflate one batch across the producer (stripe 0) + helpers.  Returns
 * 0 on success, 1 on corrupt data.  Runs on the producer thread; the
 * compressed buffer must stay immovable until this returns. */
static int bga_inflate_batch(BgzfAsync *a, void *ldd, z_stream *zs,
                             const BgzfBlock *blocks, int nblocks,
                             unsigned char *out) {
    FqReader *r = a->r;
    pthread_mutex_lock(&a->mu);
    a->job_comp = r->comp;
    a->job_out = out;
    a->job_blocks = blocks;
    a->job_nblocks = nblocks;
    a->job_done = 0;
    a->job_failed = 0;
    a->job_gen++;
    pthread_cond_broadcast(&a->cv_help);
    pthread_mutex_unlock(&a->mu);

    int failed = 0;
    for (int i = 0; i < nblocks; i += 1 + BGZF_HELPERS) {
        const BgzfBlock *b = &blocks[i];
        if (inflate_block(ldd, zs, r->comp + b->comp_off, b->comp_len,
                          out + b->out_off, b->isize)) {
            failed = 1;
            break;
        }
    }
    pthread_mutex_lock(&a->mu);
    while (a->job_done < BGZF_HELPERS)
        pthread_cond_wait(&a->cv_hdone, &a->mu);
    failed |= a->job_failed;
    pthread_mutex_unlock(&a->mu);
    return failed;
}

/* Producer main loop: walk headers, inflate batches into ring slots. */
static void *bga_producer(void *arg) {
    BgzfAsync *a = (BgzfAsync *)arg;
    FqReader *r = a->r;
    int err = 0;
    void *ldd = NULL;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) {
        snprintf(r->error, sizeof(r->error), "inflateInit failed");
        err = FQ_ERR_NOMEM;
        goto out;
    }
    pthread_once(&ld_once, ld_init);
    ldd = ld_alloc ? ld_alloc() : NULL;

    for (;;) {
        /* 1. Gather up to one batch of member headers. */
        BgzfBlock blocks[BGZF_BATCH];
        int nblocks = 0;
        size_t total_out = 0;
        while (!r->tail_plain && nblocks < BGZF_BATCH &&
               total_out < SLOT_PAYLOAD) {
            size_t msize, poff, plen, isize;
            if (r->range_hi >= 0 &&
                r->raw_base + (int64_t)r->comp_pos >= r->range_hi)
                break;  /* members past the range belong to the next host */
            int st = bg_parse_member(r->comp + r->comp_pos,
                                     r->comp_len - r->comp_pos,
                                     &msize, &poff, &plen, &isize);
            if (st == -1) {
                if (r->comp_eof) {
                    if (r->comp_len - r->comp_pos == 0) break;
                    snprintf(r->error, sizeof(r->error),
                             "truncated BGZF block");
                    err = FQ_ERR_FORMAT;
                    goto out;
                }
                if (nblocks) break; /* inflate what we have first */
                int rc = bg_refill_comp(r);
                if (rc != FQ_OK) { err = rc; goto out; }
                continue;
            }
            if (st == 0) {
                /* Non-BGZF member (e.g. plain gzip appended after
                 * blocks): finish queued blocks, stream the rest. */
                if (r->range_mode) {
                    /* Byte-range splitting relies on member chaining;
                     * a non-BGZF member breaks the contract. */
                    snprintf(r->error, sizeof(r->error),
                             "non-BGZF gzip member inside a byte range");
                    err = FQ_ERR_FORMAT;
                    goto out;
                }
                if (nblocks) break;
                r->tail_plain = 1;
                break;
            }
            if (isize > SLOT_PAYLOAD) { /* lying trailer; cap sanity */
                snprintf(r->error, sizeof(r->error),
                         "oversized BGZF block");
                err = FQ_ERR_FORMAT;
                goto out;
            }
            if (isize > 0) {
                if (total_out + isize > SLOT_PAYLOAD) break;
                blocks[nblocks].comp_off = r->comp_pos + poff;
                blocks[nblocks].comp_len = plen;
                blocks[nblocks].out_off = total_out;
                blocks[nblocks].isize = isize;
                nblocks++;
                total_out += isize;
            }
            r->comp_pos += msize;
        }

        if (nblocks == 0 && !r->tail_plain)
            break; /* end of stream (or range exhausted) */
        int64_t unit_end = r->raw_base + (int64_t)r->comp_pos;

        /* 2. Acquire a FREE slot. */
        int idx = -1;
        pthread_mutex_lock(&a->mu);
        for (;;) {
            if (a->shutdown) { pthread_mutex_unlock(&a->mu); goto out; }
            for (int i = 0; i < BGZF_SLOTS; i++)
                if (a->state[i] == SLOT_FREE) { idx = i; break; }
            if (idx >= 0) break;
            pthread_cond_wait(&a->cv_prod, &a->mu);
        }
        a->state[idx] = SLOT_FILLING;
        pthread_mutex_unlock(&a->mu);
        BgzfSlot *s = &a->slots[idx];

        if (nblocks > 0) {
            if (bga_inflate_batch(a, ldd, &zs, blocks, nblocks,
                                  s->data + SLOT_HEADROOM)) {
                snprintf(r->error, sizeof(r->error),
                         "corrupt BGZF block");
                err = FQ_ERR_FORMAT;
                pthread_mutex_lock(&a->mu);
                a->state[idx] = SLOT_FREE;
                pthread_mutex_unlock(&a->mu);
                goto out;
            }
            s->len = total_out;
            s->raw_end = unit_end;
        } else {
            /* Stream-inflate the non-BGZF remainder (concatenated
             * members handled by inflateReset on Z_STREAM_END). */
            if (!r->tail_active) {
                memset(&r->tail_zs, 0, sizeof(r->tail_zs));
                if (inflateInit2(&r->tail_zs, 15 + 32) != Z_OK) {
                    err = FQ_ERR_NOMEM;
                    pthread_mutex_lock(&a->mu);
                    a->state[idx] = SLOT_FREE;
                    pthread_mutex_unlock(&a->mu);
                    goto out;
                }
                r->tail_active = 1;
            }
            size_t produced_total = 0;
            int stream_end = 0;
            while (produced_total == 0 && !stream_end) {
                if (r->comp_len - r->comp_pos == 0 && !r->comp_eof) {
                    int rc = bg_refill_comp(r);
                    if (rc != FQ_OK) {
                        err = rc;
                        pthread_mutex_lock(&a->mu);
                        a->state[idx] = SLOT_FREE;
                        pthread_mutex_unlock(&a->mu);
                        goto out;
                    }
                }
                if (r->comp_len - r->comp_pos == 0) {
                    stream_end = 1;
                    break;
                }
                r->tail_zs.next_in = r->comp + r->comp_pos;
                r->tail_zs.avail_in =
                    (uInt)(r->comp_len - r->comp_pos);
                r->tail_zs.next_out =
                    s->data + SLOT_HEADROOM + produced_total;
                r->tail_zs.avail_out = (uInt)(s->cap - produced_total);
                int rc = inflate(&r->tail_zs, Z_NO_FLUSH);
                size_t consumed = (r->comp_len - r->comp_pos) -
                    r->tail_zs.avail_in;
                size_t produced = (s->cap - produced_total) -
                    r->tail_zs.avail_out;
                r->comp_pos += consumed;
                produced_total += produced;
                if (rc == Z_STREAM_END) {
                    inflateReset(&r->tail_zs);
                    continue;
                }
                if (rc != Z_OK && rc != Z_BUF_ERROR) {
                    snprintf(r->error, sizeof(r->error),
                             "corrupt gzip tail stream");
                    err = FQ_ERR_FORMAT;
                    pthread_mutex_lock(&a->mu);
                    a->state[idx] = SLOT_FREE;
                    pthread_mutex_unlock(&a->mu);
                    goto out;
                }
            }
            if (produced_total == 0) {
                /* Exhausted with nothing produced: release and stop. */
                pthread_mutex_lock(&a->mu);
                a->state[idx] = SLOT_FREE;
                pthread_mutex_unlock(&a->mu);
                break;
            }
            s->len = produced_total;
            s->raw_end = r->raw_base + (int64_t)r->comp_pos;
        }

        /* 3. Publish the slot. */
        pthread_mutex_lock(&a->mu);
        a->state[idx] = SLOT_READY;
        a->ready_q[(a->rq_head + a->rq_len) % BGZF_SLOTS] = idx;
        a->rq_len++;
        pthread_cond_broadcast(&a->cv_cons);
        pthread_mutex_unlock(&a->mu);
    }

out:
    inflateEnd(&zs);
    if (ldd) ld_free(ldd);
    pthread_mutex_lock(&a->mu);
    if (err) a->err = err;
    else a->eof = 1;
    pthread_cond_broadcast(&a->cv_cons);
    pthread_mutex_unlock(&a->mu);
    return NULL;
}

static int bga_start(FqReader *r) {
    BgzfAsync *a = (BgzfAsync *)calloc(1, sizeof(BgzfAsync));
    if (!a) return FQ_ERR_NOMEM;
    a->r = r;
    for (int i = 0; i < BGZF_SLOTS; i++) {
        a->slots[i].cap = SLOT_PAYLOAD;
        a->slots[i].data =
            (unsigned char *)malloc(SLOT_HEADROOM + SLOT_PAYLOAD);
        if (!a->slots[i].data) {
            for (int j = 0; j < i; j++) free(a->slots[j].data);
            free(a);
            return FQ_ERR_NOMEM;
        }
        a->state[i] = SLOT_FREE;
    }
    pthread_mutex_init(&a->mu, NULL);
    pthread_cond_init(&a->cv_prod, NULL);
    pthread_cond_init(&a->cv_cons, NULL);
    pthread_cond_init(&a->cv_help, NULL);
    pthread_cond_init(&a->cv_hdone, NULL);
    for (int t = 0; t < BGZF_HELPERS; t++)
        pthread_create(&a->helpers[t], NULL, bga_helper, a);
    pthread_create(&a->producer, NULL, bga_producer, a);
    r->async = a;
    return FQ_OK;
}

static void bga_stop(FqReader *r) {
    BgzfAsync *a = r->async;
    if (!a) return;
    pthread_mutex_lock(&a->mu);
    a->shutdown = 1;
    pthread_cond_broadcast(&a->cv_prod);
    pthread_cond_broadcast(&a->cv_help);
    pthread_mutex_unlock(&a->mu);
    pthread_join(a->producer, NULL);
    /* The producer never posts a new job after shutdown, and helpers
     * finish any in-flight job before exiting. */
    pthread_mutex_lock(&a->mu);
    pthread_cond_broadcast(&a->cv_help);
    pthread_mutex_unlock(&a->mu);
    for (int t = 0; t < BGZF_HELPERS; t++)
        pthread_join(a->helpers[t], NULL);
    for (int i = 0; i < BGZF_SLOTS; i++) free(a->slots[i].data);
    pthread_mutex_destroy(&a->mu);
    pthread_cond_destroy(&a->cv_prod);
    pthread_cond_destroy(&a->cv_cons);
    pthread_cond_destroy(&a->cv_help);
    pthread_cond_destroy(&a->cv_hdone);
    free(a);
    r->async = NULL;
}

/* Consumer side: swap the next ready slot in as the scan buffer.  The
 * unread tail of the current buffer moves into the new slot's headroom
 * so lines stay contiguous. */
static int bg_consume(FqReader *r) {
    if (!r->async) {
        int rc = bga_start(r);
        if (rc != FQ_OK) return rc;
    }
    BgzfAsync *a = r->async;
    pthread_mutex_lock(&a->mu);
    while (a->rq_len == 0 && !a->eof && !a->err)
        pthread_cond_wait(&a->cv_cons, &a->mu);
    if (a->rq_len == 0) {
        int e = a->err;
        pthread_mutex_unlock(&a->mu);
        if (e) return e;
        r->eof = 1;
        return FQ_OK;
    }
    int idx = a->ready_q[a->rq_head];
    a->rq_head = (a->rq_head + 1) % BGZF_SLOTS;
    a->rq_len--;
    a->state[idx] = SLOT_HELD;
    pthread_mutex_unlock(&a->mu);

    BgzfSlot *s = &a->slots[idx];
    r->cur_unit_end = s->raw_end;
    size_t tail = r->buf_len - r->buf_pos;
    int old_held = r->held_slot;
    if (tail <= SLOT_HEADROOM) {
        unsigned char *start = s->data + SLOT_HEADROOM - tail;
        if (tail) memcpy(start, r->buf + r->buf_pos, tail);
        if (r->big_buf) { free(r->big_buf); r->big_buf = NULL; }
        r->held_slot = idx;
        r->buf = start;
        r->buf_pos = 0;
        r->buf_len = tail + s->len;
    } else {
        /* Giant line (> headroom): accumulate into an owned buffer and
         * release the slot immediately. */
        size_t need = tail + s->len;
        unsigned char *nb = (unsigned char *)malloc(need ? need : 1);
        if (!nb) return FQ_ERR_NOMEM;
        memcpy(nb, r->buf + r->buf_pos, tail);
        memcpy(nb + tail, s->data + SLOT_HEADROOM, s->len);
        free(r->big_buf);
        r->big_buf = nb;
        r->held_slot = -1;
        r->buf = nb;
        r->buf_pos = 0;
        r->buf_len = need;
        pthread_mutex_lock(&a->mu);
        a->state[idx] = SLOT_FREE;
        pthread_cond_broadcast(&a->cv_prod);
        pthread_mutex_unlock(&a->mu);
    }
    if (old_held >= 0) {
        pthread_mutex_lock(&a->mu);
        a->state[old_held] = SLOT_FREE;
        pthread_cond_broadcast(&a->cv_prod);
        pthread_mutex_unlock(&a->mu);
    }
    return FQ_OK;
}

static int fq_fill(FqReader *r) {
    if (r->bgzf)
        return bg_consume(r);
    /* Compact unread bytes to the front and refill. */
    if (r->buf_pos > 0) {
        memmove(r->buf, r->buf + r->buf_pos, r->buf_len - r->buf_pos);
        r->buf_len -= r->buf_pos;
        r->buf_pos = 0;
    }
    if (r->buf_len == r->buf_cap) {
        size_t new_cap = r->buf_cap * 2;
        unsigned char *nb = (unsigned char *)realloc(r->buf, new_cap);
        if (!nb) return FQ_ERR_NOMEM;
        r->buf = nb;
        r->buf_cap = new_cap;
    }
    int n = gzread(r->gz, r->buf + r->buf_len,
                   (unsigned)(r->buf_cap - r->buf_len));
    if (n < 0) {
        int errnum = 0;
        const char *msg = gzerror(r->gz, &errnum);
        snprintf(r->error, sizeof(r->error), "read error: %s",
                 msg ? msg : "unknown");
        return FQ_ERR_IO;
    }
    if (n == 0) r->eof = 1;
    r->buf_len += (size_t)n;
    return FQ_OK;
}

/* Next line (without trailing \n / \r\n). Returns FQ_OK with *out/*len set,
 * FQ_EOF at end of input, or an error code. */
static int fq_next_line(FqReader *r, unsigned char **out, size_t *len) {
    for (;;) {
        unsigned char *start = r->buf + r->buf_pos;
        unsigned char *nl = (unsigned char *)memchr(
            start, '\n', r->buf_len - r->buf_pos);
        if (nl) {
            size_t l = (size_t)(nl - start);
            r->buf_pos += l + 1;
            while (l > 0 && (start[l - 1] == '\r')) l--;
            *out = start;
            *len = l;
            r->line_number++;
            return FQ_OK;
        }
        if (r->eof) {
            size_t l = r->buf_len - r->buf_pos;
            if (l == 0) return FQ_EOF;
            /* Final line without newline. */
            *out = start;
            *len = l;
            r->buf_pos = r->buf_len;
            while (*len > 0 && ((*out)[*len - 1] == '\r')) (*len)--;
            r->line_number++;
            return FQ_OK;
        }
        int rc = fq_fill(r);
        if (rc != FQ_OK) return rc;
    }
}

FqReader *fq_open(const char *path) {
    FqReader *r = (FqReader *)calloc(1, sizeof(FqReader));
    if (!r) return NULL;
    r->error_line = -1;
    r->range_hi = -1;  /* no range limit */
    /* Sniff for BGZF: gzip magic + FEXTRA + a BC subfield in the first
     * member.  BGZF files take the fd-based parallel-inflate path;
     * everything else (plain gzip, uncompressed) uses zlib's gzFile. */
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
        free(r);
        return NULL;
    }
    unsigned char head[64];
    ssize_t got = read(fd, head, sizeof(head));
    int is_bgzf = 0;
    if (got >= 18 && head[0] == 0x1f && head[1] == 0x8b &&
        head[2] == 8 && (head[3] & 4) != 0) {
        size_t xlen = (size_t)head[10] | ((size_t)head[11] << 8);
        size_t q = 12;
        while (q + 4 <= 12 + xlen && (ssize_t)(q + 4) <= got) {
            size_t slen = (size_t)head[q + 2] | ((size_t)head[q + 3] << 8);
            if (head[q] == 'B' && head[q + 1] == 'C' && slen == 2)
                is_bgzf = 1;
            q += 4 + slen;
        }
    }
    if (is_bgzf) {
        if (lseek(fd, 0, SEEK_SET) != 0) {
            close(fd);
            free(r);
            return NULL;
        }
        r->bgzf = 1;
        r->fd = fd;
        r->held_slot = -1;
        r->comp_cap = READ_BUF_SIZE;
        r->comp = (unsigned char *)malloc(r->comp_cap);
        /* Tiny seed buffer: the scanner swaps onto ring slots on the
         * first fill, so this only has to exist (tail source, len 0). */
        r->buf_cap = 64;
        r->buf = (unsigned char *)malloc(r->buf_cap);
        r->buf0 = r->buf;
        if (!r->comp || !r->buf) {
            close(fd);
            free(r->comp);
            free(r->buf);
            free(r);
            return NULL;
        }
        return r;
    }
    close(fd);
    r->gz = gzopen(path, "rb");
    if (!r->gz) {
        free(r);
        return NULL;
    }
    gzbuffer(r->gz, READ_BUF_SIZE);
    r->buf_cap = READ_BUF_SIZE;
    r->buf = (unsigned char *)malloc(r->buf_cap);
    if (!r->buf) {
        gzclose(r->gz);
        free(r);
        return NULL;
    }
    return r;
}

void fq_close(FqReader *r) {
    if (!r) return;
    if (r->bgzf) {
        bga_stop(r);
        close(r->fd);
        free(r->buf0);
        free(r->big_buf);
    } else {
        if (r->gz) gzclose(r->gz);
        free(r->buf);
    }
    if (r->tail_active) inflateEnd(&r->tail_zs);
    free(r->comp);
    free(r->pend_head);
    free(r->pend_qual);
    free(r->pend_seq);
    free(r);
}

const char *fq_error(FqReader *r) { return r->error; }
int64_t fq_error_line(FqReader *r) { return r->error_line; }
int fq_has_pending(FqReader *r) { return r->has_pending; }

static int fq_stash_pending(FqReader *r, const unsigned char *head,
                            size_t head_len, const unsigned char *seq,
                            const unsigned char *qual, size_t seq_len) {
    r->pend_head = (unsigned char *)malloc(head_len ? head_len : 1);
    r->pend_seq = (unsigned char *)malloc(seq_len ? seq_len : 1);
    r->pend_qual = (unsigned char *)malloc(seq_len ? seq_len : 1);
    if (!r->pend_head || !r->pend_seq || !r->pend_qual) return FQ_ERR_NOMEM;
    memcpy(r->pend_head, head, head_len);
    memcpy(r->pend_seq, seq, seq_len);
    memcpy(r->pend_qual, qual, seq_len);
    r->pend_head_len = head_len;
    r->pend_seq_len = seq_len;
    r->has_pending = 1;
    return FQ_OK;
}

/* Parse up to max_records records into the caller's columnar buffers.
 *
 * seq_buf/qual_buf: payload bytes (shared offsets array, len max_records+1,
 * offsets[0] must not be pre-filled — it is written here).
 * head_buf: header bytes without the leading '@' (own offsets array).
 * Returns FQ_OK (possibly 0 records at EOF) or an error code.
 * *n_records receives the record count. Parsing stops early when a record
 * would overflow a buffer; the record is carried to the next call. */
int fq_next_chunk(FqReader *r, int64_t max_records,
                  unsigned char *seq_buf, unsigned char *qual_buf,
                  int64_t payload_cap, int64_t *offsets,
                  unsigned char *head_buf, int64_t head_cap,
                  int64_t *head_offsets, int64_t *n_records) {
    int64_t n = 0;
    int64_t pos = 0, hpos = 0;
    offsets[0] = 0;
    head_offsets[0] = 0;
    *n_records = 0;

    if (r->has_pending) {
        if ((int64_t)r->pend_seq_len > payload_cap ||
            (int64_t)r->pend_head_len > head_cap) {
            /* The caller's buffers cannot hold even one record; return 0
             * records with the pending record intact — the caller detects
             * this via fq_has_pending and retries with larger buffers. */
            return FQ_OK;
        }
        memcpy(seq_buf, r->pend_seq, r->pend_seq_len);
        memcpy(qual_buf, r->pend_qual, r->pend_seq_len);
        memcpy(head_buf, r->pend_head, r->pend_head_len);
        pos = (int64_t)r->pend_seq_len;
        hpos = (int64_t)r->pend_head_len;
        offsets[1] = pos;
        head_offsets[1] = hpos;
        n = 1;
        free(r->pend_head);
        free(r->pend_seq);
        free(r->pend_qual);
        r->pend_head = r->pend_seq = r->pend_qual = NULL;
        r->has_pending = 0;
    }

    while (n < max_records) {
        unsigned char *head, *seq, *plus, *qual;
        size_t head_len, seq_len, plus_len, qual_len;
        int64_t head_line;
        int rc;

        /* Header line; tolerate stray blank lines between records (matches
         * the Python fallback in io/fastq.py). */
        do {
            rc = fq_next_line(r, &head, &head_len);
            if (rc == FQ_EOF) goto done;
            if (rc != FQ_OK) return rc;
        } while (head_len == 0);
        head_line = r->line_number - 1;
        if (head[0] != '@') {
            snprintf(r->error, sizeof(r->error),
                     "expected '@' at record start");
            r->error_line = head_line;
            return FQ_ERR_FORMAT;
        }
        /* Lines returned by fq_next_line point into the refill buffer and
         * can be invalidated (memmoved) by the next fq_next_line call, so
         * each piece is copied out before the next line is read. */
        {
            unsigned char head_tmp_stack[4096];
            unsigned char *head_tmp = head_tmp_stack;
            int head_heap = 0;
            if (head_len - 1 > sizeof(head_tmp_stack)) {
                head_tmp = (unsigned char *)malloc(head_len - 1);
                if (!head_tmp) return FQ_ERR_NOMEM;
                head_heap = 1;
            }
            memcpy(head_tmp, head + 1, head_len - 1);

            rc = fq_next_line(r, &seq, &seq_len);
            if (rc == FQ_EOF) {
                snprintf(r->error, sizeof(r->error),
                         "truncated FASTQ record");
                r->error_line = head_line;
                if (head_heap) free(head_tmp);
                return FQ_ERR_FORMAT;
            }
            if (rc != FQ_OK) { if (head_heap) free(head_tmp); return rc; }
            /* Copy sequence immediately (same invalidation hazard). */
            if (pos + (int64_t)seq_len > payload_cap ||
                hpos + (int64_t)(head_len - 1) > head_cap) {
                /* Caller's buffers are full: parse the record fully, stash
                 * it, and return what we have. */
                unsigned char *seq_tmp = (unsigned char *)malloc(
                    seq_len ? seq_len : 1);
                if (!seq_tmp) { if (head_heap) free(head_tmp);
                                return FQ_ERR_NOMEM; }
                memcpy(seq_tmp, seq, seq_len);
                rc = fq_next_line(r, &plus, &plus_len);
                if (rc != FQ_OK) {
                    free(seq_tmp);
                    if (head_heap) free(head_tmp);
                    if (rc == FQ_EOF) {
                        snprintf(r->error, sizeof(r->error),
                                 "truncated FASTQ record");
                        r->error_line = head_line;
                        return FQ_ERR_FORMAT;
                    }
                    return rc;
                }
                if (plus_len == 0 || plus[0] != '+') {
                    free(seq_tmp);
                    if (head_heap) free(head_tmp);
                    snprintf(r->error, sizeof(r->error),
                             "expected '+' on third record line");
                    r->error_line = head_line + 2;
                    return FQ_ERR_FORMAT;
                }
                rc = fq_next_line(r, &qual, &qual_len);
                if (rc != FQ_OK) {
                    free(seq_tmp);
                    if (head_heap) free(head_tmp);
                    if (rc == FQ_EOF) {
                        snprintf(r->error, sizeof(r->error),
                                 "truncated FASTQ record");
                        r->error_line = head_line;
                        return FQ_ERR_FORMAT;
                    }
                    return rc;
                }
                if (qual_len != seq_len) {
                    free(seq_tmp);
                    if (head_heap) free(head_tmp);
                    snprintf(r->error, sizeof(r->error),
                             "sequence and qualities differ in length");
                    r->error_line = head_line + 3;
                    return FQ_ERR_FORMAT;
                }
                rc = fq_stash_pending(r, head_tmp, head_len - 1, seq_tmp,
                                      qual, seq_len);
                free(seq_tmp);
                if (head_heap) free(head_tmp);
                if (rc != FQ_OK) return rc;
                goto done;
            }
            memcpy(seq_buf + pos, seq, seq_len);
            memcpy(head_buf + hpos, head_tmp, head_len - 1);
            if (head_heap) free(head_tmp);
        }

        rc = fq_next_line(r, &plus, &plus_len);
        if (rc == FQ_EOF) {
            snprintf(r->error, sizeof(r->error), "truncated FASTQ record");
            r->error_line = head_line;
            return FQ_ERR_FORMAT;
        }
        if (rc != FQ_OK) return rc;
        if (plus_len == 0 || plus[0] != '+') {
            snprintf(r->error, sizeof(r->error),
                     "expected '+' on third record line");
            r->error_line = head_line + 2;
            return FQ_ERR_FORMAT;
        }
        rc = fq_next_line(r, &qual, &qual_len);
        if (rc == FQ_EOF) {
            snprintf(r->error, sizeof(r->error), "truncated FASTQ record");
            r->error_line = head_line;
            return FQ_ERR_FORMAT;
        }
        if (rc != FQ_OK) return rc;
        if (qual_len != seq_len) {
            snprintf(r->error, sizeof(r->error),
                     "sequence and qualities differ in length");
            r->error_line = head_line + 3;
            return FQ_ERR_FORMAT;
        }
        memcpy(qual_buf + pos, qual, qual_len);
        pos += (int64_t)seq_len;
        hpos += (int64_t)(head_len - 1);
        n++;
        offsets[n] = pos;
        head_offsets[n] = hpos;
    }

done:
    *n_records = n;
    return FQ_OK;
}

/* ------------------------------------------------------------------ */
/* Phred quality reduction: mean per-base error rate per record.
 *
 * Same arithmetic as the reference's C extension
 * (/root/reference/src/fastqdedup/_fastqmodule.c:38-76): sequential
 * left-to-right float64 accumulation of a 128-entry LUT, uint8-wrapping
 * offset subtraction, range check against [phred_offset, 126]. */

#include "score_to_error_rate.h"

/* Batched: qual holds n records delimited by offsets (len n+1); writes the
 * mean error rate per record to out (NaN for empty records).  Returns -1 on
 * success or the byte index of the first out-of-range character. */
int64_t fq_avg_error_rates(const unsigned char *qual, const int64_t *offsets,
                           int64_t n, int phred_offset, double *out) {
    unsigned char max_score = (unsigned char)(126 - phred_offset);
    for (int64_t i = 0; i < n; i++) {
        int64_t start = offsets[i], end = offsets[i + 1];
        double total = 0.0;
        for (int64_t j = start; j < end; j++) {
            unsigned char score = (unsigned char)(qual[j] - phred_offset);
            if (score > max_score) return j;
            total += SCORE_TO_ERROR_RATE[score];
        }
        out[i] = total / (double)(end - start);
    }
    return -1;
}

/* Threaded wrapper: records are independent, so ranges split across
 * pthreads; per-record arithmetic is the identical sequential float64
 * loop.  The reported out-of-range byte index is the minimum over
 * threads — i.e. still the FIRST bad byte of the batch. */

typedef struct {
    const unsigned char *qual;
    const int64_t *offsets;
    int64_t lo, hi;
    int phred_offset;
    double *out;
    int64_t bad;
} AvgErrWork;

static void *avg_err_worker(void *arg) {
    AvgErrWork *w = (AvgErrWork *)arg;
    w->bad = fq_avg_error_rates(w->qual, w->offsets + w->lo,
                                w->hi - w->lo, w->phred_offset,
                                w->out + w->lo);
    return NULL;
}

int64_t fq_avg_error_rates_mt(const unsigned char *qual,
                              const int64_t *offsets, int64_t n,
                              int phred_offset, double *out,
                              int nthreads) {
    if (nthreads <= 0) {
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        nthreads = cores > 0 ? (int)cores : 1;
    }
    if (nthreads > 8) nthreads = 8;
    if ((int64_t)nthreads > n) nthreads = n > 0 ? (int)n : 1;
    if (nthreads <= 1 || n < (1 << 15))
        return fq_avg_error_rates(qual, offsets, n, phred_offset, out);
    AvgErrWork works[8];
    pthread_t tids[8];
    for (int t = 0; t < nthreads; t++) {
        works[t].qual = qual;
        works[t].offsets = offsets;
        works[t].lo = n * t / nthreads;
        works[t].hi = n * (t + 1) / nthreads;
        works[t].phred_offset = phred_offset;
        works[t].out = out;
        works[t].bad = -1;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, avg_err_worker, &works[t]);
    avg_err_worker(&works[0]);
    int64_t bad = -1;
    for (int t = 0; t < nthreads; t++) {
        if (t) pthread_join(tids[t], NULL);
        if (works[t].bad >= 0) {
            /* Worker-local index is relative to offsets[lo]'s byte
             * origin already (fq_avg_error_rates reports absolute byte
             * positions within qual because the sliced offsets still
             * hold absolute byte values). */
            if (bad < 0 || works[t].bad < bad)
                bad = works[t].bad;
        }
    }
    return bad;
}

/* ------------------------------------------------------------------ */
/* Gzip block writer: manual header with MTIME=0 + raw deflate, emitting
 * output byte-identical to CPython's gzip.GzipFile(mtime=0) so runs are
 * deterministic (see fastqdedup_tpu/io/opener.py). */

typedef struct {
    FILE *fp;
    z_stream zs;
    uint32_t crc;
    uint64_t isize;
    unsigned char out[READ_BUF_SIZE];
    int active;
} FqWriter;

FqWriter *fqw_open(const char *path, int compresslevel) {
    FqWriter *w = (FqWriter *)calloc(1, sizeof(FqWriter));
    if (!w) return NULL;
    w->fp = fopen(path, "wb");
    if (!w->fp) {
        free(w);
        return NULL;
    }
    if (deflateInit2(&w->zs, compresslevel, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK) {
        fclose(w->fp);
        free(w);
        return NULL;
    }
    unsigned char xfl = compresslevel == 9 ? 2
                      : compresslevel == 1 ? 4 : 0;
    unsigned char header[10] = {0x1f, 0x8b, 8, 0, 0, 0, 0, 0, xfl, 0xff};
    if (fwrite(header, 1, 10, w->fp) != 10) {
        deflateEnd(&w->zs);
        fclose(w->fp);
        free(w);
        return NULL;
    }
    w->crc = crc32(0L, Z_NULL, 0);
    w->active = 1;
    return w;
}

static int fqw_deflate(FqWriter *w, int flush) {
    do {
        w->zs.next_out = w->out;
        w->zs.avail_out = READ_BUF_SIZE;
        int rc = deflate(&w->zs, flush);
        if (rc == Z_STREAM_ERROR) return FQ_ERR_IO;
        size_t have = READ_BUF_SIZE - w->zs.avail_out;
        if (have && fwrite(w->out, 1, have, w->fp) != have)
            return FQ_ERR_IO;
    } while (w->zs.avail_out == 0);
    return FQ_OK;
}

int fqw_write(FqWriter *w, const unsigned char *data, int64_t len) {
    int64_t done = 0;
    w->isize += (uint64_t)len;
    while (done < len) {
        unsigned step = (unsigned)((len - done) > (1 << 30)
                                   ? (1 << 30) : (len - done));
        w->crc = crc32(w->crc, data + done, step);
        w->zs.next_in = (unsigned char *)data + done;
        w->zs.avail_in = step;
        if (fqw_deflate(w, Z_NO_FLUSH) != FQ_OK) return FQ_ERR_IO;
        done += step - w->zs.avail_in;
    }
    return FQ_OK;
}

int fqw_close(FqWriter *w) {
    if (!w) return FQ_OK;
    int rc = FQ_OK;
    if (w->active) {
        w->zs.next_in = Z_NULL;
        w->zs.avail_in = 0;
        if (fqw_deflate(w, Z_FINISH) != FQ_OK) rc = FQ_ERR_IO;
        unsigned char trailer[8];
        uint32_t crc = w->crc, isize = (uint32_t)w->isize;
        for (int i = 0; i < 4; i++) {
            trailer[i] = (unsigned char)(crc >> (8 * i));
            trailer[4 + i] = (unsigned char)(isize >> (8 * i));
        }
        if (fwrite(trailer, 1, 8, w->fp) != 8) rc = FQ_ERR_IO;
        deflateEnd(&w->zs);
        if (fclose(w->fp) != 0) rc = FQ_ERR_IO;
    }
    free(w);
    return rc;
}

/* ================= Key accumulator =====================================
 *
 * Open-addressing hash table over ragged byte keys, replacing the
 * reference trie's per-record count aggregation (_triemodule.c:233-239)
 * on the host side of the TPU pipeline.  For every distinct key it tracks
 *
 *   - count      : number of quality-PASSING records with this key
 *   - first_pos  : global record index of the key's first occurrence
 *                  among ALL records (the reference's pass 3 emits the
 *                  first record in file order regardless of the quality
 *                  filter, __init__.py:189-206)
 *
 * Key bytes live in an append-only arena; per-key metadata (count,
 * first_pos, arena offset) lives in INSERTION-ORDER arrays so that
 * acc_export is four sequential memcpys instead of 31M random arena
 * reads (25 s -> ~2 s at 31M x 100 bp keys).  Slots are a bare
 * {hash, meta index} pair — 16 bytes, four per cache line — probed by
 * hash match then memcmp verify.  Called through ctypes with the GIL
 * released, so accumulation overlaps parsing and device work.
 */

typedef struct {
    uint64_t hash;
    int64_t idx;       /* index into meta arrays; -1 marks an empty slot */
} AccSlot;

typedef struct {
    AccSlot *slots;
    size_t cap;        /* power of two */
    size_t used;
    unsigned char *arena;
    size_t arena_len, arena_cap;
    /* insertion-ordered metadata, length `used`, capacity `meta_cap`.
     * key_off is strictly increasing (keys append to the arena), so
     * entry i's length is key_off[i+1] - key_off[i] with arena_len as
     * the final sentinel. */
    int64_t *count;
    int64_t *first_pos;
    int64_t *key_off;
    size_t meta_cap;
    /* Byte-presence bitmap over all inserted key bytes: lets the
     * partition builder derive the alphabet without rescanning the
     * (possibly multi-gigabyte) merged key table on every host. */
    unsigned char present[256];
} KeyAcc;

static inline int64_t acc_entry_len(const KeyAcc *a, int64_t idx) {
    int64_t end = ((size_t)(idx + 1) < a->used)
        ? a->key_off[idx + 1] : (int64_t)a->arena_len;
    return end - a->key_off[idx];
}

static uint64_t acc_mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

static uint64_t acc_hash(const unsigned char *p, size_t n) {
    uint64_t h = 0x9e3779b97f4a7c15ULL ^ (uint64_t)n;
    while (n >= 8) {
        uint64_t k;
        memcpy(&k, p, 8);
        h = acc_mix64(h ^ k) * 0x2545F4914F6CDD1DULL;
        p += 8; n -= 8;
    }
    uint64_t k = 0;
    memcpy(&k, p, n);
    return acc_mix64(h ^ k);
}

/* One retired accumulator is retained between runs (page-backed slots +
 * arena are the process's largest recurring C allocations; re-mallocing
 * them every run pays the host's page-creation cost again).  Retention
 * is capped so a one-off giant run cannot pin gigabytes. */
#define ACC_RETIRED_SLOTS 4  /* sharded accumulators retire S tables */
static KeyAcc *acc_retired[ACC_RETIRED_SLOTS];
static pthread_mutex_t acc_retired_mu = PTHREAD_MUTEX_INITIALIZER;
#define ACC_RETAIN_MAX ((size_t)512 << 20)

static size_t acc_footprint(const KeyAcc *a) {
    return a->cap * sizeof(AccSlot) + a->arena_cap
        + 3 * a->meta_cap * sizeof(int64_t);
}

KeyAcc *acc_new(int64_t expected) {
    pthread_mutex_lock(&acc_retired_mu);
    KeyAcc *r = NULL;
    for (int s = 0; s < ACC_RETIRED_SLOTS; s++) {
        if (acc_retired[s]) {
            r = acc_retired[s];
            acc_retired[s] = NULL;
            break;
        }
    }
    pthread_mutex_unlock(&acc_retired_mu);
    if (r) {
        for (size_t i = 0; i < r->cap; i++) r->slots[i].idx = -1;
        r->used = 0;
        r->arena_len = 0;
        memset(r->present, 0, sizeof(r->present));
        return r;
    }
    KeyAcc *a = (KeyAcc *)calloc(1, sizeof(KeyAcc));
    if (!a) return NULL;
    size_t cap = 1024;
    while ((int64_t)cap < expected * 2) cap <<= 1;
    a->slots = (AccSlot *)malloc(cap * sizeof(AccSlot));
    if (!a->slots) { free(a); return NULL; }
    for (size_t i = 0; i < cap; i++) a->slots[i].idx = -1;
    a->cap = cap;
    a->arena_cap = 1 << 20;
    a->arena = (unsigned char *)malloc(a->arena_cap);
    a->meta_cap = 1024;
    a->count = (int64_t *)malloc(a->meta_cap * sizeof(int64_t));
    a->first_pos = (int64_t *)malloc(a->meta_cap * sizeof(int64_t));
    a->key_off = (int64_t *)malloc(a->meta_cap * sizeof(int64_t));
    if (!a->arena || !a->count || !a->first_pos || !a->key_off) {
        free(a->slots); free(a->arena); free(a->count);
        free(a->first_pos); free(a->key_off); free(a);
        return NULL;
    }
    return a;
}

void acc_free(KeyAcc *a) {
    if (!a) return;
    if (acc_footprint(a) <= ACC_RETAIN_MAX) {
        pthread_mutex_lock(&acc_retired_mu);
        for (int s = 0; s < ACC_RETIRED_SLOTS; s++) {
            if (!acc_retired[s]) {
                acc_retired[s] = a;
                a = NULL;
                break;
            }
        }
        pthread_mutex_unlock(&acc_retired_mu);
        if (!a) return;
    }
    free(a->slots);
    free(a->arena);
    free(a->count);
    free(a->first_pos);
    free(a->key_off);
    free(a);
}

static int acc_grow(KeyAcc *a) {
    size_t new_cap = a->cap * 2;
    AccSlot *ns = (AccSlot *)malloc(new_cap * sizeof(AccSlot));
    if (!ns) return FQ_ERR_NOMEM;
    populate_write(ns, new_cap * sizeof(AccSlot));
    for (size_t i = 0; i < new_cap; i++) ns[i].idx = -1;
    size_t mask = new_cap - 1;
    for (size_t i = 0; i < a->cap; i++) {
        const AccSlot *e = &a->slots[i];
        if (e->idx < 0) continue;
        size_t j = (size_t)e->hash & mask;
        while (ns[j].idx >= 0) j = (j + 1) & mask;
        ns[j] = *e;
    }
    free(a->slots);
    a->slots = ns;
    a->cap = new_cap;
    return FQ_OK;
}

static int acc_meta_grow(KeyAcc *a) {
    size_t nc = a->meta_cap * 2;
    int64_t *c = (int64_t *)realloc(a->count, nc * sizeof(int64_t));
    if (!c) return FQ_ERR_NOMEM;
    a->count = c;
    int64_t *f = (int64_t *)realloc(a->first_pos, nc * sizeof(int64_t));
    if (!f) return FQ_ERR_NOMEM;
    a->first_pos = f;
    int64_t *k = (int64_t *)realloc(a->key_off, nc * sizeof(int64_t));
    if (!k) return FQ_ERR_NOMEM;
    a->key_off = k;
    a->meta_cap = nc;
    return FQ_OK;
}

/* Insert/update one batch of ragged keys.
 * counted: optional uint8[n] (NULL = every record counts); first_pos is
 * tracked for every record either way.  base = global index of record 0.
 * is_new: optional uint8[n] output — 1 where the record inserted a key
 * not seen before (i.e. the record IS its key's first occurrence, since
 * batches arrive in global record order); such records are exactly the
 * candidates pass 3 may emit, so the caller can snapshot their rendered
 * bytes instead of re-reading the input (pipeline record-arena mode). */
static int acc_add_impl(KeyAcc *a, const unsigned char *key_data,
                        const int64_t *key_offsets,
                        const unsigned char *counted,
                        int64_t n, int64_t base, unsigned char *is_new) {
    /* Hash a small window ahead and prefetch the home slots: at tens of
     * millions of keys every probe is a random DRAM access, and issuing
     * a batch of independent loads overlaps their latency (the probe
     * loop below is otherwise one dependent miss per record). */
#define ACC_PREFETCH 16
    uint64_t hwin[ACC_PREFETCH];
    for (int64_t i = 0; i < n; i++) {
        int64_t w = i % ACC_PREFETCH;
        if (w == 0) {
            int64_t hi = i + ACC_PREFETCH < n ? i + ACC_PREFETCH : n;
            size_t pmask = a->cap - 1;
            for (int64_t k = i; k < hi; k++) {
                const unsigned char *kp = key_data + key_offsets[k];
                size_t kl = (size_t)(key_offsets[k + 1] - key_offsets[k]);
                hwin[k - i] = acc_hash(kp, kl);
                __builtin_prefetch(&a->slots[(size_t)hwin[k - i] & pmask]);
            }
        }
        const unsigned char *key = key_data + key_offsets[i];
        size_t len = (size_t)(key_offsets[i + 1] - key_offsets[i]);
        uint64_t h = hwin[w];
        size_t mask = a->cap - 1;
        size_t j = (size_t)h & mask;
        int inserted = 0;
        int64_t idx;
        for (;;) {
            const AccSlot *e = &a->slots[j];
            idx = e->idx;
            if (idx < 0) break;
            if (e->hash == h &&
                acc_entry_len(a, idx) == (int64_t)len &&
                memcmp(a->arena + a->key_off[idx], key, len) == 0)
                break;
            j = (j + 1) & mask;
        }
        if (idx < 0) {
            if (a->arena_len + len > a->arena_cap) {
                size_t nc = a->arena_cap * 2;
                while (a->arena_len + len > nc) nc *= 2;
                unsigned char *na = (unsigned char *)realloc(a->arena, nc);
                if (!na) return FQ_ERR_NOMEM;
                /* mremap keeps existing pages; pre-fault only the new
                 * tail (populating present pages is a cheap no-op). */
                populate_write(na + a->arena_cap, nc - a->arena_cap);
                a->arena = na;
                a->arena_cap = nc;
            }
            if (a->used == a->meta_cap) {
                if (acc_meta_grow(a) != FQ_OK) return FQ_ERR_NOMEM;
            }
            memcpy(a->arena + a->arena_len, key, len);
            for (size_t b = 0; b < len; b++) a->present[key[b]] = 1;
            idx = (int64_t)a->used;
            a->slots[j].hash = h;
            a->slots[j].idx = idx;
            a->count[idx] = 0;
            a->first_pos[idx] = base + i;
            a->key_off[idx] = (int64_t)a->arena_len;
            a->arena_len += len;
            a->used++;
            inserted = 1;
        }
        if (!counted || counted[i]) a->count[idx]++;
        if (base + i < a->first_pos[idx]) {
            a->first_pos[idx] = base + i;
            /* Out-of-order ingest (parallel range readers): this record
             * BECOMES the key's first occurrence, so the arena must
             * capture it too; the superseded entry is harmless (pass 3
             * gathers by exact final first positions).  In-order
             * streams never take this branch for existing keys. */
            inserted = 1;
        }
        if (is_new) is_new[i] = (unsigned char)inserted;
        if (a->used * 4 > a->cap * 3) {
            if (acc_grow(a) != FQ_OK) return FQ_ERR_NOMEM;
        }
    }
    return FQ_OK;
}

int acc_add(KeyAcc *a, const unsigned char *key_data,
            const int64_t *key_offsets, const unsigned char *counted,
            int64_t n, int64_t base) {
    return acc_add_impl(a, key_data, key_offsets, counted, n, base, NULL);
}

int acc_add_mark(KeyAcc *a, const unsigned char *key_data,
                 const int64_t *key_offsets, const unsigned char *counted,
                 int64_t n, int64_t base, unsigned char *is_new) {
    return acc_add_impl(a, key_data, key_offsets, counted, n, base, is_new);
}

int64_t acc_size(const KeyAcc *a) { return (int64_t)a->used; }
int64_t acc_key_bytes(const KeyAcc *a) { return (int64_t)a->arena_len; }

void acc_byte_presence(const KeyAcc *a, unsigned char *out256) {
    memcpy(out256, a->present, 256);
}

/* Dump every entry in INSERTION (first-seen) order — a deterministic
 * function of the input stream.  Keys are contiguous in the arena in
 * exactly this order, so the whole export is sequential memcpy.
 * Caller allocates: key_out[arena_len], offsets_out[used+1],
 * counts_out[used], firstpos_out[used]. */
/* Parallel memcpy: at 31M x 100 bp keys the export moves ~4 GB into
 * freshly allocated numpy buffers; splitting each copy across threads
 * parallelizes both the copy and the destination page faults. */

#define COPY_MAX_THREADS 8

typedef struct {
    const char *src;
    char *dst;
    size_t lo, hi;
} CopyWork;

static void *copy_worker(void *arg) {
    CopyWork *w = (CopyWork *)arg;
    memcpy(w->dst + w->lo, w->src + w->lo, w->hi - w->lo);
    return NULL;
}

static void par_memcpy(void *dst, const void *src, size_t n,
                       int nthreads) {
    if (n < (8 << 20) || nthreads <= 1) {
        memcpy(dst, src, n);
        return;
    }
    if (nthreads > COPY_MAX_THREADS) nthreads = COPY_MAX_THREADS;
    CopyWork works[COPY_MAX_THREADS];
    pthread_t tids[COPY_MAX_THREADS];
    size_t per = (n / (size_t)nthreads + 4095) & ~(size_t)4095;
    int used = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t lo = (size_t)t * per;
        if (lo >= n) break;
        size_t hi = lo + per;
        if (hi > n) hi = n;
        works[used].src = (const char *)src;
        works[used].dst = (char *)dst;
        works[used].lo = lo;
        works[used].hi = hi;
        used++;
    }
    for (int t = 1; t < used; t++)
        pthread_create(&tids[t], NULL, copy_worker, &works[t]);
    copy_worker(&works[0]);
    for (int t = 1; t < used; t++)
        pthread_join(tids[t], NULL);
}

void acc_export(const KeyAcc *a, unsigned char *key_out,
                int64_t *offsets_out, int64_t *counts_out,
                int64_t *firstpos_out) {
    int nt = 8;
    par_memcpy(key_out, a->arena, a->arena_len, nt);
    par_memcpy(counts_out, a->count, a->used * sizeof(int64_t), nt);
    par_memcpy(firstpos_out, a->first_pos, a->used * sizeof(int64_t), nt);
    par_memcpy(offsets_out, a->key_off, a->used * sizeof(int64_t), nt);
    offsets_out[a->used] = (int64_t)a->arena_len;
}

/* Per-key 64-bit content hashes (acc_hash of the key bytes, which salts
 * on length), indexed by insertion order to line up with acc_export.
 * The hashes already sit in the probe slots, so the export is one
 * O(capacity) sweep.  Multi-host finalize orders the gathered global
 * table by these (content-determined, so identical for the same key on
 * every host) instead of re-hashing the whole table per host. */
void acc_export_hashes(const KeyAcc *a, uint64_t *out) {
    for (size_t i = 0; i < a->cap; i++) {
        const AccSlot *e = &a->slots[i];
        if (e->idx >= 0) out[e->idx] = e->hash;
    }
}

/* ================= Ragged record rendering =============================
 *
 * Assemble selected FASTQ records ("@header\nseq\n+\nqual\n") straight
 * into one output byte buffer with memcpy — the vectorized-numpy fancy
 * indexing this replaces traverses [rows, L] int64 index matrices and is
 * ~20x slower.  Used by pass 3 (pipeline._filter_and_write).
 */
int64_t fq_render_records(const unsigned char *seq, const unsigned char *qual,
                          const int64_t *offsets,
                          const unsigned char *head,
                          const int64_t *head_offsets,
                          const int64_t *rows, int64_t n_rows,
                          unsigned char *out) {
    unsigned char *p = out;
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t i = rows[r];
        int64_t s0 = offsets[i], sl = offsets[i + 1] - s0;
        int64_t h0 = head_offsets[i], hl = head_offsets[i + 1] - h0;
        *p++ = '@';
        memcpy(p, head + h0, (size_t)hl); p += hl;
        *p++ = '\n';
        memcpy(p, seq + s0, (size_t)sl); p += sl;
        *p++ = '\n'; *p++ = '+'; *p++ = '\n';
        memcpy(p, qual + s0, (size_t)sl); p += sl;
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

/* Thread-parallel variant: the caller precomputes each row's output
 * offset (cumsum of rendered record sizes), which makes every row's
 * destination independent — threads render disjoint row ranges. */
typedef struct {
    const unsigned char *seq, *qual, *head;
    const int64_t *offsets, *head_offsets, *rows, *out_offsets;
    unsigned char *out;
    int64_t lo, hi;
} RenderWork;

static void *render_worker(void *arg) {
    RenderWork *w = (RenderWork *)arg;
    for (int64_t r = w->lo; r < w->hi; r++) {
        int64_t i = w->rows[r];
        int64_t s0 = w->offsets[i], sl = w->offsets[i + 1] - s0;
        int64_t h0 = w->head_offsets[i];
        int64_t hl = w->head_offsets[i + 1] - h0;
        unsigned char *p = w->out + w->out_offsets[r];
        *p++ = '@';
        memcpy(p, w->head + h0, (size_t)hl); p += hl;
        *p++ = '\n';
        memcpy(p, w->seq + s0, (size_t)sl); p += sl;
        *p++ = '\n'; *p++ = '+'; *p++ = '\n';
        memcpy(p, w->qual + s0, (size_t)sl); p += sl;
        *p++ = '\n';
    }
    return NULL;
}

void fq_render_records_mt(const unsigned char *seq,
                          const unsigned char *qual,
                          const int64_t *offsets,
                          const unsigned char *head,
                          const int64_t *head_offsets,
                          const int64_t *rows, int64_t n_rows,
                          const int64_t *out_offsets,
                          unsigned char *out, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > n_rows) nthreads = n_rows > 0 ? (int)n_rows : 1;
    RenderWork works[16];
    pthread_t tids[16];
    int64_t per = n_rows / nthreads, rem = n_rows % nthreads, at = 0;
    for (int t = 0; t < nthreads; t++) {
        works[t].seq = seq; works[t].qual = qual; works[t].head = head;
        works[t].offsets = offsets; works[t].head_offsets = head_offsets;
        works[t].rows = rows; works[t].out_offsets = out_offsets;
        works[t].out = out;
        works[t].lo = at;
        at += per + (t < rem ? 1 : 0);
        works[t].hi = at;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, render_worker, &works[t]);
    render_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

/* ================= Union-find over an edge list ========================
 *
 * Connected components of the within-distance pair graph (the reference's
 * pop_cluster partition, _triemodule.c:778-897).  Union by min-index root
 * with path halving: the returned label of every node is the smallest
 * node index in its component — matching the numpy min-label propagation
 * it replaces, at ~100M edges/s instead of multi-second scatter sweeps.
 */

static int64_t uf_find(int64_t *parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

int uf_components(int64_t n, const int64_t *ei, const int64_t *ej,
                  int64_t e, int64_t *labels_out) {
    int64_t *parent = labels_out;  /* in-place scratch */
    for (int64_t i = 0; i < n; i++) parent[i] = i;
    for (int64_t k = 0; k < e; k++) {
        int64_t a = uf_find(parent, ei[k]);
        int64_t b = uf_find(parent, ej[k]);
        if (a == b) continue;
        /* Attach the larger-index root beneath the smaller, so the root
         * of every component is its minimum member. */
        if (a < b) parent[b] = a;
        else parent[a] = b;
    }
    for (int64_t i = 0; i < n; i++) labels_out[i] = uf_find(parent, i);
    return FQ_OK;
}

/* Partition assembly as a counting sort: labels are component roots in
 * [0, n), so grouping keys by component needs no comparison sort.  One
 * count pass + one prefix pass + one stable scatter produce the grouped
 * order, per-key dense cluster id / within-cluster position, and the
 * C+1 cluster prefix array — O(n) total, replacing an O(n log n)
 * argsort that measured ~0.4 s replicated per host at 2.5M keys.
 * Dense ids ascend with label value and the scatter visits keys in
 * index order, so the output is bit-identical to
 * np.argsort(labels, kind="stable") grouping. */
int fq_partition_assemble(int64_t n, const int64_t *labels,
                          int64_t *order, int64_t *cluster_of,
                          int64_t *local_index,
                          int64_t *starts_out /* capacity n + 1 */,
                          int64_t *num_clusters_out) {
    if (n <= 0) { *num_clusters_out = 0; starts_out[0] = 0; return FQ_OK; }
    int64_t *cnt = (int64_t *)calloc((size_t)n, sizeof(int64_t));
    if (!cnt) return FQ_ERR_NOMEM;
    for (int64_t i = 0; i < n; i++) cnt[labels[i]]++;
    int64_t c = 0, off = 0;
    for (int64_t l = 0; l < n; l++) {
        if (cnt[l]) {
            starts_out[c] = off;
            off += cnt[l];
            cnt[l] = c++;  /* reuse slot as the dense cluster id */
        }
    }
    starts_out[c] = n;
    int64_t *cursor = (int64_t *)malloc((size_t)c * sizeof(int64_t));
    if (!cursor) { free(cnt); return FQ_ERR_NOMEM; }
    memcpy(cursor, starts_out, (size_t)c * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        int64_t d = cnt[labels[i]];
        int64_t pos = cursor[d]++;
        order[pos] = i;
        cluster_of[i] = d;
        local_index[i] = pos - starts_out[d];
    }
    free(cursor);
    free(cnt);
    *num_clusters_out = c;
    return FQ_OK;
}

/* Batched query: out[i] = stored first_pos of key i, or -1 if absent.
 * With keys inserted at base 0 in a single acc_add call, first_pos IS
 * the insertion row id — which makes this a perfect-hash index lookup
 * for pass 3's kept-key membership (pipeline._filter_and_write). */
void acc_lookup(const KeyAcc *a, const unsigned char *key_data,
                const int64_t *key_offsets, int64_t n, int64_t *out) {
    size_t mask = a->cap - 1;
    for (int64_t i = 0; i < n; i++) {
        const unsigned char *key = key_data + key_offsets[i];
        size_t len = (size_t)(key_offsets[i + 1] - key_offsets[i]);
        uint64_t h = acc_hash(key, len);
        size_t j = (size_t)h & mask;
        out[i] = -1;
        for (;;) {
            const AccSlot *e = &a->slots[j];
            if (e->idx < 0) break;
            if (e->hash == h &&
                acc_entry_len(a, e->idx) == (int64_t)len &&
                memcmp(a->arena + a->key_off[e->idx], key, len) == 0) {
                out[i] = a->first_pos[e->idx];
                break;
            }
            j = (j + 1) & mask;
        }
    }
}

/* ---- Row-content hashing ---------------------------------------------
 *
 * C twin of ops/bucket.py:_hash_window_rows: per-row 64-bit content
 * hashes over a [n, width] uint8 window (row stride allowed, columns
 * contiguous), bit-identical to the numpy implementation on the same
 * machine (both consume native-endian 8-byte words; the final partial
 * word is zero-extended).  The numpy version makes 2-5 full passes over
 * the window (pad copy, Fortran transpose, per-column ufuncs); this one
 * reads each row once, and rows split across pthreads — it feeds the
 * pigeonhole bucket grouping (twice per segment pass, every host) and
 * the edit-mode candidate join, both hot at tens of millions of keys. */

static inline uint64_t hr_mix(uint64_t h) {
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDULL;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ULL;
    h ^= h >> 33;
    return h;
}

typedef struct {
    const unsigned char *base;
    int64_t row_stride, width, lo, hi;
    uint64_t seed;
    int strong;
    uint64_t *out;
} HashRowsWork;

static void *hash_rows_worker(void *arg) {
    HashRowsWork *w = (HashRowsWork *)arg;
    const int64_t nwords = w->width / 8;
    const int64_t rem = w->width % 8;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *p = w->base + i * w->row_stride;
        uint64_t h = w->seed;
        for (int64_t c = 0; c < nwords; c++) {
            uint64_t word;
            memcpy(&word, p + c * 8, 8);
            h ^= word;
            if (w->strong) {
                h = hr_mix(h) * 0x2545F4914F6CDD1DULL;
            } else {
                h *= 0x2545F4914F6CDD1DULL;
                h ^= h >> 29;
            }
        }
        if (rem) {
            uint64_t word = 0;
            memcpy(&word, p + nwords * 8, (size_t)rem);
            h ^= word;
            if (w->strong) {
                h = hr_mix(h) * 0x2545F4914F6CDD1DULL;
            } else {
                h *= 0x2545F4914F6CDD1DULL;
                h ^= h >> 29;
            }
        }
        w->out[i] = hr_mix(h);
    }
    return NULL;
}

#define HASH_ROWS_MAX_THREADS 8

void fq_hash_rows(const unsigned char *base, int64_t n, int64_t row_stride,
                  int64_t width, uint64_t seed, int strong, int nthreads,
                  uint64_t *out) {
    if (n <= 0) return;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    /* Thread spawn costs ~50us each; only worth it for real row counts. */
    if (n < 65536) nthreads = 1;
    HashRowsWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].base = base;
        works[t].row_stride = row_stride;
        works[t].width = width;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
        works[t].seed = seed;
        works[t].strong = strong;
        works[t].out = out;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, hash_rows_worker, &works[t]);
    hash_rows_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

/* Lexicographic rank of fixed-width byte rows (threaded sample sort).
 *
 * rank[i] = position of row i in the ascending memcmp order of all m
 * rows, ties broken by row index — exactly numpy's stable void argsort
 * (np.argsort(void, kind="stable") then rank[order] = arange), which
 * the dissection paths need for the reference's lexicographic
 * tie-breaking (__init__.py:68,99-111) but which numpy computes 5-10x
 * slower (indirect void comparisons, single thread).
 *
 * Parallel plan: sort a sample to pick nthreads-1 splitter rows, bucket
 * every row by binary search over the splitters (one pass, threaded),
 * then qsort each bucket on its own thread.  Buckets are contiguous
 * rank ranges, so rank assignment is a per-bucket sequential sweep. */

typedef struct {
    const unsigned char *mat;
    int64_t width;
} RowCmpCtx;

static int row_cmp_r(const void *a, const void *b, void *arg) {
    RowCmpCtx *c = (RowCmpCtx *)arg;
    int64_t ia = *(const int64_t *)a, ib = *(const int64_t *)b;
    int r = memcmp(c->mat + ia * c->width, c->mat + ib * c->width,
                   (size_t)c->width);
    if (r) return r;
    return ia < ib ? -1 : (ia > ib ? 1 : 0);
}

typedef struct {
    const unsigned char *mat;
    int64_t width, lo, hi, nbuckets;
    const int64_t *splitters;   /* row ids of nbuckets-1 ascending rows */
    int64_t *bucket_of;         /* out: bucket id per row */
    int64_t *counts;            /* out: per-bucket counts (private) */
} RankClassifyWork;

static void *rank_classify_worker(void *arg) {
    RankClassifyWork *w = (RankClassifyWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++) {
        int64_t lo = 0, hi = w->nbuckets - 1;  /* buckets [0, n-1] */
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            int64_t s = w->splitters[mid];
            int r = memcmp(w->mat + i * w->width,
                           w->mat + s * w->width, (size_t)w->width);
            if (r < 0 || (r == 0 && i < s)) hi = mid;
            else lo = mid + 1;
        }
        w->bucket_of[i] = lo;
        w->counts[lo]++;
    }
    return NULL;
}

typedef struct {
    RowCmpCtx ctx;
    int64_t *order;     /* this bucket's slice */
    int64_t count;      /* rows in the bucket */
    int64_t rank_base;  /* global rank of the bucket's first row */
    int64_t *rank_out;
} RankSortWork;

static void *rank_sort_worker(void *arg) {
    RankSortWork *w = (RankSortWork *)arg;
    qsort_r(w->order, (size_t)w->count, sizeof(int64_t), row_cmp_r,
            &w->ctx);
    for (int64_t k = 0; k < w->count; k++)
        w->rank_out[w->order[k]] = w->rank_base + k;
    return NULL;
}

int fq_rank_rows(const unsigned char *mat, int64_t m, int64_t width,
                 int nthreads, int64_t *scratch /* >= 2m + 64*threads */,
                 int64_t *rank_out) {
    if (m <= 0) return FQ_OK;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (m < 32768) nthreads = 1;
    RowCmpCtx ctx = {mat, width};
    int64_t *order = scratch;            /* [m] */
    int64_t *bucket_of = scratch + m;    /* [m] */
    if (nthreads == 1) {
        for (int64_t i = 0; i < m; i++) order[i] = i;
        RankSortWork w = {ctx, order, m, 0, rank_out};
        rank_sort_worker(&w);
        return FQ_OK;
    }
    int64_t nbuckets = nthreads;
    /* Sample 64 rows per bucket, sort them, take quantile splitters. */
    int64_t nsample = 64 * nbuckets;
    if (nsample > m) nsample = m;
    int64_t *sample = scratch + 2 * m;   /* [nsample] */
    int64_t step = m / nsample;
    for (int64_t k = 0; k < nsample; k++) sample[k] = k * step;
    qsort_r(sample, (size_t)nsample, sizeof(int64_t), row_cmp_r, &ctx);
    int64_t splitters[HASH_ROWS_MAX_THREADS];
    for (int64_t b = 0; b + 1 < nbuckets; b++)
        splitters[b] = sample[(b + 1) * nsample / nbuckets];

    RankClassifyWork cworks[HASH_ROWS_MAX_THREADS];
    int64_t counts[HASH_ROWS_MAX_THREADS][HASH_ROWS_MAX_THREADS];
    memset(counts, 0, sizeof(counts));
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = m / nthreads;
    for (int t = 0; t < nthreads; t++) {
        cworks[t].mat = mat;
        cworks[t].width = width;
        cworks[t].lo = t * per;
        cworks[t].hi = (t == nthreads - 1) ? m : (t + 1) * per;
        cworks[t].nbuckets = nbuckets;
        cworks[t].splitters = splitters;
        cworks[t].bucket_of = bucket_of;
        cworks[t].counts = counts[t];
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, rank_classify_worker, &cworks[t]);
    rank_classify_worker(&cworks[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);

    /* Bucket starts, then scatter row ids into their bucket slices in
     * ascending row order (per-thread slices scanned in order keep the
     * scatter deterministic; ordering within a bucket is finalized by
     * the qsort anyway). */
    int64_t bucket_start[HASH_ROWS_MAX_THREADS + 1];
    bucket_start[0] = 0;
    for (int64_t b = 0; b < nbuckets; b++) {
        int64_t total = 0;
        for (int t = 0; t < nthreads; t++) total += counts[t][b];
        bucket_start[b + 1] = bucket_start[b] + total;
    }
    int64_t cursor[HASH_ROWS_MAX_THREADS];
    for (int64_t b = 0; b < nbuckets; b++) cursor[b] = bucket_start[b];
    for (int64_t i = 0; i < m; i++)
        order[cursor[bucket_of[i]]++] = i;

    RankSortWork sworks[HASH_ROWS_MAX_THREADS];
    for (int64_t b = 0; b < nbuckets; b++) {
        sworks[b].ctx = ctx;
        sworks[b].order = order + bucket_start[b];
        sworks[b].count = bucket_start[b + 1] - bucket_start[b];
        sworks[b].rank_base = bucket_start[b];
        sworks[b].rank_out = rank_out;
    }
    for (int64_t b = 1; b < nbuckets; b++)
        pthread_create(&tids[b], NULL, rank_sort_worker, &sworks[b]);
    rank_sort_worker(&sworks[0]);
    for (int64_t b = 1; b < nbuckets; b++)
        pthread_join(tids[b], NULL);
    return FQ_OK;
}

/* Nibble packing for the device rowwise pair verifier.
 *
 * C twin of ops/encode.pack_nibbles: pack a [n, L] index matrix (values
 * < 16) into uint32 lanes, 8 bases per word, low nibble first, positions
 * beyond L filled with 0xF.  ``lut`` (optional, 256 entries) translates
 * raw key bytes to alphabet indices in the same pass, so raw-byte
 * matrices (engine zero-copy entries) pack without a separate ~n*L
 * translation sweep.  One pass over the rows vs numpy's ~10; rows split
 * across pthreads.  Returns FQ_ERR_FORMAT if any index is >= 16. */

typedef struct {
    const unsigned char *base;
    const unsigned char *lut;   /* may be NULL */
    int64_t row_stride, width, lanes, lo, hi;
    uint32_t *out;
    int rc;
} PackNibWork;

static void *pack_nibbles_worker(void *arg) {
    PackNibWork *w = (PackNibWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *p = w->base + i * w->row_stride;
        uint32_t *row = w->out + i * w->lanes;
        for (int64_t lane = 0; lane < w->lanes; lane++) {
            uint32_t word = 0;
            for (int nib = 0; nib < 8; nib++) {
                int64_t pos = lane * 8 + nib;
                uint32_t v;
                if (pos < w->width) {
                    v = w->lut ? w->lut[p[pos]] : p[pos];
                    if (v >= 16) { w->rc = FQ_ERR_FORMAT; return NULL; }
                } else {
                    v = 0xF;
                }
                word |= v << (4 * nib);
            }
            row[lane] = word;
        }
    }
    return NULL;
}

int fq_pack_nibbles(const unsigned char *base, int64_t n,
                    int64_t row_stride, int64_t width,
                    const unsigned char *lut, int64_t lanes,
                    int nthreads, uint32_t *out) {
    if (n <= 0) return FQ_OK;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (n < 65536) nthreads = 1;
    PackNibWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].base = base;
        works[t].lut = lut;
        works[t].row_stride = row_stride;
        works[t].width = width;
        works[t].lanes = lanes;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
        works[t].out = out;
        works[t].rc = FQ_OK;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, pack_nibbles_worker, &works[t]);
    pack_nibbles_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    for (int t = 0; t < nthreads; t++)
        if (works[t].rc != FQ_OK) return works[t].rc;
    return FQ_OK;
}

/* Fused per-row hash + multi-host ownership select.
 *
 * For the P>1 pigeonhole bucket sharding (ops/bucket.py): computes the
 * weak row hash (bit-identical to fq_hash_rows strong=0), derives the
 * owning host as hr_mix(hash ^ salt_mix) % nproc (bit-identical to
 * parallel/distributed.bucket_owner_mask, so the bucket partition is
 * unchanged), and compacts the row indices + hashes of the rows owned
 * by `pid` — one pass, replacing three replicated ~n-sized numpy passes
 * (mix, modulo-compare, flatnonzero) per segment on EVERY host.
 * Threads each fill a private slab of the output sized by their row
 * range; the main thread closes the gaps.  Returns the owned count. */

typedef struct {
    const unsigned char *base;
    int64_t row_stride, width, lo, hi;
    uint64_t seed, salt_mix;
    uint64_t pid, nproc;
    int64_t *idx_out;     /* slab starting at lo */
    uint64_t *hash_out;   /* slab starting at lo */
    int64_t count;
} HashOwnerWork;

static void *hash_owner_worker(void *arg) {
    HashOwnerWork *w = (HashOwnerWork *)arg;
    const int64_t nwords = w->width / 8;
    const int64_t rem = w->width % 8;
    /* Power-of-two host counts (the common topologies) replace the
     * per-row 64-bit modulo with a mask — same result, no divider. */
    const uint64_t pow2_mask =
        (w->nproc & (w->nproc - 1)) == 0 ? w->nproc - 1 : 0;
    const int use_mask = (w->nproc & (w->nproc - 1)) == 0;
    int64_t k = 0;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *p = w->base + i * w->row_stride;
        uint64_t h = w->seed;
        for (int64_t c = 0; c < nwords; c++) {
            uint64_t word;
            memcpy(&word, p + c * 8, 8);
            h ^= word;
            h *= 0x2545F4914F6CDD1DULL;
            h ^= h >> 29;
        }
        if (rem) {
            uint64_t word = 0;
            memcpy(&word, p + nwords * 8, (size_t)rem);
            h ^= word;
            h *= 0x2545F4914F6CDD1DULL;
            h ^= h >> 29;
        }
        h = hr_mix(h);
        /* Branchless compaction: always store, conditionally advance —
         * the 1/nproc-taken branch would mispredict its way to ~2x the
         * whole loop's cost. */
        w->idx_out[w->lo + k] = i;
        w->hash_out[w->lo + k] = h;
        uint64_t mixed = hr_mix(h ^ w->salt_mix);
        uint64_t owner = use_mask ? (mixed & pow2_mask)
                                  : (mixed % w->nproc);
        k += (int64_t)(owner == w->pid);
    }
    w->count = k;
    return NULL;
}

int64_t fq_hash_owner_select(const unsigned char *base, int64_t n,
                             int64_t row_stride, int64_t width,
                             uint64_t seed, uint64_t salt_mix,
                             int64_t pid, int64_t nproc, int nthreads,
                             int64_t *idx_out, uint64_t *hash_out) {
    if (n <= 0) return 0;
    if (nproc < 1) nproc = 1;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (n < 65536) nthreads = 1;
    HashOwnerWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].base = base;
        works[t].row_stride = row_stride;
        works[t].width = width;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
        works[t].seed = seed;
        works[t].salt_mix = salt_mix;
        works[t].pid = (uint64_t)pid;
        works[t].nproc = (uint64_t)nproc;
        works[t].idx_out = idx_out;
        works[t].hash_out = hash_out;
        works[t].count = 0;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, hash_owner_worker, &works[t]);
    hash_owner_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    int64_t total = works[0].count;
    for (int t = 1; t < nthreads; t++) {
        if (works[t].count && total != works[t].lo) {
            memmove(idx_out + total, idx_out + works[t].lo,
                    (size_t)works[t].count * sizeof(int64_t));
            memmove(hash_out + total, hash_out + works[t].lo,
                    (size_t)works[t].count * sizeof(uint64_t));
        }
        total += works[t].count;
    }
    return total;
}

/* Ragged variant: per-row width from an offsets vector (row i spans
 * data[offsets[i]:offsets[i+1]]).  Same word algorithm as fq_hash_rows,
 * so equal byte contents hash equal regardless of layout; used as the
 * second, independent content hash of the multi-host key exchange
 * (parallel/distributed.py) where key identity is (length, h1, h2). */

typedef struct {
    const unsigned char *data;
    const int64_t *offsets;
    int64_t lo, hi;
    uint64_t seed;
    int strong;
    uint64_t *out;
} HashRaggedWork;

static void *hash_ragged_worker(void *arg) {
    HashRaggedWork *w = (HashRaggedWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *p = w->data + w->offsets[i];
        int64_t width = w->offsets[i + 1] - w->offsets[i];
        const int64_t nwords = width / 8;
        const int64_t rem = width % 8;
        uint64_t h = w->seed;
        for (int64_t c = 0; c < nwords; c++) {
            uint64_t word;
            memcpy(&word, p + c * 8, 8);
            h ^= word;
            if (w->strong) {
                h = hr_mix(h) * 0x2545F4914F6CDD1DULL;
            } else {
                h *= 0x2545F4914F6CDD1DULL;
                h ^= h >> 29;
            }
        }
        if (rem) {
            uint64_t word = 0;
            memcpy(&word, p + nwords * 8, (size_t)rem);
            h ^= word;
            if (w->strong) {
                h = hr_mix(h) * 0x2545F4914F6CDD1DULL;
            } else {
                h *= 0x2545F4914F6CDD1DULL;
                h ^= h >> 29;
            }
        }
        w->out[i] = hr_mix(h);
    }
    return NULL;
}

void fq_hash_ragged(const unsigned char *data, const int64_t *offsets,
                    int64_t n, uint64_t seed, int strong, int nthreads,
                    uint64_t *out) {
    if (n <= 0) return;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (n < 65536) nthreads = 1;
    HashRaggedWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].data = data;
        works[t].offsets = offsets;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
        works[t].seed = seed;
        works[t].strong = strong;
        works[t].out = out;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, hash_ragged_worker, &works[t]);
    hash_ragged_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

/* Gather selected ragged rows into a packed output buffer:
 * out[out_offsets[i]:out_offsets[i+1]] = row rows[i].  One memcpy per
 * row, rows split across pthreads — the numpy equivalent materializes
 * an int64 index per BYTE (8x the payload in scratch), whose first-touch
 * faults cost minutes at multi-host table sizes. */

typedef struct {
    const unsigned char *data;
    const int64_t *offsets;
    const int64_t *rows;
    const int64_t *out_offsets;
    unsigned char *out;
    int64_t lo, hi;
} GatherWork;

static void *gather_worker(void *arg) {
    GatherWork *w = (GatherWork *)arg;
    int64_t i = w->lo;
    while (i < w->hi) {
        int64_t r = w->rows[i];
        /* Coalesce maximal runs of consecutive source rows: their bytes
         * are contiguous in data (ragged offsets are cumulative), and
         * the destination is always contiguous, so one memcpy moves the
         * whole run.  Row lists here are typically sorted and dense
         * (e.g. the multi-host payload take selects most of the local
         * table), where this turns ~100 B copies into multi-KB ones. */
        int64_t j = i + 1;
        while (j < w->hi && w->rows[j] == w->rows[j - 1] + 1)
            j++;
        memcpy(w->out + w->out_offsets[i], w->data + w->offsets[r],
               (size_t)(w->offsets[w->rows[j - 1] + 1] - w->offsets[r]));
        i = j;
    }
    return NULL;
}

void fq_gather_ragged(const unsigned char *data, const int64_t *offsets,
                      const int64_t *rows, int64_t n,
                      const int64_t *out_offsets, unsigned char *out,
                      int nthreads) {
    if (n <= 0) return;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (n < 65536) nthreads = 1;
    GatherWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].data = data;
        works[t].offsets = offsets;
        works[t].rows = rows;
        works[t].out_offsets = out_offsets;
        works[t].out = out;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, gather_worker, &works[t]);
    gather_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

/* Thread-parallel batched lookup: the table is read-only during pass 3,
 * so record ranges probe independently.  At 100M records x ~150 ns of
 * hash+probe+memcmp per key, the single-thread walk is a visible slice
 * of the rewrite pass; threads split it across host cores. */

typedef struct {
    const KeyAcc *a;
    const unsigned char *key_data;
    const int64_t *key_offsets;
    int64_t lo, hi;
    int64_t *out;
} LookupWork;

static void *lookup_worker(void *arg) {
    LookupWork *w = (LookupWork *)arg;
    const KeyAcc *a = w->a;
    size_t mask = a->cap - 1;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *key = w->key_data + w->key_offsets[i];
        size_t len = (size_t)(w->key_offsets[i + 1] - w->key_offsets[i]);
        uint64_t h = acc_hash(key, len);
        size_t j = (size_t)h & mask;
        w->out[i] = -1;
        for (;;) {
            const AccSlot *e = &a->slots[j];
            if (e->idx < 0) break;
            if (e->hash == h &&
                acc_entry_len(a, e->idx) == (int64_t)len &&
                memcmp(a->arena + a->key_off[e->idx], key, len) == 0) {
                w->out[i] = a->first_pos[e->idx];
                break;
            }
            j = (j + 1) & mask;
        }
    }
    return NULL;
}

void acc_lookup_mt(const KeyAcc *a, const unsigned char *key_data,
                   const int64_t *key_offsets, int64_t n, int64_t *out,
                   int nthreads) {
    if (n <= 0) return;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS) nthreads = HASH_ROWS_MAX_THREADS;
    if (n < 16384) nthreads = 1;
    LookupWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = n / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].a = a;
        works[t].key_data = key_data;
        works[t].key_offsets = key_offsets;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? n : (t + 1) * per;
        works[t].out = out;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, lookup_worker, &works[t]);
    lookup_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
}

/* Sort four parallel int64 columns by ascending col0 — LSB radix over
 * 8-bit digits, with passes limited to the bytes col0 actually uses
 * (gathered row indices are < total gathered rows, so 3-4 passes in
 * practice).  col0 must be non-negative and outputs must not alias
 * inputs.  Replaces exchange_merge_key_tables's numpy argsort + four
 * fancy-index takes (~0.35 s per host at 2.5M keys, replicated on
 * every host) with O(n) passes fused with the 4-column permute. */
int fq_sort_permute4(int64_t n,
                     const int64_t *c0, const int64_t *c1,
                     const int64_t *c2, const int64_t *c3,
                     int64_t *o0, int64_t *o1,
                     int64_t *o2, int64_t *o3) {
    if (n <= 0) return FQ_OK;
    int64_t maxv = 0;
    for (int64_t i = 0; i < n; i++)
        if (c0[i] > maxv) maxv = c0[i];
    int passes = 1;
    while ((maxv >> (8 * passes)) && passes < 8) passes++;
    /* Persistent scratch: on hosts with hypervisor free-page
     * reporting, malloc/free per call re-faults 2n*8 bytes every
     * exchange; keeping the high-water mapping makes repeat calls
     * fault-free.  Guarded for concurrent callers. */
    static pthread_mutex_t sp4_lock = PTHREAD_MUTEX_INITIALIZER;
    static int64_t *sp4_buf = NULL;
    static int64_t sp4_cap = 0;
    pthread_mutex_lock(&sp4_lock);
    if (sp4_cap < n) {
        free(sp4_buf);
        sp4_buf = (int64_t *)malloc((size_t)n * 2 * sizeof(int64_t));
        if (!sp4_buf) {
            sp4_cap = 0;
            pthread_mutex_unlock(&sp4_lock);
            return FQ_ERR_NOMEM;
        }
        sp4_cap = n;
    }
    int64_t *a = sp4_buf;
    int64_t *b = sp4_buf + n;
    for (int64_t i = 0; i < n; i++) a[i] = i;
    for (int p = 0; p < passes; p++) {
        int shift = 8 * p;
        int64_t pos[256];
        memset(pos, 0, sizeof(pos));
        for (int64_t i = 0; i < n; i++)
            pos[(c0[a[i]] >> shift) & 0xFF]++;
        int64_t off = 0;
        for (int d = 0; d < 256; d++) {
            int64_t c = pos[d];
            pos[d] = off;
            off += c;
        }
        for (int64_t i = 0; i < n; i++)
            b[pos[(c0[a[i]] >> shift) & 0xFF]++] = a[i];
        int64_t *t = a; a = b; b = t;
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t j = a[i];
        o0[i] = c0[j];
        o1[i] = c1[j];
        o2[i] = c2[j];
        o3[i] = c3[j];
    }
    pthread_mutex_unlock(&sp4_lock);
    return FQ_OK;
}

/* ---- BGZF byte-range splitting --------------------------------------
 *
 * A BGZF file is a chain of independent gzip members (<= 64 KiB each),
 * so hosts can partition it by COMPRESSED byte ranges: host p owns the
 * members starting in [B(lo_p), hi_p) where B(x) is the first member
 * boundary at-or-after x.  Record attribution across the (decompressed)
 * range edges uses newline counts: each host counts the newlines of its
 * range once (fq_count_units), the counts allgather, and global line /
 * record ordinals follow exactly — no parsing, no heuristic resync of
 * FASTQ structure (quality lines may contain '@', so scanning for
 * record starts is not sound).  See pipeline._plan_input_ranges. */

/* First BGZF member boundary at offset >= lo, or -1 when none exists
 * before EOF, or -2 on read error.  Validates the candidate header by
 * parsing it AND chaining to the next member (depth 2) so a spurious
 * 1f 8b 08 04 inside compressed payload cannot false-sync.  Members
 * are <= 64 KiB, so the boundary (if any) lies within 64 KiB + header
 * of lo; the 256 KiB window also covers validation. */
static int64_t bg_scan_boundary(int fd, int64_t lo, int64_t fsize) {
    if (lo >= fsize) return -1;
    size_t want = 256 << 10;
    unsigned char *win = (unsigned char *)malloc(want);
    if (!win) return -2;
    size_t got = 0;
    while (got < want) {
        ssize_t n = pread(fd, win + got, want - got, lo + (int64_t)got);
        if (n < 0) { free(win); return -2; }
        if (n == 0) break;
        got += (size_t)n;
    }
    int64_t found = -1;
    for (size_t c = 0; c + 18 <= got; c++) {
        if (win[c] != 0x1f || win[c + 1] != 0x8b || win[c + 2] != 8 ||
            (win[c + 3] & 4) == 0)
            continue;
        size_t msize, poff, plen, isize;
        int st = bg_parse_member(win + c, got - c, &msize, &poff,
                                 &plen, &isize);
        if (st != 1) continue;
        size_t nxt = c + msize;
        if (lo + (int64_t)nxt == fsize) { found = lo + (int64_t)c; break; }
        if (nxt + 18 <= got) {
            size_t m2, p2, l2, i2;
            if (bg_parse_member(win + nxt, got - nxt, &m2, &p2,
                                &l2, &i2) != 1)
                continue;  /* chain broke: c was a false sync */
        }
        /* Chain parses (or extends past the window, overwhelmingly
         * the real boundary): accept. */
        found = lo + (int64_t)c;
        break;
    }
    free(win);
    return found;
}

/* Open a BGZF file restricted to the members starting in [lo, hi)
 * (hi < 0: to EOF).  Returns NULL when the file is not BGZF (callers
 * fall back to whole-file strided reading), cannot be opened, or no
 * member starts inside the range (empty range -> NULL with errno 0 is
 * indistinguishable from not-BGZF; callers that need the distinction
 * probe boundaries first via fq_scan_boundary). */
FqReader *fq_open_range(const char *path, int64_t lo, int64_t hi) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return NULL;
    unsigned char head[64];
    ssize_t got = pread(fd, head, sizeof(head), 0);
    int is_bgzf = 0;
    if (got >= 18 && head[0] == 0x1f && head[1] == 0x8b &&
        head[2] == 8 && (head[3] & 4) != 0) {
        size_t xlen = (size_t)head[10] | ((size_t)head[11] << 8);
        size_t q = 12;
        while (q + 4 <= 12 + xlen && (ssize_t)(q + 4) <= got) {
            size_t slen = (size_t)head[q + 2] | ((size_t)head[q + 3] << 8);
            if (head[q] == 'B' && head[q + 1] == 'C' && slen == 2)
                is_bgzf = 1;
            q += 4 + slen;
        }
    }
    if (!is_bgzf) { close(fd); return NULL; }
    int64_t fsize = (int64_t)lseek(fd, 0, SEEK_END);
    if (fsize < 0) { close(fd); return NULL; }
    int64_t start = 0;
    if (lo > 0) {
        start = bg_scan_boundary(fd, lo, fsize);
        if (start < 0 || (hi >= 0 && start >= hi)) {
            close(fd);
            return NULL;  /* empty range */
        }
    }
    if (lseek(fd, start, SEEK_SET) != start) { close(fd); return NULL; }
    FqReader *r = (FqReader *)calloc(1, sizeof(FqReader));
    if (!r) { close(fd); return NULL; }
    r->error_line = -1;
    r->bgzf = 1;
    r->fd = fd;
    r->held_slot = -1;
    r->raw_base = start;
    r->range_hi = hi;
    r->range_mode = 1;
    r->comp_cap = READ_BUF_SIZE;
    r->comp = (unsigned char *)malloc(r->comp_cap);
    r->buf_cap = 64;
    r->buf = (unsigned char *)malloc(r->buf_cap);
    r->buf0 = r->buf;
    if (!r->comp || !r->buf) {
        close(fd);
        free(r->comp);
        free(r->buf);
        free(r);
        return NULL;
    }
    return r;
}

/* First member boundary >= lo (for probing), or -1 (none before EOF) /
 * -2 (IO error) / -3 (not a BGZF file). */
int64_t fq_scan_boundary(const char *path, int64_t lo) {
    FqReader *probe = fq_open_range(path, 0, -1);
    if (!probe) return -3;
    int fd = probe->fd;
    int64_t fsize = (int64_t)lseek(fd, 0, SEEK_END);
    int64_t out = lo <= 0 ? 0 : bg_scan_boundary(fd, lo, fsize);
    fq_close(probe);
    return out;
}

/* Drain a (range-limited) BGZF reader, counting newlines per inflate
 * unit.  Units are the producer's slot batches (<= 64 members); each
 * unit reports (raw end offset of its members, newline count).  When
 * more than `cap` units exist the tail merges into unit cap-1 (the
 * offsets stay member boundaries, only granularity coarsens).  Returns
 * FQ_OK and the unit count via *n_out. */
int fq_count_units(FqReader *r, int64_t cap,
                   int64_t *ends, int64_t *newlines, int64_t *n_out) {
    if (!r->bgzf || cap <= 0) return FQ_ERR_FORMAT;
    int64_t n = 0;
    for (;;) {
        if (r->buf_len > r->buf_pos) {
            const unsigned char *p = r->buf + r->buf_pos;
            size_t len = r->buf_len - r->buf_pos;
            int64_t cnt = 0;
            const unsigned char *q = p;
            const unsigned char *end = p + len;
            while ((q = (const unsigned char *)memchr(
                        q, '\n', (size_t)(end - q))) != NULL) {
                cnt++;
                q++;
            }
            r->buf_pos = r->buf_len;
            if (n > 0 && ends[n - 1] == r->cur_unit_end) {
                newlines[n - 1] += cnt;      /* same slot, partial reads */
            } else if (n == cap) {
                ends[n - 1] = r->cur_unit_end;
                newlines[n - 1] += cnt;      /* merge overflow tail */
            } else {
                ends[n] = r->cur_unit_end;
                newlines[n] = cnt;
                n++;
            }
        }
        if (r->eof) break;
        if (r->tail_plain) {
            snprintf(r->error, sizeof(r->error),
                     "non-BGZF gzip member inside a byte range");
            return FQ_ERR_FORMAT;
        }
        int rc = fq_fill(r);
        if (rc != FQ_OK) return rc;
    }
    *n_out = n;
    return FQ_OK;
}

/* Consume input through the k-th newline (so the next byte read starts
 * the following line).  Used to align a range reader to a record
 * boundary computed from global line ordinals. */
int fq_skip_newlines(FqReader *r, int64_t k) {
    while (k > 0) {
        if (r->buf_len > r->buf_pos) {
            const unsigned char *p = r->buf + r->buf_pos;
            const unsigned char *nl = (const unsigned char *)memchr(
                p, '\n', r->buf_len - r->buf_pos);
            if (nl) {
                r->buf_pos += (size_t)(nl - p) + 1;
                k--;
                continue;
            }
            r->buf_pos = r->buf_len;
        }
        if (r->eof) {
            snprintf(r->error, sizeof(r->error),
                     "byte range ended before the record boundary");
            return FQ_ERR_FORMAT;
        }
        int rc = fq_fill(r);
        if (rc != FQ_OK) return rc;
    }
    return FQ_OK;
}

/* Owned-metadata merge for exchange_merge_key_tables: one open-address
 * hash pass over the gathered metadata rows replaces numpy's
 * argsort + reduceat sequence (~0.4 s/host at 3M gathered rows).
 * Key identity is (len, h1, h2); ownership is h1 %% nproc; the
 * representative is the row minimizing mix64(h1 ^ (host+1)*GOLDEN)
 * (ties: smallest gathered row), exactly the numpy tournament in
 * parallel/distributed._owned_meta_merge, so native and fallback hosts
 * can coexist in one job.  Emission order is first-seen (ascending
 * gathered row of each key's first owned occurrence) — any fixed order
 * works: the caller canonicalizes by sorting the allgathered columns
 * on representative row index.  Zero-total-count keys are dropped.
 * Returns FQ_OK / FQ_ERR_NOMEM. */
static inline uint64_t fq_mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDULL;
    x ^= x >> 33;
    x *= 0xC4CEB9FE1A85EC53ULL;
    x ^= x >> 33;
    return x;
}

int fq_owned_merge(int64_t n_rows, const int64_t *g_len,
                   const uint64_t *g_h1, const uint64_t *g_h2,
                   const int64_t *g_cnt, const int64_t *g_fp,
                   int64_t pid, int64_t nproc,
                   const int64_t *host_starts, int64_t n_hosts,
                   int64_t *rep_out, int64_t *cnt_out,
                   int64_t *fp_out, int64_t *len_out,
                   int64_t *n_out) {
    /* Capacity: power of two >= 2x the ACTUAL owned rows (ownership
     * can skew arbitrarily — e.g. few distinct h1 values). */
    int64_t owned = 0;
    for (int64_t i = 0; i < n_rows; i++)
        if ((int64_t)(g_h1[i] % (uint64_t)nproc) == pid) owned++;
    uint64_t cap = 64;
    while (cap < (uint64_t)owned * 2 + 64)
        cap <<= 1;
    int64_t *slot_of = (int64_t *)malloc(cap * sizeof(int64_t));
    if (!slot_of) return FQ_ERR_NOMEM;
    for (uint64_t i = 0; i < cap; i++) slot_of[i] = -1;
    uint64_t mask = cap - 1;
    /* Per-key state lives in the output arrays; prio/h-copies on the
     * side for probe compares. */
    uint64_t *k_h1 = (uint64_t *)malloc(cap * sizeof(uint64_t));
    uint64_t *k_h2 = (uint64_t *)malloc(cap * sizeof(uint64_t));
    uint64_t *k_prio = (uint64_t *)malloc(cap * sizeof(uint64_t));
    if (!k_h1 || !k_h2 || !k_prio) {
        free(slot_of); free(k_h1); free(k_h2); free(k_prio);
        return FQ_ERR_NOMEM;
    }
    int64_t n_keys = 0;
    int64_t host = 0;
    for (int64_t i = 0; i < n_rows; i++) {
        if ((int64_t)(g_h1[i] % (uint64_t)nproc) != pid) continue;
        while (host + 1 < n_hosts && i >= host_starts[host + 1]) host++;
        uint64_t prio = fq_mix64(
            g_h1[i] ^ ((uint64_t)(host + 1) * 0x9E3779B97F4A7C15ULL));
        uint64_t h = fq_mix64(g_h1[i] ^ (g_h2[i] * 0x9E3779B97F4A7C15ULL)
                              ^ (uint64_t)g_len[i]);
        uint64_t s = h & mask;
        for (;;) {
            int64_t k = slot_of[s];
            if (k < 0) {
                slot_of[s] = n_keys;
                k_h1[n_keys] = g_h1[i];
                k_h2[n_keys] = g_h2[i];
                k_prio[n_keys] = prio;
                rep_out[n_keys] = i;
                cnt_out[n_keys] = g_cnt[i];
                fp_out[n_keys] = g_fp[i];
                len_out[n_keys] = g_len[i];
                n_keys++;
                break;
            }
            if (k_h1[k] == g_h1[i] && k_h2[k] == g_h2[i] &&
                len_out[k] == g_len[i]) {
                cnt_out[k] += g_cnt[i];
                if (g_fp[i] < fp_out[k]) fp_out[k] = g_fp[i];
                if (prio < k_prio[k] ||
                    (prio == k_prio[k] && i < rep_out[k])) {
                    k_prio[k] = prio;
                    rep_out[k] = i;
                }
                break;
            }
            s = (s + 1) & mask;
        }
    }
    free(slot_of);
    free(k_h1);
    free(k_h2);
    free(k_prio);
    /* Drop zero-count keys in place. */
    int64_t w = 0;
    for (int64_t k = 0; k < n_keys; k++) {
        if (cnt_out[k] <= 0) continue;
        if (w != k) {
            rep_out[w] = rep_out[k];
            cnt_out[w] = cnt_out[k];
            fp_out[w] = fp_out[k];
            len_out[w] = len_out[k];
        }
        w++;
    }
    *n_out = w;
    return FQ_OK;
}

/* Banded Levenshtein <= band check for candidate index pairs over a
 * padded key matrix (row stride `stride`, per-row valid length lens).
 * Classic O(L * (2*band+1)) band DP with early exit when the whole
 * band exceeds the budget; semantics match the reference's recursive
 * within_edit_distance (distances.h:33-88) and the device banded DP
 * (ops/edit.py).  Multithreaded over pairs.  Chosen by a measured cost
 * model in engine._edit_edges_entries: over a slow host-device link
 * shipping the key matrix can cost more than the whole DP, while over
 * a fast link the device path wins at scale. */
typedef struct {
    const unsigned char *mat;
    int64_t stride;
    const int64_t *lens;
    const int64_t *ci;
    const int64_t *cj;
    int64_t lo, hi;
    int band;
    unsigned char *keep;
} EditVerifyWork;

static inline int fq_edit_banded_one(const unsigned char *a, int64_t la,
                                     const unsigned char *b, int64_t lb,
                                     int band) {
    if (la > lb) {
        const unsigned char *t = a; a = b; b = t;
        int64_t tl = la; la = lb; lb = tl;
    }
    if (lb - la > band) return 0;
    /* dp over diagonal offsets k in [-band, band]:
     * row i holds dist(a[:i], b[:i+k]) in cell[k+band]. */
    int width = 2 * band + 1;
    int cur[2 * 16 + 1];  /* band <= 16 supported */
    int nxt[2 * 16 + 1];
    if (band > 16) return -1;
    const int BIG = 1 << 20;
    for (int k = 0; k < width; k++) {
        int64_t j = k - band;  /* i = 0 */
        cur[k] = (j >= 0 && j <= lb) ? (int)j : BIG;
    }
    for (int64_t i = 1; i <= la; i++) {
        int rowmin = BIG;
        for (int k = 0; k < width; k++) {
            int64_t j = i + k - band;
            int v = BIG;
            if (j >= 0 && j <= lb) {
                if (j > 0) {
                    int sub = cur[k];  /* (i-1, j-1) same offset */
                    if (sub < BIG)
                        sub += (a[i - 1] == b[j - 1]) ? 0 : 1;
                    v = sub;
                    if (k > 0 && nxt[k - 1] < BIG &&
                        nxt[k - 1] + 1 < v)
                        v = nxt[k - 1] + 1;  /* insert into a: (i, j-1) */
                } else {
                    v = (int)i;  /* j == 0 */
                }
                if (k + 1 < width && cur[k + 1] < BIG &&
                    cur[k + 1] + 1 < v)
                    v = cur[k + 1] + 1;      /* delete from a: (i-1, j) */
            }
            nxt[k] = v;
            if (v < rowmin) rowmin = v;
        }
        if (rowmin > band) return 0;
        memcpy(cur, nxt, (size_t)width * sizeof(int));
    }
    int k_end = (int)(lb - la) + band;
    return cur[k_end] <= band;
}

static void *edit_verify_worker(void *arg) {
    EditVerifyWork *w = (EditVerifyWork *)arg;
    for (int64_t p = w->lo; p < w->hi; p++) {
        const unsigned char *a = w->mat + w->ci[p] * w->stride;
        const unsigned char *b = w->mat + w->cj[p] * w->stride;
        w->keep[p] = (unsigned char)fq_edit_banded_one(
            a, w->lens[w->ci[p]], b, w->lens[w->cj[p]], w->band);
    }
    return NULL;
}

int fq_edit_verify(const unsigned char *mat, int64_t stride,
                   const int64_t *lens, const int64_t *ci,
                   const int64_t *cj, int64_t npairs, int band,
                   unsigned char *keep_out, int nthreads) {
    if (band < 0 || band > 16) return FQ_ERR_FORMAT;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > HASH_ROWS_MAX_THREADS)
        nthreads = HASH_ROWS_MAX_THREADS;
    if (npairs < 4096) nthreads = 1;
    EditVerifyWork works[HASH_ROWS_MAX_THREADS];
    pthread_t tids[HASH_ROWS_MAX_THREADS];
    int64_t per = npairs / nthreads;
    for (int t = 0; t < nthreads; t++) {
        works[t].mat = mat;
        works[t].stride = stride;
        works[t].lens = lens;
        works[t].ci = ci;
        works[t].cj = cj;
        works[t].lo = t * per;
        works[t].hi = (t == nthreads - 1) ? npairs : (t + 1) * per;
        works[t].band = band;
        works[t].keep = keep_out;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, edit_verify_worker, &works[t]);
    edit_verify_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    return FQ_OK;
}

/* In-place LSB radix sort of uint64 values (8 passes of 8-bit digits,
 * persistent ping-pong scratch as in fq_sort_permute4).  Feeds the
 * bucket-grouping composite sort: at 31M keys numpy's introsort
 * argsort measures 6-8 s while 8 sequential counting passes move the
 * same data in ~2 s. */
/* One scratch + lock shared by the serial and parallel radix sorts:
 * the pipeline's sorts are sequential, and sharing halves the retained
 * high-water scratch.  Call with rs_lock NOT held; returns NULL on
 * allocation failure (lock released). */
static pthread_mutex_t rs_lock = PTHREAD_MUTEX_INITIALIZER;
static uint64_t *rs_buf = NULL;
static int64_t rs_cap = 0;

static uint64_t *rs_acquire(int64_t n) {
    pthread_mutex_lock(&rs_lock);
    if (rs_cap < n) {
        free(rs_buf);
        rs_buf = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
        if (!rs_buf) {
            rs_cap = 0;
            pthread_mutex_unlock(&rs_lock);
            return NULL;
        }
        rs_cap = n;
    }
    return rs_buf;
}

int fq_radix_sort_u64(int64_t n, uint64_t *a) {
    if (n <= 1) return FQ_OK;
    if (!rs_acquire(n))
        return FQ_ERR_NOMEM;
    uint64_t *src = a;
    uint64_t *dst = rs_buf;
    for (int p = 0; p < 8; p++) {
        int shift = 8 * p;
        int64_t pos[256];
        memset(pos, 0, sizeof(pos));
        for (int64_t i = 0; i < n; i++)
            pos[(src[i] >> shift) & 0xFF]++;
        int constant = 0;
        for (int d = 0; d < 256; d++)
            if (pos[d] == n) { constant = 1; break; }
        if (constant)  /* every value shares this digit: skip the pass */
            continue;
        int64_t off = 0;
        for (int d = 0; d < 256; d++) {
            int64_t c = pos[d];
            pos[d] = off;
            off += c;
        }
        for (int64_t i = 0; i < n; i++)
            dst[pos[(src[i] >> shift) & 0xFF]++] = src[i];
        uint64_t *t = src; src = dst; dst = t;
    }
    if (src != a)
        memcpy(a, src, (size_t)n * sizeof(uint64_t));
    pthread_mutex_unlock(&rs_lock);
    return FQ_OK;
}

/* ---- Hamming pair verification --------------------------------------
 *
 * keep[i] = hamming(matrix[gi[i]], matrix[gj[i]]) <= max_distance over
 * equal-width rows, with the reference's fast-fail early exit
 * (distances.h:22-30): pairs split across threads, no gathered row
 * temporaries. */

typedef struct {
    const unsigned char *m;
    int64_t stride, width, maxd;
    const int64_t *gi, *gj;
    unsigned char *keep;
    int64_t lo, hi;
} HamVerifyWork;

static void *ham_verify_worker(void *arg) {
    HamVerifyWork *w = (HamVerifyWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++) {
        const unsigned char *a = w->m + w->gi[i] * w->stride;
        const unsigned char *b = w->m + w->gj[i] * w->stride;
        int64_t mism = 0;
        int64_t k = 0;
        for (; k < w->width; k++) {
            if (a[k] != b[k] && ++mism > w->maxd)
                break;
        }
        w->keep[i] = (unsigned char)(mism <= w->maxd);
    }
    return NULL;
}

int fq_hamming_verify_pairs(const unsigned char *matrix, int64_t stride,
                            int64_t width, const int64_t *gi,
                            const int64_t *gj, int64_t n_pairs,
                            int64_t max_distance, unsigned char *keep,
                            int nthreads) {
    if (n_pairs <= 0) return FQ_OK;
    if (nthreads <= 0) {
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        nthreads = cores > 0 ? (int)cores : 1;
    }
    if (nthreads > 8) nthreads = 8;
    if ((int64_t)nthreads > n_pairs) nthreads = (int)n_pairs;
    HamVerifyWork works[8];
    pthread_t tids[8];
    for (int t = 0; t < nthreads; t++) {
        works[t].m = matrix;
        works[t].stride = stride;
        works[t].width = width;
        works[t].maxd = max_distance;
        works[t].gi = gi;
        works[t].gj = gj;
        works[t].keep = keep;
        works[t].lo = n_pairs * t / nthreads;
        works[t].hi = n_pairs * (t + 1) / nthreads;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, ham_verify_worker, &works[t]);
    ham_verify_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    return FQ_OK;
}

/* ---- Parallel radix sort --------------------------------------------
 *
 * One top-byte counting partition (parallel histogram + parallel
 * scatter with per-(thread, bucket) cursors), then the 256 partitions
 * are LSB-radix-sorted independently across threads — each partition
 * ping-pongs between its slice of the scratch and its slice of the
 * output array, so no extra memory beyond the single n-word scratch
 * the serial sort already keeps. */

typedef struct {
    const uint64_t *src;
    uint64_t *dst;
    int64_t lo, hi;
    int64_t *cursor;        /* this thread's 256 scatter cursors */
    int64_t hist[256];
} RsScatterWork;

static void *rs_hist_worker(void *arg) {
    RsScatterWork *w = (RsScatterWork *)arg;
    memset(w->hist, 0, sizeof(w->hist));
    for (int64_t i = w->lo; i < w->hi; i++)
        w->hist[w->src[i] >> 56]++;
    return NULL;
}

static void *rs_scatter_worker(void *arg) {
    RsScatterWork *w = (RsScatterWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++)
        w->dst[w->cursor[w->src[i] >> 56]++] = w->src[i];
    return NULL;
}

/* Sort one partition ascending; data starts in part[0..m), result must
 * end in out[0..m) (their underlying regions do not overlap). */
static void rs_sort_partition(uint64_t *part, uint64_t *out, int64_t m) {
    uint64_t *src = part;
    uint64_t *dst = out;
    for (int p = 0; p < 7; p++) {   /* top byte is constant by split */
        int shift = 8 * p;
        int64_t pos[256];
        memset(pos, 0, sizeof(pos));
        for (int64_t i = 0; i < m; i++)
            pos[(src[i] >> shift) & 0xFF]++;
        int constant = 0;
        for (int d = 0; d < 256; d++)
            if (pos[d] == m) { constant = 1; break; }
        if (constant)
            continue;
        int64_t off = 0;
        for (int d = 0; d < 256; d++) {
            int64_t c = pos[d];
            pos[d] = off;
            off += c;
        }
        for (int64_t i = 0; i < m; i++)
            dst[pos[(src[i] >> shift) & 0xFF]++] = src[i];
        uint64_t *t = src; src = dst; dst = t;
    }
    if (src != out)
        memcpy(out, src, (size_t)m * sizeof(uint64_t));
}

typedef struct {
    uint64_t *buf;          /* partitioned data                   */
    uint64_t *a;            /* final output                       */
    const int64_t *off;     /* [257] partition offsets            */
    int parts[256];
    int count;
} RsPartWork;

static void *rs_parts_worker(void *arg) {
    RsPartWork *w = (RsPartWork *)arg;
    for (int k = 0; k < w->count; k++) {
        int d = w->parts[k];
        int64_t lo = w->off[d], m = w->off[d + 1] - lo;
        if (m > 0)
            rs_sort_partition(w->buf + lo, w->a + lo, m);
    }
    return NULL;
}

int fq_radix_sort_u64_mt(int64_t n, uint64_t *a, int nthreads) {
    if (nthreads <= 0) {
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        nthreads = cores > 0 ? (int)cores : 1;
    }
    if (nthreads > 8) nthreads = 8;
    if (n < (1 << 22) || nthreads <= 1)
        return fq_radix_sort_u64(n, a);
    uint64_t *mt_buf = rs_acquire(n);
    if (!mt_buf)
        return FQ_ERR_NOMEM;
    RsScatterWork works[8];
    pthread_t tids[8];
    for (int t = 0; t < nthreads; t++) {
        works[t].src = a;
        works[t].dst = mt_buf;
        works[t].lo = n * t / nthreads;
        works[t].hi = n * (t + 1) / nthreads;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, rs_hist_worker, &works[t]);
    rs_hist_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    /* Partition offsets + per-(thread, bucket) scatter cursors: thread
     * t's bucket-d region starts after all earlier threads' d-counts. */
    int64_t part_off[257];
    int64_t cursors[8][256];
    int64_t off = 0;
    for (int d = 0; d < 256; d++) {
        part_off[d] = off;
        for (int t = 0; t < nthreads; t++) {
            cursors[t][d] = off;
            off += works[t].hist[d];
        }
    }
    part_off[256] = off;
    for (int t = 0; t < nthreads; t++)
        works[t].cursor = cursors[t];
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, rs_scatter_worker, &works[t]);
    rs_scatter_worker(&works[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    /* Greedy-balance the partitions across threads by size. */
    RsPartWork pworks[8];
    int64_t load[8];
    for (int t = 0; t < nthreads; t++) {
        pworks[t].buf = mt_buf;
        pworks[t].a = a;
        pworks[t].off = part_off;
        pworks[t].count = 0;
        load[t] = 0;
    }
    int by_size[256];
    for (int d = 0; d < 256; d++) by_size[d] = d;
    for (int i = 1; i < 256; i++) {  /* insertion sort, descending */
        int d = by_size[i];
        int64_t sz = part_off[d + 1] - part_off[d];
        int j = i;
        while (j > 0 && part_off[by_size[j - 1] + 1]
                        - part_off[by_size[j - 1]] < sz) {
            by_size[j] = by_size[j - 1];
            j--;
        }
        by_size[j] = d;
    }
    for (int i = 0; i < 256; i++) {
        int d = by_size[i];
        int64_t sz = part_off[d + 1] - part_off[d];
        if (!sz) continue;
        int best = 0;
        for (int t = 1; t < nthreads; t++)
            if (load[t] < load[best]) best = t;
        pworks[best].parts[pworks[best].count++] = d;
        load[best] += sz;
    }
    for (int t = 1; t < nthreads; t++)
        pthread_create(&tids[t], NULL, rs_parts_worker, &pworks[t]);
    rs_parts_worker(&pworks[0]);
    for (int t = 1; t < nthreads; t++)
        pthread_join(tids[t], NULL);
    pthread_mutex_unlock(&rs_lock);
    return FQ_OK;
}

/* ---- Sharded parallel key accumulation ------------------------------
 *
 * Pass 1's accumulator insert is single-threaded behind the parse
 * pipeline; at 100M reads the accumulate backlog drains ~30 s after
 * parsing finishes.  Sharding the table by high hash bits lets S
 * threads insert concurrently: every key routes to exactly one shard
 * (global uniqueness preserved; the exported concatenation of shard
 * tables is deterministic), and a shard's records are visited in
 * ascending global order (counting-scatter is an ascending scan), so
 * first-occurrence semantics are identical to the serial table. */

static int acc_add_rows(KeyAcc *a, const unsigned char *key_data,
                        const int64_t *key_offsets,
                        const unsigned char *counted,
                        const int64_t *rows, int64_t nrows,
                        int64_t base, unsigned char *is_new,
                        const uint64_t *hashes) {
    for (int64_t r = 0; r < nrows; r++) {
        int64_t i = rows[r];
        if ((r & 15) == 0) {
            int64_t hi = r + 16 < nrows ? r + 16 : nrows;
            size_t pmask = a->cap - 1;
            for (int64_t k = r; k < hi; k++)
                __builtin_prefetch(
                    &a->slots[(size_t)hashes[rows[k]] & pmask]);
        }
        const unsigned char *key = key_data + key_offsets[i];
        size_t len = (size_t)(key_offsets[i + 1] - key_offsets[i]);
        uint64_t h = hashes[i];
        size_t mask = a->cap - 1;
        size_t j = (size_t)h & mask;
        int inserted = 0;
        int64_t idx;
        for (;;) {
            const AccSlot *e = &a->slots[j];
            idx = e->idx;
            if (idx < 0) break;
            if (e->hash == h &&
                acc_entry_len(a, idx) == (int64_t)len &&
                memcmp(a->arena + a->key_off[idx], key, len) == 0)
                break;
            j = (j + 1) & mask;
        }
        if (idx < 0) {
            if (a->arena_len + len > a->arena_cap) {
                size_t nc = a->arena_cap * 2;
                while (a->arena_len + len > nc) nc *= 2;
                unsigned char *na = (unsigned char *)realloc(a->arena, nc);
                if (!na) return FQ_ERR_NOMEM;
                populate_write(na + a->arena_cap, nc - a->arena_cap);
                a->arena = na;
                a->arena_cap = nc;
            }
            if (a->used == a->meta_cap) {
                if (acc_meta_grow(a) != FQ_OK) return FQ_ERR_NOMEM;
            }
            memcpy(a->arena + a->arena_len, key, len);
            for (size_t b = 0; b < len; b++) a->present[key[b]] = 1;
            idx = (int64_t)a->used;
            a->slots[j].hash = h;
            a->slots[j].idx = idx;
            a->count[idx] = 0;
            a->first_pos[idx] = base + i;
            a->key_off[idx] = (int64_t)a->arena_len;
            a->arena_len += len;
            a->used++;
            inserted = 1;
        }
        if (!counted || counted[i]) a->count[idx]++;
        if (base + i < a->first_pos[idx]) {
            a->first_pos[idx] = base + i;
            inserted = 1;  /* see acc_add_impl: out-of-order first */
        }
        if (is_new) is_new[i] = (unsigned char)inserted;
        if (a->used * 4 > a->cap * 3) {
            if (acc_grow(a) != FQ_OK) return FQ_ERR_NOMEM;
        }
    }
    return FQ_OK;
}

typedef struct {
    KeyAcc *shard;
    const unsigned char *key_data;
    const int64_t *key_offsets;
    const unsigned char *counted;
    const int64_t *rows;
    int64_t nrows;
    int64_t base;
    unsigned char *is_new;
    const uint64_t *hashes;
    int rc;
} AccShardWork;

typedef struct {
    const unsigned char *key_data;
    const int64_t *key_offsets;
    uint64_t *hashes;
    int64_t lo, hi;
} AccHashWork;

static void *acc_shard_worker(void *arg) {
    AccShardWork *w = (AccShardWork *)arg;
    w->rc = acc_add_rows(w->shard, w->key_data, w->key_offsets,
                         w->counted, w->rows, w->nrows, w->base,
                         w->is_new, w->hashes);
    return NULL;
}

static void *acc_hash_worker(void *arg) {
    AccHashWork *w = (AccHashWork *)arg;
    for (int64_t i = w->lo; i < w->hi; i++)
        w->hashes[i] = acc_hash(
            w->key_data + w->key_offsets[i],
            (size_t)(w->key_offsets[i + 1] - w->key_offsets[i]));
    return NULL;
}

#define ACC_MAX_SHARDS 16

int acc_add_sharded(uint64_t *shard_handles, int nshards,
                    const unsigned char *key_data,
                    const int64_t *key_offsets,
                    const unsigned char *counted,
                    int64_t n, int64_t base, unsigned char *is_new) {
    if (nshards < 1 || nshards > ACC_MAX_SHARDS) return FQ_ERR_FORMAT;
    static pthread_mutex_t as_lock = PTHREAD_MUTEX_INITIALIZER;
    static uint64_t *as_hashes = NULL;
    static int64_t *as_rows = NULL;
    static int64_t as_cap = 0;
    pthread_mutex_lock(&as_lock);
    if (as_cap < n) {
        free(as_hashes);
        free(as_rows);
        as_hashes = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
        as_rows = (int64_t *)malloc((size_t)n * sizeof(int64_t));
        if (!as_hashes || !as_rows) {
            free(as_hashes); free(as_rows);
            as_hashes = NULL; as_rows = NULL; as_cap = 0;
            pthread_mutex_unlock(&as_lock);
            return FQ_ERR_NOMEM;
        }
        as_cap = n;
    }
    /* 1. Hash every key (parallel ranges). */
    pthread_t tids[ACC_MAX_SHARDS];
    AccHashWork hw[ACC_MAX_SHARDS];
    int nht = nshards;
    int64_t per = n / nht;
    for (int t = 0; t < nht; t++) {
        hw[t].key_data = key_data;
        hw[t].key_offsets = key_offsets;
        hw[t].hashes = as_hashes;
        hw[t].lo = t * per;
        hw[t].hi = (t == nht - 1) ? n : (t + 1) * per;
    }
    for (int t = 1; t < nht; t++)
        pthread_create(&tids[t], NULL, acc_hash_worker, &hw[t]);
    acc_hash_worker(&hw[0]);
    for (int t = 1; t < nht; t++)
        pthread_join(tids[t], NULL);
    /* 2. Partition record indices by high hash bits (stable ascending
     * scan keeps global record order within each shard). */
    int64_t counts_s[ACC_MAX_SHARDS];
    memset(counts_s, 0, sizeof(counts_s));
    for (int64_t i = 0; i < n; i++)
        counts_s[(as_hashes[i] >> 56) % (uint64_t)nshards]++;
    int64_t starts_s[ACC_MAX_SHARDS + 1];
    starts_s[0] = 0;
    for (int s = 0; s < nshards; s++)
        starts_s[s + 1] = starts_s[s] + counts_s[s];
    int64_t cursor[ACC_MAX_SHARDS];
    memcpy(cursor, starts_s, (size_t)nshards * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++)
        as_rows[cursor[(as_hashes[i] >> 56) % (uint64_t)nshards]++] = i;
    /* 3. Insert each shard's records concurrently. */
    AccShardWork works[ACC_MAX_SHARDS];
    for (int s = 0; s < nshards; s++) {
        works[s].shard = (KeyAcc *)(uintptr_t)shard_handles[s];
        works[s].key_data = key_data;
        works[s].key_offsets = key_offsets;
        works[s].counted = counted;
        works[s].rows = as_rows + starts_s[s];
        works[s].nrows = counts_s[s];
        works[s].base = base;
        works[s].is_new = is_new;
        works[s].hashes = as_hashes;
        works[s].rc = FQ_OK;
    }
    for (int s = 1; s < nshards; s++)
        pthread_create(&tids[s], NULL, acc_shard_worker, &works[s]);
    acc_shard_worker(&works[0]);
    for (int s = 1; s < nshards; s++)
        pthread_join(tids[s], NULL);
    pthread_mutex_unlock(&as_lock);
    for (int s = 0; s < nshards; s++)
        if (works[s].rc != FQ_OK) return works[s].rc;
    return FQ_OK;
}
