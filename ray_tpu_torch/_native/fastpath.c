/* _fastpath: native data-plane primitives for the host object store.
 *
 * The object plane's hot path is memcpy into /dev/shm segments (put, pull,
 * spill).  CPython does that copy single-threaded while holding the GIL
 * (memoryview slice assignment), which caps large puts at a few GiB/s and
 * stalls every other thread in the process.  This module provides:
 *
 *   copy(dest, src, nthreads=0)  -- parallel memcpy, GIL released
 *   prefault(dest, nthreads=0)   -- touch pages in parallel (first-touch
 *                                   faults on fresh shm dominate cold puts)
 *
 * Role-equivalent to the memcpy/population work plasma does natively in the
 * reference (reference: src/ray/object_manager/plasma/store.cc writes into
 * dlmalloc'd shm from C++, never through the interpreter).
 *
 * Plain C + pthreads; no dependencies beyond the CPython C API.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <string.h>
#include <stdint.h>
#include <time.h>
#include <unistd.h>

typedef struct {
    char *dest;
    const char *src;   /* NULL for prefault */
    size_t n;
} span_t;

static void *copy_worker(void *arg) {
    span_t *s = (span_t *)arg;
    if (s->src != NULL) {
        memcpy(s->dest, s->src, s->n);
    } else {
        /* Touch one byte per page; write so the kernel allocates backing
         * pages for shm (read faults map the shared zero page). */
        volatile char *p = (volatile char *)s->dest;
        for (size_t off = 0; off < s->n; off += 4096)
            p[off] = p[off];
        if (s->n)
            p[s->n - 1] = p[s->n - 1];
    }
    return NULL;
}

/* Split [0, n) into k contiguous spans aligned to 64-byte cache lines and
 * run copy_worker over them on k threads (caller's thread runs span 0). */
static int run_spans(char *dest, const char *src, size_t n, int k) {
    if (k <= 1 || n < (size_t)k * 4096) {
        span_t s = {dest, src, n};
        copy_worker(&s);
        return 0;
    }
    pthread_t tids[64];
    span_t spans[64];
    if (k > 64) k = 64;
    /* Ceil-divide then align up so k spans always cover all n bytes
     * (floor-divide drops the tail whenever n/k is already aligned). */
    size_t chunk = ((n + (size_t)k - 1) / (size_t)k + 63) & ~(size_t)63;
    int started = 0;
    size_t off = 0;
    for (int i = 0; i < k && off < n; i++) {
        size_t len = chunk < n - off ? chunk : n - off;
        spans[i].dest = dest + off;
        spans[i].src = src ? src + off : NULL;
        spans[i].n = len;
        off += len;
        if (i > 0) {
            /* Record only successfully-created handles; a failed create
             * runs the span inline instead. */
            if (pthread_create(&tids[started], NULL, copy_worker,
                               &spans[i]) != 0) {
                copy_worker(&spans[i]);
                continue;
            }
            started++;
        }
    }
    copy_worker(&spans[0]);
    for (int i = 0; i < started; i++)
        pthread_join(tids[i], NULL);
    return 0;
}

static int default_threads(size_t n) {
    if (n < (8u << 20))
        return 1;
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    if (ncpu < 1) ncpu = 1;
    int k = (int)(n / (8u << 20));       /* >= 8 MiB per thread */
    if (k > ncpu) k = (int)ncpu;
    if (k > 16) k = 16;
    if (k < 1) k = 1;
    return k;
}

static PyObject *py_copy(PyObject *self, PyObject *args) {
    PyObject *dest_obj, *src_obj;
    int nthreads = 0;
    if (!PyArg_ParseTuple(args, "OO|i", &dest_obj, &src_obj, &nthreads))
        return NULL;
    Py_buffer dest, src;
    if (PyObject_GetBuffer(dest_obj, &dest, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (PyObject_GetBuffer(src_obj, &src, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&dest);
        return NULL;
    }
    if (src.len > dest.len) {
        PyBuffer_Release(&src);
        PyBuffer_Release(&dest);
        PyErr_Format(PyExc_ValueError,
                     "source (%zd bytes) larger than destination (%zd bytes)",
                     src.len, dest.len);
        return NULL;
    }
    size_t n = (size_t)src.len;
    int k = nthreads > 0 ? nthreads : default_threads(n);
    Py_BEGIN_ALLOW_THREADS
    run_spans((char *)dest.buf, (const char *)src.buf, n, k);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&src);
    PyBuffer_Release(&dest);
    return PyLong_FromSize_t(n);
}

static PyObject *py_prefault(PyObject *self, PyObject *args) {
    PyObject *dest_obj;
    int nthreads = 0;
    if (!PyArg_ParseTuple(args, "O|i", &dest_obj, &nthreads))
        return NULL;
    Py_buffer dest;
    if (PyObject_GetBuffer(dest_obj, &dest, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    size_t n = (size_t)dest.len;
    int k = nthreads > 0 ? nthreads : default_threads(n);
    Py_BEGIN_ALLOW_THREADS
    run_spans((char *)dest.buf, NULL, n, k);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&dest);
    return PyLong_FromSize_t(n);
}

/* Spin-then-sleep wait on an SPSC channel header: [u64 write_seq]
 * [u64 read_seq] at the buffer head.  want_unread=1 waits for
 * write_seq > read_seq (reader side); 0 waits for write_seq <= read_seq
 * (writer side, slot free).  GIL released; acquire loads pair with the
 * peer process's stores through the coherent shm mapping.  Python-level
 * spin loops cost ~1us/iteration in interpreter overhead; this loop is
 * ~1ns/iteration, which is what makes sub-100us DAG hops possible. */
static PyObject *py_wait_seq(PyObject *self, PyObject *args) {
    PyObject *buf_obj;
    double timeout_s;
    int want_unread;
    if (!PyArg_ParseTuple(args, "Odi", &buf_obj, &timeout_s, &want_unread))
        return NULL;
    Py_buffer buf;
    if (PyObject_GetBuffer(buf_obj, &buf, PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (buf.len < 16) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "buffer too small for seq header");
        return NULL;
    }
    const uint64_t *w = (const uint64_t *)buf.buf;
    const uint64_t *r = w + 1;
    int ok = 0;
    Py_BEGIN_ALLOW_THREADS
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    double deadline = ts.tv_sec + ts.tv_nsec * 1e-9 + timeout_s;
    long spins = 0;
    for (;;) {
        uint64_t wv = __atomic_load_n(w, __ATOMIC_ACQUIRE);
        uint64_t rv = __atomic_load_n(r, __ATOMIC_ACQUIRE);
        int unread = wv > rv;
        if (unread == (want_unread != 0)) { ok = 1; break; }
        if (++spins < 20000) {
#if defined(__x86_64__) || defined(__i386__)
            __builtin_ia32_pause();
#endif
            continue;
        }
        clock_gettime(CLOCK_MONOTONIC, &ts);
        if (ts.tv_sec + ts.tv_nsec * 1e-9 > deadline) break;
        struct timespec nap = {0, 50000};  /* 50us */
        nanosleep(&nap, NULL);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf);
    if (ok) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

/* Atomic release store of a u64 header word.  Pairs with wait_seq's acquire
 * loads: on x86_64/aarch64 a plain aligned store happens to be atomic, but
 * mixing plain stores with atomic loads is UB-adjacent and can tear on other
 * architectures — all header publishes go through here instead. */
static PyObject *py_store_seq(PyObject *self, PyObject *args) {
    PyObject *buf_obj;
    Py_ssize_t offset;
    unsigned long long value;
    if (!PyArg_ParseTuple(args, "OnK", &buf_obj, &offset, &value))
        return NULL;
    Py_buffer buf;
    if (PyObject_GetBuffer(buf_obj, &buf, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (offset < 0 || offset + 8 > buf.len || (offset & 7) != 0) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "offset must be 8-aligned and in range");
        return NULL;
    }
    uint64_t *p = (uint64_t *)((char *)buf.buf + offset);
    __atomic_store_n(p, (uint64_t)value, __ATOMIC_RELEASE);
    PyBuffer_Release(&buf);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"copy", py_copy, METH_VARARGS,
     "copy(dest, src, nthreads=0) -> bytes copied.  Parallel memcpy with the "
     "GIL released; nthreads=0 picks a size-based default."},
    {"prefault", py_prefault, METH_VARARGS,
     "prefault(dest, nthreads=0) -> bytes touched.  Fault in backing pages."},
    {"wait_seq", py_wait_seq, METH_VARARGS,
     "wait_seq(buf, timeout_s, want_unread) -> bool.  Spin-then-sleep wait "
     "on an SPSC [write_seq, read_seq] header; True when satisfied, False "
     "on timeout."},
    {"store_seq", py_store_seq, METH_VARARGS,
     "store_seq(buf, offset, value).  Atomic release store of a u64 header "
     "word (pairs with wait_seq's acquire loads)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastpath",
    "Native data-plane primitives (parallel memcpy / prefault).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__fastpath(void) {
    return PyModule_Create(&moduledef);
}
