/* Fast corpus tokenizer — the native data-loading path.
 *
 * The reference parses corpora with per-token Python dict lookups
 * (upstream:inferencer.py parse_data [UNVERIFIED]; SURVEY.md section 2.1
 * row 7).  Host-side parsing is off the device critical path but feeds
 * the SVI streaming loader, so it is implemented natively: a C string
 * hash table over the vocabulary and a single-pass scanner over the raw
 * corpus bytes (ASCII lowercase, whitespace split, OOV dropped) that
 * emits flat int32 token ids + per-document offsets.
 *
 * Exposed via the CPython C API (no pybind11 in this environment):
 *   build_vocab(list[str]) -> capsule
 *   parse(capsule, bytes)  -> (ids: bytes of int32, offsets: bytes of int64)
 * The Python wrapper (pylda_tpu_torch/native/__init__.py) turns these into
 * numpy arrays and falls back to the pure-Python parser for non-ASCII
 * input or when the extension is unavailable.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- open-addressing string hash table (FNV-1a) ---- */

typedef struct {
    char *key;      /* owned, NUL-terminated */
    int32_t value;  /* vocab id */
} Slot;

typedef struct {
    Slot *slots;
    size_t capacity; /* power of two */
    size_t size;
} StrMap;

static uint64_t fnv1a(const char *s, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static StrMap *strmap_new(size_t expect) {
    StrMap *m = (StrMap *)malloc(sizeof(StrMap));
    if (!m) return NULL;
    m->capacity = 64;
    while (m->capacity < expect * 2) m->capacity <<= 1;
    m->size = 0;
    m->slots = (Slot *)calloc(m->capacity, sizeof(Slot));
    if (!m->slots) { free(m); return NULL; }
    return m;
}

static void strmap_free(StrMap *m) {
    if (!m) return;
    for (size_t i = 0; i < m->capacity; i++) free(m->slots[i].key);
    free(m->slots);
    free(m);
}

static int strmap_put(StrMap *m, const char *key, size_t n, int32_t value) {
    uint64_t h = fnv1a(key, n);
    size_t mask = m->capacity - 1;
    size_t i = (size_t)h & mask;
    while (m->slots[i].key) {
        if (!strncmp(m->slots[i].key, key, n) && m->slots[i].key[n] == '\0')
            return 0; /* first occurrence wins (vocab dedup semantics) */
        i = (i + 1) & mask;
    }
    m->slots[i].key = (char *)malloc(n + 1);
    if (!m->slots[i].key) return -1;
    memcpy(m->slots[i].key, key, n);
    m->slots[i].key[n] = '\0';
    m->slots[i].value = value;
    m->size++;
    return 0;
}

static int32_t strmap_get(const StrMap *m, const char *key, size_t n) {
    uint64_t h = fnv1a(key, n);
    size_t mask = m->capacity - 1;
    size_t i = (size_t)h & mask;
    while (m->slots[i].key) {
        if (!strncmp(m->slots[i].key, key, n) && m->slots[i].key[n] == '\0')
            return m->slots[i].value;
        i = (i + 1) & mask;
    }
    return -1;
}

/* ---- module functions ---- */

static void capsule_destructor(PyObject *capsule) {
    StrMap *m = (StrMap *)PyCapsule_GetPointer(capsule, "pylda.StrMap");
    strmap_free(m);
}

static PyObject *py_build_vocab(PyObject *self, PyObject *args) {
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &list)) return NULL;
    Py_ssize_t n = PyList_GET_SIZE(list);
    StrMap *m = strmap_new((size_t)(n > 0 ? n : 1));
    if (!m) return PyErr_NoMemory();
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(list, i);
        Py_ssize_t len;
        const char *s = PyUnicode_AsUTF8AndSize(item, &len);
        if (!s) { strmap_free(m); return NULL; }
        /* Keys stored verbatim: tokens are lowercased before lookup, so
         * an uppercase vocab entry never matches — identical to the
         * Python parser's semantics. */
        if (strmap_put(m, s, (size_t)len, (int32_t)i) < 0) {
            strmap_free(m); return PyErr_NoMemory();
        }
    }
    return PyCapsule_New(m, "pylda.StrMap", capsule_destructor);
}

static int is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

static PyObject *py_parse(PyObject *self, PyObject *args) {
    PyObject *capsule;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "Oy*", &capsule, &data)) return NULL;
    StrMap *m = (StrMap *)PyCapsule_GetPointer(capsule, "pylda.StrMap");
    if (!m) { PyBuffer_Release(&data); return NULL; }

    const char *buf = (const char *)data.buf;
    size_t len = (size_t)data.len;

    size_t ids_cap = 4096, ids_n = 0;
    int32_t *ids = (int32_t *)malloc(ids_cap * sizeof(int32_t));
    size_t offs_cap = 256, offs_n = 0;
    int64_t *offs = (int64_t *)malloc(offs_cap * sizeof(int64_t));
    if (!ids || !offs) {
        free(ids); free(offs); PyBuffer_Release(&data);
        return PyErr_NoMemory();
    }
    char tokbuf[256];

    Py_BEGIN_ALLOW_THREADS
    size_t i = 0;
    while (i <= len) {
        /* one document per line; a trailing line without \n still counts */
        size_t line_end = i;
        while (line_end < len && buf[line_end] != '\n') line_end++;
        if (i >= len) break;
        /* scan tokens */
        size_t p = i;
        while (p < line_end) {
            while (p < line_end && is_space(buf[p])) p++;
            size_t t0 = p;
            while (p < line_end && !is_space(buf[p])) p++;
            size_t tn = p - t0;
            if (tn == 0) continue;
            /* Stack buffer for the common case; heap for rare giant
             * tokens so semantics match the Python parser exactly. */
            char *tok = tokbuf;
            char *heap = NULL;
            if (tn >= sizeof(tokbuf)) {
                heap = (char *)malloc(tn);
                if (!heap) { ids_n = SIZE_MAX; break; }
                tok = heap;
            }
            for (size_t j = 0; j < tn; j++) {
                char c = buf[t0 + j];
                tok[j] = (c >= 'A' && c <= 'Z') ? (char)(c + 32) : c;
            }
            int32_t id = strmap_get(m, tok, tn);
            free(heap);
            if (id >= 0) {
                if (ids_n == ids_cap) {
                    ids_cap <<= 1;
                    int32_t *nids =
                        (int32_t *)realloc(ids, ids_cap * sizeof(int32_t));
                    if (!nids) { ids_n = SIZE_MAX; break; }
                    ids = nids;
                }
                ids[ids_n++] = id;
            }
        }
        if (ids_n == SIZE_MAX) break;
        if (offs_n == offs_cap) {
            offs_cap <<= 1;
            int64_t *noffs =
                (int64_t *)realloc(offs, offs_cap * sizeof(int64_t));
            if (!noffs) { ids_n = SIZE_MAX; break; }
            offs = noffs;
        }
        offs[offs_n++] = (int64_t)ids_n; /* end offset of this doc */
        i = line_end + 1;
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&data);
    if (ids_n == SIZE_MAX) {
        free(ids); free(offs);
        return PyErr_NoMemory();
    }
    PyObject *ids_b =
        PyBytes_FromStringAndSize((const char *)ids, (Py_ssize_t)(ids_n * 4));
    PyObject *offs_b = PyBytes_FromStringAndSize(
        (const char *)offs, (Py_ssize_t)(offs_n * 8));
    free(ids); free(offs);
    if (!ids_b || !offs_b) { Py_XDECREF(ids_b); Py_XDECREF(offs_b); return NULL; }
    PyObject *out = PyTuple_Pack(2, ids_b, offs_b);
    Py_DECREF(ids_b);
    Py_DECREF(offs_b);
    return out;
}

static PyMethodDef Methods[] = {
    {"build_vocab", py_build_vocab, METH_VARARGS,
     "build_vocab(list[str]) -> capsule hash table (first occurrence wins)"},
    {"parse", py_parse, METH_VARARGS,
     "parse(capsule, bytes) -> (int32 ids bytes, int64 doc-end-offset bytes)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_fastcorpus",
    "Native corpus tokenizer (ASCII lowercase, whitespace split, OOV drop)",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__fastcorpus(void) { return PyModule_Create(&module); }
