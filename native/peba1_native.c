/* peba1_native: C runtime helpers for the peba1 package.
 *
 * Native equivalents of the runtime-side work the reference does in C++
 * around its crypto engine (bit-slicing at encrypt/decrypt call sites,
 * /root/reference/src/main.cpp:58-85, and the unused-but-linked tfhe_io
 * serialization layer, SURVEY.md E9):
 *
 *   - bit_slice / bit_unslice: values <-> LSB-first bit planes for large
 *     batches (the client-side hot path feeding gate encryption);
 *   - crc32c: Castagnoli CRC (software slice-by-1; framing integrity);
 *   - frame_encode / frame_decode: length+CRC framed payloads for the
 *     client/server wire protocol (io/wire.py).
 *
 * CPython C API only (no pybind11 on this image).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ---------------------------------------------------------------- crc32c */

static uint32_t crc32c_table[256];
static int crc32c_ready = 0;

static void crc32c_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    crc32c_ready = 1;
}

static uint32_t crc32c(const uint8_t *buf, Py_ssize_t len, uint32_t crc) {
    if (!crc32c_ready) crc32c_init();
    crc = ~crc;
    for (Py_ssize_t i = 0; i < len; i++)
        crc = crc32c_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

static PyObject *py_crc32c(PyObject *self, PyObject *args) {
    Py_buffer view;
    unsigned int seed = 0;
    if (!PyArg_ParseTuple(args, "y*|I", &view, &seed)) return NULL;
    uint32_t crc = crc32c((const uint8_t *)view.buf, view.len, (uint32_t)seed);
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLong(crc);
}

/* ------------------------------------------------------------- bit slice */

/* values (int64 LE array of n elements) -> bits int8[n][nbits], LSB first */
static PyObject *py_bit_slice(PyObject *self, PyObject *args) {
    Py_buffer view;
    int nbits;
    if (!PyArg_ParseTuple(args, "y*i", &view, &nbits)) return NULL;
    if (view.len % 8 != 0 || nbits < 1 || nbits > 64) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "values must be int64 bytes; 1<=nbits<=64");
        return NULL;
    }
    Py_ssize_t n = view.len / 8;
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * nbits);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    const int64_t *vals = (const int64_t *)view.buf;
    uint8_t *bits = (uint8_t *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        uint64_t v = (uint64_t)vals[i];
        for (int b = 0; b < nbits; b++)
            bits[i * nbits + b] = (uint8_t)((v >> b) & 1u);
    }
    PyBuffer_Release(&view);
    return out;
}

/* bits int8[n][nbits] -> values int64[n] */
static PyObject *py_bit_unslice(PyObject *self, PyObject *args) {
    Py_buffer view;
    int nbits;
    if (!PyArg_ParseTuple(args, "y*i", &view, &nbits)) return NULL;
    if (nbits < 1 || nbits > 64 || view.len % nbits != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bits length must be divisible by nbits");
        return NULL;
    }
    Py_ssize_t n = view.len / nbits;
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 8);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    const uint8_t *bits = (const uint8_t *)view.buf;
    int64_t *vals = (int64_t *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        uint64_t v = 0;
        for (int b = 0; b < nbits; b++)
            if (bits[i * nbits + b]) v |= (1ull << b);
        vals[i] = (int64_t)v;
    }
    PyBuffer_Release(&view);
    return out;
}

/* ------------------------------------------------------------- framing */

/* frame: magic(4) 'PEB1' | version(u16) | kind(u16) | payload_len(u64)
 *        | crc32c(payload) (u32) | payload */
#define FRAME_MAGIC "PEB1"
#define FRAME_HDR 20

static PyObject *py_frame_encode(PyObject *self, PyObject *args) {
    Py_buffer view;
    unsigned int kind, version = 1;
    if (!PyArg_ParseTuple(args, "Iy*|I", &kind, &view, &version)) return NULL;
    PyObject *out = PyBytes_FromStringAndSize(NULL, FRAME_HDR + view.len);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    memcpy(p, FRAME_MAGIC, 4);
    uint16_t v16 = (uint16_t)version, k16 = (uint16_t)kind;
    memcpy(p + 4, &v16, 2);
    memcpy(p + 6, &k16, 2);
    uint64_t len = (uint64_t)view.len;
    memcpy(p + 8, &len, 8);
    uint32_t crc = crc32c((const uint8_t *)view.buf, view.len, 0);
    memcpy(p + 16, &crc, 4);
    memcpy(p + FRAME_HDR, view.buf, view.len);
    PyBuffer_Release(&view);
    return out;
}

static PyObject *py_frame_decode(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const uint8_t *p = (const uint8_t *)view.buf;
    if (view.len < FRAME_HDR || memcmp(p, FRAME_MAGIC, 4) != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bad frame magic");
        return NULL;
    }
    uint16_t version, kind;
    uint64_t len;
    uint32_t crc;
    memcpy(&version, p + 4, 2);
    memcpy(&kind, p + 6, 2);
    memcpy(&len, p + 8, 8);
    memcpy(&crc, p + 16, 4);
    if ((uint64_t)(view.len - FRAME_HDR) < len) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "truncated frame");
        return NULL;
    }
    if (crc32c(p + FRAME_HDR, (Py_ssize_t)len, 0) != crc) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "frame CRC mismatch");
        return NULL;
    }
    PyObject *payload = PyBytes_FromStringAndSize((const char *)(p + FRAME_HDR),
                                                  (Py_ssize_t)len);
    PyBuffer_Release(&view);
    if (!payload) return NULL;
    return Py_BuildValue("(IIN)", (unsigned)kind, (unsigned)version, payload);
}

static PyMethodDef methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS, "crc32c(data, seed=0) -> int"},
    {"bit_slice", py_bit_slice, METH_VARARGS,
     "bit_slice(int64_bytes, nbits) -> int8 bit-plane bytes (LSB first)"},
    {"bit_unslice", py_bit_unslice, METH_VARARGS,
     "bit_unslice(bit_bytes, nbits) -> int64 bytes"},
    {"frame_encode", py_frame_encode, METH_VARARGS,
     "frame_encode(kind, payload, version=1) -> framed bytes"},
    {"frame_decode", py_frame_decode, METH_VARARGS,
     "frame_decode(data) -> (kind, version, payload)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "peba1_native",
    "Native runtime helpers for peba1", -1, methods,
};

PyMODINIT_FUNC PyInit_peba1_native(void) { return PyModule_Create(&module); }
