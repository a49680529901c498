/* Host data-plane fast paths for the engine driver.
 *
 * The reference's engine runs its per-item plumbing in native code
 * (Rust); here the hot host-tier loop — grouping a delivery of
 * (key, value) tuples by key — is one C pass instead of per-item
 * Python bytecode.  Strictness contract: only exact 2-tuples with
 * str keys take the fast path; anything else raises TypeError and
 * the caller falls back to the general Python loop (which accepts
 * any 2-iterable and raises the step-qualified error).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <datetime.h>

#if PY_VERSION_HEX < 0x030A0000
/* 3.9 lacks the tzinfo accessor macro; same layout read. */
#define PyDateTime_DATE_GET_TZINFO(o)                                  \
    (((PyDateTime_DateTime *)(o))->hastzinfo                           \
         ? ((PyDateTime_DateTime *)(o))->tzinfo                        \
         : Py_None)
#endif

static PyObject *
group_kv(PyObject *self, PyObject *args)
{
    PyObject *items;
    if (!PyArg_ParseTuple(args, "O", &items)) {
        return NULL;
    }
    if (!PyList_Check(items)) {
        PyErr_SetString(PyExc_TypeError, "items must be a list");
        return NULL;
    }
    PyObject *groups = PyDict_New();
    if (groups == NULL) {
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(items);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(items, i); /* borrowed */
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
            Py_DECREF(groups);
            PyErr_SetString(PyExc_TypeError,
                            "row is not a (key, value) 2-tuple");
            return NULL;
        }
        PyObject *k = PyTuple_GET_ITEM(item, 0);
        PyObject *v = PyTuple_GET_ITEM(item, 1);
        if (!PyUnicode_Check(k)) {
            Py_DECREF(groups);
            PyErr_SetString(PyExc_TypeError, "key is not a str");
            return NULL;
        }
        PyObject *lst = PyDict_GetItemWithError(groups, k); /* borrowed */
        if (lst == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(groups);
                return NULL;
            }
            lst = PyList_New(0);
            if (lst == NULL || PyDict_SetItem(groups, k, lst) < 0) {
                Py_XDECREF(lst);
                Py_DECREF(groups);
                return NULL;
            }
            Py_DECREF(lst); /* dict keeps it alive; borrowed below */
        }
        if (PyList_Append(lst, v) < 0) {
            Py_DECREF(groups);
            return NULL;
        }
    }
    return groups;
}

/* zlib-compatible adler32 over a short buffer (keys are short; the
 * blocked deferral trick zlib uses for long inputs is not worth it
 * here).  Matches zlib.adler32(data) with the default start of 1. */
static unsigned long
adler32_key(const char *buf, Py_ssize_t len)
{
    unsigned long a = 1, b = 0;
    for (Py_ssize_t i = 0; i < len; i++) {
        a += (unsigned char)buf[i];
        if (a >= 65521) {
            a -= 65521;
        }
        b += a;
        if (b >= 65521) {
            b -= 65521;
        }
    }
    return (b << 16) | a;
}

/* Bucket a list of (str key, value) 2-tuples by
 * adler32(key utf-8) % n_buckets in one C pass; returns a list of
 * n_buckets lists of the original items.  This is the keyed-exchange
 * and default-part_fn routing loop — the exact hot spot the
 * reference flags in its own output driver. */
static PyObject *
bucket_adler(PyObject *self, PyObject *args)
{
    PyObject *items;
    Py_ssize_t n_buckets;
    if (!PyArg_ParseTuple(args, "On", &items, &n_buckets)) {
        return NULL;
    }
    if (!PyList_Check(items)) {
        PyErr_SetString(PyExc_TypeError, "items must be a list");
        return NULL;
    }
    if (n_buckets <= 0) {
        PyErr_SetString(PyExc_ValueError, "n_buckets must be positive");
        return NULL;
    }
    PyObject *buckets = PyList_New(n_buckets);
    if (buckets == NULL) {
        return NULL;
    }
    for (Py_ssize_t w = 0; w < n_buckets; w++) {
        PyObject *lst = PyList_New(0);
        if (lst == NULL) {
            Py_DECREF(buckets);
            return NULL;
        }
        PyList_SET_ITEM(buckets, w, lst);
    }
    Py_ssize_t n = PyList_GET_SIZE(items);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(items, i); /* borrowed */
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
            Py_DECREF(buckets);
            PyErr_SetString(PyExc_TypeError,
                            "row is not a (key, value) 2-tuple");
            return NULL;
        }
        PyObject *k = PyTuple_GET_ITEM(item, 0);
        if (!PyUnicode_Check(k)) {
            Py_DECREF(buckets);
            PyErr_SetString(PyExc_TypeError, "key is not a str");
            return NULL;
        }
        Py_ssize_t klen;
        const char *kbuf = PyUnicode_AsUTF8AndSize(k, &klen);
        if (kbuf == NULL) {
            Py_DECREF(buckets);
            return NULL;
        }
        Py_ssize_t w = (Py_ssize_t)(adler32_key(kbuf, klen)
                                    % (unsigned long)n_buckets);
        if (PyList_Append(PyList_GET_ITEM(buckets, w), item) < 0) {
            Py_DECREF(buckets);
            return NULL;
        }
    }
    return buckets;
}

/* Flatten a {key: [values]} group dict (insertion-ordered, as built
 * by group_kv) into a caller-provided contiguous float64 buffer, one
 * group after another.  Returns the list of group sizes.  Raises
 * TypeError when a value is not float-coercible — the caller falls
 * back to the host tier. */
static PyObject *
scan_fill_values(PyObject *self, PyObject *args)
{
    PyObject *groups, *out;
    if (!PyArg_ParseTuple(args, "O!O", &PyDict_Type, &groups, &out)) {
        return NULL;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(out, &view, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        return NULL;
    }
    double *buf = (double *)view.buf;
    Py_ssize_t cap = view.len / (Py_ssize_t)sizeof(double);
    PyObject *lens = PyList_New(0);
    if (lens == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t pos = 0, di = 0;
    PyObject *k, *v;
    while (PyDict_Next(groups, &di, &k, &v)) {
        if (!PyList_Check(v)) {
            PyErr_SetString(PyExc_TypeError, "group values must be lists");
            goto fail;
        }
        Py_ssize_t m = PyList_GET_SIZE(v);
        if (pos + m > cap) {
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            goto fail;
        }
        for (Py_ssize_t i = 0; i < m; i++) {
            double d = PyFloat_AsDouble(PyList_GET_ITEM(v, i));
            if (d == -1.0 && PyErr_Occurred()) {
                goto fail;
            }
            buf[pos++] = d;
        }
        PyObject *len_obj = PyLong_FromSsize_t(m);
        if (len_obj == NULL || PyList_Append(lens, len_obj) < 0) {
            Py_XDECREF(len_obj);
            goto fail;
        }
        Py_DECREF(len_obj);
    }
    PyBuffer_Release(&view);
    return lens;
fail:
    Py_DECREF(lens);
    PyBuffer_Release(&view);
    return NULL;
}

/* Build the scan step's emission list
 * [(key, (value, out0, out1, ...)), ...] in one C pass over the
 * insertion-ordered group dict plus the device output columns —
 * reusing the original key and value objects so only the per-row
 * scalars and two tuples are allocated.  The columns arrive as a
 * tuple of contiguous 1-D buffers (numpy arrays); each element's
 * Python conversion is picked from the buffer's format character
 * (floats, bools, signed ints), so any ScanKind's output layout
 * rides the same fast path. */
#define SCAN_EMIT_MAX_OUTS 8

static PyObject *
scan_emit(PyObject *self, PyObject *args)
{
    PyObject *groups, *outs;
    if (!PyArg_ParseTuple(args, "O!O!", &PyDict_Type, &groups,
                          &PyTuple_Type, &outs)) {
        return NULL;
    }
    Py_ssize_t n_outs = PyTuple_GET_SIZE(outs);
    if (n_outs < 1 || n_outs > SCAN_EMIT_MAX_OUTS) {
        PyErr_Format(PyExc_ValueError,
                     "scan_emit takes 1..%d output columns, got %zd",
                     SCAN_EMIT_MAX_OUTS, n_outs);
        return NULL;
    }
    Py_buffer views[SCAN_EMIT_MAX_OUTS];
    /* 0 = float, 1 = bool, 2 = signed int (by itemsize). */
    int conv[SCAN_EMIT_MAX_OUTS];
    Py_ssize_t n_views = 0;
    PyObject *out = NULL;
    Py_ssize_t n = -1;
    for (Py_ssize_t c = 0; c < n_outs; c++) {
        if (PyObject_GetBuffer(PyTuple_GET_ITEM(outs, c), &views[c],
                               PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0) {
            goto done;
        }
        n_views++;
        Py_buffer *bv = &views[c];
        char fmt = bv->format != NULL ? bv->format[0] : '\0';
        if (fmt == '>' || fmt == '!') {
            /* Non-native byte order would be silently mis-decoded by
             * the native-endian loads below: make the caller
             * normalize instead. */
            PyErr_SetString(PyExc_TypeError,
                            "scan output columns must be native-endian");
            goto done;
        }
        if (fmt == '<' || fmt == '=' || fmt == '@') {
            fmt = bv->format[1];
        }
        if (fmt == 'f' || fmt == 'd') {
            conv[c] = 0;
        } else if (fmt == '?') {
            conv[c] = 1;
        } else if (fmt == 'b' || fmt == 'h' || fmt == 'i' || fmt == 'l'
                   || fmt == 'q') {
            conv[c] = 2;
        } else if (fmt == 'B') {
            conv[c] = 3; /* uint8 data, NOT bool (numpy bool is '?') */
        } else {
            PyErr_Format(PyExc_TypeError,
                         "unsupported scan output format '%c'", fmt);
            goto done;
        }
        Py_ssize_t rows = bv->itemsize > 0 ? bv->len / bv->itemsize : 0;
        if (n < 0) {
            n = rows;
        } else if (rows != n) {
            PyErr_SetString(PyExc_ValueError,
                            "scan output column length mismatch");
            goto done;
        }
    }
    out = PyList_New(n);
    if (out == NULL) {
        goto done;
    }
    Py_ssize_t pos = 0, di = 0;
    PyObject *k, *v;
    while (PyDict_Next(groups, &di, &k, &v)) {
        if (!PyList_Check(v)) {
            PyErr_SetString(PyExc_TypeError, "group values must be lists");
            Py_CLEAR(out);
            goto done;
        }
        Py_ssize_t m = PyList_GET_SIZE(v);
        if (pos + m > n) {
            PyErr_SetString(PyExc_ValueError, "row count mismatch");
            Py_CLEAR(out);
            goto done;
        }
        for (Py_ssize_t i = 0; i < m; i++) {
            PyObject *inner = PyTuple_New(1 + n_outs);
            if (inner == NULL) {
                Py_CLEAR(out);
                goto done;
            }
            PyObject *val = PyList_GET_ITEM(v, i);
            Py_INCREF(val);
            PyTuple_SET_ITEM(inner, 0, val);
            for (Py_ssize_t c = 0; c < n_outs; c++) {
                const char *p = (const char *)views[c].buf
                                + pos * views[c].itemsize;
                PyObject *cell;
                if (conv[c] == 0) {
                    double d = views[c].itemsize == 4
                                   ? (double)*(const float *)p
                                   : *(const double *)p;
                    cell = PyFloat_FromDouble(d);
                } else if (conv[c] == 1) {
                    cell = *(const unsigned char *)p ? Py_True : Py_False;
                    Py_INCREF(cell);
                } else if (conv[c] == 3) {
                    cell = PyLong_FromLong(*(const unsigned char *)p);
                } else {
                    long long iv;
                    switch (views[c].itemsize) {
                    case 1: iv = *(const signed char *)p; break;
                    case 2: iv = *(const int16_t *)p; break;
                    case 4: iv = *(const int32_t *)p; break;
                    default: iv = *(const int64_t *)p; break;
                    }
                    cell = PyLong_FromLongLong(iv);
                }
                if (cell == NULL) {
                    Py_DECREF(inner);
                    Py_CLEAR(out);
                    goto done;
                }
                PyTuple_SET_ITEM(inner, 1 + c, cell);
            }
            PyObject *pair = PyTuple_New(2);
            if (pair == NULL) {
                Py_DECREF(inner);
                Py_CLEAR(out);
                goto done;
            }
            Py_INCREF(k);
            PyTuple_SET_ITEM(pair, 0, k);
            PyTuple_SET_ITEM(pair, 1, inner);
            PyList_SET_ITEM(out, pos, pair);
            pos++;
        }
    }
    if (pos != n) {
        PyErr_SetString(PyExc_ValueError, "row count mismatch");
        Py_CLEAR(out);
    }
done:
    for (Py_ssize_t c = 0; c < n_views; c++) {
        PyBuffer_Release(&views[c]);
    }
    return out;
}

/* One-pass itemized->columnar promotion for keyed aggregation:
 * dictionary-encode the keys of (str key, value) 2-tuples through the
 * caller's {key: dense_id} dict (assigning len(dict) to first-seen
 * keys) and fill the values into a float64 buffer, walking each
 * cache-cold item tuple exactly once.  Returns (new_keys, all_int):
 * the keys added this call in id order, and whether every value was
 * an exact int.  On error the added keys are rolled back out of the
 * dict so the caller's id space stays consistent. */
static PyObject *
kv_encode(PyObject *self, PyObject *args)
{
    PyObject *items, *iddict, *ids_obj, *vals_obj, *ivals_obj = NULL;
    if (!PyArg_ParseTuple(args, "O!O!OO|O", &PyList_Type, &items,
                          &PyDict_Type, &iddict, &ids_obj, &vals_obj,
                          &ivals_obj)) {
        return NULL;
    }
    if (ivals_obj == Py_None) {
        ivals_obj = NULL;
    }
    Py_buffer iv, vv, iiv;
    iiv.buf = NULL;
    if (PyObject_GetBuffer(ids_obj, &iv, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        return NULL;
    }
    if (PyObject_GetBuffer(vals_obj, &vv, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&iv);
        return NULL;
    }
    if (ivals_obj != NULL
        && PyObject_GetBuffer(ivals_obj, &iiv,
                              PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&iv);
        PyBuffer_Release(&vv);
        return NULL;
    }
    int32_t *ids = (int32_t *)iv.buf;
    double *vals = (double *)vv.buf;
    int64_t *ivals = (int64_t *)iiv.buf; /* NULL without the buffer */
    Py_ssize_t n = PyList_GET_SIZE(items);
    PyObject *new_keys = NULL;
    if (iv.len / (Py_ssize_t)sizeof(int32_t) < n
        || vv.len / (Py_ssize_t)sizeof(double) < n
        || (ivals != NULL && iiv.len / (Py_ssize_t)sizeof(int64_t) < n)) {
        PyErr_SetString(PyExc_ValueError, "output buffers too small");
        goto fail;
    }
    new_keys = PyList_New(0);
    if (new_keys == NULL) {
        goto fail;
    }
    int all_int = 1;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(items, i); /* borrowed */
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
            PyErr_SetString(PyExc_TypeError,
                            "row is not a (key, value) 2-tuple");
            goto fail;
        }
        PyObject *k = PyTuple_GET_ITEM(item, 0);
        PyObject *v = PyTuple_GET_ITEM(item, 1);
        if (!PyUnicode_Check(k)) {
            PyErr_SetString(PyExc_TypeError, "key is not a str");
            goto fail;
        }
        /* PyIndex_Check covers exact integers beyond PyLong (numpy
         * int scalars implement __index__; floats do not), so int
         * streams keep the exact integer accumulator. */
        if (all_int && !PyIndex_Check(v)) {
            all_int = 0;
        }
        if (all_int && ivals != NULL) {
            /* Exact int64 lane: values beyond 2^53 survive (the
             * float64 lane would round them).  Overflow past int64
             * drops the whole batch to the float path, like the
             * per-item fallback's numpy coercion would error. */
            PyObject *exact = PyNumber_Index(v);
            if (exact == NULL) {
                goto fail;
            }
            int overflow = 0;
            long long llv = PyLong_AsLongLongAndOverflow(exact, &overflow);
            Py_DECREF(exact);
            if (llv == -1 && PyErr_Occurred()) {
                goto fail;
            }
            if (overflow) {
                all_int = 0;
            } else {
                ivals[i] = (int64_t)llv;
            }
        }
        double d = PyFloat_AsDouble(v);
        if (d == -1.0 && PyErr_Occurred()) {
            goto fail;
        }
        PyObject *id_obj = PyDict_GetItemWithError(iddict, k); /* borrowed */
        long id;
        if (id_obj != NULL) {
            id = PyLong_AsLong(id_obj);
        } else {
            if (PyErr_Occurred()) {
                goto fail;
            }
            id = (long)PyDict_GET_SIZE(iddict);
            id_obj = PyLong_FromLong(id);
            if (id_obj == NULL || PyDict_SetItem(iddict, k, id_obj) < 0) {
                Py_XDECREF(id_obj);
                goto fail;
            }
            Py_DECREF(id_obj);
            if (PyList_Append(new_keys, k) < 0) {
                goto fail;
            }
        }
        ids[i] = (int32_t)id;
        vals[i] = d;
    }
    PyBuffer_Release(&iv);
    PyBuffer_Release(&vv);
    if (iiv.buf != NULL) {
        PyBuffer_Release(&iiv);
    }
    PyObject *res = Py_BuildValue("(Oi)", new_keys, all_int);
    Py_DECREF(new_keys);
    return res;
fail:
    if (new_keys != NULL) {
        /* Roll the added keys back out so a retry or fallback sees
         * the dict exactly as before this call (the live exception
         * is parked across the dict calls). */
        PyObject *et, *ev, *tb;
        PyErr_Fetch(&et, &ev, &tb);
        Py_ssize_t added = PyList_GET_SIZE(new_keys);
        for (Py_ssize_t j = 0; j < added; j++) {
            if (PyDict_DelItem(iddict, PyList_GET_ITEM(new_keys, j)) < 0) {
                PyErr_Clear();
            }
        }
        PyErr_Restore(et, ev, tb);
        Py_DECREF(new_keys);
    }
    PyBuffer_Release(&iv);
    PyBuffer_Release(&vv);
    if (iiv.buf != NULL) {
        PyBuffer_Release(&iiv);
    }
    return NULL;
}

/* any(isinstance(x, types) for x in items) in one C pass with a
 * last-clean-type cache: homogeneous lists (the overwhelmingly common
 * benchmark/test shape) cost one pointer compare per item after the
 * first isinstance check. */
static PyObject *
any_isinstance(PyObject *self, PyObject *args)
{
    PyObject *items, *types;
    if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &items, &types)) {
        return NULL;
    }
    PyTypeObject *clean = NULL;
    Py_ssize_t n = PyList_GET_SIZE(items);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PyList_GET_ITEM(items, i); /* borrowed */
        if (Py_TYPE(it) == clean) {
            continue;
        }
        int r = PyObject_IsInstance(it, types);
        if (r < 0) {
            return NULL;
        }
        if (r) {
            Py_RETURN_TRUE;
        }
        clean = Py_TYPE(it);
    }
    Py_RETURN_FALSE;
}

/* Days since the Unix epoch for a proleptic-Gregorian civil date
 * (Howard Hinnant's days_from_civil). */
static int64_t
days_from_civil(int y, int m, int d)
{
    y -= m <= 2;
    int64_t era = (y >= 0 ? y : y - 399) / 400;
    unsigned yoe = (unsigned)(y - era * 400);
    unsigned doy = (unsigned)((153 * (m + (m > 2 ? -3 : 9)) + 2) / 5
                              + d - 1);
    unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + (int64_t)doe - 719468;
}

/* Epoch-microseconds of a UTC-tzinfo datetime via pure arithmetic
 * (no per-item .timestamp() call).  Returns -1 with an exception set
 * when the object is not a datetime carrying the UTC singleton
 * tzinfo — non-UTC (or naive) timestamps take the per-item Python
 * path, which handles any tzinfo via .timestamp(). */
static int
utc_dt_to_us(PyObject *v, double *out)
{
    if (!PyDateTime_Check(v)
        || PyDateTime_DATE_GET_TZINFO(v) != PyDateTime_TimeZone_UTC) {
        PyErr_SetString(PyExc_TypeError,
                        "timestamp is not a UTC-tzinfo datetime");
        return -1;
    }
    int64_t days = days_from_civil(PyDateTime_GET_YEAR(v),
                                   PyDateTime_GET_MONTH(v),
                                   PyDateTime_GET_DAY(v));
    int64_t secs = days * 86400
                   + PyDateTime_DATE_GET_HOUR(v) * 3600
                   + PyDateTime_DATE_GET_MINUTE(v) * 60
                   + PyDateTime_DATE_GET_SECOND(v);
    *out = (double)(secs * 1000000 + PyDateTime_DATE_GET_MICROSECOND(v));
    return 0;
}

/* One-pass itemized->columnar promotion for event-time windowing:
 * dictionary-encode the keys of (str key, value) 2-tuples through the
 * caller's {key: dense_id} dict (assigning len(dict) to first-seen
 * keys, like kv_encode) and fill per-row (epoch-us timestamp, float
 * value) columns.  Two row shapes, uniform per call:
 *   mode 1: value is a UTC datetime (windowed counts) -> ts = value,
 *           val = 1.0;
 *   mode 2: value is float-coercible and carries a UTC datetime in a
 *           `ts` attribute (the TsValue degrade shape) -> val =
 *           float(value), ts = value.ts.
 * Returns (new_keys, mode); raises TypeError (with the iddict rolled
 * back) on malformed or mixed rows so the caller can fall back. */
static PyObject *
wa_encode(PyObject *self, PyObject *args)
{
    PyObject *items, *iddict, *ids_obj, *ts_obj, *vals_obj;
    if (!PyArg_ParseTuple(args, "O!O!OOO", &PyList_Type, &items,
                          &PyDict_Type, &iddict, &ids_obj, &ts_obj,
                          &vals_obj)) {
        return NULL;
    }
    Py_buffer iv, tv, vv;
    if (PyObject_GetBuffer(ids_obj, &iv, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        return NULL;
    }
    if (PyObject_GetBuffer(ts_obj, &tv, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&iv);
        return NULL;
    }
    if (PyObject_GetBuffer(vals_obj, &vv, PyBUF_CONTIG | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&iv);
        PyBuffer_Release(&tv);
        return NULL;
    }
    int32_t *ids = (int32_t *)iv.buf;
    double *tss = (double *)tv.buf;
    double *vals = (double *)vv.buf;
    Py_ssize_t n = PyList_GET_SIZE(items);
    PyObject *new_keys = NULL;
    int mode = 0;
    if (iv.len / (Py_ssize_t)sizeof(int32_t) < n
        || tv.len / (Py_ssize_t)sizeof(double) < n
        || vv.len / (Py_ssize_t)sizeof(double) < n) {
        PyErr_SetString(PyExc_ValueError, "output buffers too small");
        goto fail;
    }
    new_keys = PyList_New(0);
    if (new_keys == NULL) {
        goto fail;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(items, i); /* borrowed */
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
            PyErr_SetString(PyExc_TypeError,
                            "row is not a (key, value) 2-tuple");
            goto fail;
        }
        PyObject *k = PyTuple_GET_ITEM(item, 0);
        PyObject *v = PyTuple_GET_ITEM(item, 1);
        if (!PyUnicode_Check(k)) {
            PyErr_SetString(PyExc_TypeError, "key is not a str");
            goto fail;
        }
        if (PyDateTime_Check(v)) {
            if (mode == 2) {
                PyErr_SetString(PyExc_TypeError,
                                "mixed datetime/value row shapes");
                goto fail;
            }
            mode = 1;
            if (utc_dt_to_us(v, &tss[i]) < 0) {
                goto fail;
            }
            vals[i] = 1.0;
        } else {
            if (mode == 1) {
                PyErr_SetString(PyExc_TypeError,
                                "mixed datetime/value row shapes");
                goto fail;
            }
            mode = 2;
            double d = PyFloat_AsDouble(v);
            if (d == -1.0 && PyErr_Occurred()) {
                goto fail;
            }
            PyObject *ts = PyObject_GetAttrString(v, "ts");
            if (ts == NULL) {
                goto fail;
            }
            int bad = utc_dt_to_us(ts, &tss[i]);
            Py_DECREF(ts);
            if (bad < 0) {
                goto fail;
            }
            vals[i] = d;
        }
        PyObject *id_obj = PyDict_GetItemWithError(iddict, k); /* borrowed */
        long id;
        if (id_obj != NULL) {
            id = PyLong_AsLong(id_obj);
        } else {
            if (PyErr_Occurred()) {
                goto fail;
            }
            id = (long)PyDict_GET_SIZE(iddict);
            id_obj = PyLong_FromLong(id);
            if (id_obj == NULL || PyDict_SetItem(iddict, k, id_obj) < 0) {
                Py_XDECREF(id_obj);
                goto fail;
            }
            Py_DECREF(id_obj);
            if (PyList_Append(new_keys, k) < 0) {
                goto fail;
            }
        }
        ids[i] = (int32_t)id;
    }
    PyBuffer_Release(&iv);
    PyBuffer_Release(&tv);
    PyBuffer_Release(&vv);
    PyObject *res = Py_BuildValue("(Oi)", new_keys, mode);
    Py_DECREF(new_keys);
    return res;
fail:
    if (new_keys != NULL) {
        PyObject *et, *ev, *tb;
        PyErr_Fetch(&et, &ev, &tb);
        Py_ssize_t added = PyList_GET_SIZE(new_keys);
        for (Py_ssize_t j = 0; j < added; j++) {
            if (PyDict_DelItem(iddict, PyList_GET_ITEM(new_keys, j)) < 0) {
                PyErr_Clear();
            }
        }
        PyErr_Restore(et, ev, tb);
        Py_DECREF(new_keys);
    }
    PyBuffer_Release(&iv);
    PyBuffer_Release(&tv);
    PyBuffer_Release(&vv);
    return NULL;
}

static PyMethodDef HostOpsMethods[] = {
    {"group_kv", group_kv, METH_VARARGS,
     "Group a list of (str key, value) tuples into {key: [values]}."},
    {"bucket_adler", bucket_adler, METH_VARARGS,
     "Bucket (str key, value) tuples by adler32(key) %% n_buckets."},
    {"scan_fill_values", scan_fill_values, METH_VARARGS,
     "Flatten {key: [values]} into a float64 buffer; return group sizes."},
    {"scan_emit", scan_emit, METH_VARARGS,
     "Build [(key, (value, *outs)), ...] from groups + output columns."},
    {"kv_encode", kv_encode, METH_VARARGS,
     "Dict-encode (str key, value) tuples + fill values in one pass."},
    {"any_isinstance", any_isinstance, METH_VARARGS,
     "any(isinstance(x, types) for x in items) with a clean-type cache."},
    {"wa_encode", wa_encode, METH_VARARGS,
     "Dict-encode timestamped (str key, value) tuples + fill (ts, value) "
     "columns in one pass."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef hostopsmodule = {
    PyModuleDef_HEAD_INIT, "host_ops",
    "Native host-tier fast paths.", -1, HostOpsMethods,
};

PyMODINIT_FUNC
PyInit_host_ops(void)
{
    PyDateTime_IMPORT;
    if (PyDateTimeAPI == NULL) {
        return NULL;
    }
    return PyModule_Create(&hostopsmodule);
}
