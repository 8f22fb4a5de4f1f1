// C ABI over the tfhe_tpu_torch high-level API (reference: tfhe/src/c_api/,
// whose cbindgen-generated tfhe.h is consumed by tfhe/c_api_tests/*.c).
//
// The reference's C API wraps a Rust library; here the host library is
// Python/PyTorch, so the shim embeds CPython and dispatches every call to the
// flat opaque-handle surface in tfhe_tpu_torch/capi.py.  Handles are the
// Python side's integer handles passed through verbatim.  tfhe_tpu_init
// imports that module and calls its init(), which reads
// TFHE_TPU_TORCH_DEVICE: the compute runs on the card unless it says "cpu",
// and init fails (tfhe_tpu_last_error says why) where it names a card and
// there is none.  The header is include/tfhe_tpu.h, the C API's own name.
//
// Build (see tfhe_tpu_torch/native/__init__.py build_capi):
//   g++ -O2 -shared -fPIC capi.cpp $(python3-config --includes) \
//       $(python3-config --embed --ldflags) -o libtfhe_tpu_torch_capi.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>

#include "include/tfhe_tpu.h"

namespace {

PyObject *g_mod = nullptr;       // tfhe_tpu_torch.capi module
bool g_we_initialized = false;   // whether WE called Py_Initialize
PyThreadState *g_main_ts = nullptr;  // saved after init (GIL released)
std::string g_err = "no error";

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      g_err = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  } else {
    g_err = "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Unpack a (status, value...) tuple from capi.py; writes up to two u64s.
// Guards tuple arity/NULL items so a contract mismatch on the Python side
// surfaces as an error status, not a segfault.
tfhe_status unpack(PyObject *res, uint64_t *out1, uint64_t *out2 = nullptr) {
  if (!res) {
    capture_py_error();
    return 1;
  }
  tfhe_status st = 0;
  if (PyTuple_Check(res)) {
    Py_ssize_t n = PyTuple_Size(res);
    Py_ssize_t need = 1 + (out1 ? 1 : 0) + (out2 ? 1 : 0);
    PyObject *st_item = n >= 1 ? PyTuple_GetItem(res, 0) : nullptr;
    if (!st_item) {
      Py_DECREF(res);
      g_err = "malformed result tuple from tfhe_tpu_torch.capi";
      return 1;
    }
    st = (tfhe_status)PyLong_AsLong(st_item);
    if (st == 0 && n < need) {
      Py_DECREF(res);
      g_err = "result tuple from tfhe_tpu_torch.capi is too short";
      return 1;
    }
    if (st == 0 && out1) {
      *out1 = PyLong_AsUnsignedLongLong(PyTuple_GetItem(res, 1));
    }
    if (st == 0 && out2) {
      *out2 = PyLong_AsUnsignedLongLong(PyTuple_GetItem(res, 2));
    }
    if (st == 0 && PyErr_Occurred()) {
      capture_py_error();
      Py_DECREF(res);
      return 1;
    }
  } else {
    st = (tfhe_status)PyLong_AsLong(res);  // plain int status
  }
  Py_DECREF(res);
  if (st != 0) g_err = "tfhe_tpu_torch.capi returned error status";
  return st;
}

}  // namespace

extern "C" {

tfhe_status tfhe_tpu_init(void) {
  if (g_mod) return 0;
  bool we_initialized_now = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = we_initialized_now = true;
  }
  {
    Gil gil;
    // the library may be loaded from anywhere; make the repo (cwd) importable
    PyRun_SimpleString("import sys, os\n"
                       "if os.getcwd() not in sys.path:\n"
                       "    sys.path.insert(0, os.getcwd())\n");
    g_mod = PyImport_ImportModule("tfhe_tpu_torch.capi");
    PyObject *r = g_mod ? PyObject_CallMethod(g_mod, "init", nullptr) : nullptr;
    if (r) {
      Py_DECREF(r);
    } else {
      capture_py_error();
      Py_CLEAR(g_mod);
    }
  }
  // Py_InitializeEx leaves the calling thread holding the GIL; release it so
  // entry points (which each take the GIL via PyGILState_Ensure) are callable
  // from any thread, matching the reference C API's thread-safety contract.
  if (we_initialized_now) g_main_ts = PyEval_SaveThread();
  return g_mod ? 0 : 1;
}

tfhe_status tfhe_tpu_shutdown(void) {
  if (g_mod) {
    Gil gil;
    Py_DECREF(g_mod);
    g_mod = nullptr;
  }
  // Finalizing an embedded CPython with live CUDA and torch runtimes is unreliable;
  // like most embedders we leave the interpreter up for process lifetime.
  return 0;
}

const char *tfhe_tpu_last_error(void) { return g_err.c_str(); }

tfhe_status tfhe_config_builder_default(tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "config_builder_default", nullptr),
                out);
}

tfhe_status tfhe_config_builder_custom(const char *name, tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "config_builder_custom", "s", name),
                out);
}

tfhe_status tfhe_generate_keys(tfhe_handle config, uint64_t seed,
                               tfhe_handle *client_key,
                               tfhe_handle *server_key) {
  Gil gil;
  return unpack(
      PyObject_CallMethod(g_mod, "generate_keys", "KK", config, seed),
      client_key, server_key);
}

tfhe_status tfhe_set_server_key(tfhe_handle server_key) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "set_server_key", "K", server_key),
                nullptr);
}

tfhe_status tfhe_destroy(tfhe_handle h) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "destroy", "K", h), nullptr);
}

#define TFHE_BINOP(cname, pyname)                                             \
  tfhe_status cname(tfhe_handle lhs, tfhe_handle rhs, tfhe_handle *out) {     \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KK", lhs, rhs), out);   \
  }

/* Stamp a full FheUintN function family (reference c_api macro expansion
 * across integer widths, tfhe/src/c_api/high_level_api/integers/). */
#define TFHE_FHEUINT_FAMILY(N, ctype)                                         \
  tfhe_status tfhe_fheuint##N##_try_encrypt_with_client_key_u##N(             \
      ctype value, tfhe_handle ck, tfhe_handle *out) {                        \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(                                        \
                      g_mod, "fheuint" #N "_try_encrypt_with_client_key",     \
                      "KK", (uint64_t)value, ck),                             \
                  out);                                                       \
  }                                                                           \
  tfhe_status tfhe_fheuint##N##_decrypt(tfhe_handle ct, tfhe_handle ck,       \
                                        ctype *out) {                         \
    Gil gil;                                                                  \
    uint64_t v = 0;                                                           \
    tfhe_status st = unpack(                                                  \
        PyObject_CallMethod(g_mod, "fheuint" #N "_decrypt", "KK", ct, ck),    \
        &v);                                                                  \
    if (st == 0 && out) *out = (ctype)v;                                      \
    return st;                                                                \
  }                                                                           \
  tfhe_status tfhe_fheuint##N##_scalar_add(tfhe_handle lhs, ctype scalar,     \
                                           tfhe_handle *out) {                \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, "fheuint" #N "_scalar_add",      \
                                      "KK", lhs, (uint64_t)scalar),           \
                  out);                                                       \
  }                                                                           \
  tfhe_status tfhe_deserialize_fheuint##N(const uint8_t *data, size_t len,    \
                                          tfhe_handle *out) {                 \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, "deserialize_fheuint" #N,        \
                                      "y#", (const char *)data,               \
                                      (Py_ssize_t)len),                       \
                  out);                                                       \
  }                                                                           \
  TFHE_BINOP(tfhe_fheuint##N##_add, "fheuint" #N "_add")                      \
  TFHE_BINOP(tfhe_fheuint##N##_sub, "fheuint" #N "_sub")                      \
  TFHE_BINOP(tfhe_fheuint##N##_mul, "fheuint" #N "_mul")                      \
  TFHE_BINOP(tfhe_fheuint##N##_bitand, "fheuint" #N "_bitand")                \
  TFHE_BINOP(tfhe_fheuint##N##_bitor, "fheuint" #N "_bitor")                  \
  TFHE_BINOP(tfhe_fheuint##N##_bitxor, "fheuint" #N "_bitxor")                \
  TFHE_BINOP(tfhe_fheuint##N##_eq, "fheuint" #N "_eq")                        \
  TFHE_BINOP(tfhe_fheuint##N##_le, "fheuint" #N "_le")

TFHE_FHEUINT_FAMILY(8, uint8_t)
TFHE_FHEUINT_FAMILY(16, uint16_t)
TFHE_FHEUINT_FAMILY(32, uint32_t)
TFHE_FHEUINT_FAMILY(64, uint64_t)

#undef TFHE_FHEUINT_FAMILY
#undef TFHE_BINOP

/* FheUint128 (values as two little-endian u64 words, like the reference's
 * U128 c_api struct; FheUint256 is available on the Python surface) ------- */

tfhe_status tfhe_fheuint128_try_encrypt_with_client_key_u128(
    uint64_t w0, uint64_t w1, tfhe_handle ck, tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(
                    g_mod, "fheuint128_try_encrypt_with_client_key", "KKK",
                    w0, w1, ck),
                out);
}

tfhe_status tfhe_fheuint128_decrypt(tfhe_handle ct, tfhe_handle ck,
                                    uint64_t *w0, uint64_t *w1) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "fheuint128_decrypt", "KK", ct, ck),
                w0, w1);
}

#define TFHE_U128_BINOP(cname, pyname)                                        \
  tfhe_status cname(tfhe_handle lhs, tfhe_handle rhs, tfhe_handle *out) {     \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KK", lhs, rhs), out);   \
  }

TFHE_U128_BINOP(tfhe_fheuint128_add, "fheuint128_add")
TFHE_U128_BINOP(tfhe_fheuint128_sub, "fheuint128_sub")
TFHE_U128_BINOP(tfhe_fheuint128_bitxor, "fheuint128_bitxor")
TFHE_U128_BINOP(tfhe_fheuint128_bitand, "fheuint128_bitand")

#undef TFHE_U128_BINOP

/* FheUint256 (values as four little-endian u64 words, like the reference's
 * U256 c_api struct) ------------------------------------------------------ */

tfhe_status tfhe_fheuint256_try_encrypt_with_client_key_u256(
    uint64_t w0, uint64_t w1, uint64_t w2, uint64_t w3, tfhe_handle ck,
    tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(
                    g_mod, "fheuint256_try_encrypt_with_client_key", "KKKKK",
                    w0, w1, w2, w3, ck),
                out);
}

tfhe_status tfhe_fheuint256_decrypt(tfhe_handle ct, tfhe_handle ck,
                                    uint64_t *w0, uint64_t *w1, uint64_t *w2,
                                    uint64_t *w3) {
  Gil gil;
  PyObject *res =
      PyObject_CallMethod(g_mod, "fheuint256_decrypt", "KK", ct, ck);
  if (!res) {
    capture_py_error();
    return 1;
  }
  tfhe_status st = 1;
  if (PyTuple_Check(res) && PyTuple_Size(res) >= 5) {
    st = (tfhe_status)PyLong_AsLong(PyTuple_GetItem(res, 0));
    uint64_t *outs[4] = {w0, w1, w2, w3};
    for (int i = 0; st == 0 && i < 4; ++i) {
      if (outs[i])
        *outs[i] = PyLong_AsUnsignedLongLong(PyTuple_GetItem(res, i + 1));
    }
    /* PyLong_AsLong on a non-int status returns -1 with a pending
     * exception; fetch it unconditionally so it cannot leak into the
     * next ABI call. */
    if (PyErr_Occurred()) {
      capture_py_error();
      st = 1;
    }
  } else {
    g_err = "malformed fheuint256_decrypt result";
  }
  Py_DECREF(res);
  return st;
}

#define TFHE_U256_BINOP(cname, pyname)                                        \
  tfhe_status cname(tfhe_handle lhs, tfhe_handle rhs, tfhe_handle *out) {     \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KK", lhs, rhs), out);   \
  }

TFHE_U256_BINOP(tfhe_fheuint256_add, "fheuint256_add")
TFHE_U256_BINOP(tfhe_fheuint256_sub, "fheuint256_sub")
TFHE_U256_BINOP(tfhe_fheuint256_bitxor, "fheuint256_bitxor")
TFHE_U256_BINOP(tfhe_fheuint256_bitand, "fheuint256_bitand")

#undef TFHE_U256_BINOP

/* compressed / compact keys and ciphertexts (reference c_api
 * compressed_server_key.rs, compact list / compressed integers) ----------- */

tfhe_status tfhe_compressed_server_key_new(tfhe_handle client_key,
                                           uint64_t seed, tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "compressed_server_key_new", "KK",
                                    client_key, seed),
                out);
}

tfhe_status tfhe_compressed_server_key_decompress(tfhe_handle csk,
                                                  tfhe_handle *out) {
  Gil gil;
  return unpack(
      PyObject_CallMethod(g_mod, "compressed_server_key_decompress", "K", csk),
      out);
}

tfhe_status tfhe_compact_public_key_new(tfhe_handle client_key, uint64_t seed,
                                        tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "compact_public_key_new", "KK",
                                    client_key, seed),
                out);
}

#define TFHE_COMPRESSED_FAMILY(N, ctype)                                      \
  tfhe_status tfhe_compressed_fheuint##N##_try_encrypt_with_client_key_u##N(  \
      ctype value, tfhe_handle ck, tfhe_handle *out) {                        \
    Gil gil;                                                                  \
    return unpack(                                                            \
        PyObject_CallMethod(g_mod,                                            \
                            "compressed_fheuint" #N                           \
                            "_try_encrypt_with_client_key",                   \
                            "KK", (uint64_t)value, ck),                       \
        out);                                                                 \
  }                                                                           \
  tfhe_status tfhe_compressed_fheuint##N##_decompress(tfhe_handle h,          \
                                                      tfhe_handle *out) {     \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(                                        \
                      g_mod, "compressed_fheuint" #N "_decompress", "K", h),  \
                  out);                                                       \
  }                                                                           \
  tfhe_status tfhe_fheuint##N##_try_encrypt_with_compact_public_key_u##N(     \
      ctype value, tfhe_handle pk, tfhe_handle *out) {                        \
    Gil gil;                                                                  \
    return unpack(                                                            \
        PyObject_CallMethod(                                                  \
            g_mod, "fheuint" #N "_try_encrypt_with_compact_public_key", "KK", \
            (uint64_t)value, pk),                                             \
        out);                                                                 \
  }

TFHE_COMPRESSED_FAMILY(8, uint8_t)
TFHE_COMPRESSED_FAMILY(32, uint32_t)

#undef TFHE_COMPRESSED_FAMILY

/* FheInt widths (signed; two's-complement across the ABI) ----------------- */

#define TFHE_FHEINT_FAMILY(N, ctype)                                          \
  tfhe_status tfhe_fheint##N##_try_encrypt_with_client_key_i##N(              \
      ctype value, tfhe_handle ck, tfhe_handle *out) {                        \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(                                        \
                      g_mod, "fheint" #N "_try_encrypt_with_client_key",      \
                      "KK", (uint64_t)value, ck),                             \
                  out);                                                       \
  }                                                                           \
  tfhe_status tfhe_fheint##N##_decrypt(tfhe_handle ct, tfhe_handle ck,        \
                                       ctype *out) {                          \
    Gil gil;                                                                  \
    uint64_t v = 0;                                                           \
    tfhe_status st = unpack(                                                  \
        PyObject_CallMethod(g_mod, "fheint" #N "_decrypt", "KK", ct, ck),     \
        &v);                                                                  \
    if (st == 0 && out) *out = (ctype)v;                                      \
    return st;                                                                \
  }                                                                           \
  tfhe_status tfhe_fheint##N##_neg(tfhe_handle ct, tfhe_handle *out) {        \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, "fheint" #N "_neg", "K", ct),    \
                  out);                                                       \
  }                                                                           \
  TFHE_SIGNED_BINOP(tfhe_fheint##N##_add, "fheint" #N "_add")                 \
  TFHE_SIGNED_BINOP(tfhe_fheint##N##_sub, "fheint" #N "_sub")                 \
  TFHE_SIGNED_BINOP(tfhe_fheint##N##_mul, "fheint" #N "_mul")

#define TFHE_SIGNED_BINOP(cname, pyname)                                      \
  tfhe_status cname(tfhe_handle lhs, tfhe_handle rhs, tfhe_handle *out) {     \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KK", lhs, rhs), out);   \
  }

TFHE_FHEINT_FAMILY(32, int32_t)
TFHE_FHEINT_FAMILY(64, int64_t)

#undef TFHE_FHEINT_FAMILY
#undef TFHE_SIGNED_BINOP

/* boolean scheme (reference c_api/boolean/) ------------------------------- */

tfhe_status tfhe_boolean_gen_keys(const char *param_set_name, uint64_t seed,
                                  tfhe_handle *client_key,
                                  tfhe_handle *server_key) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "boolean_gen_keys", "sK",
                                    param_set_name, seed),
                client_key, server_key);
}

tfhe_status tfhe_boolean_encrypt(int value, tfhe_handle ck,
                                 tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "boolean_encrypt", "KK",
                                    (uint64_t)(value != 0), (uint64_t)ck),
                out);
}

tfhe_status tfhe_boolean_decrypt(tfhe_handle ct, tfhe_handle ck, int *out) {
  Gil gil;
  uint64_t v = 0;
  tfhe_status st = unpack(
      PyObject_CallMethod(g_mod, "boolean_decrypt", "KK", ct, ck), &v);
  if (st == 0 && out) *out = (int)v;
  return st;
}

#define TFHE_BOOL_GATE(cname, pyname)                                         \
  tfhe_status cname(tfhe_handle sk, tfhe_handle lhs, tfhe_handle rhs,         \
                    tfhe_handle *out) {                                       \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KKK", sk, lhs, rhs),    \
                  out);                                                       \
  }

TFHE_BOOL_GATE(tfhe_boolean_and, "boolean_and")
TFHE_BOOL_GATE(tfhe_boolean_or, "boolean_or")
TFHE_BOOL_GATE(tfhe_boolean_xor, "boolean_xor")
TFHE_BOOL_GATE(tfhe_boolean_nand, "boolean_nand")
TFHE_BOOL_GATE(tfhe_boolean_nor, "boolean_nor")
TFHE_BOOL_GATE(tfhe_boolean_xnor, "boolean_xnor")

#undef TFHE_BOOL_GATE

tfhe_status tfhe_boolean_not(tfhe_handle sk, tfhe_handle ct,
                             tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "boolean_not", "KK", sk, ct), out);
}

tfhe_status tfhe_boolean_mux(tfhe_handle sk, tfhe_handle cond,
                             tfhe_handle then_ct, tfhe_handle else_ct,
                             tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "boolean_mux", "KKKK", sk, cond,
                                    then_ct, else_ct),
                out);
}

/* shortint scheme (reference c_api/shortint/) ------------------------------ */

tfhe_status tfhe_shortint_gen_keys(const char *param_set_name, uint64_t seed,
                                   tfhe_handle *client_key,
                                   tfhe_handle *server_key) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "shortint_gen_keys", "sK",
                                    param_set_name, seed),
                client_key, server_key);
}

tfhe_status tfhe_shortint_encrypt(uint64_t value, tfhe_handle ck,
                                  tfhe_handle *out) {
  Gil gil;
  return unpack(
      PyObject_CallMethod(g_mod, "shortint_encrypt", "KK", value, (uint64_t)ck),
      out);
}

tfhe_status tfhe_shortint_decrypt(tfhe_handle ct, tfhe_handle ck,
                                  uint64_t *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "shortint_decrypt", "KK", ct, ck),
                out);
}

#define TFHE_SHORTINT_OP(cname, pyname)                                       \
  tfhe_status cname(tfhe_handle sk, tfhe_handle lhs, tfhe_handle rhs,         \
                    tfhe_handle *out) {                                       \
    Gil gil;                                                                  \
    return unpack(PyObject_CallMethod(g_mod, pyname, "KKK", sk, lhs, rhs),    \
                  out);                                                       \
  }

TFHE_SHORTINT_OP(tfhe_shortint_add, "shortint_add")
TFHE_SHORTINT_OP(tfhe_shortint_sub, "shortint_sub")
TFHE_SHORTINT_OP(tfhe_shortint_mul, "shortint_mul")
TFHE_SHORTINT_OP(tfhe_shortint_bitand, "shortint_bitand")
TFHE_SHORTINT_OP(tfhe_shortint_bitxor, "shortint_bitxor")
TFHE_SHORTINT_OP(tfhe_shortint_greater, "shortint_greater")

#undef TFHE_SHORTINT_OP

tfhe_status tfhe_shortint_scalar_add(tfhe_handle sk, tfhe_handle lhs,
                                     uint64_t scalar, tfhe_handle *out) {
  Gil gil;
  return unpack(PyObject_CallMethod(g_mod, "shortint_scalar_add", "KKK", sk,
                                    lhs, scalar),
                out);
}

tfhe_status tfhe_serialize(tfhe_handle h, uint8_t **out, size_t *len) {
  Gil gil;
  PyObject *res = PyObject_CallMethod(g_mod, "serialize", "K", h);
  if (!res) {
    capture_py_error();
    return 1;
  }
  if (!PyTuple_Check(res) || PyTuple_Size(res) < 2) {
    Py_DECREF(res);
    g_err = "malformed result tuple from tfhe_tpu_torch.capi serialize";
    return 1;
  }
  tfhe_status st = (tfhe_status)PyLong_AsLong(PyTuple_GetItem(res, 0));
  if (st == 0) {
    PyObject *bytes = PyTuple_GetItem(res, 1);
    char *buf = nullptr;
    Py_ssize_t n = 0;
    if (bytes != nullptr && PyBytes_AsStringAndSize(bytes, &buf, &n) == 0) {
      uint8_t *dst = (uint8_t *)std::malloc((size_t)n);
      if (dst == nullptr) {
        g_err = "allocation failed in tfhe_serialize";
        st = 1;
      } else {
        std::memcpy(dst, buf, (size_t)n);
        *out = dst;
        *len = (size_t)n;
      }
    } else {
      capture_py_error();
      st = 1;
    }
  }
  Py_DECREF(res);
  return st;
}

void tfhe_buffer_destroy(uint8_t *buf) { std::free(buf); }

}  // extern "C"
