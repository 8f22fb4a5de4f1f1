/* tfhe_tpu C API.
 *
 * The analogue of the reference's cbindgen-generated tfhe.h
 * (tfhe/src/c_api/ + tfhe/build.rs): a flat C ABI over the high-level API,
 * opaque handles + destroy functions + int status returns (0 = success).
 * This copy is tfhe_tpu_torch's: implemented by libtfhe_tpu_torch_capi.so
 * (tfhe_tpu_torch/native/capi.cpp), which embeds CPython and dispatches to
 * the tfhe_tpu_torch.capi flat surface; computation runs on the CUDA card
 * unless the environment variable TFHE_TPU_TORCH_DEVICE is "cpu" when
 * tfhe_tpu_init() runs (without a card and without it, init fails).
 *
 * Usage mirrors tfhe/c_api_tests/test_high_level_integers.c:
 *   tfhe_tpu_init();
 *   tfhe_config_builder_custom("PARAM_MESSAGE_2_CARRY_2_KS_PBS", &cfg);
 *   tfhe_generate_keys(cfg, seed, &ck, &sk);
 *   tfhe_set_server_key(sk);
 *   tfhe_fheuint8_try_encrypt_with_client_key_u8(3, ck, &a);  ...
 */
#ifndef TFHE_TPU_H
#define TFHE_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int32_t tfhe_status; /* 0 = ok, non-zero = error */
typedef uint64_t tfhe_handle; /* opaque object handle; 0 is never valid */

/* runtime lifecycle ------------------------------------------------------ */
tfhe_status tfhe_tpu_init(void);
tfhe_status tfhe_tpu_shutdown(void);
/* static string describing the last Python-side error (never NULL) */
const char *tfhe_tpu_last_error(void);

/* config / keys ---------------------------------------------------------- */
tfhe_status tfhe_config_builder_default(tfhe_handle *out);
tfhe_status tfhe_config_builder_custom(const char *param_set_name,
                                       tfhe_handle *out);
tfhe_status tfhe_generate_keys(tfhe_handle config, uint64_t seed,
                               tfhe_handle *client_key,
                               tfhe_handle *server_key);
tfhe_status tfhe_set_server_key(tfhe_handle server_key);
tfhe_status tfhe_destroy(tfhe_handle h);

/* FheUint widths (reference c_api covers u8..u256; u8/16/32/64 here) ------ */
#define TFHE_TPU_DECLARE_FHEUINT(N, ctype)                                    \
  tfhe_status tfhe_fheuint##N##_try_encrypt_with_client_key_u##N(             \
      ctype value, tfhe_handle client_key, tfhe_handle *out);                 \
  tfhe_status tfhe_fheuint##N##_decrypt(tfhe_handle ct,                       \
                                        tfhe_handle client_key, ctype *out);  \
  tfhe_status tfhe_fheuint##N##_add(tfhe_handle, tfhe_handle, tfhe_handle *); \
  tfhe_status tfhe_fheuint##N##_sub(tfhe_handle, tfhe_handle, tfhe_handle *); \
  tfhe_status tfhe_fheuint##N##_mul(tfhe_handle, tfhe_handle, tfhe_handle *); \
  tfhe_status tfhe_fheuint##N##_bitand(tfhe_handle, tfhe_handle,              \
                                       tfhe_handle *);                        \
  tfhe_status tfhe_fheuint##N##_bitor(tfhe_handle, tfhe_handle,               \
                                      tfhe_handle *);                         \
  tfhe_status tfhe_fheuint##N##_bitxor(tfhe_handle, tfhe_handle,              \
                                       tfhe_handle *);                        \
  tfhe_status tfhe_fheuint##N##_eq(tfhe_handle, tfhe_handle, tfhe_handle *);  \
  tfhe_status tfhe_fheuint##N##_le(tfhe_handle, tfhe_handle, tfhe_handle *);  \
  tfhe_status tfhe_fheuint##N##_scalar_add(tfhe_handle lhs, ctype scalar,     \
                                           tfhe_handle *out);                 \
  tfhe_status tfhe_deserialize_fheuint##N(const uint8_t *data, size_t len,    \
                                          tfhe_handle *out);

TFHE_TPU_DECLARE_FHEUINT(8, uint8_t)
TFHE_TPU_DECLARE_FHEUINT(16, uint16_t)
TFHE_TPU_DECLARE_FHEUINT(32, uint32_t)
TFHE_TPU_DECLARE_FHEUINT(64, uint64_t)

#undef TFHE_TPU_DECLARE_FHEUINT

/* FheUint128 / FheUint256 (values as little-endian u64 words, like the
 * reference's U128/U256 c_api structs) ------------------------------------ */
tfhe_status tfhe_fheuint128_try_encrypt_with_client_key_u128(
    uint64_t w0, uint64_t w1, tfhe_handle client_key, tfhe_handle *out);
tfhe_status tfhe_fheuint128_decrypt(tfhe_handle ct, tfhe_handle client_key,
                                    uint64_t *w0, uint64_t *w1);
tfhe_status tfhe_fheuint128_add(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint128_sub(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint128_bitxor(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint128_bitand(tfhe_handle, tfhe_handle, tfhe_handle *);

tfhe_status tfhe_fheuint256_try_encrypt_with_client_key_u256(
    uint64_t w0, uint64_t w1, uint64_t w2, uint64_t w3,
    tfhe_handle client_key, tfhe_handle *out);
tfhe_status tfhe_fheuint256_decrypt(tfhe_handle ct, tfhe_handle client_key,
                                    uint64_t *w0, uint64_t *w1, uint64_t *w2,
                                    uint64_t *w3);
tfhe_status tfhe_fheuint256_add(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint256_sub(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint256_bitxor(tfhe_handle, tfhe_handle, tfhe_handle *);
tfhe_status tfhe_fheuint256_bitand(tfhe_handle, tfhe_handle, tfhe_handle *);

/* compressed / compact keys and compressed ciphertexts (reference c_api
 * compressed_server_key.rs, compact public key, compressed integers) ------ */
tfhe_status tfhe_compressed_server_key_new(tfhe_handle client_key,
                                           uint64_t seed, tfhe_handle *out);
tfhe_status tfhe_compressed_server_key_decompress(tfhe_handle csk,
                                                  tfhe_handle *out);
tfhe_status tfhe_compact_public_key_new(tfhe_handle client_key, uint64_t seed,
                                        tfhe_handle *out);
#define TFHE_TPU_DECLARE_COMPRESSED(N, ctype)                                 \
  tfhe_status tfhe_compressed_fheuint##N##_try_encrypt_with_client_key_u##N(  \
      ctype value, tfhe_handle client_key, tfhe_handle *out);                 \
  tfhe_status tfhe_compressed_fheuint##N##_decompress(tfhe_handle h,          \
                                                      tfhe_handle *out);      \
  tfhe_status tfhe_fheuint##N##_try_encrypt_with_compact_public_key_u##N(     \
      ctype value, tfhe_handle public_key, tfhe_handle *out);

TFHE_TPU_DECLARE_COMPRESSED(8, uint8_t)
TFHE_TPU_DECLARE_COMPRESSED(32, uint32_t)

#undef TFHE_TPU_DECLARE_COMPRESSED

/* FheInt widths (signed; two's-complement values across the ABI) ---------- */
#define TFHE_TPU_DECLARE_FHEINT(N, ctype)                                     \
  tfhe_status tfhe_fheint##N##_try_encrypt_with_client_key_i##N(              \
      ctype value, tfhe_handle client_key, tfhe_handle *out);                 \
  tfhe_status tfhe_fheint##N##_decrypt(tfhe_handle ct,                        \
                                       tfhe_handle client_key, ctype *out);   \
  tfhe_status tfhe_fheint##N##_add(tfhe_handle, tfhe_handle, tfhe_handle *);  \
  tfhe_status tfhe_fheint##N##_sub(tfhe_handle, tfhe_handle, tfhe_handle *);  \
  tfhe_status tfhe_fheint##N##_mul(tfhe_handle, tfhe_handle, tfhe_handle *);  \
  tfhe_status tfhe_fheint##N##_neg(tfhe_handle ct, tfhe_handle *out);

TFHE_TPU_DECLARE_FHEINT(32, int32_t)
TFHE_TPU_DECLARE_FHEINT(64, int64_t)

#undef TFHE_TPU_DECLARE_FHEINT

/* boolean scheme (reference c_api/boolean/) ------------------------------- */
tfhe_status tfhe_boolean_gen_keys(const char *param_set_name, uint64_t seed,
                                  tfhe_handle *client_key,
                                  tfhe_handle *server_key);
tfhe_status tfhe_boolean_encrypt(int value, tfhe_handle client_key,
                                 tfhe_handle *out);
tfhe_status tfhe_boolean_decrypt(tfhe_handle ct, tfhe_handle client_key,
                                 int *out);
tfhe_status tfhe_boolean_and(tfhe_handle sk, tfhe_handle, tfhe_handle,
                             tfhe_handle *);
tfhe_status tfhe_boolean_or(tfhe_handle sk, tfhe_handle, tfhe_handle,
                            tfhe_handle *);
tfhe_status tfhe_boolean_xor(tfhe_handle sk, tfhe_handle, tfhe_handle,
                             tfhe_handle *);
tfhe_status tfhe_boolean_nand(tfhe_handle sk, tfhe_handle, tfhe_handle,
                              tfhe_handle *);
tfhe_status tfhe_boolean_nor(tfhe_handle sk, tfhe_handle, tfhe_handle,
                             tfhe_handle *);
tfhe_status tfhe_boolean_xnor(tfhe_handle sk, tfhe_handle, tfhe_handle,
                              tfhe_handle *);
tfhe_status tfhe_boolean_not(tfhe_handle sk, tfhe_handle ct, tfhe_handle *out);
tfhe_status tfhe_boolean_mux(tfhe_handle sk, tfhe_handle cond,
                             tfhe_handle then_ct, tfhe_handle else_ct,
                             tfhe_handle *out);

/* shortint scheme (reference c_api/shortint/) ------------------------------ */
tfhe_status tfhe_shortint_gen_keys(const char *param_set_name, uint64_t seed,
                                   tfhe_handle *client_key,
                                   tfhe_handle *server_key);
tfhe_status tfhe_shortint_encrypt(uint64_t value, tfhe_handle client_key,
                                  tfhe_handle *out);
tfhe_status tfhe_shortint_decrypt(tfhe_handle ct, tfhe_handle client_key,
                                  uint64_t *out);
tfhe_status tfhe_shortint_add(tfhe_handle sk, tfhe_handle, tfhe_handle,
                              tfhe_handle *);
tfhe_status tfhe_shortint_sub(tfhe_handle sk, tfhe_handle, tfhe_handle,
                              tfhe_handle *);
tfhe_status tfhe_shortint_mul(tfhe_handle sk, tfhe_handle, tfhe_handle,
                              tfhe_handle *);
tfhe_status tfhe_shortint_bitand(tfhe_handle sk, tfhe_handle, tfhe_handle,
                                 tfhe_handle *);
tfhe_status tfhe_shortint_bitxor(tfhe_handle sk, tfhe_handle, tfhe_handle,
                                 tfhe_handle *);
tfhe_status tfhe_shortint_greater(tfhe_handle sk, tfhe_handle, tfhe_handle,
                                  tfhe_handle *);
tfhe_status tfhe_shortint_scalar_add(tfhe_handle sk, tfhe_handle lhs,
                                     uint64_t scalar, tfhe_handle *out);

/* serialization ---------------------------------------------------------- */
/* On success *out is malloc'd (caller frees with tfhe_buffer_destroy). */
tfhe_status tfhe_serialize(tfhe_handle h, uint8_t **out, size_t *len);
void tfhe_buffer_destroy(uint8_t *buf);

#ifdef __cplusplus
}
#endif

#endif /* TFHE_TPU_H */
