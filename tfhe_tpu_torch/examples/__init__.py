"""Worked examples (counterpart of `tfhe_tpu/examples/`; reference
tfhe/examples/): sha256_bool (SHA-256 over boolean gates), dark_market
(encrypted order matching), regex_engine (encrypted regex matching)."""
