"""The C library over edipack_tpu_torch (``edtpu_*`` and the reference
EDIpack C-binding names); ``build.py`` builds it."""
