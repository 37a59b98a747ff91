"""The C example of edipack_tpu_torch (``hm_bethe.c``) and its build
(``python -m edipack_tpu_torch.examples.c.build``)."""
