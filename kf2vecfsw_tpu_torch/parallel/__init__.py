"""Data-parallel training over ranks (the port's ``kf2vecfsw_tpu/parallel/``):
process groups and the collective helpers (``mesh``), sharded canonical
counting (``counting``) and a launcher for N local ranks (``mp_check``)."""
