"""Training over ranks (the port's ``kf2vecfsw_tpu/parallel/``): process
groups, the grid of data and model ranks and the collective helpers
(``mesh``), sharded canonical counting (``counting``) and a launcher for N
local ranks (``mp_check``)."""
