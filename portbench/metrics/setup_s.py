"""Seconds from the process's start to the window's open: imports, CUDA
and the kernels' build, the server, elections, the DDL and load phases
and the warm-up."""


def read(snap: dict):
    return snap["setup_s"]
