"""The native storage plane: native/wal.cc (host C++, no CUDA) built with
g++ at first use and loaded through ctypes (native/build.py).  A failed
build or load raises; the Python writers run only when asked for."""
from raftsql_tpu_torch.native.build import (load_native_plog,  # noqa: F401
                                            load_native_wal)
