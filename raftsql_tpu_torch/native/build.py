"""Build and load the native storage plane (native/wal.cc) through
ctypes, and build the HTTP load generator (native/http_load.cc) and the
WAL's sanitizer stress harness (native/wal_stress.cc).

wal.cc is host C++ (no CUDA): the WAL writers, the `plog_*` payload log,
the combined `walplog_*` calls and the `kv_*` apply plane, behind a plain
C ABI.  It is compiled at first use, never at import, with

    g++ -O2 -std=c++17 -shared -fPIC

into build/native/libwal_<source digest>.so at the root of the checkout
(the digest covers the source and the flags, so an edit rebuilds).  The
compiler writes a temporary file that is renamed into place, so processes
building at once (test workers, the three Procfile children) never open a
half-written library.

Unlike the JAX package's build, which falls back to the Python writers
when the compiler or the load fails, this one never falls back: when the
native backend is asked for (`WAL(native=True)`, or the `native=None`
default outside an fsio fault injector), a failed build or load raises
with the compiler's stderr.  The Python backend runs only when asked for:
`native=False`, an active fsio injector, or RAFTSQL_TPU_NATIVE=0 (the
JAX package's switch), under which the loaders below return None.

The library is loaded with ctypes' default RTLD_LOCAL, so its C symbols
never clash with another library exporting the same names in the same
process (the JAX package's own build of wal.cc, in the parity tests).

native/sqlite_apply.cc (the SQLite state machine's run apply) is built the
same way into build/native/libsqlite_apply_<digest>.so by
`load_sqlite_apply`, which binds it to the libsqlite3 that the
interpreter's own sqlite3 module loaded.  It has no Python fallback for a
file-backed state machine and ignores RAFTSQL_TPU_NATIVE: a failed build
or load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "wal.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}        # (source, build dir) -> the loaded CDLL


def build(source: Optional[str] = None,
          build_dir: Optional[str] = None) -> str:
    """Compile `source` (default native/wal.cc) into `build_dir` (default
    build/native/) as lib<source stem>_<digest>.so unless this source's
    build is there already; returns the library's path.  Raises
    RuntimeError with the compiler's output when g++ is missing or
    fails."""
    source = SOURCE if source is None else source
    build_dir = BUILD_DIR if build_dir is None else build_dir
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(build_dir, f"lib{stem}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, source],
                                 capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native storage plane: cannot run g++ on "
                               f"{source}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"native storage plane: g++ failed on "
                               f"{source} ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _declare(lib) -> None:
    """argtypes/restype of every entry point, as the JAX package's
    native/build.py declares them."""
    c = ctypes
    u8p, u32p = c.POINTER(c.c_uint8), c.POINTER(c.c_uint32)
    u64p, i64p = c.POINTER(c.c_uint64), c.POINTER(c.c_int64)
    # The WAL fast path.
    lib.wal_open.restype = c.c_void_p
    lib.wal_open.argtypes = [c.c_char_p]
    lib.wal_append_entry.restype = c.c_int
    lib.wal_append_entry.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                     c.c_uint64, c.c_char_p, c.c_uint32]
    lib.wal_append_entries.restype = c.c_int
    lib.wal_append_entries.argtypes = [c.c_void_p, c.c_uint32, u32p, u64p,
                                       u64p, c.c_char_p, u32p]
    lib.wal_append_ranges.restype = c.c_int
    lib.wal_append_ranges.argtypes = [c.c_void_p, c.c_uint32, u32p, u64p,
                                      u64p, u32p, c.c_char_p, u32p]
    lib.wal_set_hardstate.restype = c.c_int
    lib.wal_set_hardstate.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                      c.c_int64, c.c_uint64]
    lib.wal_set_hardstates.restype = c.c_int
    lib.wal_set_hardstates.argtypes = [c.c_void_p, c.c_uint32, u32p, u64p,
                                       i64p, u64p]
    lib.wal_set_snapshot.restype = c.c_int
    lib.wal_set_snapshot.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                     c.c_uint64]
    lib.wal_epoch.restype = c.c_int
    lib.wal_epoch.argtypes = [c.c_void_p, c.c_uint64, c.c_uint8]
    lib.wal_set_compact.restype = c.c_int
    lib.wal_set_compact.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                    c.c_uint64]
    lib.wal_sync.restype = c.c_int
    lib.wal_sync.argtypes = [c.c_void_p]
    lib.wal_close.restype = c.c_int
    lib.wal_close.argtypes = [c.c_void_p]
    # The payload log and the combined WAL + payload-log calls.
    lib.plog_new.restype = c.c_void_p
    lib.plog_new.argtypes = [c.c_uint32]
    lib.plog_free.restype = None
    lib.plog_free.argtypes = [c.c_void_p]
    for fn in ("plog_length", "plog_start", "plog_start_term"):
        f = getattr(lib, fn)
        f.restype = c.c_uint64
        f.argtypes = [c.c_void_p, c.c_uint32]
    lib.plog_set_start.restype = c.c_int
    lib.plog_set_start.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                   c.c_uint64]
    lib.plog_term_of.restype = c.c_uint64
    lib.plog_term_of.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64]
    lib.plog_compact.restype = c.c_int
    lib.plog_compact.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                 c.c_uint64]
    lib.plog_put_range.restype = c.c_int
    lib.plog_put_range.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                   c.c_uint32, u64p, c.c_char_p, u32p,
                                   c.c_int64]
    lib.plog_range_bytes.restype = c.c_uint64
    lib.plog_range_bytes.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                     c.c_uint32]
    lib.plog_read_range.restype = c.c_int
    lib.plog_read_range.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64,
                                    c.c_uint32, u8p, u32p, u64p]
    lib.plog_ranges_bytes.restype = c.c_uint64
    lib.plog_ranges_bytes.argtypes = [c.c_void_p, c.c_uint32, u32p, u64p,
                                      u32p]
    lib.plog_read_groups.restype = c.c_int
    lib.plog_read_groups.argtypes = [c.c_void_p, c.c_uint32, u32p, u64p,
                                     u32p, u8p, u32p]
    lib.walplog_put_uniform.restype = c.c_int
    lib.walplog_put_uniform.argtypes = [c.c_void_p, c.c_void_p, c.c_uint32,
                                        u32p, u64p, u32p, u64p, c.c_char_p,
                                        u32p, c.c_uint32]
    lib.walplog_mirror_all.restype = c.c_int
    lib.walplog_mirror_all.argtypes = [c.POINTER(c.c_void_p),
                                       c.POINTER(c.c_void_p), c.c_uint32,
                                       u32p, u32p, u32p, u64p, u32p, i64p,
                                       u64p, u32p]
    # The KV apply plane.
    lib.kv_new.restype = c.c_void_p
    lib.kv_new.argtypes = [c.c_uint32]
    lib.kv_free.restype = None
    lib.kv_free.argtypes = [c.c_void_p]
    lib.kv_apply_plog.restype = c.c_uint64
    lib.kv_apply_plog.argtypes = [c.c_void_p, c.c_void_p, c.c_uint32, u32p,
                                  u64p, u32p, u64p]
    lib.kv_applied.restype = c.c_uint64
    lib.kv_applied.argtypes = [c.c_void_p, c.c_uint32]
    lib.kv_count.restype = c.c_uint64
    lib.kv_count.argtypes = [c.c_void_p, c.c_uint32]
    lib.kv_get.restype = c.c_int64
    lib.kv_get.argtypes = [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint32,
                           u8p, c.c_uint32]


def _load():
    """The loaded library (built first if needed), or None under
    RAFTSQL_TPU_NATIVE=0.  Raises when the build or the load fails."""
    if os.environ.get("RAFTSQL_TPU_NATIVE", "1") == "0":
        return None
    key = (SOURCE, BUILD_DIR)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            so = build(SOURCE, BUILD_DIR)
            try:
                lib = ctypes.CDLL(so)
                _declare(lib)
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"native storage plane: cannot load "
                                   f"{so}: {e}") from e
            _libs[key] = lib
        return lib


def load_native_wal():
    """ctypes handle to the WAL fast path; None under
    RAFTSQL_TPU_NATIVE=0."""
    return _load()


SQLITE_APPLY_SOURCE = os.path.join(_DIR, "sqlite_apply.cc")


def _sqlite_library() -> str:
    """The path of the SQLite library the interpreter's sqlite3 module
    runs on: the libsqlite3 mapped into this process, or the `_sqlite3`
    extension itself where it carries SQLite inside.  One SQLite in the
    process keeps one record of the file locks it holds."""
    import _sqlite3
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libsqlite3"):
                return path
    return _sqlite3.__file__


def load_sqlite_apply():
    """ctypes handle to native/sqlite_apply.cc (built first if needed),
    its SQLite entry points bound.  Raises when the build, the load or
    the binding fails."""
    key = (SQLITE_APPLY_SOURCE, BUILD_DIR)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            so = build(SQLITE_APPLY_SOURCE, BUILD_DIR)
            c = ctypes
            i64p = c.POINTER(c.c_int64)
            try:
                lib = ctypes.CDLL(so)
                lib.sa_init.restype = c.c_int
                lib.sa_init.argtypes = [c.c_char_p]
                lib.sa_open.restype = c.c_void_p
                lib.sa_open.argtypes = [c.c_char_p, c.c_int]
                lib.sa_close.restype = None
                lib.sa_close.argtypes = [c.c_void_p]
                lib.sa_apply_run.restype = c.c_int64
                lib.sa_apply_run.argtypes = [
                    c.POINTER(c.c_void_p), c.c_int32, i64p, i64p,
                    c.c_char_p, i64p, i64p, i64p, c.POINTER(c.c_int32),
                    i64p, i64p, c.POINTER(c.c_void_p), i64p]
                lib.sa_free.restype = None
                lib.sa_free.argtypes = [c.c_void_p]
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"native SQLite apply: cannot load "
                                   f"{so}: {e}") from e
            sqlite = _sqlite_library()
            if lib.sa_init(sqlite.encode()) != 0:
                raise RuntimeError(f"native SQLite apply: cannot bind the "
                                   f"SQLite entry points of {sqlite}")
            _libs[key] = lib
        return lib


HTTP_LOAD_SOURCE = os.path.join(_DIR, "http_load.cc")
HTTP_LOAD_FLAGS = ("-O2",)


def build_http_load(build_dir: Optional[str] = None) -> str:
    """Compile native/http_load.cc (the single-thread epoll HTTP load
    generator) into `build_dir` (default build/native/) as
    http_load_<digest> unless that build is there already; returns the
    executable's path.  Raises RuntimeError with the compiler's output
    when g++ is missing or fails: there is no fall back to Python client
    threads.  Usage of the binary: `http_load <seconds> <conns> <groups>
    <port> [port ...]`, one JSON line {"n", "errors", "p50_ms",
    "p99_ms", "secs"} on stdout; each connection loops PUT `INSERT INTO
    t (v) VALUES (...)` over the groups, so every group needs a table
    `t (v)`."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    with open(HTTP_LOAD_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(HTTP_LOAD_FLAGS)
                                .encode()).hexdigest()[:16]
    exe = os.path.join(build_dir, f"http_load_{digest}")
    if os.path.exists(exe):
        return exe
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{exe}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        try:
            res = subprocess.run(
                ["g++", *HTTP_LOAD_FLAGS, "-o", tmp, HTTP_LOAD_SOURCE],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"http_load: cannot run g++ on "
                               f"{HTTP_LOAD_SOURCE}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"http_load: g++ failed on "
                               f"{HTTP_LOAD_SOURCE} ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, exe)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return exe


STRESS_SOURCE = os.path.join(_DIR, "wal_stress.cc")
# Sanitizer variants of the WAL stress harness (the JAX package's flags):
# -O1 keeps stacks honest in reports, -fno-omit-frame-pointer makes asan
# traces readable, -fno-sanitize-recover turns every ubsan diagnostic
# into a nonzero exit.
SANITIZERS = {
    "asan": ("-pthread", "-fsanitize=address", "-fno-omit-frame-pointer"),
    "ubsan": ("-pthread", "-fsanitize=undefined",
              "-fno-sanitize-recover=all"),
    "tsan": ("-pthread", "-fsanitize=thread"),
}


def build_wal_stress(sanitizer: str,
                     build_dir: Optional[str] = None) -> str:
    """Compile native/wal_stress.cc with native/wal.cc under `sanitizer`
    (a SANITIZERS key) into `build_dir` (default build/native/) as
    wal_stress_<sanitizer>_<digest> unless that build is there already;
    returns the executable's path.  Raises RuntimeError with the
    compiler's output when g++ is missing or fails (the JAX package's
    build returns None and its script skips).  Usage of the binary:
    `wal_stress <dir> [iters]`: four threads on one WAL handle in
    <dir>."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    flags = ("-O1", "-g", "-std=c++17", *SANITIZERS[sanitizer])
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (STRESS_SOURCE, SOURCE):
        with open(src, "rb") as f:
            h.update(f.read())
    exe = os.path.join(build_dir,
                       f"wal_stress_{sanitizer}_{h.hexdigest()[:16]}")
    if os.path.exists(exe):
        return exe
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{exe}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        try:
            res = subprocess.run(
                ["g++", *flags, "-o", tmp, STRESS_SOURCE, SOURCE],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"wal_stress[{sanitizer}]: cannot run g++: "
                               f"{e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"wal_stress[{sanitizer}]: g++ failed "
                               f"({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, exe)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return exe


def load_native_plog():
    """ctypes handle to the native payload log, the combined walplog
    entry points and the KV apply plane (the WAL's shared object); None
    under RAFTSQL_TPU_NATIVE=0."""
    return _load()
