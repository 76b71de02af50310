"""The quorum-commit kernels (commit_rule="pallas") as CUDA C++ for Hopper.

Port of raftsql_tpu/ops/pallas_quorum.py.  The JAX package's two Pallas
kernels become two hand-written CUDA kernels in csrc/quorum.cu (the
source note there says what they compute and what bounds them):

  pallas_quorum_commit_index         K1, the static full-voter rule
  pallas_masked_quorum_commit_index  K2, the voter-mask (joint) rule

The names stay those of the JAX package, so the step reads the same,
and like the JAX kernels they take any peer count P.  Each wrapper
takes its plain PyTorch version (`*_plain`, beside it) for tensors on
the CPU and only then; a CUDA tensor is checked (device, dtype, shape,
contiguity: one pass) and launches the kernel or raises.  `launches`
counts kernel launches per wrapper; a launch recorded into a CUDA graph
(`counting_capture`) is counted on each replay of the graph instead.

The kernels are compiled at first use with `nvcc` into build/kernels/
(a shared library with a plain C interface, loaded with ctypes), keyed
by a hash of the source so an edit rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

I32 = torch.int32
_NEG = -(1 << 30)
_MAX_ROWS = (1 << 31) - 1 - 256     # csrc/quorum.cu kMaxRows: int rows

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "quorum.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

launches = {"pallas_quorum_commit_index": 0,
            "pallas_masked_quorum_commit_index": 0}
_lib: Optional[ctypes.CDLL] = None
_log_path: Optional[str] = None
# Per thread: the counts of the graph capture in progress, or None.
_capturing = threading.local()

# The kernels' inputs in their C order, with the dtype each must have.
_NAMES = ("match", "log_term", "log_len", "commit", "term", "is_leader",
          "voters", "voters_joint")
_DTYPES = (I32, I32, I32, I32, I32, torch.bool, torch.bool, torch.bool)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@contextmanager
def counting_capture():
    """Count the launches this thread records into a CUDA graph apart
    from `launches` (a capture runs no kernel): yields those counts,
    which `count_replay` adds to `launches` on each replay."""
    counts = dict.fromkeys(launches, 0)
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = None


def count_replay(counts: dict) -> None:
    """One replay of a graph whose capture recorded `counts`."""
    for k, n in counts.items():
        launches[k] += n


def _count(name: str) -> None:
    counts = getattr(_capturing, "counts", None)
    (launches if counts is None else counts)[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the quorum "
                           "kernels are built from csrc/quorum.cu at "
                           "first use")
    return found


def build() -> float:
    """Compile csrc/quorum.cu (if the build for this source is missing)
    and load it; returns the seconds spent.  The compiler's report
    (ptxas registers, stack frames and spills per kernel) is kept beside
    the library: `build_log()`."""
    global _lib, _log_path
    if _lib is not None:
        return 0.0
    t0 = time.monotonic()
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libquorum_{digest}.so")
    log_path = so[:-3] + ".ptxas.txt"
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(log_path, "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.raftsql_quorum_commit.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.raftsql_quorum_commit.restype = ci
    lib.raftsql_masked_quorum_commit.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    lib.raftsql_masked_quorum_commit.restype = ci
    lib.raftsql_cuda_error_string.argtypes = [ci]
    lib.raftsql_cuda_error_string.restype = ctypes.c_char_p
    _lib, _log_path = lib, log_path
    return time.monotonic() - t0


def build_log() -> str:
    """The compiler's output for the loaded build (empty before it)."""
    if _log_path is None or not os.path.exists(_log_path):
        return ""
    with open(_log_path) as f:
        return f.read()


def _loaded() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


def _checked(ts, window: int):
    """Raise unless `ts` (in _NAMES order) are contiguous tensors of the
    kernels' dtypes and shapes on one CUDA card; returns (R, P).  One
    pass, one combined test a tensor: the message is built only for the
    tensor that fails."""
    match = ts[0]
    if not match.is_cuda:
        raise ValueError(f"quorum kernels run on cuda or cpu, not "
                         f"{match.device}")
    if match.dim() != 2:
        raise ValueError(f"match: expected [R, P], got {tuple(match.shape)}")
    if window < 1:
        raise ValueError(f"window {window}: the ring needs a slot")
    R, P = match.shape
    if R > _MAX_ROWS:
        raise ValueError(f"{R} rows: the kernels take at most {_MAX_ROWS}")
    dev = match.get_device()
    shapes = ((R, P), (R, window), (R,), (R,), (R,), (R,), (R, P), (R, P))
    for x, dt, shape, name in zip(ts, _DTYPES, shapes, _NAMES):
        if (x.dtype is not dt or x.get_device() != dev or x.shape != shape
                or not x.is_contiguous()):
            _refuse(name, x, dt, shape, match.device)
    return R, P


def _refuse(name, x, dtype, shape, dev):
    if x.dtype is not dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.shape != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    raise ValueError(f"{name}: not contiguous")


def _raise_on(rc: int, what: str) -> None:
    msg = _lib.raftsql_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


# ---- K1: the static full-voter rule ----------------------------------------

def quorum_commit_index_plain(match, log_term, log_len, commit, term,
                              is_leader, *, quorum: int, window: int):
    """Plain PyTorch version of K1: the same O(P^2) count and direct ring
    read, on any device."""
    cnt = (match[..., None, :] >= match[..., :, None]).sum(-1, dtype=I32)
    cand = torch.where(cnt >= quorum, match, 0).amax(-1)
    return _advance(cand, log_term, log_len, commit, term, is_leader,
                    window)


def _advance(cand, log_term, log_len, commit, term, is_leader, window):
    slot = torch.remainder(cand - 1, window)
    ct = torch.gather(log_term, -1, slot.long()[..., None])[..., 0]
    ct = torch.where((cand >= 1) & (cand <= log_len), ct, 0)
    ok = is_leader & (ct == term) & (cand > commit)
    return torch.where(ok, cand, commit)


def pallas_quorum_commit_index(match, log_term, log_len, commit, term,
                               is_leader, *, quorum: int, window: int):
    """K1 over [G, P] match, [G, W] ring and [G] columns (int32; is_leader
    bool) -> [G] int32.  CPU tensors take the plain version."""
    if match.is_cpu:
        return quorum_commit_index_plain(
            match, log_term, log_len, commit, term, is_leader,
            quorum=quorum, window=window)
    ts = (match, log_term, log_len, commit, term, is_leader)
    R, P = _checked(ts, window)
    lib = _loaded()
    out = torch.empty_like(commit)
    rc = lib.raftsql_quorum_commit(
        *[x.data_ptr() for x in ts], out.data_ptr(), R, P, window, quorum,
        torch._C._cuda_getCurrentRawStream(match.get_device()))
    if rc:
        _raise_on(rc, "K1 quorum_commit")
    _count("pallas_quorum_commit_index")
    return out


# ---- K2: the voter-mask rule -------------------------------------------------

def masked_quorum_commit_index_plain(match, log_term, log_len, commit, term,
                                     is_leader, *, voters, voters_joint,
                                     window: int, size=None):
    """Plain PyTorch version of K2."""
    def qidx(mask):
        P = match.shape[-1]
        m = torch.where(mask, match, _NEG)
        nv = mask.sum(-1, dtype=I32)
        need = nv // 2 + 1
        if size is not None:
            need = torch.where(nv == P, size, need)
        cnt = ((m[..., None, :] >= m[..., :, None])
               & mask[..., None, :]).sum(-1, dtype=I32)
        ok = mask & (cnt >= need[..., None])
        cand = torch.where(ok, m, _NEG).amax(-1)
        return torch.where(nv > 0, cand.clamp(min=0), 0)

    cand = torch.minimum(qidx(voters), qidx(voters_joint))
    return _advance(cand, log_term, log_len, commit, term, is_leader,
                    window)


def pallas_masked_quorum_commit_index(match, log_term, log_len, commit,
                                      term, is_leader, *, voters,
                                      voters_joint, window: int, size=None):
    """K2: K1's shapes plus [G, P] bool `voters` / `voters_joint`; `size`
    is the flexible write quorum on full masks (None = majority)."""
    if match.is_cpu:
        return masked_quorum_commit_index_plain(
            match, log_term, log_len, commit, term, is_leader,
            voters=voters, voters_joint=voters_joint, window=window,
            size=size)
    ts = (match, log_term, log_len, commit, term, is_leader, voters,
          voters_joint)
    R, P = _checked(ts, window)
    lib = _loaded()
    out = torch.empty_like(commit)
    rc = lib.raftsql_masked_quorum_commit(
        match.data_ptr(), voters.data_ptr(), voters_joint.data_ptr(),
        *[x.data_ptr() for x in ts[1:6]], out.data_ptr(), R, P, window,
        0 if size is None else int(size), size is not None,
        torch._C._cuda_getCurrentRawStream(match.get_device()))
    if rc:
        _raise_on(rc, "K2 masked quorum_commit")
    _count("pallas_masked_quorum_commit_index")
    return out
