"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` are compiled for ``sm_90a`` (one ``nvcc -c`` per
source, all started together) and linked into one shared library with a
plain C interface. The library is built at first use into ``build/`` at the
repository root, named by a digest of the sources and flags, so an unchanged
tree reuses it and a changed one rebuilds. Each C function returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("paged_attention.cu", "bcsc_matmul.cu", "bcsc_mlp.cu",
           "local_attention.cu", "rs_matmul.cu", "flash_backward.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
SIGNATURES = {
    # q, k_pool, v_pool, k_scale, v_scale, block_table, lengths, out, ws,
    # B, KV, KVp, kv_offset, R, D, P, ps, MP, pages_per_split, n_split,
    # sm_scale, softcap, stream
    "repro_paged_attention": [P] * 9 + [I] * 11 + [F, F, P],
    # x, M, K, blocks, row_ids, col_ptr, out, ws, N, bm, split, stream
    "repro_bcsc_gemm": [P, I, I, P, P, P, P, P, I, I, I, P],
    # x, K, blocks, row_ids, col_ptr, bias, act, out, N, split, stream
    "repro_bcsc_gemv": [P, I, P, P, P, P, I, P, I, I, P],
    # x, Mp, K, g_blk, g_rows, g_ptr, u_blk, u_rows, u_ptr, d_blk, d_rows,
    # d_ptr, counts, act, d_ff, n_out, hidden, out, ws, words, grid, split,
    # stream
    "repro_bcsc_mlp": [P, I, I] + [P] * 10 + [I, I, I] + [P] * 4
                      + [I, I, P],
    # q, k, v, out, lse (or null), B, S, H, KV, D, window, chunk,
    # score_mult, softcap, stream
    "repro_sliding_window_attention": [P] * 5 + [I] * 7 + [F, F, P],
    # q, k, v, out, lse (or null), B, Sq, Sk, q_offset, H, KV, D, window,
    # chunk, score_mult, softcap, stream
    "repro_sliding_window_attention_q": [P] * 5 + [I] * 9 + [F, F, P],
    # q, k, v, out16, lse, dout, dq, dk, dv, ws, B, Sq, Sk, q_offset, H,
    # KV, D, window, chunk, groups, score_mult, softcap, scale, stream
    "repro_flash_backward": [P] * 10 + [I] * 10 + [F, F, F, P],
    # x, ldx, w, ldw, bias, act, out, out_bf16, M, K, N, ws, stream
    "repro_rs_matmul": [P, I, P, I, P, I, P, I, I, I, I, P, P],
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"repro_kernels-{_digest()}.so"


def build() -> pathlib.Path:
    """Compile and link the kernels unless this tree's library exists.
    Raises RuntimeError with nvcc's output on a failed build. The compiler
    output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [cc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [(src, p.communicate()[0], p.returncode)
                for src, p in zip(SOURCES, procs)]
        log = "\n".join(f"== {src} (rc {rc})\n{out}" for src, out, rc in logs)
        if any(rc for _, _, rc in logs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_lib = os.path.join(tmp, lib.name)
        link = subprocess.run(
            [cc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *objs, "-o", tmp_lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text(log + link.stdout)
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the planners
    (``paged_attention.split_plan``, ``bcsc_matmul.gemm_plan``) size their
    grids to it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


_SYNC_WORDS = {}


def sync_words(t, n: int, stream: int):
    """At least ``n`` int32 words on ``t``'s device for the kernels
    launched on its current stream to count arrivals in: words 0 and 1 a
    grid barrier's arrival count and generation, the rest the counters of
    a fixed-order combine (``bcsc_mlp``). Allocated zeroed once
    per device and stream (grown when a call needs more) and never filled
    again: every kernel leaves its counters at zero, and a barrier's
    generation only counts up. Calls on one stream run in order, so they
    can share the words. ``stream`` is ``stream_of(t)``.

    Under CUDA graph capture the words must already exist: allocated (and
    zeroed) inside the capture, they would come from the graph's private
    pool and their fill would replay with the graph. ``serve.graphs.
    StepGraph`` warms up on its capture stream first, which allocates them
    there; a capture that finds none raises."""
    import torch
    key = (t.device.index, stream)
    words = _SYNC_WORDS.get(key)
    if words is None or words.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sync words first asked for under CUDA graph capture: run "
                "the captured work once on the capture stream before "
                "capturing it")
        words = torch.zeros(max(n, 256), dtype=torch.int32, device=t.device)
        _SYNC_WORDS[key] = words
    return words


def stream_of(t) -> int:
    """The current PyTorch stream on ``t``'s device, as a C pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    """Device pointer of a tensor, or None (a C null) for None."""
    return None if t is None else t.data_ptr()
