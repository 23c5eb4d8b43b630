"""Build and bind the port's CUDA kernels (csrc/*.cu).

At first use, one nvcc per csrc/*.cu source, all started together,
compiles it for sm_90a into falcon_tpu_torch/_build/ (git ignores it), and
a last nvcc links the objects into one shared library with a plain C
interface; a source or header newer than the library triggers a rebuild,
the way ops/native.py rebuilds the host library beside it.  The library is
loaded with ctypes.  A missing nvcc or a failed build raises.

Every C entry launches on the stream it is given and returns
cudaGetLastError() after the launch; `check` turns a non-zero code into a
RuntimeError.
"""
import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libftpu_torch_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
ARCH = "arch=compute_90a,code=sm_90a"

_lib = None


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")


def build():
    """Compile csrc/*.cu into LIB_PATH if it is missing or older than a
    source: one nvcc per source in parallel, then one link.  Returns the
    seconds spent (0.0 when up to date); nvcc's output, -Xptxas -v register
    and shared-memory counts included, goes to LOG_PATH."""
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    newest = max(os.path.getmtime(p) for p in
                 sources + glob.glob(os.path.join(SRC_DIR, "*.cuh")))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = ".%d" % os.getpid()
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + tag + ".o")
            for src in sources]
    cmds = [[nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-c", src, "-o", obj]
            for src, obj in zip(sources, objs)]
    tmp = LIB_PATH + tag
    t0 = time.time()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode]
    if not failed:
        cmds.append([nvcc, "-shared", "-o", tmp] + objs)
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append((cmds[-1], link.returncode, outs[-1]))
    for obj in objs:
        if os.path.exists(obj):
            os.unlink(obj)
    with open(LOG_PATH, "w") as f:
        for c, o in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + o)
    if failed:
        c, rc, o = failed[0]
        raise RuntimeError("nvcc failed (%d): %s\n%s" % (rc, " ".join(c), o))
    os.replace(tmp, LIB_PATH)
    return time.time() - t0


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        build()
        so = ctypes.CDLL(LIB_PATH)
        p, i = ctypes.c_void_p, ctypes.c_int
        so.ftt_extend_warp.argtypes = [p, p, p, p, i, i, i, i, p, p, p]
        so.ftt_extend_warp.restype = i
        so.ftt_extend_block.argtypes = [p, p, p, p, i, i, i, i, p, p]
        so.ftt_extend_block.restype = i
        so.ftt_tb_fwd.argtypes = [p, p, p, p, i, i, i, i, p, p, p]
        so.ftt_tb_fwd.restype = i
        so.ftt_tb_bwd.argtypes = [p, p, p, i, i, i, p, p, p]
        so.ftt_tb_bwd.restype = i
        so.ftt_tb_fwd_block.argtypes = so.ftt_tb_fwd.argtypes
        so.ftt_tb_fwd_block.restype = i
        so.ftt_tb_bwd_block.argtypes = so.ftt_tb_bwd.argtypes
        so.ftt_tb_bwd_block.restype = i
        so.ftt_tags.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                ctypes.c_float, i, i, p]
        so.ftt_tags.restype = i
        so.ftt_cns_scan.argtypes = [p, i, i, i, p, p, p, p, p, p, p]
        so.ftt_cns_scan.restype = i
        so.ftt_cns_walk.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p]
        so.ftt_cns_walk.restype = i
        so.ftt_chase.argtypes = [p, i, i, i, p, p, p]
        so.ftt_chase.restype = i
        so.ftt_error_string.argtypes = [i]
        so.ftt_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(code, what):
    if code != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            what, code, lib().ftt_error_string(code).decode()))


def check_batch(q, qlen, t, tlen, W):
    """Validate one [B, L] batch for K1/K2: int8 q/t of one shape, int32
    [B] lengths, all contiguous on one device; W a multiple of 32 in
    [32, 1024] (K1 and K2 take all of them; align_cuda.kernel_for and
    align_tb_cuda.kernel_for say with which kernel)."""
    if q.dim() != 2 or t.shape != q.shape:
        raise ValueError("q and t must both be [B, L]; got %s and %s"
                         % (tuple(q.shape), tuple(t.shape)))
    B = q.shape[0]
    for name, x, dt, shape in (("q", q, torch.int8, q.shape),
                               ("t", t, torch.int8, q.shape),
                               ("qlen", qlen, torch.int32, (B,)),
                               ("tlen", tlen, torch.int32, (B,))):
        if x.dtype != dt or tuple(x.shape) != tuple(shape):
            raise ValueError("%s must be %s %s; got %s %s" % (
                name, dt, tuple(shape), x.dtype, tuple(x.shape)))
        if not x.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if x.device != q.device:
            raise ValueError("%s is on %s, q on %s" % (name, x.device,
                                                       q.device))
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError("W must be a multiple of 32 in [32, 1024]; got %d"
                         % W)


def stream_of(x):
    return torch.cuda.current_stream(x.device).cuda_stream
