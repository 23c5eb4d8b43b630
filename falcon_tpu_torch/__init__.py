"""falcon_tpu_torch: the PyTorch/CUDA port of falcon_tpu's main assembly path.

The same pipeline as falcon_tpu (raw reads -> overlaps -> preads -> pread
overlaps -> p_ctg.fa / a_ctg.fa / GFA), with every device step on one
NVIDIA H100 and every Pallas kernel of that path rewritten by hand in CUDA
C++ for sm_90a:

  K1  csrc/extend.cu     banded extension        (falcon_tpu ops/align_pallas.py)
  K2  csrc/align_tb.cu   forward DP + trace      (ops/align_tb_pallas.py _fwd_kernel)
  K3  csrc/align_tb.cu   traceback walk          (ops/align_tb_pallas.py _bwd_kernel)
  K4-K6  csrc/cns_dp.cu  device-DP consensus     (ops/cns_dp.py scans)

Each kernel's Python wrapper launches it on a CUDA tensor and runs its plain
PyTorch twin on a CPU tensor; the twins are what the CPU tests hold against
the JAX package.

There are no learned parameters and so no weight conversion: the only state
that crosses between the two packages is the read database, a block's code
arrays and the cfg, all files.  This package imports torch, never jax, and
nothing of falcon_tpu: the host code (io, graph, config, the overlap chain
stage, the host C++ kernels behind ops.native, cns.runner, ...) is this
package's own copy of falcon_tpu's, file for file at the same relative
path, and the C++ library is built into this package's own _build/.

Layout mirrors falcon_tpu so each counterpart is easy to find:

  utils/device.py       device choice                 (utils/jaxinit.py)
  ops/align_device.py   plain extension + batching    (ops/align_device.py)
  ops/align_cuda.py     K1 wrapper                    (ops/align_pallas.py)
  ops/align_tb.py       plain alignment + traceback   (ops/align_tb.py)
  ops/align_tb_cuda.py  K2 + K3 wrapper               (ops/align_tb_pallas.py)
  ops/_build.py         nvcc build + ctypes binding
  ops/native.py         g++ build + ctypes binding    (ops/native.py)
  overlap/engine.py     make_device_aligner           (overlap/engine.py)
  cns/device.py         host-MSA device consensus     (cns/device.py)
  pipeline/driver.py    the fc_run-equivalent driver  (pipeline/driver.py)
"""

__version__ = "0.1.0"
