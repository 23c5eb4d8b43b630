"""Device choice for the port (replaces falcon_tpu/utils/jaxinit.py).

JAX picks its backend globally; the port instead passes an explicit
torch.device to every entry point.  resolve_device turns a name -- the
caller's `device=` argument, else FTPU_TORCH_DEVICE, else "cuda" -- into
that device.  Asking for CUDA on a machine without a GPU raises: nothing
on the port's device path falls back to the CPU on its own.

A bare "cuda" names no card.  In one process it is the current device;
in a process that is one of several (parallel.distributed.
want_distributed) it is that process's own card, process_card(), so that
the processes of a host spread over its GPUs.
"""
import logging
import os

import torch

LOG = logging.getLogger(__name__)
_logged = set()


def process_card():
    """This process's card when it is one of several processes
    (parallel.distributed.want_distributed): cuda:k with k =
    FTPU_PROCESS_ID modulo the visible GPUs (on a one-card host every
    process gets cuda:0).  None in a process that is not one of several.
    Logged once a process, with a warning when FTPU_NUM_PROCESSES exceeds
    the visible GPUs: then two processes of a host can share a card
    (always on a one-card host; on several hosts unless each host's ranks
    differ modulo its GPUs)."""
    from ..parallel.distributed import want_distributed
    if not want_distributed():
        return None
    pid = int(os.environ.get("FTPU_PROCESS_ID", "0"))
    num = int(os.environ.get("FTPU_NUM_PROCESSES", "1"))
    n = torch.cuda.device_count()
    dev = torch.device("cuda", pid % n)
    if "process" not in _logged:
        _logged.add("process")
        LOG.info("process %d of several: its card is %s (FTPU_PROCESS_ID "
                 "mod %d visible GPUs)", pid, dev, n)
        if num > n:
            LOG.warning("%d processes over %d visible GPUs: processes of "
                        "one host whose FTPU_PROCESS_ID agree modulo %d "
                        "share a card; name one with FTPU_TORCH_DEVICE to "
                        "choose", num, n, n)
    return dev


def resolve_device(device=None):
    """torch.device from `device` (str or torch.device), FTPU_TORCH_DEVICE
    or "cuda".  A bare "cuda" resolves to process_card() in one of several
    processes, else to the current CUDA device index; a device with an
    index is taken as named."""
    if device is None:
        device = os.environ.get("FTPU_TORCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r asked for, but torch.cuda.is_available() is "
                "False (pass device='cpu' to run the plain twins)" % str(dev))
        if dev.index is None:
            dev = process_card() or torch.device(
                "cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r" % str(dev))
    if dev not in _logged:
        _logged.add(dev)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "host"
        LOG.info("falcon_tpu_torch device: %s (%s)", dev, name)
    return dev
