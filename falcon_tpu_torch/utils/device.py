"""Device choice for the port (replaces falcon_tpu/utils/jaxinit.py).

JAX picks its backend globally; the port instead passes an explicit
torch.device to every entry point.  resolve_device turns a name -- the
caller's `device=` argument, else FTPU_TORCH_DEVICE, else "cuda" -- into
that device.  Asking for CUDA on a machine without a GPU raises: nothing
on the port's device path falls back to the CPU on its own.
"""
import logging
import os

import torch

LOG = logging.getLogger(__name__)
_logged = set()


def resolve_device(device=None):
    """torch.device from `device` (str or torch.device), FTPU_TORCH_DEVICE
    or "cuda".  A bare "cuda" resolves to the current CUDA device index."""
    if device is None:
        device = os.environ.get("FTPU_TORCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r asked for, but torch.cuda.is_available() is "
                "False (pass device='cpu' to run the plain twins)" % str(dev))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r" % str(dev))
    if dev not in _logged:
        _logged.add(dev)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "host"
        LOG.info("falcon_tpu_torch device: %s (%s)", dev, name)
    return dev
